"""Scene-rollout harness (port of umgen_tpu/tools/harness.py, minimal).

Runs the rollout for one scene or a batch of scenes, writes the token
pickles ``saved_token/<scene>_tokens.pkl`` (skipping scenes already done)
and reports per-frame seconds and frames/s.  Detokenized videos, MMD and
the collision-rate metric are not ported yet (ROADMAP.md: 'VQ
detokenizers, videos and metrics').
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List

import numpy as np

from umgen_tpu_torch.config import InferConfig
from umgen_tpu_torch.models.generate import Generator


def _scene_name(batch: Dict) -> str:
    return os.path.basename(str(batch.get("file_name", "scene"))).replace(
        ".pkl", "")


class SceneRunner:
    def __init__(self, generator: Generator, infer_config: InferConfig,
                 output_path: str = "output/UMGen"):
        self.gen = generator
        self.cfg = infer_config
        self.token_save_path = os.path.join(output_path, "saved_token")
        os.makedirs(self.token_save_path, exist_ok=True)
        self.timings: List[Dict] = []

    def _token_path(self, name: str) -> str:
        return os.path.join(self.token_save_path, f"{name}_tokens.pkl")

    def run_scenes(self, batches: List[Dict]) -> List[Dict[str, np.ndarray]]:
        """Stack the scenes on the batch axis, run ONE rollout, save each
        scene's tokens.  Returns the per-scene token dicts."""
        todo = []
        for b in batches:
            name = _scene_name(b)
            if os.path.exists(self._token_path(name)):
                print(f"{name} has been processed")
                continue
            todo.append((name, b))
        if not todo:
            return []
        mods = self.gen.model.layout.mod_order
        input_cond = self.cfg.input_cond_frames

        def frames_of(b):
            arr = np.asarray(b[mods[0]])
            return arr.shape[0] if arr.ndim == 2 else arr.shape[1]

        T0 = min(frames_of(b) for _, b in todo)
        cond = {}
        for m in mods:
            rows = []
            for _, b in todo:
                arr = np.asarray(b[m])
                rows.append((arr[None] if arr.ndim == 2 else arr)[:, :T0]
                            .astype(np.int64))
            cond[m] = np.concatenate(rows, axis=0)
        new_frames = self.cfg.num_new_frames
        if new_frames == -1:
            new_frames = T0 - input_cond

        n0 = len(self.gen.frame_seconds)
        t0 = time.perf_counter()
        out = self.gen.generate(cond, new_frames=new_frames,
                                input_cond_frames=input_cond)
        dt = time.perf_counter() - t0
        per_frame = self.gen.frame_seconds[n0:]
        self.timings.append({"scenes": len(todo), "frames": new_frames,
                             "seconds": dt, "frame_seconds": per_frame,
                             "frames_per_sec": len(todo) * new_frames / dt})
        print("per-frame seconds: "
              + ", ".join(f"{s:.3f}" for s in per_frame)
              + f"  ({len(todo) * new_frames / dt:.4f} frames/s over "
              f"{len(todo)} scene(s))")
        outs = []
        for i, (name, _) in enumerate(todo):
            per = {m: out[m][i:i + 1] for m in mods}
            with open(self._token_path(name), "wb") as f:
                pickle.dump(per, f)
            outs.append(per)
        return outs
