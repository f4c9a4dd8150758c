"""Scene-rollout harness (port of umgen_tpu/tools/harness.py, without the
videos).

Runs the rollout for one scene (`run_scene`: a video clip, or a control pkl
with its ego trajectory and controlled agents) or a batch of video scenes
(`run_scenes`: one rollout with the scenes on the batch axis), writes the
token pickles ``saved_token/<scene>_tokens.pkl`` (skipping scenes already
done), reports per-frame seconds and frames/s, decodes the boxes and the
pose, and accumulates the agent metrics: the collision rate (`BoxOverlap`)
over every frame, MMD against the GT continuation.  The map and image
pictures and the videos are not ported yet (ROADMAP.md: 'VQ detokenizers,
videos and metrics').
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from umgen_tpu_torch.config import InferConfig
from umgen_tpu_torch.data.pipeline import ScenePipeline
from umgen_tpu_torch.models.generate import Generator
from umgen_tpu_torch.ops.collision import BoxOverlap
from umgen_tpu_torch.ops.metrics import MMDMetric


def _scene_name(batch: Dict) -> str:
    return os.path.basename(str(batch.get("file_name", "scene"))).replace(
        ".pkl", "")


def _frames(arr) -> np.ndarray:
    """A scene's stream, [T, len] or [B, T, len] → [B, T, len] int64."""
    arr = np.asarray(arr)
    return (arr[None] if arr.ndim == 2 else arr).astype(np.int64)


class SceneRunner:
    def __init__(self, generator: Generator, infer_config: InferConfig,
                 output_path: str = "output/UMGen",
                 pipeline: Optional[ScenePipeline] = None,
                 init_token_mod: Optional[Sequence[str]] = None):
        """init_token_mod: modalities forced to the GT continuation during
        generation (the reference's init-token replay for FID / MMD
        evaluation, ref:model_pl.py:103-130), e.g. ("map", "image")."""
        self.gen = generator
        self.cfg = infer_config
        self.pipeline = pipeline or ScenePipeline()
        self.init_token_mod = tuple(init_token_mod or ())
        self.token_save_path = os.path.join(output_path, "saved_token")
        os.makedirs(self.token_save_path, exist_ok=True)
        self.box_overlap = BoxOverlap()
        self.mmd = MMDMetric()
        self.timings: List[Dict] = []

    def _token_path(self, name: str) -> str:
        return os.path.join(self.token_save_path, f"{name}_tokens.pkl")

    def _done(self, name: str) -> bool:
        """Skip-if-exists resume (ref:model_pl.py:215-216)."""
        if os.path.exists(self._token_path(name)):
            print(f"{name} has been processed")
            return True
        return False

    def _forced(self, cond, input_cond: int, new_frames: int):
        """init_token_mod replay: the listed modalities' GT continuation."""
        forced = {m: cond[m][:, input_cond:input_cond + new_frames]
                  for m in self.init_token_mod
                  if m in cond and cond[m].shape[1] > input_cond}
        return forced or None

    def _generate(self, cond, new_frames, input_cond, scenes, **kw):
        n0 = len(self.gen.frame_seconds)
        t0 = time.perf_counter()
        out = self.gen.generate(cond, new_frames=new_frames,
                                cond_frames=self.cfg.cond_frames,
                                input_cond_frames=input_cond, **kw)
        dt = time.perf_counter() - t0
        per_frame = self.gen.frame_seconds[n0:]
        self.timings.append({"scenes": scenes, "frames": new_frames,
                             "seconds": dt, "frame_seconds": per_frame,
                             "frames_per_sec": scenes * new_frames / dt})
        print("per-frame seconds: "
              + ", ".join(f"{s:.3f}" for s in per_frame)
              + f"  ({scenes * new_frames / dt:.4f} frames/s over "
              f"{scenes} scene(s))")
        return out

    def run_scene(self, batch: Dict, control_test: bool = False
                  ) -> Optional[Dict[str, np.ndarray]]:
        """One scene: rollout → save → decode → metrics.  batch: a token
        dict from the dataset (video), or a control pkl dict with
        'dataset_token' / 'control_dict' (control, ref:model_pl.py:
        132-200).  Returns the scene's tokens, None if it was done."""
        if control_test:
            gt = batch["dataset_token"]
            control = batch.get("control_dict") or {}
            name = str(batch.get("scene_name", "control_scene"))
            init = {m: _frames(v) for m, v in control.items()}
            input_cond = int(batch.get("input_cond_frame",
                                       self.cfg.input_cond_frames))
            if "no_control" in name:
                init, control_test = None, False
        else:
            gt, init = batch, None
            name = _scene_name(batch)
            input_cond = self.cfg.input_cond_frames
        if self._done(name):
            return None
        cond = {m: _frames(gt[m]) for m in self.gen.model.layout.mod_order}
        new_frames = self.cfg.num_new_frames
        if new_frames == -1:
            new_frames = cond["bbox3d"].shape[1] - input_cond
        forced = None if control_test else \
            self._forced(cond, input_cond, new_frames)
        out = self._generate(cond, new_frames, input_cond, 1,
                             init_tokens=init, control_test=control_test,
                             forced_streams=forced)
        self._postprocess(out, gt, name, input_cond)
        return out

    def run_scenes(self, batches: List[Dict], control_test: bool = False
                   ) -> List[Optional[Dict[str, np.ndarray]]]:
        """Stack the video scenes on the batch axis, run ONE rollout, then
        save and score each scene.  Control scenes carry their own
        trajectories and run one by one."""
        if control_test or len(batches) == 1:
            return [self.run_scene(b, control_test) for b in batches]
        todo = [(_scene_name(b), b) for b in batches]
        todo = [(n, b) for n, b in todo if not self._done(n)]
        if not todo:
            return []
        mods = self.gen.model.layout.mod_order
        input_cond = self.cfg.input_cond_frames
        T0 = min(_frames(b["pose"]).shape[1] for _, b in todo)
        cond = {m: np.concatenate([_frames(b[m])[:, :T0] for _, b in todo])
                for m in mods}
        new_frames = self.cfg.num_new_frames
        if new_frames == -1:
            new_frames = T0 - input_cond
        out = self._generate(
            cond, new_frames, input_cond, len(todo),
            forced_streams=self._forced(cond, input_cond, new_frames))
        outs = []
        for i, (name, b) in enumerate(todo):
            per = {m: out[m][i:i + 1] for m in mods}
            self._postprocess(per, b, name, input_cond)
            outs.append(per)
        return outs

    def _postprocess(self, out, gt, name: str, input_cond: int) -> None:
        """Save the tokens, decode them, score the agents."""
        with open(self._token_path(name), "wb") as f:
            pickle.dump(out, f)
        try:
            decoded = self.decode_tokens(out)
        except Exception as e:  # noqa: BLE001 — journal it, go on
            # scenes whose decode failed, for an offline re-decode (the
            # reference's undecoded_token.txt, ref:model_pl.py:343-348)
            with open(os.path.join(self.token_save_path,
                                   "undecoded_token.txt"), "a") as f:
                f.write(name + "\n")
            print(f"decode failed for {name}: {e}")
            return
        if "bbox3d" not in out:      # agent-free task: no agent metrics
            return
        # MMD between the generated frames and the GT continuation when the
        # clip is long enough (the paper's agent-realism metric)
        gt_bbox = _frames(gt["bbox3d"])
        if gt_bbox.shape[1] > input_cond:
            gt_boxes, gt_cats, gt_valid = self.pipeline.decode_bboxes(
                gt_bbox[0, input_cond:])
            pb, pc, pv = (decoded["boxes"][input_cond:],
                          decoded["cat_ids"][input_cond:],
                          decoded["valid"][input_cond:])
            n = min(len(gt_boxes), len(pb))
            if n > 0:
                self.mmd.update(pb[:n][pv[:n]], pc[:n][pv[:n]],
                                gt_boxes[:n][gt_valid[:n]],
                                gt_cats[:n][gt_valid[:n]])

    def decode_tokens(self, out_tokens: Dict[str, np.ndarray]) -> Dict:
        """Token streams → metric boxes and pose values
        (ref:model_pl.py:357-457); adds the frames to the collision
        rate."""
        T = out_tokens["pose"].shape[1]
        if "bbox3d" in out_tokens:
            boxes, cats, valid = self.pipeline.decode_bboxes(
                out_tokens["bbox3d"][0])
        else:                        # agent-free tasks (e.g. pose_map)
            boxes = np.zeros((T, 0, 10), np.float32)
            cats = np.zeros((T, 0), np.int32)
            valid = np.zeros((T, 0), bool)
        res = {"boxes": boxes, "cat_ids": cats, "valid": valid,
               "pose": self.pipeline.decode_pose(out_tokens["pose"][0])}
        self.box_overlap.update([boxes[t][valid[t]]
                                 for t in range(boxes.shape[0])])
        return res
