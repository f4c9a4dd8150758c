"""Multi-frame scene rollout on the cached path (port of
umgen_tpu/models/generate.py, `Generator._generate_cached` without a mesh,
ring refresh or chunked prefill).

The conditioning window is ingested once (`frame_step_prefill`), then each
generated frame becomes the next step's ingested frame
(`frame_step_cached`).  Trajectory replay and agent control (the
reference's `--infer_task control` and `--init_token_mod`) are not driven
from here yet; the frame steps take their overrides.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen

Params = Dict[str, Any]


class Generator:
    def __init__(self, model: UMGen, params: Params, seed: int = 0,
                 device=None):
        self.model = model
        self.params = params
        self.rollout = Rollout(model)
        self.device = torch.device(device) if device is not None else \
            params["axe"].device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # host-clock seconds of each generated frame (the frame's tokens
        # are copied to the host, which waits for the device)
        self.frame_seconds: List[float] = []

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def generate(self, cond_tokens: Dict[str, np.ndarray], new_frames: int,
                 input_cond_frames: int = -1) -> Dict[str, np.ndarray]:
        """cond_tokens {mod: [B, T0, len]} → {mod: [B, input_cond_frames +
        new_frames, len]} numpy (the conditioning prefix + generated
        frames)."""
        lo = self.model.layout
        mods = lo.mod_order
        if input_cond_frames == -1:
            input_cond_frames = self.model.config.cond_frame
        out = {m: np.asarray(cond_tokens[m][:, :input_cond_frames])
               for m in mods}
        sl = lo.slices()
        cache = None
        for idx in range(new_frames):
            t0 = time.perf_counter()
            if idx == 0:
                res, cache = self.rollout.frame_step_prefill(
                    self.params, {m: self._dev(out[m]) for m in mods},
                    self.generator)
            else:
                res, cache = self.rollout.frame_step_cached(
                    self.params, {m: self._dev(out[m][:, -1:]) for m in mods},
                    cache, self.generator)
            tokens = res.tokens.cpu().numpy()
            if not (torch.isfinite(res.ego_logits).all()
                    and torch.isfinite(res.prior_seq).all()):
                raise FloatingPointError(
                    f"frame {idx}: non-finite ego logits or TAR priors")
            self.frame_seconds.append(time.perf_counter() - t0)
            for m in mods:
                out[m] = np.concatenate([out[m], tokens[:, None, sl[m]]],
                                        axis=1)
        return out
