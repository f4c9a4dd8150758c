"""Multi-frame scene rollout (port of umgen_tpu/models/generate.py, the
video task without a mesh).

Recompute mode (`tar_mode="recompute"`, the reference's semantics): before
each frame the window is cut to its last `cond_frames` frames and the whole
of it runs through every TAR stack (`Rollout.frame_step`).

Temporal-cache mode: the conditioning window is ingested once — in one
full-window pass (`frame_step_prefill`), or with `chunked_prefill` frame by
frame (`frame_step_chunked`) — then each generated frame becomes the next
step's ingested frame (`frame_step_cached`).  With `tar_cache_refresh` = N,
every N-th frame after the window has slid rebuilds the rings from the
window's last `tar_cache_window` frames, with window-relative indices, so
that the frame decoded then sees recompute's semantics.

Trajectory replay and agent control (the reference's `--infer_task control`
and `--init_token_mod`) are not driven from here yet; the frame steps take
their overrides.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import NotPortedError, UMGen

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
        # ring rebuilds under tar_cache_refresh
        self.refreshes = 0

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def generate(self, cond_tokens: Dict[str, np.ndarray], new_frames: int,
                 cond_frames: int = 20, input_cond_frames: int = -1,
                 init_tokens: Optional[Dict[str, np.ndarray]] = None,
                 control_test: bool = False,
                 forced_streams: Optional[Dict[str, np.ndarray]] = None
                 ) -> Dict[str, np.ndarray]:
        """cond_tokens {mod: [B, T0, len]} → {mod: [B, input_cond_frames +
        new_frames, len]} numpy (the conditioning prefix + generated
        frames).  `cond_frames`: recompute mode's window; the cached path's
        is the ring's."""
        if init_tokens is not None or control_test or forced_streams:
            raise NotPortedError("trajectory replay, agent control and "
                                 "forced streams are not ported yet "
                                 "(ROADMAP.md: 'Control mode and "
                                 "--init_token_mod')")
        cfg = self.model.config
        mods = self.model.layout.mod_order
        if input_cond_frames == -1:
            input_cond_frames = cond_frames if cfg.tar_mode == "recompute" \
                else cfg.cond_frame
        out = {m: np.asarray(cond_tokens[m][:, :input_cond_frames])
               for m in mods}
        window = cond_frames if cfg.tar_mode == "recompute" \
            else self.model.t_max
        refresh = cfg.tar_cache_refresh
        cache = None
        for idx in range(new_frames):
            t0 = time.perf_counter()
            # the reference's window: the stream's last `window` frames
            # (the port's stream carries no control overwrites, so `out` is
            # the window's exact content)
            last = {m: self._dev(out[m][:, -window:]) for m in mods}
            if cfg.tar_mode == "recompute":
                res = self.rollout.frame_step(self.params, last,
                                              self.generator)
            elif idx == 0:
                inputs = {m: self._dev(out[m]) for m in mods}
                first = self.rollout.frame_step_prefill
                if cfg.chunked_prefill and inputs["pose"].shape[1] > 1:
                    first = self.rollout.frame_step_chunked
                res, cache = first(self.params, inputs, self.generator)
            elif (refresh and idx % refresh == 0 and window > 1
                  and out["pose"].shape[1] > window):
                # fresh rings (frames counted from 0, so window-relative
                # PEs) from the window's frames, each with the next one's
                # pose, then the cached step on the newest: the old rings
                # go first, as the reference frees them
                cache = None
                res, cache = self.rollout.frame_step_chunked(
                    self.params, last, self.generator)
                self.refreshes += 1
            else:
                res, cache = self.rollout.frame_step_cached(
                    self.params, {m: v[:, -1:] for m, v in last.items()},
                    cache, self.generator)
            tokens = res.tokens.cpu().numpy()
            if not (torch.isfinite(res.ego_logits).all()
                    and torch.isfinite(res.prior_seq).all()):
                raise FloatingPointError(
                    f"frame {idx}: non-finite ego logits or TAR priors")
            self.frame_seconds.append(time.perf_counter() - t0)
            sl = self.model.layout.slices()
            for m in mods:
                out[m] = np.concatenate([out[m], tokens[:, None, sl[m]]],
                                        axis=1)
        return out
