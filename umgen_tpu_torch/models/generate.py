"""Multi-frame scene rollout (port of umgen_tpu/models/generate.py).

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

Trajectory replay and agent control (the reference's `--infer_task
control`): `init_tokens["pose"]` forces the ego action of each generated
frame while it lasts, and under `control_test` `init_tokens["bbox3d"]`
(-1 where free) overwrites the agents of the window's newest frame before
the frame is decoded.  The reference writes that overwrite into its window
tensor, so it stays as the window slides: the loop keeps the window (`cond`)
apart from the output stream (`out`).  `forced_streams` (`--init_token_mod`)
teacher-forces the listed modalities of each generated frame to the given
tokens; a forced pose rides trajectory control.

Multi-process rollouts (`mesh`, a parallel.mesh.Mesh, and `spmd`, the
JAX Generator's argument, umgen_tpu/models/generate.py:35-190): every
rank rolls its contiguous shard of the scenes (its dp index's rows) — its
own rings and OAR cache, the control and forced streams split like the
tokens — and at the end every rank gathers the whole batch's tokens.

  * spmd="gspmd" (the default, JAX's GSPMD program; the only one that
    takes tp): the model runs on the mesh (UMGen.on_mesh), split over tp
    as the rank's params are (parallel.mesh.Mesh.shard_params): the TAR
    family on the rank's heads, the rings holding them, the OAR split or
    whole as its params are (models/rollout.py); a split int8 OAR whose
    pushes go to the v1 kernel (`fused_oar_kernel`, a bfloat16 / float8
    cache, no packs) is gathered whole here, as the v1 kernel runs every
    head.  The sampling noise is
    the unsharded run's: every rank's sampler is seeded with `seed`, and
    over dp > 1 samples the whole batch's gathered logits and keeps its
    rows.  Recompute and temporal-cache mode both serve.
  * spmd="shard_map" (the dp-only serving program): whole params on every
    rank, a sampler seeded from `seed` and the rank's dp index (JAX's
    `fold_in(rng, axis_index("dp"))`); temporal-cache mode only, at tp = 1,
    as JAX's program.

The frame loop's only collectives besides the blocks' are the sum of the
speculative telemetry over dp and, under gspmd, the gathered logits.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen

Params = Dict[str, Any]


def rank_seed(seed: int, rank: int) -> int:
    """The sampler seed of data-parallel rank `rank` of a run seeded with
    `seed`: distinct for each rank, so that scenes in the same row of two
    ranks' shards do not draw the same noise."""
    lo, hi = np.random.SeedSequence((seed, rank)).generate_state(
        2, np.uint32)
    return (int(hi) << 31) | int(lo) >> 1


class Generator:
    def __init__(self, model: UMGen, params: Params, seed: int = 0,
                 device=None, mesh=None, spmd: str = "gspmd"):
        """mesh: a parallel.mesh.Mesh for a multi-process rollout (scenes
        split over its dp ranks; the batch must divide dp).  spmd: "gspmd"
        (params the rank's blocks, `mesh.shard_params`) or "shard_map"
        (params whole; tp = 1, temporal-cache mode)."""
        if spmd not in ("gspmd", "shard_map"):
            raise ValueError(f"spmd must be gspmd|shard_map, got {spmd}")
        if spmd == "shard_map":
            if mesh is None:
                raise ValueError("spmd='shard_map' requires a mesh")
            if mesh.shape["tp"] != 1:
                raise ValueError(
                    "spmd='shard_map' serving is dp-only (the fused kernels "
                    "run whole-head-set per chip); use tp=1")
            if model.config.tar_mode != "temporal_cache":
                raise ValueError(
                    "spmd='shard_map' requires tar_mode='temporal_cache'")
        elif mesh is not None:
            model = model.on_mesh(mesh)
        self.model = model
        self.mesh = mesh
        self.spmd = spmd
        self.rollout = Rollout(model)
        if model.config.oar_cache_dtype in ("bfloat16", "float8_e4m3fn") \
                and self.rollout.runs_v1(params) \
                and self.rollout.oar_tp(params) is not None:
            # v1 runs the whole head set on every rank, as GSPMD
            # replicates JAX's custom call: the OAR stack gathered whole
            params = {**params, "oar": mesh.unshard_params(params["oar"])}
        self.params = params
        self.device = torch.device(device) if device is not None else \
            params["axe"].device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(
            rank_seed(seed, mesh.dp_rank) if spmd == "shard_map" else seed)
        # host-clock seconds of each generated frame (the frame's tokens
        # are copied to the host, which waits for the device)
        self.frame_seconds: List[float] = []
        # ring rebuilds under tar_cache_refresh
        self.refreshes = 0
        # speculative decoding, summed over the generated frames: verify
        # steps and accepted drafts (accepted / chunks drafts a chunk;
        # sequential decode of the same tokens takes chunks + accepted steps)
        self.spec_chunks = 0
        self.spec_accepted = 0

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def _check_streams(self, out, streams: Dict[str, np.ndarray],
                       what: str) -> None:
        """Control and forced streams {mod: [B, T, len]} must fit the scene
        batch and the modality's row; refused by name otherwise."""
        for m, v in streams.items():
            B, row = out[m].shape[0], out[m].shape[2]
            if v.ndim != 3 or v.shape[0] != B or v.shape[2] != row:
                raise ValueError(f"{what}[{m!r}] has shape {v.shape}; the "
                                 f"scenes need [{B}, frames, {row}]")

    def generate(self, cond_tokens: Dict[str, np.ndarray], new_frames: int,
                 cond_frames: int = 20, input_cond_frames: int = -1,
                 init_tokens: Optional[Dict[str, np.ndarray]] = None,
                 control_test: bool = False,
                 forced_streams: Optional[Dict[str, np.ndarray]] = None
                 ) -> Dict[str, np.ndarray]:
        """cond_tokens {mod: [B, T0, len]} → {mod: [B, input_cond_frames +
        new_frames, len]} numpy (the conditioning prefix + generated
        frames).  `cond_frames`: recompute mode's window; the cached path's
        is the ring's.

        init_tokens {pose: [B, T_c, 3], bbox3d: [B, T_c, 660]}: trajectory
        replay for generated frames idx < T_c (other modalities are
        dropped, and without a pose stream the whole dict); once the pose
        stream runs out control is off for the rest of the rollout.
        forced_streams {mod: [B, T_f, len]}: frames idx < T_f take these
        tokens for the listed modalities instead of sampling them.
        Under a mesh every argument holds the whole batch, each rank rolls
        its rows, and every rank returns the whole batch."""
        cfg = self.model.config
        mods = self.model.layout.mod_order
        recompute = cfg.tar_mode == "recompute"
        if forced_streams and "pose" in forced_streams:
            init_tokens = dict(init_tokens or {})
            init_tokens.setdefault("pose", forced_streams["pose"])
        init = None
        if init_tokens is not None:
            init = {m: np.asarray(v) for m, v in init_tokens.items()
                    if v is not None and m in ("pose", "bbox3d")}
            if "pose" not in init:
                init = None
        forced = {m: np.asarray(v) for m, v in (forced_streams or {}).items()
                  if m in mods and m != "pose"}
        if input_cond_frames == -1:
            input_cond_frames = cond_frames if recompute else cfg.cond_frame
        out = {m: np.asarray(cond_tokens[m][:, :input_cond_frames])
               for m in mods}
        self._check_streams(out, init or {}, "init_tokens")
        self._check_streams(out, forced, "forced_streams")
        if self.mesh is not None:         # this rank's scenes
            out, forced = (self._shard(d) for d in (out, forced))
            init = None if init is None else self._shard(init)
        # the window the model reads: `out` with the agent-control
        # overwrites of each newest frame, which persist as it slides
        cond = dict(out)
        window = cond_frames if recompute else self.model.t_max
        refresh = cfg.tar_cache_refresh
        sl = self.model.layout.slices()
        cache = None
        for idx in range(new_frames):
            t0 = time.perf_counter()
            if recompute or idx:    # the cached prefill takes all of it
                cond = {m: v[:, -window:] for m, v in cond.items()}
            step_kw = {}       # the overrides this frame has
            if init is not None and idx < init["pose"].shape[1]:
                step_kw["pose_override"] = self._dev(init["pose"][:, idx])
                if control_test and "bbox3d" in init \
                        and idx < init["bbox3d"].shape[1]:
                    cb = init["bbox3d"][:, idx]
                    step_kw["control_bbox"] = self._dev(cb)
                    b3 = cond["bbox3d"].copy()
                    b3[:, -1] = np.where(cb != -1, cb, b3[:, -1])
                    cond["bbox3d"] = b3
            elif init is not None:
                init = None           # the pose stream ran out: control off
            fd = {m: self._dev(v[:, idx]) for m, v in forced.items()
                  if idx < v.shape[1]}
            if fd:
                step_kw["forced_tokens"] = fd
            last = {m: self._dev(v) for m, v in cond.items()}
            if recompute:
                res = self.rollout.frame_step(self.params, last,
                                              self.generator, **step_kw)
            elif idx == 0:
                first = self.rollout.frame_step_prefill
                if cfg.chunked_prefill and last["pose"].shape[1] > 1:
                    first = self.rollout.frame_step_chunked
                res, cache = first(self.params, last, self.generator,
                                   **step_kw)
            elif (refresh and idx % refresh == 0 and window > 1
                  and out["pose"].shape[1] > window):
                # fresh rings (frames counted from 0, so window-relative
                # PEs) from the window's frames, each with the next one's
                # pose, then the cached step on the newest: the old rings
                # go first, as the reference frees them
                cache = None
                res, cache = self.rollout.frame_step_chunked(
                    self.params, last, self.generator, **step_kw)
                self.refreshes += 1
            else:
                res, cache = self.rollout.frame_step_cached(
                    self.params, {m: v[:, -1:] for m, v in last.items()},
                    cache, self.generator, **step_kw)
            tokens = res.tokens.cpu().numpy()
            spec = (res.spec_chunks, res.spec_accepted)
            if self.mesh is not None and cfg.speculative_k > 0:
                spec = self.mesh.all_sum(torch.tensor(spec)).tolist()
            self.spec_chunks += spec[0]
            self.spec_accepted += spec[1]
            if not (torch.isfinite(res.prior_seq).all()
                    and (res.ego_logits is None
                         or torch.isfinite(res.ego_logits).all())):
                raise FloatingPointError(
                    f"frame {idx}: non-finite ego logits or TAR priors")
            self.frame_seconds.append(time.perf_counter() - t0)
            for m in mods:
                new = tokens[:, None, sl[m]]
                # a replayed modality enters the stream as given: the pose
                # in both modes; recompute also appends an init bbox3d
                # without control_test (the reference's two loops differ)
                if init is not None and m in init and (m == "pose" or (
                        recompute and not (control_test
                                           and m == "bbox3d"))):
                    new = init[m][:, idx][:, None]
                out[m] = np.concatenate([out[m], new], axis=1)
                cond[m] = np.concatenate([cond[m], new], axis=1)
        if self.mesh is not None:
            out = {m: self.mesh.gather_rows(v) for m, v in out.items()}
        return out

    def _shard(self, streams: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {m: self.mesh.shard(v) for m, v in streams.items()}
