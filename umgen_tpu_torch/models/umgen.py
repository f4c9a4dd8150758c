"""The UMGen-class world model, cached path (port of umgen_tpu/models/umgen.py).

Embeddings, the TAR cascade (trunk, map and box stacks) and the ego network
against per-layer temporal KV rings: `prefill_ego_cache` /
`prefill_tar_caches` ingest the conditioning window and create the rings,
`ego_logits_cached` / `tar_priors_cached` push one new frame through every
stack against them.  Rings are bf16 [L, B·S, T_max, H, Dh] pairs; a new
frame's K/V is written into its ring slot in place, layer by layer (the
JAX package scatters all layers at once after its layer scan — the slot
being written is masked out of the frame's own temporal attention, so the
two orders agree).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from umgen_tpu.config import BOS_EOS, MAP_HW, TASKS, ModelConfig
from umgen_tpu.data.pipeline import ScenePipeline
from umgen_tpu.layout import SequenceLayout
from umgen_tpu_torch.models import modules as nn
from umgen_tpu_torch.ops.warp import affine_warp_map
from umgen_tpu_torch.params import torch_dtype

Params = Dict[str, Any]


class NotPortedError(NotImplementedError):
    """A configuration the port does not serve yet; names the ROADMAP
    item that adds it."""


def build_buffers(config: ModelConfig,
                  pipeline: Optional[ScenePipeline] = None,
                  map_codebook: Optional[np.ndarray] = None,
                  img_codebook: Optional[np.ndarray] = None,
                  rng: Optional[np.random.Generator] = None,
                  device=None) -> Params:
    """Frozen tables: sinusoidal PEs (rounded through bf16 as the
    reference's checkpoint tables are), VQ codebooks (seeded random when
    none are given) and the pose / bbox decode constants."""
    d = config.n_embd
    rng = rng or np.random.default_rng(0)
    pipeline = pipeline or ScenePipeline()
    fouier = nn.bf16_round(nn.position_encoding_init(1024, d))
    spatial = nn.bf16_round(nn.position_encoding_init(1030, d,
                                                      start_index=1024))
    # grid-center PE: 32x32 cell centers at 4 m/cell, negated, normalized
    # to [0, 1] and digitized into the 1024-bin spatial table
    gh, gw = MAP_HW
    cell = 128.0 / gh
    gi, gj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    cx = -((gi + 0.5) * cell - 64.0)
    cy = -((gj + 0.5) * cell - 64.0)
    norm = (np.stack([cx, cy], axis=-1) + 64.0) / 128.0
    tok = np.digitize(norm, np.linspace(0.0, 1.0, 1024))
    grid_pe = spatial[tok[..., 0].reshape(-1)] + spatial[tok[..., 1].reshape(-1)]
    if map_codebook is None:
        map_codebook = rng.normal(0, 1, (config.map_vocab_size,
                                         config.n_map_embd))
    if img_codebook is None:
        img_codebook = rng.normal(0, 1, (config.img_vocab_size,
                                         config.n_img_embd))
    consts = pipeline.device_constants()
    dt = torch_dtype(config.dtype)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, np.float32), dtype=torch.float32,
                               device=device).to(dtype)

    return {
        "fouier_pe": t(fouier, dt),
        "bbox_spatial_pe": t(spatial, dt),
        "grid_center_pe": t(grid_pe, dt),
        "map_codebook": t(map_codebook, dt),
        "img_codebook": t(img_codebook, dt),
        "ego_bin_mid": t(consts["ego_bin_midpoints"], torch.float32),
        "ego_mean": t(consts["ego_mean"], torch.float32),
        "ego_std": t(consts["ego_std"], torch.float32),
        "agent_bin_mid": t(consts["agent_bin_midpoints"], torch.float32),
        "agent_lo": t(consts["agent_lo"], torch.float32),
        "agent_span": t(consts["agent_span"], torch.float32),
    }


def check_served(cfg: ModelConfig) -> None:
    """Raise NotPortedError for configuration values outside the port."""
    if cfg.tar_mode != "temporal_cache":
        raise NotPortedError("tar_mode=recompute is not ported yet "
                             "(ROADMAP.md: 'Recompute mode')")
    if cfg.tar_cache_dtype != "bfloat16":
        raise NotPortedError(
            f"TAR ring dtype {cfg.tar_cache_dtype!r} is not ported yet; the "
            "port serves bfloat16 rings (ROADMAP.md: 'fp8 / int4 / int2 TAR "
            "rings')")
    if cfg.temporal_pe_mode != "absolute":
        raise NotPortedError("temporal_pe_mode=relative is not ported yet "
                             "(ROADMAP.md: 'Relative temporal PE')")
    if cfg.speculative_k > 0:
        raise NotPortedError("speculative decoding is not ported yet "
                             "(ROADMAP.md: 'Speculative decoding')")
    if cfg.chunked_prefill or cfg.tar_cache_refresh > 0:
        raise NotPortedError("chunked prefill and ring refresh are not "
                             "ported yet (ROADMAP.md: 'Chunked prefill and "
                             "ring refresh')")
    if cfg.n_step != 1 or cfg.bias:
        raise NotPortedError("the port serves the published heads "
                             "(n_step=1, bias=False)")


class UMGen:
    """Stateless model wrapper: config + layout + apply functions."""

    def __init__(self, config: ModelConfig,
                 attn_impl: Optional[Callable] = None):
        check_served(config)
        self.config = config
        self.layout = SequenceLayout(config.task)
        if attn_impl is None and config.use_pallas_attention:
            from umgen_tpu_torch.ops.attention import attn_impl as dispatch
            attn_impl = dispatch
        self.attn = attn_impl or nn.sdpa

    # ------------------------------------------------------------------
    # embeddings
    # ------------------------------------------------------------------
    def embed_pose(self, params, tokens):
        return params["buffers"]["fouier_pe"][tokens]

    def embed_map(self, params, tokens, grid_pe: bool):
        feats = nn.mlp(params["map_mlp_pre"],
                       params["buffers"]["map_codebook"][tokens])
        if grid_pe:
            feats = feats + params["buffers"]["grid_center_pe"]
        return feats

    def embed_image(self, params, tokens):
        return nn.mlp(params["img_mlp_pre"],
                      params["buffers"]["img_codebook"][tokens])

    def embed_bbox(self, params, tokens, spatial_pe: bool):
        """tokens [..., 660]; the spatial PE adds per-object x/y table
        entries broadcast over the 11 attribute tokens."""
        feats = params["be"][tokens]
        if spatial_pe:
            shape = tokens.shape[:-1]
            boxes = tokens.reshape(*shape, self.config.pad_to_length, 11)
            pe_tab = params["buffers"]["bbox_spatial_pe"]
            pe = pe_tab[boxes[..., 0]] + pe_tab[boxes[..., 1]]
            pe = pe[..., None, :].expand(*pe.shape[:-1], 11, pe.shape[-1])
            feats = feats + pe.reshape(*shape, -1, feats.shape[-1])
        return feats

    def add_bos_eos(self, params, feats, mod):
        """Wrap [B, T, S, D] content with the modality's BOS/EOS."""
        bos, eos = BOS_EOS[mod]
        B, T, _, D = feats.shape
        axe = params["axe"]
        return torch.cat([axe[bos].expand(B, T, 1, D), feats,
                          axe[eos].expand(B, T, 1, D)], dim=2)

    def add_pos_emb(self, params, x, t_offset: int = 0):
        """+ sequence PE + absolute temporal PE; the temporal index
        saturates at config.tpe_clamp (default max_frame_len - 1)."""
        B, T, S, D = x.shape
        clamp = self.config.tpe_clamp
        if clamp is None:
            clamp = self.config.max_frame_len - 1
        idx = torch.clamp(torch.arange(T, device=x.device) + t_offset,
                          max=clamp)
        return x + params["spe"][:S][None, None] \
            + params["tpe"][idx][None, :, None, :]

    def decode_pose(self, params, pose_tokens):
        """pose tokens [..., 3] → metric (dx, dy, dθ) float32."""
        b = params["buffers"]
        mids = b["ego_bin_mid"][torch.clamp(pose_tokens, 0, 1023)]
        return mids * b["ego_std"] + b["ego_mean"]

    def _tar_input(self, params, inputs, mods, *, map_grid_pe: bool,
                   pose_diff, t_offset: int = 0, warp: bool = True):
        """Embed + warp + wrap + concat a TAR input sequence → (emb [B, T,
        sum(seg_len), D], warped content-only map embedding or None)."""
        segs = []
        map_warped = None
        for mod in mods:
            if mod == "pose":
                feats = self.embed_pose(params, inputs["pose"])
            elif mod == "map":
                feats = self.embed_map(params, inputs["map"],
                                       grid_pe=map_grid_pe)
                if self.config.map_transform and warp:
                    map_warped = affine_warp_map(feats, pose_diff)
                    feats = map_warped + feats
            elif mod == "bbox3d":
                feats = self.embed_bbox(params, inputs["bbox3d"],
                                        spatial_pe=self.config.add_posi_embedd)
            elif mod == "image":
                feats = self.embed_image(params, inputs["image"])
            else:
                raise ValueError(mod)
            segs.append(self.add_bos_eos(params, feats, mod))
        emb = torch.cat(segs, dim=2)
        return self.add_pos_emb(params, emb, t_offset=t_offset), map_warped

    # ------------------------------------------------------------------
    # ego network
    # ------------------------------------------------------------------
    def _ego_queries(self, params, ctx, B, T, t_offset) -> torch.Tensor:
        """3 learned ego queries cross-attend each frame's scene embedding.
        ctx [B·T, S, D] → [B, T, 3, D]."""
        cfg = self.config
        D = ctx.shape[-1]
        ego = params["egoe"][None, None].expand(B, T, 3, D)
        q = self.add_pos_emb(params, ego, t_offset=t_offset).reshape(
            B * T, 3, D)
        stack = params["ego_ca"]
        for l in range(nn.n_layers(stack)):
            q = nn.decoder_block(nn.layer(stack, l), q, ctx, cfg.n_head)
        return nn.layer_norm(params["ln_ego"], q).reshape(B, T, 3, D)

    # ------------------------------------------------------------------
    # temporal-cache path
    # ------------------------------------------------------------------
    def _stack_names(self):
        cfg, lo = self.config, self.layout
        names = [("tar", "ln_tar", lo.seq_len),
                 ("ego_tar", "ln_ego_tar", lo.seq_len)]
        if cfg.split_map_tar and "map" in lo.mod_order:
            names.append(("map_tar", "ln_map_tar", 5 + 1026))
        if cfg.split_box_tar and "bbox3d" in lo.mod_order:
            names.append(("box_tar", "ln_box_tar", 5 + 1026 + 662))
        return names

    @property
    def t_max(self) -> int:
        """TAR ring length (tar_cache_window, default cond_frame)."""
        return self.config.tar_cache_window or self.config.cond_frame

    def init_tar_cache(self, B: int, device=None) -> Dict[str, Any]:
        cfg = self.config
        counts = {"tar": cfg.n_tar_layer, "ego_tar": cfg.n_ego_tar_layer,
                  "map_tar": cfg.n_map_tar_layer,
                  "box_tar": cfg.n_box_tar_layer}
        dt = torch_dtype(cfg.tar_cache_dtype)
        cache: Dict[str, Any] = {"frames": 0}
        for name, _, S in self._stack_names():
            shape = (counts[name], B * S, self.t_max, cfg.n_head,
                     cfg.head_dim)
            cache[name] = (torch.zeros(shape, dtype=dt, device=device),
                           torch.zeros(shape, dtype=dt, device=device))
        return cache

    def _run_tar_stack_prefill(self, params, stack_name, ln_name, emb,
                               T_max):
        """Full-window pass that also creates the stack's rings: emb [B, T,
        S, D] → (ln(out) [B, T, S, D], (ring_k, ring_v) [L, B·S, T_max, H,
        Dh]).  With T > T_max only the last T_max frames are kept, each at
        its absolute ring slot."""
        cfg = self.config
        B, T, S, _ = emb.shape
        keep = min(T, T_max)
        slots = torch.as_tensor(np.arange(T - keep, T) % T_max,
                                device=emb.device)
        stack = params[stack_name]
        L = nn.n_layers(stack)
        dt = torch_dtype(cfg.tar_cache_dtype)
        shape = (L, B * S, T_max, cfg.n_head, cfg.head_dim)
        ring_k = torch.zeros(shape, dtype=dt, device=emb.device)
        ring_v = torch.zeros(shape, dtype=dt, device=emb.device)
        h = emb
        for l in range(L):
            h, (k, v) = nn.block_tar_collect_kv(nn.layer(stack, l), h,
                                                cfg.n_head,
                                                attn_impl=self.attn)
            ring_k[l][:, slots] = k[:, -keep:].to(dt)
            ring_v[l][:, slots] = v[:, -keep:].to(dt)
        return nn.layer_norm(params[ln_name], h), (ring_k, ring_v)

    def _run_tar_stack_cached(self, params, stack_name, ln_name, x, kv,
                              slot: int, n_valid: int):
        """x [B, S, D] new frame → (ln(out) [B, S, D], kv) with the frame's
        K/V written into ring slot `slot` in place."""
        cfg = self.config
        ring_k, ring_v = kv
        stack = params[stack_name]
        h = x
        for l in range(nn.n_layers(stack)):
            h, k_new, v_new = nn.block_tar_decode_deferred(
                nn.layer(stack, l), h, cfg.n_head, ring_k[l], ring_v[l],
                slot, n_valid, attn_impl=self.attn)
            ring_k[l][:, slot] = k_new.to(ring_k.dtype)
            ring_v[l][:, slot] = v_new.to(ring_v.dtype)
        return nn.layer_norm(params[ln_name], h), kv

    def _priors(self, params, frame_emb, run_stack):
        """Shared tail of the two TAR cascades: trunk, then the map and box
        refinement stacks overriding their segments, then the warped-map
        residual on the map content positions → prior_seq [B, 2207, D].

        frame_emb(mods, grid_pe) → (emb, warped map of the prior frame);
        run_stack(stack_name, ln_name, emb) → per-frame output [B, S, D]."""
        cfg, lo = self.config, self.layout
        emb, _ = frame_emb(lo.mod_order, cfg.add_spatial_pos_embedd_on_map)
        trunk = run_stack("tar", "ln_tar", emb)
        seg_lens = [s.end - s.start + 1 for s in lo.segments]
        offs = np.cumsum([0] + seg_lens)
        tar_emb = {s.mod: trunk[:, int(offs[i]):int(offs[i + 1])]
                   for i, s in enumerate(lo.segments)}
        warped_prior = None
        if cfg.split_map_tar and "map" in lo.mod_order:
            emb_m, warped_prior = frame_emb(TASKS["pose_map"], False)
            tar_emb["map"] = run_stack("map_tar", "ln_map_tar", emb_m)[:, 5:]
        if cfg.split_box_tar and "bbox3d" in lo.mod_order:
            emb_b, warped_b = frame_emb(TASKS["pose_map_bbox3d"], False)
            out_b = run_stack("box_tar", "ln_box_tar", emb_b)
            tar_emb["bbox3d"] = out_b[:, 5 + 1026:]
            if not cfg.split_map_tar:
                tar_emb["map"] = out_b[:, 5:5 + 1026]
                warped_prior = warped_b
        if cfg.map_transform and "map" in lo.mod_order \
                and warped_prior is not None:
            m = tar_emb["map"]
            tar_emb["map"] = torch.cat(
                [m[:, :1], m[:, 1:-1] + warped_prior, m[:, -1:]], dim=1)
        return torch.cat([tar_emb[s.mod] for s in lo.segments], dim=1)

    def prefill_ego_cache(self, params, inputs, cache):
        """Ingest the raw window {mod: [B, T, len]} into the ego rings →
        (last-frame ego logits [B, 3, 1024], cache)."""
        emb, _ = self._tar_input(params, inputs, self.layout.mod_order,
                                 map_grid_pe=False, pose_diff=None,
                                 warp=False, t_offset=0)
        cache = dict(cache)
        out, cache["ego_tar"] = self._run_tar_stack_prefill(
            params, "ego_tar", "ln_ego_tar", emb, self.t_max)
        B, T = out.shape[:2]
        q = self._ego_queries(params, out[:, -1], B, 1, t_offset=T - 1)
        return nn.linear(params["head_ego"], q[:, 0]), cache

    def ego_logits_cached(self, params, frame_inputs, cache, abs_frame: int):
        """One new raw frame {mod: [B, 1, len]} (pose = motion into it)
        through the ego rings → (logits [B, 3, 1024], cache)."""
        slot = abs_frame % self.t_max
        n_valid = min(abs_frame + 1, self.t_max)
        emb, _ = self._tar_input(params, frame_inputs, self.layout.mod_order,
                                 map_grid_pe=False, pose_diff=None,
                                 warp=False, t_offset=abs_frame)
        cache = dict(cache)
        ctx, cache["ego_tar"] = self._run_tar_stack_cached(
            params, "ego_tar", "ln_ego_tar", emb[:, 0], cache["ego_tar"],
            slot, n_valid)
        q = self._ego_queries(params, ctx, ctx.shape[0], 1,
                              t_offset=abs_frame)
        return nn.linear(params["head_ego"], q[:, 0]), cache

    def prefill_tar_caches(self, params, shifted_inputs, cache):
        """Ingest the shifted window into the trunk/map/box rings →
        {"prior_seq" [B, 2207, D], "pose_diff", "cache"} for its last
        frame."""
        pose_diff = self.decode_pose(params, shifted_inputs["pose"])
        cache = dict(cache)

        def frame_emb(mods, grid_pe):
            emb, warped = self._tar_input(params, shifted_inputs, mods,
                                          map_grid_pe=grid_pe,
                                          pose_diff=pose_diff, t_offset=0)
            return emb, (warped[:, -1] if warped is not None else None)

        def run_stack(name, ln, emb):
            out, cache[name] = self._run_tar_stack_prefill(
                params, name, ln, emb, self.t_max)
            return out[:, -1]

        prior = self._priors(params, frame_emb, run_stack)
        return {"prior_seq": prior, "pose_diff": pose_diff, "cache": cache}

    def tar_priors_cached(self, params, frame_inputs, cache, abs_frame: int):
        """One-frame TAR cascade against the rings.  frame_inputs {mod:
        [B, 1, len]} with the pose slot holding the CURRENT action; →
        {"prior_seq", "pose_diff", "cache"}."""
        slot = abs_frame % self.t_max
        n_valid = min(abs_frame + 1, self.t_max)
        pose_diff = self.decode_pose(params, frame_inputs["pose"])
        cache = dict(cache)

        def frame_emb(mods, grid_pe):
            emb, warped = self._tar_input(params, frame_inputs, mods,
                                          map_grid_pe=grid_pe,
                                          pose_diff=pose_diff,
                                          t_offset=abs_frame)
            return emb[:, 0], (warped[:, 0] if warped is not None else None)

        def run_stack(name, ln, emb):
            out, cache[name] = self._run_tar_stack_cached(
                params, name, ln, emb, cache[name], slot, n_valid)
            return out

        prior = self._priors(params, frame_emb, run_stack)
        return {"prior_seq": prior, "pose_diff": pose_diff, "cache": cache}
