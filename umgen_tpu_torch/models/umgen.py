"""The UMGen-class world model (port of umgen_tpu/models/umgen.py).

Embeddings, the TAR cascade (trunk, map and box stacks) and the ego network,
in the reference's two modes:

  * recompute (`tar_mode="recompute"`, the reference's own semantics):
    `ego_logits` / `tar_priors` run the whole conditioning window through
    every stack each frame and read its last frame;
  * temporal cache: against per-layer temporal KV rings.
    `prefill_ego_cache` / `prefill_tar_caches` ingest the window (the same
    full-window pass) and create the rings, `ego_logits_cached` /
    `tar_priors_cached` push one new frame through every stack against
    them.  Rings are bf16, float8_e4m3fn or float32 [L, B·S, T_max, H,
    Dh] pairs (fp8 written through `modules.saturate_cast`), int4
    (`tar_cache_dtype="int4"`): nibble-packed int8 [L, B·S, T_max, H,
    Dh/2] pairs plus float32 [L, B, T_max, H] dequantization scales, one
    per (layer, scene, frame, head), or int2 (`"int2"`): 2-bit-packed
    [L, B·S, T_max, H, Dh/4] pairs, those scales, and float32 [L, B, H, Dh]
    channel equalizers frozen at the full-window prefill (ones after a
    chunked one).  A new frame's K/V is written into its
    ring slot in place, layer by layer (the JAX package scatters all layers
    at once after its layer scan — the slot being written is masked out of
    the frame's own temporal attention, so the two orders agree).

The trainer's teacher-forced pass (parallel/train.py) keeps every frame of
the window: `forward_ego_net` runs the ego queries of all T frames,
`tar_cascade` returns every frame's TAR embeddings, and `oar_forward` is the
OAR's full causal pass over one frame; with config.remat each block is
recomputed in the backward pass (`modules.apply_stack`).

The temporal PE is absolute (a learned [max_frame_len, D] table added to
the embeddings) or, with `temporal_pe_mode="relative"`, a per-head bias
`tpe_rel` [H, max_frame_len] on the temporal attention's logits by query-key
frame distance (`_t_bias_window`, `_t_bias_ring`); the embeddings and the
rings then carry no temporal position.

Tensor parallelism (`on_mesh`, the JAX package's GSPMD program at tp > 1):
the model of one rank of a (dp, tp) mesh runs every stack on the rank's
n_head / tp heads and hidden columns (models/modules.py), its rings hold
those heads ([L, B·S, T_max, H / tp, Dh], JAX's `_ring_spec`), and each
head's vocab-parallel logits are gathered over the group (`head`) before
the sampler and the loss.  The params are the rank's blocks
(parallel.mesh.Mesh.shard_params).

The remaining configuration: `n_step` > 1 widens the bbox TAR head to
n_step vocab slices side by side ("head_tar_n_step_bbox3d"), of which the
rollout and the trainer read step 0 (`tar_bbox_logits`); `bias=True`
drops the attention projections' biases and gives the MLPs theirs.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from umgen_tpu_torch.config import BOS_EOS, MAP_HW, TASKS, ModelConfig
from umgen_tpu_torch.data.pipeline import ScenePipeline
from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.models import modules as nn
from umgen_tpu_torch.ops.warp import affine_warp_map
from umgen_tpu_torch.params import torch_dtype
from umgen_tpu_torch.runtime.profiler import span

Params = Dict[str, Any]


RING_DTYPES = ("float8_e4m3fn", "bfloat16", "float32", "int4", "int2")


class NotPortedError(NotImplementedError):
    """A configuration the port does not serve; names the ROADMAP item or
    decision behind it."""


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
    """Raise ValueError for configuration values outside the model."""
    if cfg.tar_mode not in ("temporal_cache", "recompute"):
        raise ValueError(f"unknown tar_mode {cfg.tar_mode!r}")
    if cfg.tar_cache_dtype not in RING_DTYPES:
        raise ValueError(f"unknown TAR ring dtype {cfg.tar_cache_dtype!r}: "
                         f"{', '.join(RING_DTYPES)}")
    if cfg.temporal_pe_mode not in ("absolute", "relative"):
        raise ValueError(f"unknown temporal_pe_mode "
                         f"{cfg.temporal_pe_mode!r}")
    if cfg.n_step < 1:
        raise ValueError(f"n_step {cfg.n_step}: at least 1")


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
        self.mesh = None

    # ------------------------------------------------------------------
    # tensor parallelism
    # ------------------------------------------------------------------
    def on_mesh(self, mesh) -> "UMGen":
        """This model for one rank of a GSPMD-mode run over `mesh` (a
        parallel.mesh.Mesh): under tp > 1 its stacks run on the rank's
        heads; the params must be the rank's blocks.  tp must divide
        n_head (every head's vocab is checked by the sharding)."""
        if mesh is not None and self.config.n_head % mesh.tp:
            raise ValueError(f"tp={mesh.tp} does not divide n_head "
                             f"{self.config.n_head}")
        m = copy.copy(self)
        m.mesh = mesh
        return m

    @property
    def tp(self):
        """The mesh under tensor parallelism (tp > 1), else None."""
        return self.mesh if self.mesh is not None and self.mesh.tp > 1 \
            else None

    @property
    def heads(self) -> int:
        """The attention heads this rank runs in a TAR-family stack."""
        return self.config.n_head // (self.tp.tp if self.tp else 1)

    def head(self, params, name: str, x, cols: Optional[int] = None):
        """Logits of the head `name` on x, the whole vocab: under tp the
        rank's vocab block gathered over the group.  `cols`: only the first
        cols (the n-step head's step 0)."""
        p = params[name]
        if self.tp is None:
            return nn.linear(p if cols is None else
                             nn.slice_linear_out(p, cols), x)
        y = self.tp.gather(nn.linear(p, self.tp.copy(x)))
        return y if cols is None else y[..., :cols]

    def tar_bbox_logits(self, params, x):
        """The bbox TAR head's logits [..., V] (the n-step head's step-0
        vocab slice)."""
        if self.config.n_step > 1:
            return self.head(params, "head_tar_n_step_bbox3d", x,
                             cols=self.config.bbox3d_vocab_size)
        return self.head(params, "head_tar_bbox3d", x)

    # ------------------------------------------------------------------
    # embeddings
    # ------------------------------------------------------------------
    def embed_pose(self, params, tokens):
        return params["buffers"]["fouier_pe"][tokens]

    def embed_map(self, params, tokens, grid_pe: bool):
        feats = nn.mlp(params["map_mlp_pre"],
                       params["buffers"]["map_codebook"][tokens], self.tp)
        if grid_pe:
            feats = feats + params["buffers"]["grid_center_pe"]
        return feats

    def embed_image(self, params, tokens):
        return nn.mlp(params["img_mlp_pre"],
                      params["buffers"]["img_codebook"][tokens], self.tp)

    def embed_bbox(self, params, tokens, spatial_pe: bool):
        """tokens [..., 660]; the spatial PE adds per-object x/y table
        entries broadcast over the 11 attribute tokens."""
        feats = nn.lookup(params["be"], tokens)
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
        saturates at config.tpe_clamp (default max_frame_len - 1).  In
        relative mode the sequence PE only: the temporal position enters at
        the temporal attention's logits."""
        B, T, S, D = x.shape
        spe = params["spe"][:S][None, None]
        if self.config.temporal_pe_mode == "relative":
            return x + spe
        idx = torch.clamp(torch.arange(T, device=x.device) + t_offset,
                          max=self._rel_clamp())
        return x + spe + nn.lookup(params["tpe"], idx)[None, :, None, :]

    # relative temporal PE (temporal_pe_mode="relative")
    def _rel_clamp(self) -> int:
        c = self.config.tpe_clamp
        return self.config.max_frame_len - 1 if c is None else c

    def _t_bias_window(self, params, T: int):
        """[H, T, T] logit bias of a full-window temporal attention,
        bias[h, t, s] = tpe_rel[h, t - s] (the distance clamped to the
        trained range), or None in absolute mode."""
        if self.config.temporal_pe_mode != "relative":
            return None
        t = torch.arange(T, device=params["tpe_rel"].device)
        rel = torch.clamp(t[:, None] - t[None, :], 0, self._rel_clamp())
        return nn.lookup(params["tpe_rel"].t(), rel).permute(2, 0, 1)

    def _t_bias_ring(self, params, slot: int, T_max: int):
        """([H, T_max] bias of each ring slot, [H] the self term's) for the
        one-frame path: slot j holds the frame (slot - j) % T_max frames
        ago, the new frame is the self term at distance 0.  (None, None) in
        absolute mode."""
        if self.config.temporal_pe_mode != "relative":
            return None, None
        tpe_rel = params["tpe_rel"]
        ages = torch.remainder(
            slot - torch.arange(T_max, device=tpe_rel.device), T_max)
        ages = torch.clamp(ages, max=self._rel_clamp())
        return tpe_rel[:, ages], tpe_rel[:, 0]

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
        q = nn.apply_stack(
            params["ego_ca"], q,
            lambda p, h: nn.decoder_block(p, h, ctx, self.heads, self.tp),
            remat=cfg.remat)
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

    @property
    def ring_q4(self) -> bool:
        """int4 rings: nibble-packed int8 + per-(L, B, T, H) scales."""
        return self.config.tar_cache_dtype == "int4"

    @property
    def ring_q2(self) -> bool:
        """int2 rings: 2-bit-packed int8 + per-(L, B, T, H) scales + per-(L,
        B, H, Dh) channel equalizers frozen at the prefill."""
        return self.config.tar_cache_dtype == "int2"

    def _ring_zeros(self, L: int, N: int, B: int, device) -> tuple:
        """Empty rings of one stack: (k, v) of the ring type, int4 (k, v,
        scale_k, scale_v), or int2 (k, v, scale_k, scale_v, chan_k, chan_v)
        with the equalizers at ones."""
        cfg = self.config
        per_byte = 4 if self.ring_q2 else 2 if self.ring_q4 else 1
        if cfg.head_dim % per_byte:
            raise ValueError(
                f"tar_cache_dtype={cfg.tar_cache_dtype!r} packs {per_byte} "
                f"head dims a byte: head_dim {cfg.head_dim} must be "
                + ("even" if per_byte == 2 else "a multiple of 4"))
        shape = (L, N, self.t_max, self.heads, cfg.head_dim)
        if per_byte == 1:
            dt = torch_dtype(cfg.tar_cache_dtype)
            return (torch.zeros(shape, dtype=dt, device=device),
                    torch.zeros(shape, dtype=dt, device=device))
        packed = shape[:-1] + (cfg.head_dim // per_byte,)
        sshape = (L, B, self.t_max, self.heads)
        rings = (torch.zeros(packed, dtype=torch.int8, device=device),
                 torch.zeros(packed, dtype=torch.int8, device=device),
                 torch.zeros(sshape, dtype=torch.float32, device=device),
                 torch.zeros(sshape, dtype=torch.float32, device=device))
        if self.ring_q2:
            cshape = (L, B, self.heads, cfg.head_dim)
            rings += (torch.ones(cshape, dtype=torch.float32, device=device),
                      torch.ones(cshape, dtype=torch.float32, device=device))
        return rings

    def init_tar_cache(self, B: int, device=None) -> Dict[str, Any]:
        cfg = self.config
        counts = {"tar": cfg.n_tar_layer, "ego_tar": cfg.n_ego_tar_layer,
                  "map_tar": cfg.n_map_tar_layer,
                  "box_tar": cfg.n_box_tar_layer}
        cache: Dict[str, Any] = {"frames": 0}
        for name, _, S in self._stack_names():
            cache[name] = self._ring_zeros(counts[name], B * S, B, device)
        return cache

    @staticmethod
    def _ring_q4_quantize(x: torch.Tensor, B: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [L, N, H, Dh] new K or V rows (N = B·S) → (packed [L, N, H,
        Dh/2] int8, dequantization scales [L, B, H] f32): amax over the
        frame's positions and head dims per (layer, scene, head), / 7."""
        L, N, H, Dh = x.shape
        xf = x.float().reshape(L, B, N // B, H, Dh)
        s = torch.clamp(xf.abs().amax(dim=(2, 4)), min=1e-6) * (1.0 / 7.0)
        q = torch.clamp(torch.round(xf / s[:, :, None, :, None]), -7, 7)
        return nn.q4_pack(q.to(torch.int8).reshape(L, N, H, Dh)), s

    @staticmethod
    def _ring_q4_quantize_layer(x: torch.Tensor, B: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One layer of `_ring_q4_quantize`: x [N, H, Dh] → (packed [N, H,
        Dh/2] int8, scales [B, H] f32)."""
        packed, s = UMGen._ring_q4_quantize(x[None], B)
        return packed[0], s[0]

    @staticmethod
    def _ring_q2_quantize_layer(x: torch.Tensor, B: int, chan: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, H, Dh] one new frame's K or V rows, chan [B, H, Dh] the
        stack layer's frozen equalizer → (packed [N, H, Dh/4] int8, scales
        [B, H] f32).  Levels {-1.5, -0.5, 0.5, 1.5}·s·chan: q = clip(round(
        x/(chan·s) - 0.5), -2, 1); s is the frame's amax per (scene, head)
        over the equalized values, / 1.5."""
        N, H, Dh = x.shape
        xf = x.float().reshape(B, N // B, H, Dh) / chan[:, None]
        s = torch.clamp(xf.abs().amax(dim=(1, 3)), min=1e-6) * (1 / 1.5)
        q = torch.clamp(torch.round(xf / s[:, None, :, None] - 0.5), -2, 1)
        return nn.q2_pack(q.to(torch.int8).reshape(N, H, Dh)), s

    @staticmethod
    def _ring_q2_quantize_window(a: torch.Tensor, B: int, keep: int):
        """A full-window prefill's K or V a [N, T, H, Dh] → (packed [N,
        keep, H, Dh/4] int8 and scales [B, keep, H] of its last `keep`
        frames, the equalizer [B, H, Dh]: each channel's amax over the
        whole window, frozen for the cached frames that follow)."""
        N, T, H, Dh = a.shape
        af = a.float().reshape(B, N // B, T, H, Dh)
        c = torch.clamp(af.abs().amax(dim=(1, 2)), min=1e-6)
        ae = af / c[:, None, None]
        s = torch.clamp(ae.abs().amax(dim=(1, 4)), min=1e-6) * (1.0 / 1.5)
        q = torch.clamp(torch.round(ae / s[:, None, :, :, None] - 0.5), -2, 1)
        packed = nn.q2_pack(q.to(torch.int8).reshape(N, T, H, Dh))
        return packed[:, -keep:], s[:, -keep:], c

    @staticmethod
    def _ring_store(ring: torch.Tensor, slots, a: torch.Tensor) -> None:
        """ring[:, slots] = a in the ring's storage type; fp8 saturates
        (`saturate_cast`) and is written as its bytes."""
        a = nn.saturate_cast(a, ring.dtype)
        if a.dtype == torch.float8_e4m3fn:
            ring, a = ring.view(torch.uint8), a.view(torch.uint8)
        ring[:, slots] = a

    def _run_tar_stack(self, params, stack_name, ln_name, emb,
                       rings: bool = False):
        """Full-window pass: emb [B, T, S, D] → (ln(out) [B, T, S, D], the
        stack's rings [L, B·S, T_max, ...] with `rings`, else None).  With T
        > T_max only the last T_max frames are kept, each at its absolute
        ring slot.  int4 rings quantize each window frame per (scene,
        head); int2 rings too, after the channel equalizer taken over the
        whole window.  Relative temporal PE: the window's bias on every
        temporal attention.  Without rings the stack runs through
        `nn.apply_stack` (config.remat recomputes each block in the
        backward pass)."""
        cfg = self.config
        B, T, S, _ = emb.shape
        stack = params[stack_name]
        t_bias = self._t_bias_window(params, T)
        if not rings:
            h = nn.apply_stack(
                stack, emb,
                lambda p, x: nn.block_tar(p, x, self.heads,
                                          attn_impl=self.attn,
                                          t_bias=t_bias, tp=self.tp),
                remat=cfg.remat)
            return nn.layer_norm(params[ln_name], h), None
        L = nn.n_layers(stack)
        keep = min(T, self.t_max)
        slots = torch.as_tensor(np.arange(T - keep, T) % self.t_max,
                                device=emb.device)
        kv_rings = self._ring_zeros(L, B * S, B, emb.device)
        h = emb
        for l in range(L):
            h, kv = nn.block_tar(nn.layer(stack, l), h, self.heads,
                                 attn_impl=self.attn, collect_kv=True,
                                 t_bias=t_bias, tp=self.tp)
            for i, a in enumerate(kv):                 # [B·S, T, H, Dh]
                if self.ring_q2:
                    packed, sc, chan = self._ring_q2_quantize_window(a, B,
                                                                     keep)
                    kv_rings[i][l][:, slots] = packed
                    kv_rings[2 + i][l][:, slots] = sc
                    kv_rings[4 + i][l] = chan
                elif self.ring_q4:
                    # each kept frame quantized as one new frame would be
                    packed, sc = self._ring_q4_quantize(
                        a[:, -keep:].transpose(0, 1), B)
                    kv_rings[i][l][:, slots] = packed.transpose(0, 1)
                    kv_rings[2 + i][l][:, slots] = sc.transpose(0, 1)
                else:
                    self._ring_store(kv_rings[i][l], slots, a[:, -keep:])
        return nn.layer_norm(params[ln_name], h), kv_rings

    def _run_tar_stack_cached(self, params, stack_name, ln_name, x, kv,
                              slot: int, n_valid: int):
        """x [B, S, D] new frame → (ln(out) [B, S, D], kv) with the frame's
        K/V written into ring slot `slot` in place."""
        B = x.shape[0]
        stack = params[stack_name]
        tb_ring, tb_self = self._t_bias_ring(params, slot, self.t_max)
        h = x
        for l in range(nn.n_layers(stack)):
            extra = ({"ring_scale_k": kv[2][l], "ring_scale_v": kv[3][l]}
                     if self.ring_q4 or self.ring_q2 else {})
            if self.ring_q2:
                extra.update(ring_chan_k=kv[4][l], ring_chan_v=kv[5][l],
                             ring_bits=2)
            h, k_new, v_new = nn.block_tar_decode_deferred(
                nn.layer(stack, l), h, self.heads, kv[0][l], kv[1][l],
                slot, n_valid, attn_impl=self.attn, t_bias_ring=tb_ring,
                t_bias_self=tb_self, tp=self.tp, **extra)
            for i, new in enumerate((k_new, v_new)):
                if self.ring_q2:
                    kv[i][l][:, slot], kv[2 + i][l][:, slot] = \
                        self._ring_q2_quantize_layer(new, B, kv[4 + i][l])
                elif self.ring_q4:
                    kv[i][l][:, slot], kv[2 + i][l][:, slot] = \
                        self._ring_q4_quantize_layer(new, B)
                else:
                    self._ring_store(kv[i][l], slot, new)
        return nn.layer_norm(params[ln_name], h), kv

    def _tar_embs(self, params, frame_emb, run_stack):
        """Shared body of the TAR cascades: trunk, then the map and box
        refinement stacks overriding their segments, then the warped-map
        residual on the map content positions → {mod: [..., seg_len, D]}.

        frame_emb(mods, grid_pe) → (emb, warped map of the same frames);
        run_stack(stack_name, ln_name, emb) → output [..., S, D]: one frame
        [B, S, D] (the rollouts) or every frame [B, T, S, D] (the
        trainer's `tar_cascade`)."""
        cfg, lo = self.config, self.layout
        emb, _ = frame_emb(lo.mod_order, cfg.add_spatial_pos_embedd_on_map)
        trunk = run_stack("tar", "ln_tar", emb)
        seg_lens = [s.end - s.start + 1 for s in lo.segments]
        offs = np.cumsum([0] + seg_lens)
        tar_emb = {s.mod: trunk[..., int(offs[i]):int(offs[i + 1]), :]
                   for i, s in enumerate(lo.segments)}
        warped_prior = None
        if cfg.split_map_tar and "map" in lo.mod_order:
            emb_m, warped_prior = frame_emb(TASKS["pose_map"], False)
            tar_emb["map"] = run_stack("map_tar", "ln_map_tar",
                                       emb_m)[..., 5:, :]
        if cfg.split_box_tar and "bbox3d" in lo.mod_order:
            emb_b, warped_b = frame_emb(TASKS["pose_map_bbox3d"], False)
            out_b = run_stack("box_tar", "ln_box_tar", emb_b)
            tar_emb["bbox3d"] = out_b[..., 5 + 1026:, :]
            if not cfg.split_map_tar:
                tar_emb["map"] = out_b[..., 5:5 + 1026, :]
                warped_prior = warped_b
        if cfg.map_transform and "map" in lo.mod_order \
                and warped_prior is not None:
            m = tar_emb["map"]
            tar_emb["map"] = torch.cat(
                [m[..., :1, :], m[..., 1:-1, :] + warped_prior,
                 m[..., -1:, :]], dim=-2)
        return tar_emb

    def _priors(self, params, frame_emb, run_stack):
        """`_tar_embs` of one frame → prior_seq [B, 2207, D], its
        segments in decode order."""
        tar_emb = self._tar_embs(params, frame_emb, run_stack)
        return torch.cat([tar_emb[s.mod] for s in self.layout.segments],
                         dim=1)

    def _ego_context(self, params, inputs, rings: bool):
        """The raw window {mod: [B, T, len]} through the ego stack (no map
        warp, no grid PE: the reference's ego net sees the raw window) →
        (out [B, T, S, D], the ego rings or None)."""
        emb, _ = self._tar_input(params, inputs, self.layout.mod_order,
                                 map_grid_pe=False, pose_diff=None,
                                 warp=False, t_offset=0)
        return self._run_tar_stack(params, "ego_tar", "ln_ego_tar", emb,
                                   rings=rings)

    def forward_ego_net(self, params, inputs):
        """The ego net over the raw window {mod: [B, T, len]} with the
        queries of every frame (at t_offset 0) → ego embeddings [B, T, 3,
        D] (the trainer's; the rollouts read the last frame's only)."""
        out, _ = self._ego_context(params, inputs, rings=False)
        B, T, S, D = out.shape
        return self._ego_queries(params, out.reshape(B * T, S, D), B, T,
                                 t_offset=0)

    def _ego_window(self, params, inputs, rings: bool):
        """`_ego_context`'s last frame through the ego queries → (ego
        logits [B, 3, 1024], the ego rings or None)."""
        out, kv = self._ego_context(params, inputs, rings)
        B, T = out.shape[:2]
        q = self._ego_queries(params, out[:, -1], B, 1, t_offset=T - 1)
        return self.head(params, "head_ego", q[:, 0]), kv

    def ego_logits(self, params, inputs):
        """Recompute mode: the window's last-frame ego logits [B, 3, 1024]
        (the reference's forward_ego_net + head; the queries of the
        earlier frames, which it also computes, are never read)."""
        with span("umgen.ego"):
            return self._ego_window(params, inputs, rings=False)[0]

    def prefill_ego_cache(self, params, inputs, cache):
        """Ingest the raw window {mod: [B, T, len]} into the ego rings →
        (last-frame ego logits [B, 3, 1024], cache)."""
        cache = dict(cache)
        with span("umgen.ego"):
            logits, cache["ego_tar"] = self._ego_window(params, inputs,
                                                        rings=True)
        return logits, cache

    def ego_logits_cached(self, params, frame_inputs, cache, abs_frame: int):
        """One new raw frame {mod: [B, 1, len]} (pose = motion into it)
        through the ego rings → (logits [B, 3, 1024], cache)."""
        slot = abs_frame % self.t_max
        n_valid = min(abs_frame + 1, self.t_max)
        cache = dict(cache)
        with span("umgen.ego"):
            emb, _ = self._tar_input(params, frame_inputs,
                                     self.layout.mod_order, map_grid_pe=False,
                                     pose_diff=None, warp=False,
                                     t_offset=abs_frame)
            ctx, cache["ego_tar"] = self._run_tar_stack_cached(
                params, "ego_tar", "ln_ego_tar", emb[:, 0], cache["ego_tar"],
                slot, n_valid)
            q = self._ego_queries(params, ctx, ctx.shape[0], 1,
                                  t_offset=abs_frame)
            return self.head(params, "head_ego", q[:, 0]), cache

    def _window_priors(self, params, shifted_inputs, cache=None):
        """The shifted window through the trunk / map / box stacks →
        {"prior_seq" [B, 2207, D], "pose_diff", "cache"} for its last
        frame; with `cache` (a dict) the stacks' rings are created in it."""
        pose_diff = self.decode_pose(params, shifted_inputs["pose"])
        rings = cache is not None
        cache = dict(cache) if rings else None

        def frame_emb(mods, grid_pe):
            emb, warped = self._tar_input(params, shifted_inputs, mods,
                                          map_grid_pe=grid_pe,
                                          pose_diff=pose_diff, t_offset=0)
            return emb, (warped[:, -1] if warped is not None else None)

        def run_stack(name, ln, emb):
            out, kv = self._run_tar_stack(params, name, ln, emb, rings=rings)
            if rings:
                cache[name] = kv
            return out[:, -1]

        prior = self._priors(params, frame_emb, run_stack)
        return {"prior_seq": prior, "pose_diff": pose_diff, "cache": cache}

    def tar_cascade(self, params, shifted_inputs):
        """The shifted window {mod: [B, T, len]} through every TAR stack,
        every frame kept (the trainer's teacher-forced pass) → {"tar_emb":
        {mod: [B, T, seg_len, D]} with the split stacks' overrides and the
        warped-map residual, "pose_diff" [B, T, 3]}."""
        pose_diff = self.decode_pose(params, shifted_inputs["pose"])

        def frame_emb(mods, grid_pe):
            return self._tar_input(params, shifted_inputs, mods,
                                   map_grid_pe=grid_pe, pose_diff=pose_diff,
                                   t_offset=0)

        def run_stack(name, ln, emb):
            return self._run_tar_stack(params, name, ln, emb)[0]

        return {"tar_emb": self._tar_embs(params, frame_emb, run_stack),
                "pose_diff": pose_diff}

    def oar_forward(self, params, oar_input):
        """The OAR's full causal pass over a frame's inputs [B, S, D]
        (`Rollout.oar_inputs_from_tokens`) → ln_oar(h) [B, S, D]: the
        output at input index p-1 predicts position p."""
        cfg = self.config
        h = nn.apply_stack(
            params["oar"], oar_input,
            lambda p, x: nn.block_oar(p, x, self.heads, attn_impl=self.attn,
                                      tp=self.tp),
            remat=cfg.remat)
        return nn.layer_norm(params["ln_oar"], h)

    def tar_priors(self, params, shifted_inputs):
        """Recompute mode: the whole shifted window {mod: [B, T, len]} (the
        pose slot of frame t holding the action out of it, the last one the
        action being generated) through every TAR stack → {"prior_seq" [B,
        2207, D], "pose_diff" [B, T, 3]} of its last frame."""
        with span("umgen.tar"):
            out = self._window_priors(params, shifted_inputs)
        return {"prior_seq": out["prior_seq"], "pose_diff": out["pose_diff"]}

    def prefill_tar_caches(self, params, shifted_inputs, cache):
        """Ingest the shifted window into the trunk/map/box rings →
        {"prior_seq" [B, 2207, D], "pose_diff", "cache"} for its last
        frame."""
        with span("umgen.tar"):
            return self._window_priors(params, shifted_inputs, cache)

    def tar_priors_cached(self, params, frame_inputs, cache, abs_frame: int):
        """One-frame TAR cascade against the rings.  frame_inputs {mod:
        [B, 1, len]} with the pose slot holding the CURRENT action; →
        {"prior_seq", "pose_diff", "cache"}."""
        slot = abs_frame % self.t_max
        n_valid = min(abs_frame + 1, self.t_max)
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

        with span("umgen.tar"):
            pose_diff = self.decode_pose(params, frame_inputs["pose"])
            prior = self._priors(params, frame_emb, run_stack)
        return {"prior_seq": prior, "pose_diff": pose_diff, "cache": cache}
