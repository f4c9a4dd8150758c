"""The frame step: ego → TAR cascade → OAR token decode (port of
umgen_tpu/models/rollout.py): `frame_step` in recompute mode, the
`frame_step_*` of the temporal-cache path.

The JAX package compiles a whole frame into one XLA program; the port runs
the same schedule eagerly: a Python loop over the frame's positions, each
step one fused decode-kernel call (or, without the fused kernels, the
reference's unfused body, `_oar_step_eager`) plus the head, the sampler and
the next input's embedding, all on the device.  Static per-position facts (the
modality, the bbox object/attribute, whether a box completes) are Python
values from the SequenceLayout, so no step waits on the host.

Decode-order bookkeeping (1-indexed positions after the task slot): input
index k carries embed(token_k) + prior_seq[k] (the task embedding at k=0);
sampling position p feeds input k = p-1 with the KV cache holding inputs
0..p-2.  Separators are forced, never sampled.

The OAR KV cache is flat [L, B, 2208, H·Dh] — int8 for the integer-logit
decode kernels, bfloat16 or float8_e4m3fn for the dense-cache ones (v2, v1)
— or, with `oar_cache_dtype="int4"`, a `PackedKV` of nibble-packed rows and
per-(row, head) scales; each is updated in place (the JAX package threads it
functionally).  With `speculative_k` = K > 0 the map and image segments (and
the bbox segment unless `speculative_bbox` is off) are decoded in verify
chunks of K positions (models/speculative.py), and the cache has K slack
rows.

On a rank of a GSPMD-mode run (`model.mesh`, UMGen.on_mesh) the TAR
cascade runs split over tp, each head's logits are gathered before the
sampler (`UMGen.head`), and the OAR runs as its params are: a split OAR
stack (the unfused body) on the rank's heads and a cache of them, a whole
one (a tree with decode packs: the decode kernels are whole-head-set, as
GSPMD replicates JAX's custom calls) on every head and a whole cache.
The sampling noise is the unsharded run's: over dp > 1 every rank samples
the whole batch's gathered logits with the run's seed and keeps its rows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from umgen_tpu_torch.config import EGO_WHL, TASK_NAME_ID
from umgen_tpu_torch.models import modules as nn
from umgen_tpu_torch.models import speculative as spec
from umgen_tpu_torch.models.sampling import make_sampler
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.ops import decode_kernel as dk
from umgen_tpu_torch.ops.collision import candidate_collides
from umgen_tpu_torch.params import torch_dtype

Params = Dict[str, Any]

MAX_BOXES = 62   # ego + 60 slots + candidate headroom


class PackedKV(NamedTuple):
    """One half (K or V) of the int4 OAR cache: packed [L, B, S, H·Dh/2]
    int8 nibble pairs in the halves layout (ops.decode_kernel.
    quantize_kv_int4) and scale [L, B, S, H] float32."""
    packed: torch.Tensor
    scale: torch.Tensor


def _kv_rows(kv) -> int:
    """Cache length (the S axis) of dense or packed storage."""
    return (kv.packed if isinstance(kv, PackedKV) else kv).shape[2]


class OarState(NamedTuple):
    """The OAR decode's state within one frame."""
    kv_k: torch.Tensor        # [L, B, S, H·Dh] (or PackedKV)
    kv_v: torch.Tensor
    prev_emb: torch.Tensor    # [B, 1, D] input embedding for the next step


class FrameOutputs(NamedTuple):
    tokens: torch.Tensor       # [B, seq_len] sampled/forced stream
    pose_tokens: torch.Tensor  # [B, 3] ego tokens used this frame
    # the frame's ego logits [B, 3, 1024] and TAR priors [B, 2207, D]
    ego_logits: Optional[torch.Tensor] = None
    prior_seq: Optional[torch.Tensor] = None
    # verify steps and accepted drafts of the frame's speculatively decoded
    # segments: sequential decode would have taken chunks + accepted steps
    spec_chunks: int = 0
    spec_accepted: int = 0


class Rollout:
    """Per-frame generation on the cached path."""

    def __init__(self, model: UMGen):
        self.model = model
        self.config = cfg = model.config
        self.layout = model.layout
        if cfg.sample_method == "greedy":
            self._samplers = {m: make_sampler("greedy")
                              for m in ("pose", "map", "bbox3d", "image")}
        else:
            def param(k):
                return k if cfg.sample_method == "topk" else cfg.top_p

            self._samplers = {
                "pose": make_sampler(cfg.sample_method, param(cfg.top_k),
                                     cfg.sfmx_temp),
                "map": make_sampler(cfg.sample_method, param(cfg.top_k_map),
                                    cfg.sfmx_temp),
                "bbox3d": make_sampler(cfg.sample_method, param(cfg.top_k),
                                       cfg.sfmx_temp),
                # image sampling is top-k 16 regardless of the method
                "image": make_sampler("topk", cfg.top_k_image,
                                      cfg.sfmx_temp),
            }
        if cfg.speculative_k > 0 and cfg.oar_cache_dtype == "int4" \
                and not cfg.fused_oar_kernel:
            # without the v5mqi4 / w4mqi4 kernels every verify chunk would
            # dequantize the whole int4 prefix through the eager body
            raise ValueError(
                "speculative_k > 0 with the int4 OAR cache requires "
                "fused_oar_kernel=True (the v5mqi4 verify kernel); use "
                "oar_cache_dtype='int8' otherwise")
        if (cfg.speculative_k > 0 and cfg.oar_cache_dtype == "int4"
                and cfg.speculative_k * cfg.n_head > 128):
            raise ValueError(
                "speculative_k * n_head must be <= 128 with the int4 OAR "
                "cache (v5mqi4 takes at most 128 query rows a scene; larger "
                "chunks would fall back to the eager int4 body)")
        mesh = model.mesh
        if mesh is not None and mesh.dp > 1 \
                and cfg.sample_method != "greedy":
            if cfg.speculative_k > 0:
                raise ValueError(
                    "spmd='gspmd' over dp > 1 draws the unsharded run's "
                    "noise by gathering each sampler's logits; speculative "
                    "sampling draws its own: use sample_method='greedy' or "
                    "spmd='shard_map'")
            self._samplers = {m: self._whole_batch(f)
                              for m, f in self._samplers.items()}
        ego = EGO_WHL["nuplan"]
        self._ego_box = torch.tensor(
            [0, 0, 0, ego["l"], ego["w"], ego["h"], 0, 0, 0, 0],
            dtype=torch.float32)

    def _whole_batch(self, sampler):
        """`sampler` on the logits of every dp rank's rows, with the run's
        generator; this rank's rows of its draw."""
        mesh = self.model.mesh

        def sample(generator, logits):
            return mesh.shard(sampler(generator, mesh.gather_rows_t(logits)))
        return sample

    # ------------------------------------------------------------------
    # OAR plumbing
    # ------------------------------------------------------------------
    def oar_heads(self, params: Params) -> int:
        """The heads of the OAR stack in `params`: every head, or the
        rank's under a split one."""
        if "oar" not in params:        # decode packs alone
            return self.config.n_head
        qkv = params["oar"]["attn"]["qkv"]
        w = next(qkv[k] for k in ("w", "wq", "wq4") if k in qkv)
        return self.config.n_head * w.shape[-1] // (3 * self.config.n_embd)

    def runs_v1(self, params: Params) -> bool:
        """Whether Q = 1 pushes on a bfloat16 / float8 cache go to the v1
        kernel: fused kernels on, int8-quantized OAR weights, no packs."""
        return (self.config.fused_oar_kernel and "oar_packed" not in params
                and "wq" in params["oar"]["attn"]["qkv"])

    def oar_tp(self, params: Params):
        """The mesh where the OAR stack is split over tp, else None."""
        tp = self.model.tp
        return tp if tp is not None and \
            self.oar_heads(params) != self.config.n_head else None

    def init_kv(self, B: int, device=None, n_head: Optional[int] = None):
        """Flat [L, B, 2208, H·Dh] caches in the OAR cache dtype (int8 for
        the integer-logit kernels, bfloat16 or float8_e4m3fn for v2 / v1),
        or two PackedKV for "int4": nibble pairs [L, B, 2208, H·Dh/2] int8
        with scales [L, B, 2208, H] float32.  The reference keeps bf16 / fp8
        caches 5-D [L, B, S, H, Dh]; here storage is always flat and 5-D is
        a view of it (`kv.view(L, B, S, H, Dh)`), which every step that
        takes a 5-D cache accepts.  Speculative decoding adds
        `speculative_k` slack rows: a verify chunk may write up to K - 1
        rows past a segment's end (never read, then overwritten).
        `n_head`: the heads the OAR runs (a split stack's, `oar_heads`;
        default every head)."""
        cfg = self.config
        S = self.layout.input_len + max(cfg.speculative_k, 0)
        L, H = cfg.n_oar_layer, n_head or cfg.n_head
        if cfg.oar_cache_dtype == "int4":

            def half():
                return PackedKV(
                    torch.zeros(L, B, S, H * cfg.head_dim // 2,
                                dtype=torch.int8, device=device),
                    torch.zeros(L, B, S, H, dtype=torch.float32,
                                device=device))
            return half(), half()
        shape = (L, B, S, H * cfg.head_dim)
        dt = torch_dtype(cfg.oar_cache_dtype)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    def oar_step(self, params: Params, x: torch.Tensor, kv_k, kv_v,
                 cache_len: int):
        """Push Q new inputs x [B, Q, D] through the OAR stack; their K/V
        land in the caches at cache_len.  The dispatch is the reference's,
        branch for branch (rollout.py:211-272).  PackedKV caches go to
        `_oar_step_int4`.  With the fused kernels on, packed weights and
        Q = 1: an int8 cache goes to w4 under W4A8 packing, else a flat one
        to v7 (`oar_kernel_version` 7 while B·H <= 128, the reference's
        routing rule) or v5, and a 5-D one to v4 (six-stream packing) or
        v3; any other cache type to v2.  1 < Q·H <= 128 on a flat int8 cache
        goes to v5mq / w4mq.  Q = 1 with int8-quantized but unpacked
        `params["oar"]` on a bf16 / fp8 cache goes to v1 — the reference
        tells that case by its cache being 5-D, which here any cache may be
        as a view, so it is told by the dtype.  Anything else runs the
        eager body.  Returns (ln_oar(h) [B, Q, D], kv_k, kv_v)."""
        cfg = self.config
        B, Q, H = x.shape[0], x.shape[1], cfg.n_head
        if isinstance(kv_k, PackedKV):
            return self._oar_step_int4(params, x, kv_k, kv_v, cache_len)
        packed = params.get("oar_packed") if cfg.fused_oar_kernel else None
        int8 = kv_k.dtype == torch.int8
        fused = None
        if packed is not None and Q == 1:
            if not int8:
                fused = dk.fused_decode_step_v2
            elif "wqp4" in packed:                 # W4A8 packing
                fused = dk.fused_decode_step_w4
            elif kv_k.ndim == 4 and cfg.oar_kernel_version == 7 \
                    and B * H <= 128 and not cfg.oar_batch_block:
                fused = dk.fused_decode_step_v7
            elif kv_k.ndim == 4:
                fused = dk.fused_decode_step_v5
            elif "wfca" in packed:                 # pack_fused_oar_v4
                fused = dk.fused_decode_step_v4
            else:
                fused = dk.fused_decode_step_v3
        elif packed is not None and 1 < Q and Q * H <= 128 \
                and kv_k.ndim == 4 and int8:
            fused = (dk.fused_decode_step_w4mq if "wqp4" in packed
                     else dk.fused_decode_step_v5mq)
        elif self.runs_v1(params) and Q == 1 \
                and kv_k.dtype in dk.DENSE_KV_DTYPES[:2]:
            if self.oar_tp(params) is not None:
                raise ValueError(
                    "fused_oar_kernel on a split int8 OAR stack: the v1 "
                    "kernel runs the whole head set on every rank, as GSPMD "
                    "replicates JAX's custom call; gather the OAR whole "
                    "(Generator(spmd='gspmd') does)")
            fused, packed = dk.fused_decode_step, params["oar"]
        if fused is not None:
            h, kv_k, kv_v = fused(packed, x, kv_k, kv_v, cache_len, n_head=H)
            return nn.layer_norm(params["ln_oar"], h), kv_k, kv_v
        return self._oar_step_eager(params, x, kv_k, kv_v, cache_len)

    def _oar_step_eager(self, params, x, kv_k, kv_v, cache_len: int):
        """The reference's multi-row XLA body: every layer attends [prefix
        < cache_len ‖ causal new block] with the int8 prefix dequantized
        from the 1/16 grid, a bf16 / fp8 one cast, or the int4 one
        (PackedKV) from its nibbles and per-(row, head) scales; flat or 5-D
        dense caches.  It is the plain counterpart of the fused step in the
        JAX package's own terms.  A split OAR stack (`oar_tp`) runs on the
        rank's heads."""
        cfg = self.config
        H, Dh = self.oar_heads(params), cfg.head_dim
        tp = self.oar_tp(params)
        B, Q, D = x.shape
        S = _kv_rows(kv_k)
        scale = 1.0 / math.sqrt(Dh)
        int4 = isinstance(kv_k, PackedKV)
        kpos = torch.arange(S, device=x.device)
        prefix_valid = kpos < cache_len
        self_mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                          device=x.device))

        def load(c, l):
            if int4:
                return dk.kv_load_int4(c.packed[l], c.scale[l], H, x.dtype)
            return dk.kv_load(c[l].reshape(B, S, H, Dh), x.dtype)

        def store(c, l, t):
            rows = slice(cache_len, cache_len + Q)
            if int4:
                c.packed[l, :, rows], c.scale[l, :, rows] = \
                    dk.quantize_kv_int4(t.reshape(B, Q, H * Dh), H)
            else:
                c[l, :, rows] = dk.kv_store(t, c.dtype).reshape(
                    c[l, :, rows].shape)

        h = x
        stack = params["oar"]
        for l in range(nn.n_layers(stack)):
            p = nn.layer(stack, l)
            q, k_new, v_new = nn.qkv(p["attn"]["qkv"],
                                     nn.layer_norm(p["ln1"], h), tp)
            q = q.reshape(B, Q, H, Dh)
            k_new = k_new.reshape(B, Q, H, Dh)
            v_new = v_new.reshape(B, Q, H, Dh)
            lp = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              load(kv_k, l).float()) * scale
            lp = lp.masked_fill(~prefix_valid, float("-inf"))
            ls = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k_new.float()) * scale
            ls = ls.masked_fill(~self_mask, float("-inf"))
            m = torch.maximum(lp.amax(-1, keepdim=True),
                              ls.amax(-1, keepdim=True))
            ep = torch.exp(lp - m)
            es = torch.exp(ls - m)
            denom = ep.sum(-1, keepdim=True) + es.sum(-1, keepdim=True)
            wp = (ep / denom).to(x.dtype)
            ws = (es / denom).to(x.dtype)
            y = (torch.einsum("bhqk,bkhd->bqhd", wp.float(),
                              load(kv_v, l).float()).to(x.dtype)
                 + torch.einsum("bhqk,bkhd->bqhd", ws.float(),
                                v_new.float()).to(x.dtype))
            h = h + nn.row_linear(p["attn"]["proj"], y.reshape(B, Q, H * Dh),
                                  tp)
            h = h + nn.mlp(p["mlp"], nn.layer_norm(p["ln2"], h), tp)
            store(kv_k, l, k_new)
            store(kv_v, l, v_new)
        return nn.layer_norm(params["ln_oar"], h), kv_k, kv_v

    def _oar_step_int4(self, params: Params, x: torch.Tensor,
                       kv_k: PackedKV, kv_v: PackedKV, cache_len: int):
        """oar_step on the nibble-packed int4 cache (rollout.py:332-438).
        With the fused kernels on, Q = 1 goes to v5i4 and 1 < Q·H <= 128 to
        v5mqi4 (w4i4 / w4mqi4 for W4A8 packing).  Otherwise the eager body
        dequantizes the prefix per layer and re-quantizes the new rows per
        (row, head)."""
        cfg = self.config
        Q, H = x.shape[1], cfg.n_head
        if (cfg.fused_oar_kernel and "oar_packed" in params
                and Q * H <= 128):
            if "wqp4" in params["oar_packed"]:
                fused = (dk.fused_decode_step_w4i4 if Q == 1
                         else dk.fused_decode_step_w4mqi4)
            else:
                fused = (dk.fused_decode_step_v5i4 if Q == 1
                         else dk.fused_decode_step_v5mqi4)
            h, kp, vp, ks, vs = fused(params["oar_packed"], x, kv_k.packed,
                                      kv_v.packed, kv_k.scale, kv_v.scale,
                                      cache_len, n_head=H)
            return (nn.layer_norm(params["ln_oar"], h), PackedKV(kp, ks),
                    PackedKV(vp, vs))
        return self._oar_step_eager(params, x, kv_k, kv_v, cache_len)

    def _embed_token(self, params: Params, mod: str,
                     token: torch.Tensor) -> torch.Tensor:
        """token → next-step OAR input embedding (no positional terms)."""
        if mod == "pose":
            return params["buffers"]["fouier_pe"][token]
        if mod == "map":
            return nn.mlp(params["map_mlp_pre"],
                          params["buffers"]["map_codebook"][token],
                          self.model.tp)
        if mod == "bbox3d":
            return nn.lookup(params["be"], token)
        if mod == "image":
            return nn.mlp(params["img_mlp_pre"],
                          params["buffers"]["img_codebook"][token],
                          self.model.tp)
        raise ValueError(mod)

    def _aux_emb(self, params: Params, aux_id: int, B: int) -> torch.Tensor:
        axe = params["axe"]
        return axe[aux_id][None, None].expand(B, 1, axe.shape[-1])

    def oar_inputs_from_tokens(self, params: Params,
                               frame_tokens: torch.Tensor,
                               prior_seq: torch.Tensor) -> torch.Tensor:
        """The OAR's input sequence of a complete token stream (the
        trainer's teacher-forced pass).  frame_tokens [B, seq_len] with its
        separators (position p at column p-1), prior_seq [B, seq_len, D] →
        [B, seq_len, D] in cfg.dtype: index 0 the task embedding, index k >=
        1 token k's embedding by its modality (the aux embedding at a
        separator), every index + prior_seq[k]; the output of
        `UMGen.oar_forward` at index p-1 predicts position p."""
        cfg, lo = self.config, self.layout
        B = frame_tokens.shape[0]
        tske = params["tske"][TASK_NAME_ID[cfg.task]]
        parts = [tske[None, None].expand(B, 1, tske.shape[-1])]
        for seg in lo.segments:
            content = frame_tokens[:, seg.content_start - 1:seg.content_end]
            parts += [self._aux_emb(params, seg.bos, B),
                      self._embed_token(params, seg.mod, content),
                      self._aux_emb(params, seg.eos, B)]
        # the final EOS is never an input
        full = torch.cat(parts, dim=1)[:, :lo.seq_len]
        return (full + prior_seq[:, :lo.seq_len]).to(torch_dtype(cfg.dtype))

    # While decoding a segment the cache never grows past the segment's
    # end, so the steps get a prefix VIEW of it (writes land in the full
    # cache).  The kernel reads only rows < cache_len either way; the view
    # keeps the plain version's S-blocking identical to the reference's.
    def _sliced(self, state: OarState, kv_len: int) -> OarState:
        def cut(kv):
            if isinstance(kv, PackedKV):
                return PackedKV(kv.packed[:, :, :kv_len],
                                kv.scale[:, :, :kv_len])
            return kv[:, :, :kv_len]

        return OarState(cut(state.kv_k), cut(state.kv_v), state.prev_emb)

    def _unsliced(self, full: OarState, part: OarState) -> OarState:
        return OarState(full.kv_k, full.kv_v, part.prev_emb)

    # ------------------------------------------------------------------
    # segments
    # ------------------------------------------------------------------
    def _decode_plain_segment(self, params, mod, seg, state: OarState,
                              prior_seq, head_name, generator):
        """Sample a contiguous run of same-modality content positions."""
        sampler = self._samplers[mod]
        tokens = []
        prev = state.prev_emb
        for i in range(seg.content_len):
            p = seg.content_start + i
            h, _, _ = self.oar_step(params, prev, state.kv_k, state.kv_v,
                                    cache_len=p - 1)
            token = sampler(generator,
                            self.model.head(params, head_name, h[:, -1]))
            prev = (self._embed_token(params, mod, token)[:, None, :]
                    + prior_seq[:, p:p + 1]).to(prev.dtype)
            tokens.append(token)
        return state._replace(prev_emb=prev), torch.stack(tokens, dim=1)

    def _decode_forced_segment(self, params, mod, seg, state: OarState,
                               prior_seq, forced: torch.Tensor):
        """Teacher-force a whole segment to `forced` [B, content_len]: one
        causal multi-row push of the known inputs extends the cache exactly
        as if the tokens had been sampled."""
        c0, L = seg.content_start, seg.content_len
        dt = state.prev_emb.dtype
        forced = forced.long()
        emb = self._embed_token(params, mod, forced[:, :L - 1])
        x = torch.cat([state.prev_emb,
                       (emb + prior_seq[:, c0:c0 + L - 1]).to(dt)], dim=1)
        self.oar_step(params, x, state.kv_k, state.kv_v, cache_len=c0 - 1)
        last = (self._embed_token(params, mod, forced[:, L - 1:L])
                + prior_seq[:, c0 + L - 1:c0 + L])
        return state._replace(prev_emb=last.to(dt)), forced

    def _decode_bbox_segment(self, params, seg, state: OarState, prior_seq,
                             prev_frame_bbox, tar_box_logits, control_mask,
                             generator):
        """660 bbox positions with the reference's decode rules:

        * control override: controlled slots sample the TAR head with <pad>
          masked out (object id from the BOS position, so a category token
          maps to the NEXT object — the reference's quirk);
        * pad→TAR merge rule: an OAR <pad> for an object alive last frame
          is resampled from the TAR head;
        * no-born rule (optional);
        * rule constraint: at each box completion the decoded box is tested
          against the boxes accepted so far (+ ego); a NEWBORN that
          collides, or arrives past 30 boxes, has its 11 tokens rewritten
          to <pad> (already-written KV is not recomputed)."""
        cfg = self.config
        sampler = self._samplers["bbox3d"]
        pad = cfg.bbox3d_vocab_size - 1
        dev = state.prev_emb.device
        B = state.prev_emb.shape[0]
        buf = params["buffers"]
        boxes = torch.zeros(B, MAX_BOXES, 10, device=dev)
        boxes[:, 0] = self._ego_box.to(dev)
        bvalid = torch.zeros(B, MAX_BOXES, dtype=torch.bool, device=dev)
        bvalid[:, 0] = True
        nbox = torch.ones(B, dtype=torch.long, device=dev)
        win = torch.full((B, 11), pad, dtype=torch.long, device=dev)
        tokens = torch.zeros(B, seg.content_len, dtype=torch.long,
                             device=dev)
        slots = torch.arange(MAX_BOXES, device=dev)
        prev = state.prev_emb

        for i in range(seg.content_len):
            p = seg.content_start + i
            h, _, _ = self.oar_step(params, prev, state.kv_k, state.kv_v,
                                    cache_len=p - 1)
            tok_ar = sampler(generator, self.model.head(
                params, "head_ar_bbox3d", h[:, -1]))
            prev_tok = prev_frame_bbox[:, i]
            is_ctrl = control_mask[:, (i + 1) // 11]
            tar_logits = tar_box_logits[:, i]
            nopad = tar_logits.clone()
            nopad[:, -1] = float("-inf")
            token = torch.where(is_ctrl, sampler(generator, nopad), tok_ar)
            if cfg.merge_ar_tar and not cfg.only_ar:
                tok_tar = sampler(generator, tar_logits)
                merge = (token == pad) & (prev_tok != pad) & ~is_ctrl
                token = torch.where(merge, tok_tar, token)
            if cfg.no_born:
                token = torch.where(prev_tok == pad,
                                    torch.full_like(token, pad), token)
            win = torch.cat([win[:, 1:], token[:, None]], dim=1)
            tokens[:, i] = token

            if cfg.rule_constrain and i % 11 == 10:
                attr = torch.clamp(win[:, :10], 0, 1023)
                cand = buf["agent_bin_mid"][attr] * buf["agent_span"] \
                    + buf["agent_lo"]
                collide = candidate_collides(cand, boxes, bvalid)
                alive = token != pad
                kill = alive & (prev_tok == pad) & (collide | (nbox + 1 > 30))
                keep = alive & ~kill
                put = (slots[None] == nbox[:, None]) & keep[:, None]
                boxes = torch.where(put[..., None], cand[:, None], boxes)
                bvalid = bvalid | put
                nbox = nbox + keep.long()
                tokens[:, i - 10:i + 1] = torch.where(
                    kill[:, None], torch.full_like(win, pad),
                    tokens[:, i - 10:i + 1])
                token = torch.where(kill, torch.full_like(token, pad), token)
                win = torch.where(kill[:, None], torch.full_like(win, pad),
                                  win)
            prev = (self._embed_token(params, "bbox3d", token)[:, None, :]
                    + prior_seq[:, p:p + 1]).to(prev.dtype)
        return state._replace(prev_emb=prev), tokens

    # ------------------------------------------------------------------
    # full frame
    # ------------------------------------------------------------------
    def _finish_frame(self, params: Params, prior_seq: torch.Tensor,
                      ego_tokens: torch.Tensor,
                      prev_frame_bbox: Optional[torch.Tensor],
                      control_mask: torch.Tensor, generator,
                      forced_tokens: Optional[Dict[str, torch.Tensor]] = None
                      ) -> FrameOutputs:
        """The OAR decode of one frame given its TAR priors."""
        cfg, lo = self.config, self.layout
        B = prior_seq.shape[0]
        dev = prior_seq.device
        dt = torch_dtype(cfg.dtype)
        tar_box_logits = None
        if any(s.mod == "bbox3d" for s in lo.segments):
            bseg = lo.segment("bbox3d")
            tar_box_logits = self.model.tar_bbox_logits(   # [B, 660, V]
                params, prior_seq[:, bseg.start:bseg.content_end])

        kv_k, kv_v = self.init_kv(B, device=dev,
                                  n_head=self.oar_heads(params))
        # prefill: [task, pose_bos, p1, p2, p3, pose_eos]
        pseg = lo.segment("pose")
        task_emb = params["tske"][TASK_NAME_ID[cfg.task]][None, None].expand(
            B, 1, cfg.n_embd)
        prefill = torch.cat([task_emb, self._aux_emb(params, pseg.bos, B),
                             self._embed_token(params, "pose", ego_tokens),
                             self._aux_emb(params, pseg.eos, B)],
                            dim=1).to(dt)
        n_pre = prefill.shape[1]
        self.oar_step(params, prefill + prior_seq[:, :n_pre], kv_k, kv_v,
                      cache_len=0)

        tokens = torch.zeros(B, lo.seq_len + 1, dtype=torch.long, device=dev)
        tokens[:, pseg.start] = pseg.bos
        tokens[:, pseg.start + 1:pseg.end] = ego_tokens
        tokens[:, pseg.end] = pseg.eos

        segs = [s for s in lo.segments if s.mod != "pose"]
        state = OarState(kv_k, kv_v,
                         (self._aux_emb(params, segs[0].bos, B)
                          + prior_seq[:, segs[0].start:segs[0].start + 1]
                          ).to(dt))
        head_for = {"map": "head_ar_map", "image": "head_ar_img",
                    "bbox3d": "head_ar_bbox3d"}
        # speculative decoding drafts from the TAR heads (not under top-p)
        spec_k = cfg.speculative_k if cfg.sample_method in ("topk",
                                                            "greedy") else 0
        greedy = cfg.sample_method == "greedy"
        tar_head_for = {"map": "head_tar_map", "image": "head_tar_img"}
        sample_k_for = {"map": cfg.top_k_map, "image": cfg.top_k_image}
        chunks = accepted = 0                 # speculative telemetry
        forced_tokens = forced_tokens or {}
        for si, seg in enumerate(segs):
            tokens[:, seg.start] = seg.bos
            forced = forced_tokens.get(seg.mod)
            bbox_spec = (seg.mod == "bbox3d" and spec_k > 0
                         and cfg.speculative_bbox and forced is None)
            # the view's rows (and so the S-blocking) are the reference's:
            # + K slack rows wherever a segment may be speculated
            kv_len = min(seg.end + (spec_k if seg.mod != "bbox3d"
                                    or bbox_spec else 0),
                         _kv_rows(state.kv_k))
            part = self._sliced(state, kv_len)
            tel = None
            if forced is not None:
                part, seg_tokens = self._decode_forced_segment(
                    params, seg.mod, seg, part, prior_seq, forced)
            elif bbox_spec:
                part, seg_tokens, tel = spec.decode_bbox_segment_speculative(
                    self, params, seg, part, prior_seq, prev_frame_bbox,
                    tar_box_logits, control_mask, K=spec_k, greedy=greedy,
                    generator=generator)
            elif seg.mod != "bbox3d" and spec_k > 0:
                part, seg_tokens, tel = spec.decode_segment_speculative(
                    self, params, seg, part, prior_seq, head_for[seg.mod],
                    tar_head_for[seg.mod], k=sample_k_for[seg.mod],
                    temp=cfg.sfmx_temp, K=spec_k, greedy=greedy,
                    generator=generator)
            elif seg.mod == "bbox3d":
                # the merge rule reads the control-OVERWRITTEN last frame
                part, seg_tokens = self._decode_bbox_segment(
                    params, seg, part, prior_seq, prev_frame_bbox,
                    tar_box_logits, control_mask, generator)
            else:
                part, seg_tokens = self._decode_plain_segment(
                    params, seg.mod, seg, part, prior_seq, head_for[seg.mod],
                    generator)
            state = self._unsliced(state, part)
            if tel is not None:
                chunks, accepted = chunks + tel.chunks, accepted + tel.accepted
            tokens[:, seg.content_start:seg.content_end + 1] = seg_tokens
            tokens[:, seg.end] = seg.eos

            if si + 1 < len(segs):
                # push [embed(last sampled), EOS] to extend the cache to
                # input index seg.end, then hand the next segment its BOS
                nxt = segs[si + 1]
                eos_emb = (self._aux_emb(params, seg.eos, B)
                           + prior_seq[:, seg.end:seg.end + 1]).to(dt)
                self.oar_step(params, torch.cat([state.prev_emb, eos_emb],
                                                dim=1),
                              state.kv_k, state.kv_v, cache_len=seg.end - 1)
                state = state._replace(prev_emb=(
                    self._aux_emb(params, nxt.bos, B)
                    + prior_seq[:, nxt.start:nxt.start + 1]).to(dt))
        return FrameOutputs(tokens=tokens[:, 1:], pose_tokens=ego_tokens,
                            spec_chunks=chunks, spec_accepted=accepted)

    def _control_setup(self, inputs, control_bbox):
        """Agent-control overwrite of the window's newest frame: inputs
        {mod: [B, T, len]} → (inputs with the overwritten bbox frame, that
        frame [B, 660] or None without a bbox stream, the [B, 61] control
        mask)."""
        B = inputs["pose"].shape[0]
        control_mask = torch.zeros(B, 61, dtype=torch.bool,
                                   device=inputs["pose"].device)
        if "bbox3d" not in inputs:
            return inputs, None, control_mask
        frame_bbox = inputs["bbox3d"][:, -1]
        if control_bbox is not None:
            valid = control_bbox != -1
            frame_bbox = torch.where(valid, control_bbox, frame_bbox)
            control_mask[:, :60] = valid.reshape(B, 60, 11).any(dim=2)
        inputs = dict(inputs)
        inputs["bbox3d"] = torch.cat([inputs["bbox3d"][:, :-1],
                                      frame_bbox[:, None]], dim=1)
        return inputs, frame_bbox, control_mask

    def frame_step(self, params: Params, inputs: Dict[str, torch.Tensor],
                   generator, pose_override=None, control_bbox=None,
                   forced_tokens=None) -> FrameOutputs:
        """Recompute mode: one frame from the conditioning window {mod: [B,
        T, len]} (pose not yet shifted).  The ego action comes first (from
        the raw window, unless `pose_override` [B, 3] forces it), then the
        pose shift, the agent-control overwrite of the newest frame
        (`control_bbox` [B, 660], -1 where free), the whole window through
        every TAR stack, and the OAR decode of its last frame's priors."""
        model = self.model
        ego_logits = None
        if pose_override is None:
            ego_logits = model.ego_logits(params, inputs)
            ego_tokens = self._samplers["pose"](generator, ego_logits)
        else:
            ego_tokens = pose_override
        shifted = dict(inputs)
        shifted["pose"] = torch.cat([inputs["pose"], ego_tokens[:, None]],
                                    dim=1)[:, 1:]
        shifted, last_bbox, control_mask = self._control_setup(shifted,
                                                               control_bbox)
        pri = model.tar_priors(params, shifted)
        out = self._finish_frame(params, pri["prior_seq"], ego_tokens,
                                 last_bbox, control_mask, generator,
                                 forced_tokens=forced_tokens)
        return out._replace(ego_logits=ego_logits,
                            prior_seq=pri["prior_seq"])

    def frame_step_prefill(self, params: Params,
                           inputs: Dict[str, torch.Tensor], generator,
                           pose_override=None, control_bbox=None,
                           forced_tokens=None):
        """First cached step: ingest the raw window {mod: [B, T, len]}
        (starting at absolute frame 0) into the rings, then decode one
        frame.  Returns (FrameOutputs, cache)."""
        model = self.model
        T = inputs["pose"].shape[1]
        # the control overwrite persists into the rings (the reference
        # mutates its window in place)
        inputs, last_bbox, control_mask = self._control_setup(inputs,
                                                              control_bbox)
        ego_logits, cache = model.prefill_ego_cache(params, inputs, {})
        ego_tokens = (self._samplers["pose"](generator, ego_logits)
                      if pose_override is None else pose_override)
        shifted = dict(inputs)
        shifted["pose"] = torch.cat([inputs["pose"], ego_tokens[:, None]],
                                    dim=1)[:, 1:]
        pri = model.prefill_tar_caches(params, shifted, cache)
        cache = pri["cache"]
        cache["frames"] = T
        out = self._finish_frame(params, pri["prior_seq"], ego_tokens,
                                 last_bbox, control_mask, generator,
                                 forced_tokens=forced_tokens)
        return out._replace(ego_logits=ego_logits,
                            prior_seq=pri["prior_seq"]), cache

    def ingest_frame(self, params: Params, raw_frame: Dict[str, torch.Tensor],
                     next_pose: torch.Tensor, cache: Dict) -> Dict:
        """Chunked prefill: push ONE conditioning frame {mod: [B, 1, len]}
        into the ego and TAR rings without decoding.  next_pose [B, 3]: the
        raw pose tokens of the next frame (the TAR rings see each frame with
        the action that leads out of it, as the full-window prefill's
        shifted window does).  The rings are updated in place."""
        model = self.model
        abs_frame = int(cache["frames"])
        _, cache = model.ego_logits_cached(params, raw_frame, cache,
                                           abs_frame)
        shifted = dict(raw_frame, pose=next_pose[:, None, :])
        cache = model.tar_priors_cached(params, shifted, cache,
                                        abs_frame)["cache"]
        cache["frames"] = abs_frame + 1
        return cache

    def frame_step_chunked(self, params: Params,
                           inputs: Dict[str, torch.Tensor], generator,
                           pose_override=None, control_bbox=None,
                           forced_tokens=None):
        """First cached step under `chunked_prefill`: the raw window {mod:
        [B, T, len]} (T > 1, starting at absolute frame 0) is ingested frame
        by frame — frames 0..T-2 with the next frame's pose, then one
        `frame_step_cached` on frame T-1, which decodes the next frame (as
        the reference's `_generate_cached` does).  Peak memory is one
        frame's activations, not the [B, T, S, D] window.  Returns
        (FrameOutputs, cache)."""
        B, T = inputs["pose"].shape[:2]
        cache = self.model.init_tar_cache(B, inputs["pose"].device)
        for t in range(T - 1):
            cache = self.ingest_frame(
                params, {m: v[:, t:t + 1] for m, v in inputs.items()},
                inputs["pose"][:, t + 1], cache)
        return self.frame_step_cached(
            params, {m: v[:, T - 1:] for m, v in inputs.items()}, cache,
            generator, pose_override=pose_override, control_bbox=control_bbox,
            forced_tokens=forced_tokens)

    def frame_step_cached(self, params: Params,
                          newest_frame: Dict[str, torch.Tensor], cache: Dict,
                          generator, pose_override=None, control_bbox=None,
                          forced_tokens=None):
        """Steady-state step: ingest ONE raw frame {mod: [B, 1, len]} (the
        frame generated last, pose = motion into it) and decode the next.
        Returns (FrameOutputs, cache); the rings are updated in place."""
        model = self.model
        abs_frame = int(cache["frames"])
        newest_frame, last_bbox, control_mask = self._control_setup(
            newest_frame, control_bbox)
        ego_logits, cache = model.ego_logits_cached(params, newest_frame,
                                                    cache, abs_frame)
        ego_tokens = (self._samplers["pose"](generator, ego_logits)
                      if pose_override is None else pose_override)
        shifted = dict(newest_frame)
        shifted["pose"] = ego_tokens[:, None]
        pri = model.tar_priors_cached(params, shifted, cache, abs_frame)
        cache = pri["cache"]
        cache["frames"] = abs_frame + 1
        out = self._finish_frame(params, pri["prior_seq"], ego_tokens,
                                 last_bbox, control_mask, generator,
                                 forced_tokens=forced_tokens)
        return out._replace(ego_logits=ego_logits,
                            prior_seq=pri["prior_seq"]), cache
