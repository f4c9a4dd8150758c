"""Fused OAR decode step (port of umgen_tpu/ops/decode_kernel.py: all
fourteen of its decode kernels, the v5 and W4A8 families on the flat int8
cache and on the nibble-packed int4 cache, and the six older variants).

Replaces the TPU kernels with one CUDA kernel family, csrc/decode_step.cu
(its header says what bounds it on the H100 and how the design answers
that):

  * `fused_decode_step_v5` (decode_kernel.py:1363, pallas_call :1457) —
    int8 weights, one token per scene (Q = 1), every Q = 1 OAR step of the
    rollout;
  * `fused_decode_step_v5mq` (decode_kernel.py:3411, through `_mq_call`
    :3318, pallas_call :3395) — 1 < Q <= 128 / n_head rows per scene with
    causal attention inside the chunk: the 6-row pose prefill and the
    2-row pushes at segment boundaries;
  * `fused_decode_step_w4` (decode_kernel.py:2034, pallas_call :2103,
    body `_kernel_w4`) and `fused_decode_step_w4mq` (:3488, through
    `_mq_call`) — the same two with W4A8 weights (group-128 int4, packed
    by runtime/quantize.pack_fused_w4).  Only the four products of a layer
    differ;
  * `fused_decode_step_v5i4` (decode_kernel.py:2588, pallas_call :2657),
    `fused_decode_step_w4i4` (:2883, pallas_call :2950),
    `fused_decode_step_v5mqi4` (:3451) and `fused_decode_step_w4mqi4`
    (:3523, both through `_mq_call` with int4=True) — the four above on the
    int4 OAR cache: rows of H·Dh/2 nibble-pair bytes (`quantize_kv_int4`'s
    halves layout) with one float32 absmax scale per (row, head), which
    the attention folds into its logits and softmax weights.  Only the
    attention over the prefix and the store of the new rows differ;
  * `fused_decode_step_v3` (:752, pallas_call :831) and `_v4` (:1052,
    :1131) — v5's arithmetic, bit for bit, on the reference's 5-D int8
    cache [L, B, S, H, Dh] (v4 from `pack_fused_oar_v4`'s six weight
    streams).  A 5-D cache whose rows are contiguous is the flat cache's
    memory: they launch v5's kernel on the view.  Their S-block list
    (`V2_BLOCKS`) holds 276, which v5's does not: it matters to the plain
    version only;
  * `fused_decode_step_v6` (:1654, :1732) — v5 with the new rows put on
    the int8 grid from float32 rather than from their bf16 rounding (a
    kernel flag); its in-place append is what every step here does;
  * `fused_decode_step_v7` (:2293, :2370) — v5 with one query scale per
    (scene, head) rather than one per scene (a kernel flag);
  * `fused_decode_step_v2` (:497, :571) and `fused_decode_step` (v1, :186,
    :238) — int8 weights on a DENSE cache (bfloat16, float8_e4m3fn, or
    int8 on the 1/16 grid dequantized to bf16): logits from bf16 products,
    bf16 softmax weights, bf16 sums a block — over S-blocks with a flash
    state (v2), or in one block over all of S with normalized weights (v1,
    which also takes the unpacked `params["oar"]`).  C entry
    `umgen_decode_step_dense`, plain version `decode_step_dense_plain`.

The wrappers take `params["oar_packed"]` (runtime/quantize.pack_fused or
pack_fused_w4), x [B, Q, d] bf16 and the flat int8 caches [L, B, S, H·Dh]
(the JAX layout; views of a longer cache are accepted), and return (h
[B, Q, d] bf16 before the final layer norm, kv_k, kv_v).  The Q new K/V
rows are written into the caches at `cache_len` IN PLACE — the JAX package
writes them back functionally; the returned caches are the same tensors
that were passed.  Any B·Q is taken (the kernel tiles the rows).  The int4
wrappers take the packed caches [L, B, S, H·Dh/2] int8 and the scale planes
[L, B, S, H] float32 and return (h, kv_k, kv_v, k_scale, v_scale), all four
written in place.  v1-v4 take the reference's 5-D caches (v1 and v2 flat
ones too).

Every wrapper refuses inputs that require a gradient while autograd
records (`_cuda.refuse_autograd`: the kernels have no backward).  For CUDA
tensors the kernel launches or the wrapper raises.  For CPU
tensors the wrappers run `decode_step_plain` (`decode_step_dense_plain` for
v1 and v2): the reference kernel's arithmetic in plain PyTorch, including
its S-block online softmax (`pick_block_s`) and the bf16 rounding of the
softmax weights, with the integer products done exactly in float64
(float32 is not exact at K = 3072).  The W4A8 plain version reads JAX's
packed layout (wqp4, wfc4, wpj4, scales4); the kernel reads the
output-major repacking of the same values (`w4k`, `s4k`,
runtime/quantize.w4_kernel_layout).
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from umgen_tpu_torch.models.modules import saturate_cast
from umgen_tpu_torch.ops import _cuda
from umgen_tpu_torch.runtime.quantize import (W4_GROUP, pack_decode_weights,
                                              vec_offsets)

Params = Dict[str, Any]

KV_INT8_SCALE = 16.0     # fixed-grid int8 KV: step 1/16, range ±7.94
MAX_Q = 8                # rows a scene of one mq step (the others take 1)
LAUNCHES = {"fused_decode_step_v5": 0, "fused_decode_step_v5mq": 0,
            "fused_decode_step_w4": 0, "fused_decode_step_w4mq": 0,
            "fused_decode_step_v5i4": 0, "fused_decode_step_v5mqi4": 0,
            "fused_decode_step_w4i4": 0, "fused_decode_step_w4mqi4": 0,
            "fused_decode_step": 0, "fused_decode_step_v2": 0,
            "fused_decode_step_v3": 0, "fused_decode_step_v4": 0,
            "fused_decode_step_v6": 0, "fused_decode_step_v7": 0}

# preferred S-block sizes: v5 and its family (decode_kernel.py:299), and
# v2, v3 and v4, whose list also holds 276 (:514, :764, :1065)
V5_BLOCKS = (552, 512, 416, 384, 368, 256)
V2_BLOCKS = (552, 512, 416, 384, 368, 276, 256)
# storage types of the dense-cache steps (v2 takes all three, v1 the first two)
DENSE_KV_DTYPES = (torch.bfloat16, torch.float8_e4m3fn, torch.int8)


def pick_block_s(S: int, block_s: int = 0, prefer=V5_BLOCKS) -> int:
    """The reference kernel's S-block size for an S-row cache (the plain
    version reproduces its online-softmax blocking): a `block_s` that
    divides S, else the first of `prefer` that does, else the largest
    divisor that is a multiple of 8 in [64, 640], else S."""
    bs = block_s if block_s and S % block_s == 0 else S
    if bs == S and not block_s:
        for cand in prefer:
            if S % cand == 0:
                return cand
    if bs == S:
        for cand in range(min(S, 640), 63, -8):
            if S % cand == 0:
                return cand
    return bs


def kv_store(x: torch.Tensor, dtype: torch.dtype = torch.int8
             ) -> torch.Tensor:
    """K/V activations → cache rows of `dtype`, as the reference's
    `_kv_store` writes them: int8 on the 1/16 grid (×16, round, clip);
    any other type by a rounding of x, float8_e4m3fn saturating at ±448
    (`saturate_cast`, the TAR rings' rule too; JAX's overflows to NaN).
    The kernels round the new rows to bf16 first: their plain versions pass
    them so."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() * KV_INT8_SCALE),
                           -127, 127).to(torch.int8)
    return saturate_cast(x, dtype)


def kv_load(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cache rows → `dtype`: int8 from the 1/16 grid, anything else cast."""
    if c.dtype == torch.int8:
        return (c.float() * (1.0 / KV_INT8_SCALE)).to(dtype)
    return c.to(dtype)


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c as an IEEE division on every device, as the kernel divides
    (PyTorch's CUDA division by a Python scalar multiplies by its rounded
    reciprocal instead, one bit off for some t)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def quantize_kv_int4(rows: torch.Tensor, n_head: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., HD] rows → (packed [..., HD/2] int8, scales [..., H] float32).

    Per (row, head) s = max|x| + 1e-12, q = clip(round(x·(7/s)), ±7),
    dequantized x ≈ q·s/7.  Halves layout: byte j holds value j in its low
    nibble and value j + HD/2 in its high one.  7/s is a division per
    element and then a product, as the reference computes it (a Python
    scalar on the left would become 7·(1/s))."""
    *lead, HD = rows.shape
    r = rows.float().reshape(*lead, n_head, HD // n_head)
    s = r.abs().amax(-1) + 1e-12
    seven = torch.full((), 7.0, dtype=torch.float32, device=rows.device)
    q = torch.clamp(torch.round(r * (seven / s[..., None])), -7, 7)
    q = q.reshape(*lead, HD).int()
    lo, hi = q[..., :HD // 2], q[..., HD // 2:]
    return ((hi << 4) | (lo & 0xF)).to(torch.int8), s


def unpack_kv_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., HD/2] nibble pairs → [..., HD] sign-extended int32 values."""
    w = packed.int()
    return torch.cat([(w << 28) >> 28, w >> 4], dim=-1)


def kv_load_int4(packed: torch.Tensor, scale: torch.Tensor, n_head: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """[B, S, HD/2] nibbles + [B, S, H] scales → [B, S, H, Dh] dequantized."""
    B, S, HDp = packed.shape
    full = unpack_kv_int4(packed).float().reshape(B, S, n_head,
                                                  2 * HDp // n_head)
    return (full * _div(scale[..., None].float(), 7.0)).to(dtype)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------
def _block_sum(v: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """Row sums of v [R, n] in the order of the kernel's `block_sum` over
    256 threads: thread t adds elements t, t + 256, ... in turn, each warp
    folds its 32 lanes by the xor butterfly (16, 8, 4, 2, 1), and lane 0's
    values of the 8 warps are added in order."""
    R, n = v.shape
    v = torch.nn.functional.pad(v, (0, -n % threads))
    t = v.reshape(R, -1, threads)
    s = t[:, 0]
    for k in range(1, t.shape[1]):
        s = s + t[:, k]
    lanes = s.reshape(R, threads // 32, 32)
    idx = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    tot = lanes[:, 0, 0]
    for w in range(1, threads // 32):
        tot = tot + lanes[:, w, 0]
    return tot[:, None]


def _ln(v: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm as the kernel rounds it: block-ordered sums, 1 / sqrt."""
    n = v.shape[-1]
    mu = _div(_block_sum(v), n)
    c = v - mu
    var = _div(_block_sum(c * c), n)
    return c * (1.0 / torch.sqrt(var + eps)) * w


def _quant_rows(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    sa = _div(v.abs().amax(-1, keepdim=True), 127.0) + 1e-12
    return torch.clamp(torch.round(v / sa), -127, 127), sa


def _qdot(v: torch.Tensor, wt: torch.Tensor, ws: torch.Tensor,
          b: torch.Tensor = None) -> torch.Tensor:
    """W8A8 product: per-row activation quant, exact integer dot (float64),
    float32 rescale.  wt is output-major [N, K] int8."""
    aq, sa = _quant_rows(v)
    acc = (aq.double() @ wt.double().T).float()
    y = acc * sa * ws
    return y + b if b is not None else y


def _qdot4(v: torch.Tensor, w4: torch.Tensor, s: torch.Tensor,
           b: torch.Tensor = None) -> torch.Tensor:
    """W4A8 product (`_kernel_w4.qdot4`): per-row activation quant, exact
    integer dot per 128-row input group (float64), then in float32 over the
    group pairs y = y + acc_lo·s_lo + acc_hi·s_hi, y·sa, + b.  w4 [K/2, N]
    int8 in JAX's packing (byte j·128 + i of a column: row (2j)·128 + i in
    the low nibble, (2j+1)·128 + i in the high one); s [K/128, N]."""
    aq, sa = _quant_rows(v)
    R, K = aq.shape
    P = K // (2 * W4_GROUP)
    wb = w4.reshape(P, W4_GROUP, -1).int()
    lo = ((wb << 28) >> 28).double()                # sign-extended nibbles
    hi = (wb >> 4).double()
    a = aq.reshape(R, P, 2, W4_GROUP).double()
    acc_lo = torch.einsum("rpi,pin->rpn", a[:, :, 0], lo).float()
    acc_hi = torch.einsum("rpi,pin->rpn", a[:, :, 1], hi).float()
    y = torch.zeros(R, w4.shape[-1], device=v.device)
    for j in range(P):
        y = y + acc_lo[:, j] * s[2 * j] + acc_hi[:, j] * s[2 * j + 1]
    y = y * sa
    return y + b if b is not None else y


def _layer_products(packed: Params, l: int, d: int, vec: torch.Tensor):
    """Layer l's four products (qkv, proj, fc, pj) as functions of their
    input, from int8 (pack_decode_weights), six-stream int8
    (pack_fused_oar_v4, input-major: fc in column halves, pj in row halves)
    or W4A8 (pack_fused_oar_w4) packing."""
    off = vec_offsets(d)

    def v_(name):
        a, b = off[name]
        return vec[a:b]

    if "wqp4" in packed:
        G = d // W4_GROUP
        sc = packed["scales4"][l]
        wqp, wfc, wpj = (packed[k][l] for k in ("wqp4", "wfc4", "wpj4"))
        s_pj = sc[2 * G:3 * G].reshape(4 * G, d)    # group g: row g//4 ...
        return (lambda a: _qdot4(a, wqp[:, :3 * d], sc[:G, :3 * d],
                                 v_("qkv_b")),
                lambda y: _qdot4(y, wqp[:, 3 * d:], sc[:G, 3 * d:],
                                 v_("proj_b")),
                lambda a: _qdot4(a, wfc, sc[G:2 * G]),
                lambda a: _qdot4(a, wpj, s_pj))
    if "wfca" in packed:
        wfc = torch.cat([packed["wfca"][l], packed["wfcb"][l]], dim=1)
        wpj = torch.cat([packed["wpja"][l], packed["wpjb"][l]], dim=0)
        return (lambda a: _qdot(a, packed["wqkv"][l].T, v_("qkv_ws"),
                                v_("qkv_b")),
                lambda y: _qdot(y, packed["wproj"][l].T, v_("proj_ws"),
                                v_("proj_b")),
                lambda a: _qdot(a, wfc.T, v_("fc_ws")),
                lambda a: _qdot(a, wpj.T, v_("pj_ws")))
    return (lambda a: _qdot(a, packed["wqkv"][l], v_("qkv_ws"), v_("qkv_b")),
            lambda y: _qdot(y, packed["wproj"][l], v_("proj_ws"),
                            v_("proj_b")),
            lambda a: _qdot(a, packed["wfc"][l], v_("fc_ws")),
            lambda a: _qdot(a, packed["wpj"][l], v_("pj_ws")))


def _gelu_as(x: torch.Tensor) -> torch.Tensor:
    """x·0.5·(1 + erf(x/√2)) with the reference kernel's A&S erf."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    z = _div(x, 1.41421353816986083984375)
    ax = z.abs()
    t = 1.0 / (1.0 + p * ax)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t \
        * torch.exp(-ax * ax)
    return x * 0.5 * (1.0 + torch.sign(z) * y)


def _bf16_add(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (h.to(torch.bfloat16) + y.to(torch.bfloat16)).float()


def decode_step_plain(packed: Params, x: torch.Tensor, kv_k: torch.Tensor,
                      kv_v: torch.Tensor, cache_len: int, n_head: int,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      block_s: int = 0, prefer=V5_BLOCKS,
                      head_scale: bool = False, rows_f32: bool = False
                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch; writes the new rows into
    kv_k/kv_v in place and returns h [B, Q, d] bf16.  `block_s` / `prefer`
    choose the S-blocks (`pick_block_s`); `head_scale` quantizes the queries
    with one scale per (scene, head) instead of one per scene (`_kernel_v7`);
    `rows_f32` puts the new rows on the int8 grid from their float32 values
    instead of their bf16 rounding (`_kernel_v6`).  With k_scale/v_scale
    [L, B, S, H] the caches are int4 nibble pairs [L, B, S, HD/2]
    (`_kernel_v5i4`, `_kernel_mq` with int4=True): integer logits against
    the sign-extended nibbles, logits = li·ks·(sq·scale/7), softmax weights
    pv = bf16(p·vs·(1/7)) against the nibbles, and the new rows quantized
    per (row, head) from their bf16 rounding, scales written too."""
    int4 = k_scale is not None
    L, B, S, HD = kv_k.shape
    if int4:
        HD = 2 * HD
    _, Q, d = x.shape
    H = n_head
    Dh = HD // H
    cl = int(cache_len)
    scale = 1.0 / math.sqrt(Dh)
    cq = scale / 7.0 if int4 else scale / KV_INT8_SCALE
    bs = pick_block_s(S, block_s, prefer)
    off = vec_offsets(d)
    vecs = packed["vec"].reshape(L, -1)     # JAX's W4 packing: [L, 1, V]
    h = x.reshape(B * Q, d).float()
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                   device=x.device))
    for l in range(L):
        vec = vecs[l]

        def v_(name):
            a, b = off[name]
            return vec[a:b]

        mm_qkv, mm_proj, mm_fc, mm_pj = _layer_products(packed, l, d, vec)
        qkv = mm_qkv(_ln(h, v_("ln1")))
        q, k_new, v_new = qkv.split(HD, dim=-1)
        # queries: one int8 scale per scene over its Q rows, or one per
        # (scene, head); sq broadcasts over [B, Q, H, Dh]
        qh = q.reshape(B, Q, H, Dh)
        amax = (qh.abs().amax(dim=(1, 3)) if head_scale
                else qh.abs().amax(dim=(1, 2, 3))[:, None].expand(B, H))
        sq = (_div(amax, 127.0) + 1e-12)[:, None, :, None]
        qp = torch.clamp(torch.round(qh / sq), -127, 127)
        kh = k_new.reshape(B, Q, H, Dh)
        vh = v_new.reshape(B, Q, H, Dh)
        # intra-chunk causal term initializes the flash state; its dot
        # products over Dh and its sums over the chunk's keys are taken one
        # term at a time, in the kernel's order (the reference sums over
        # the keys in that order too)
        qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (qh, kh, vh))
        lij = torch.zeros(B, H, Q, Q, device=x.device)
        for i in range(Dh):
            lij = lij + qt[..., :, None, i] * kt[..., None, :, i]
        lij = (lij * scale).masked_fill(~causal, float("-inf"))
        m = lij.amax(-1)                                           # [B,H,Q]
        p0 = torch.exp(lij - m[..., None])
        den = torch.zeros_like(m)
        acc = torch.zeros_like(qt)                                 # [B,H,Q,Dh]
        for j in range(Q):
            den = den + p0[..., j]
            acc = acc + p0[..., j, None] * vt[:, :, None, j]
        # S-blocks of the cached prefix, online softmax as the reference
        fac = (sq * cq).permute(0, 2, 1, 3)                # [B, H, 1, 1]
        qpd = qp.double()
        for s0 in range(0, cl, bs):
            s1 = min(s0 + bs, S)
            kb, vb = kv_k[l, :, s0:s1], kv_v[l, :, s0:s1]
            if int4:
                kb, vb = unpack_kv_int4(kb), unpack_kv_int4(vb)
                # [B, s, H] → [B, H, 1, s]
                ksb = k_scale[l, :, s0:s1].permute(0, 2, 1)[:, :, None]
                vsb = v_scale[l, :, s0:s1].permute(0, 2, 1)[:, :, None]
            kb = kb.reshape(B, s1 - s0, H, Dh).double()
            li = torch.einsum("bshd,bqhd->bhqs", kb, qpd).float()
            logits = li * ksb * fac if int4 else li * fac
            pos = torch.arange(s0, s1, device=x.device)
            logits = logits.masked_fill(pos >= cl, float("-inf"))
            m_new = torch.maximum(m, logits.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            den = den * corr + p.sum(-1)
            if int4:      # the value scales folded into the weights
                pv = p * vsb * (1.0 / 7.0)
                vb = vb.float()
            else:
                pv = p
                vb = vb.float() * (1.0 / KV_INT8_SCALE)
            part = torch.einsum("bhqs,bshd->bhqd",
                                pv.to(torch.bfloat16).float(),
                                vb.reshape(B, s1 - s0, H, Dh))
            acc = acc * corr[..., None] + part
            m = m_new
        y = (acc / den[..., None]).permute(0, 2, 1, 3).reshape(B * Q, HD)

        h = _bf16_add(h, mm_proj(y))
        hid = _gelu_as(mm_fc(_ln(h, v_("ln2"))))
        h = _bf16_add(h, mm_pj(hid))

        if int4:
            for new, cache, plane in ((k_new, kv_k, k_scale),
                                      (v_new, kv_v, v_scale)):
                rows, sc = quantize_kv_int4(
                    new.to(torch.bfloat16).reshape(B, Q, HD), H)
                cache[l, :, cl:cl + Q] = rows
                plane[l, :, cl:cl + Q] = sc
        else:
            # v6 puts the rows on the grid from float32, the rest from bf16
            for new, cache in ((k_new, kv_k), (v_new, kv_v)):
                rows = new if rows_f32 else new.to(torch.bfloat16)
                cache[l, :, cl:cl + Q] = kv_store(rows).reshape(B, Q, HD)
    return h.to(torch.bfloat16).reshape(B, Q, d)


def decode_step_dense_plain(packed: Params, x: torch.Tensor,
                            kv_k: torch.Tensor, kv_v: torch.Tensor,
                            cache_len: int, n_head: int,
                            whole_s: bool = False) -> torch.Tensor:
    """The dense-cache step (`_kernel_v2`; `_kernel` with `whole_s`) in
    plain PyTorch: x [B, 1, d], caches [L, B, S, H·Dh] bf16, float8_e4m3fn
    or int8 on the 1/16 grid, read as bf16.  The new rows are written in
    place at cache_len; returns h [B, 1, d] bf16.

    The reference's rounding points: q to bf16; every product k·q to bf16,
    a head's sum in float32, × scale; the self logit from bf16(k_new·q).
    Blocked (v2): the self term seeds a float32 flash state (m = self logit,
    den = 1, acc = v_new); per S-block (`pick_block_s` with V2_BLOCKS) the
    unnormalized weights p round to bf16, bf16(p)·v rounds to bf16, the
    block's rows sum in float32 and the sum rounds to bf16; the running
    rescale exp(m − m') and the final denominator round to bf16 too.
    `whole_s` (v1): one block over all rows, the normalized weights
    ep / denom round to bf16, the rows' sum rounds to bf16, and the self
    term adds bf16(es / denom)·v_new in float32."""
    L, B, S, HD = kv_k.shape
    d = x.shape[-1]
    H = n_head
    Dh = HD // H
    cl = int(cache_len)
    scale = 1.0 / math.sqrt(Dh)
    bs = S if whole_s else pick_block_s(S, prefer=V2_BLOCKS)
    bf = torch.bfloat16
    off = vec_offsets(d)
    vecs = packed["vec"].reshape(L, -1)
    h = x.reshape(B, d).float()

    def lanes(t):                     # [..., H] → [..., H·Dh]
        return t.repeat_interleave(Dh, dim=-1)

    def pooled(t):                    # [..., H·Dh] → [..., H] float32 sums
        return t.float().reshape(*t.shape[:-1], H, Dh).sum(-1)

    for l in range(L):
        vec = vecs[l]

        def v_(name):
            a, b = off[name]
            return vec[a:b]

        mm_qkv, mm_proj, mm_fc, mm_pj = _layer_products(packed, l, d, vec)
        q, k_new, v_new = mm_qkv(_ln(h, v_("ln1"))).split(HD, dim=-1)
        qb = q.to(bf)[:, None]                                   # [B, 1, HD]
        self_logit = pooled((k_new * q).to(bf)) * scale          # [B, H]

        def block(s0, s1):
            """logits [B, s, H] and bf16 values [B, s, HD] of rows s0:s1"""
            kmat = kv_load(kv_k[l, :, s0:s1], bf)
            return pooled(kmat * qb) * scale, kv_load(kv_v[l, :, s0:s1], bf)

        if whole_s:
            logits, vmat = block(0, cl)
            m = torch.maximum(logits.amax(1), self_logit) if cl \
                else self_logit
            ep = torch.exp(logits - m[:, None])
            es = torch.exp(self_logit - m)
            denom = ep.sum(1) + es
            wp = (ep / denom[:, None]).to(bf)
            mixed = (lanes(wp) * vmat).float().sum(1).to(bf).float()
            y = mixed + lanes((es / denom).to(bf).float()) * v_new
        else:
            m, den, acc = self_logit, torch.ones_like(self_logit), v_new
            for s0 in range(0, cl, bs):
                logits, vmat = block(s0, min(s0 + bs, cl))
                m_new = torch.maximum(m, logits.amax(1))
                corr = torch.exp(m - m_new)
                p = torch.exp(logits - m_new[:, None])
                den = den * corr + p.sum(1)
                mix = (lanes(p.to(bf)) * vmat).float().sum(1).to(bf).float()
                acc = acc * lanes(corr.to(bf).float()) + mix
                m = m_new
            y = acc / lanes(den.to(bf).float())

        h = _bf16_add(h, mm_proj(y))
        hid = _gelu_as(mm_fc(_ln(h, v_("ln2"))))
        h = _bf16_add(h, mm_pj(hid))
        kv_k[l, :, cl] = kv_store(k_new.to(bf), kv_k.dtype)
        kv_v[l, :, cl] = kv_store(v_new.to(bf), kv_v.dtype)
    return h.to(bf).reshape(B, 1, d)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
_ARGS_HEAD = [_cuda.VOIDP, _cuda.VOIDP] + [_cuda.INT] * 5 + [_cuda.VOIDP]
_ARGS_KV = [_cuda.VOIDP] * 2 + [_cuda.INT64] * 2     # two arrays, two strides
_ARGS_TAIL = ([_cuda.INT, _cuda.INT, _cuda.FLOAT, _cuda.FLOAT]
              + [_cuda.VOIDP, _cuda.VOIDP])
# C entry by (W4A8 weights, int4 cache)
_ENTRIES = {(False, False): "umgen_decode_step",
            (True, False): "umgen_decode_step_w4",
            (False, True): "umgen_decode_step_i4",
            (True, True): "umgen_decode_step_w4_i4"}


# flags of `umgen_decode_step` (int8 weights on the int8 cache)
FLAG_HEAD_SCALE = 1      # one query scale per (scene, head): v7
FLAG_ROWS_F32 = 2        # new rows quantized from float32: v6
# storage codes of `umgen_decode_step_dense`
_DENSE_CODE = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.int8: 2}


def _argtypes(w4: bool, int4: bool):
    """int8 weights on the int8 cache take the flags and the S-block rows,
    the other three entries the S-block rows."""
    tail = [_cuda.INT] if w4 or int4 else [_cuda.INT, _cuda.INT]
    return (_ARGS_HEAD + [_cuda.VOIDP] * (2 if w4 else 4)
            + _ARGS_KV * (2 if int4 else 1) + _ARGS_TAIL + tail)


def _require_cache(name: str, k: torch.Tensor, v: torch.Tensor,
                   dtype: torch.dtype, row: int, align: int) -> None:
    """k/v [L, B, S, row]: CUDA tensors of `dtype` with the same strides,
    contiguous rows, and layers and scenes `align` bytes apart (views of a
    longer cache pass)."""
    if v.shape != k.shape or v.stride() != k.stride():
        raise ValueError(f"decode kernel: the K and V {name} must have the "
                         "same shape and strides")
    for t in (k, v):
        if not t.is_cuda or t.dtype != dtype:
            raise ValueError(f"decode kernel: {name} must be CUDA {dtype}")
        nbytes = t.element_size()
        if t.stride(3) != 1 or t.stride(2) != row or t.data_ptr() % align \
                or t.stride(0) * nbytes % align \
                or t.stride(1) * nbytes % align:
            raise ValueError(f"decode kernel: {name} rows must be "
                             f"contiguous and {align}-byte aligned")


def decode_step_cuda(packed: Params, x: torch.Tensor, kv_k: torch.Tensor,
                     kv_v: torch.Tensor, cache_len: int, n_head: int,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     flags: int = 0, block_s: int = 0) -> torch.Tensor:
    """Launch csrc/decode_step.cu (int8 or W4A8 weights, as packed; int8
    caches, or int4 ones when the scale planes are given); new rows written
    in place.  `flags` (FLAG_HEAD_SCALE, FLAG_ROWS_F32) exist for int8
    weights on the int8 cache only.  `block_s`: the rows of the prefix
    attention's S-blocks (`pick_block_s` of it; 0: v5's)."""
    int4 = k_scale is not None
    L, B, S, row = kv_k.shape
    HD = 2 * row if int4 else row
    _, Q, d = x.shape
    H = n_head
    cl = int(cache_len)
    w4 = "wqp4" in packed
    if flags and (w4 or int4):
        raise ValueError("decode kernel: the per-head query scale and the "
                         "float32 row store exist for int8 weights on the "
                         "int8 cache only")
    if HD != d or d % H or (d // H) not in (16, 48) or d % 16 or d > 768:
        raise ValueError(f"decode kernel: unsupported widths d={d}, "
                         f"H={H}, cache row {row}")
    if int4 and H % 2:
        raise ValueError("int4 decode kernel: the halves layout pairs head "
                         f"h with h + H/2 and needs an even H, got {H}")
    if w4 and (d % (2 * W4_GROUP) or d > 768):
        raise ValueError(f"W4A8 decode kernel: d={d} must be a multiple of "
                         f"{2 * W4_GROUP} and at most 768")
    if Q > MAX_Q or Q * H > 128:
        raise ValueError(f"decode kernel takes Q <= {MAX_Q}, Q*H <= 128; "
                         f"got Q={Q}, H={H}")
    if not 0 <= cl <= S - Q:
        raise ValueError(f"cache_len {cl} + Q {Q} exceeds {S} cache rows")
    _require_cache("caches", kv_k, kv_v, torch.int8, row, 16)
    kv_args = [kv_k.data_ptr(), kv_v.data_ptr(), kv_k.stride(0),
               kv_k.stride(1)]
    if int4:
        if v_scale is None or tuple(k_scale.shape) != (L, B, S, H):
            raise ValueError(f"int4 decode kernel: scale planes must be "
                             f"{(L, B, S, H)}, got {tuple(k_scale.shape)}")
        _require_cache("scale planes", k_scale, v_scale, torch.float32, H, 4)
        kv_args += [k_scale.data_ptr(), v_scale.data_ptr(),
                    k_scale.stride(0), k_scale.stride(1)]
    x = x.contiguous()
    vec = packed["vec"].reshape(L, -1)
    _cuda.require(x, torch.bfloat16, "decode kernel x", align=4)
    _cuda.require(vec, torch.float32, "decode kernel vec", 4)
    if vec.shape[1] != vec_offsets(d)["__total__"]:
        raise ValueError(f"packed vec {tuple(vec.shape)} does not match d={d}")
    weights = _kernel_weights(packed, L, d)
    ws = _workspace(B, Q, d, H, S, x.device)
    out = torch.empty_like(x)
    scale = 1.0 / math.sqrt(d // H)
    bs = pick_block_s(S, block_s)
    tail = [bs] if w4 or int4 else [flags, bs]
    fn = _cuda.function(_ENTRIES[w4, int4], _argtypes(w4, int4))
    err = fn(x.data_ptr(), out.data_ptr(), B, Q, d, H, L, vec.data_ptr(),
             *(t.data_ptr() for t in weights), *kv_args, S, cl, scale,
             scale / (7.0 if int4 else KV_INT8_SCALE), ws.data_ptr(),
             _cuda.stream_ptr(x), *tail)
    _cuda.check(err, "fused decode step")
    return out


def _kernel_weights(packed: Params, L: int, d: int):
    """The weight arrays csrc/decode_step.cu reads, checked against L and
    d: (w4k, s4k) of a W4A8 packing, else the four output-major int8
    matrices."""
    if "wqp4" in packed:
        if "w4k" not in packed:
            raise ValueError("W4A8 packing without the kernel layout: add it "
                             "with runtime.quantize.w4_kernel_layout")
        weights = (packed["w4k"], packed["s4k"])
        _cuda.require(weights[0], torch.int8, "decode kernel w4k")
        _cuda.require(weights[1], torch.float32, "decode kernel s4k", 4)
        expect = [(L, 6 * d * d), (L, 12 * d * (d // W4_GROUP))]
    else:
        weights = tuple(packed[n] for n in ("wqkv", "wproj", "wfc", "wpj"))
        for name, t in zip(("wqkv", "wproj", "wfc", "wpj"), weights):
            _cuda.require(t, torch.int8, f"decode kernel {name}")
        expect = [(L, 3 * d, d), (L, d, d), (L, 4 * d, d), (L, d, 4 * d)]
    if [tuple(t.shape) for t in weights] != expect:
        raise ValueError(f"packed weights {[tuple(t.shape) for t in weights]}"
                         f" do not match L={L}, d={d}")
    return weights


def _workspace(B: int, Q: int, d: int, H: int, S: int, device
               ) -> torch.Tensor:
    lib = _cuda.load()
    lib.umgen_decode_workspace_bytes.argtypes = [_cuda.INT] * 5
    lib.umgen_decode_workspace_bytes.restype = _cuda.INT64
    nbytes = lib.umgen_decode_workspace_bytes(B, Q, d, H, S)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def decode_step_dense_cuda(packed: Params, x: torch.Tensor,
                           kv_k: torch.Tensor, kv_v: torch.Tensor,
                           cache_len: int, n_head: int,
                           whole_s: bool = False) -> torch.Tensor:
    """Launch `umgen_decode_step_dense` of csrc/decode_step.cu: int8
    weights, caches [L, B, S, H·Dh] bf16, float8_e4m3fn or int8 on the 1/16
    grid read as bf16; the new row written in place.  The kernel keeps the
    plain version's S-blocks (`pick_block_s` with V2_BLOCKS, or the whole
    of S)."""
    L, B, S, HD = kv_k.shape
    _, Q, d = x.shape
    H = n_head
    cl = int(cache_len)
    if kv_k.dtype not in _DENSE_CODE:
        raise ValueError(f"dense decode kernel: cache dtype {kv_k.dtype} "
                         "(takes bfloat16, float8_e4m3fn, int8)")
    if "wqp4" in packed:
        raise ValueError("dense decode kernel: takes int8 packed weights, "
                         "got W4A8 ones")
    if Q != 1:
        raise ValueError(f"dense decode kernel takes one row per scene, got "
                         f"Q={Q}")
    if HD != d or d % H or (d // H) not in (16, 48) or d % 16 or d > 768:
        raise ValueError(f"dense decode kernel: unsupported widths d={d}, "
                         f"H={H}, cache row {HD}")
    if whole_s and (H < 4 or H > 32 or H & (H - 1)):
        raise ValueError(f"dense decode kernel, one block (v1): n_head {H} "
                         "must be a power of two in [4, 32]")
    if not 0 <= cl <= S - 1:
        raise ValueError(f"cache_len {cl} + 1 exceeds {S} cache rows")
    _require_cache("caches", kv_k, kv_v, kv_k.dtype, HD, 16)
    x = x.contiguous()
    vec = packed["vec"].reshape(L, -1)
    _cuda.require(x, torch.bfloat16, "decode kernel x", align=4)
    _cuda.require(vec, torch.float32, "decode kernel vec", 4)
    if vec.shape[1] != vec_offsets(d)["__total__"]:
        raise ValueError(f"packed vec {tuple(vec.shape)} does not match d={d}")
    weights = _kernel_weights(packed, L, d)
    ws = _workspace(B, Q, d, H, S, x.device)
    out = torch.empty_like(x)
    bs = S if whole_s else pick_block_s(S, prefer=V2_BLOCKS)
    fn = _cuda.function(
        "umgen_decode_step_dense",
        _ARGS_HEAD + [_cuda.VOIDP] * 4 + _ARGS_KV
        + [_cuda.INT, _cuda.INT, _cuda.FLOAT, _cuda.INT, _cuda.INT,
           _cuda.INT, _cuda.VOIDP, _cuda.VOIDP])
    err = fn(x.data_ptr(), out.data_ptr(), B, Q, d, H, L, vec.data_ptr(),
             *(t.data_ptr() for t in weights), kv_k.data_ptr(),
             kv_v.data_ptr(), kv_k.stride(0) * kv_k.element_size(),
             kv_k.stride(1) * kv_k.element_size(), S, cl,
             1.0 / math.sqrt(d // H), _DENSE_CODE[kv_k.dtype], bs,
             int(whole_s), ws.data_ptr(), _cuda.stream_ptr(x))
    _cuda.check(err, "fused dense decode step")
    return out


def _flat(name: str, kv: torch.Tensor) -> torch.Tensor:
    """The flat [L, B, S, H·Dh] view of a 5-D cache [L, B, S, H, Dh] (the
    reference's layout for v1-v4).  Here 5-D is a view of the flat storage:
    a cache whose rows are not H·Dh contiguous values is refused."""
    if kv.ndim == 4:
        return kv
    try:
        if kv.ndim != 5:
            raise RuntimeError
        return kv.view(*kv.shape[:3], -1)
    except RuntimeError:
        raise ValueError(
            f"{name}: the cache must be [L, B, S, H, Dh] with each row's "
            f"H·Dh values contiguous (a view of flat storage); got shape "
            f"{tuple(kv.shape)}, strides {kv.stride()}") from None


def _step(name: str, packed: Params, x: torch.Tensor, kv_k: torch.Tensor,
          kv_v: torch.Tensor, cache_len, n_head: int,
          k_scale: Optional[torch.Tensor] = None,
          v_scale: Optional[torch.Tensor] = None, block_s: int = 0,
          prefer=V5_BLOCKS, head_scale: bool = False,
          rows_f32: bool = False):
    """The integer-logit wrapper named `name` (fused_decode_step_
    {v5|w4}[mq][i4], _v3, _v4, _v6, _v7): checks Q and the packing against
    the name, then launches the kernel (CUDA tensors) or runs the plain
    version (CPU tensors).  The caches are flat, written in place, and
    returned as they were passed."""
    _cuda.refuse_autograd(name, packed, x, kv_k, kv_v, k_scale, v_scale)
    kind = name[len("fused_decode_step_"):]
    Q = x.shape[1]
    if "mq" in kind and (Q < 2 or Q * n_head > 128):
        raise ValueError(f"{name} needs 1 < Q and Q*H <= 128, got Q={Q}, "
                         f"H={n_head}")
    if "mq" not in kind and Q != 1:
        raise ValueError(f"{name} takes one row per scene, got Q={Q}")
    w4 = kind.startswith("w4")
    if w4 != ("wqp4" in packed):
        kinds = ("int8 (pack_fused)", "W4A8 (pack_fused_w4)")
        raise ValueError(f"{name} takes {kinds[w4]} packed weights, got "
                         f"{kinds[not w4]} ones")
    if kind.endswith("i4") and (k_scale is None or v_scale is None):
        raise ValueError(f"{name} needs the int4 cache's scale planes")
    if kv_k.dtype != torch.int8:
        raise ValueError(f"{name} requires int8 KV storage, got "
                         f"{kv_k.dtype}")
    # one blocking for both sides: `pick_block_s` of its own choice is that
    # choice, so the plain version, handed it as block_s, walks these blocks
    bs = pick_block_s(kv_k.shape[2], block_s, prefer)
    if x.is_cuda:
        flags = FLAG_HEAD_SCALE * head_scale + FLAG_ROWS_F32 * rows_f32
        h = decode_step_cuda(packed.get("kernel", packed), x, kv_k, kv_v,
                             cache_len, n_head, k_scale, v_scale, flags, bs)
        LAUNCHES[name] += 1
    else:
        h = decode_step_plain(packed, x, kv_k, kv_v, cache_len, n_head,
                              k_scale, v_scale, bs, prefer, head_scale,
                              rows_f32)
    if k_scale is None:
        return h, kv_k, kv_v
    return h, kv_k, kv_v, k_scale, v_scale


def _dense_step(name: str, packed: Params, x: torch.Tensor,
                kv_k: torch.Tensor, kv_v: torch.Tensor, cache_len,
                n_head: int, whole_s: bool):
    """The dense-cache wrapper named `name` (fused_decode_step, _v2):
    launches `umgen_decode_step_dense` (CUDA tensors) or runs
    `decode_step_dense_plain` (CPU tensors) on the flat view of the
    caches."""
    _cuda.refuse_autograd(name, packed, x, kv_k, kv_v)
    if x.shape[1] != 1:
        raise ValueError(f"{name} takes one row per scene, got "
                         f"Q={x.shape[1]}")
    served = DENSE_KV_DTYPES[:2] if whole_s else DENSE_KV_DTYPES
    if kv_k.dtype not in served or kv_v.dtype != kv_k.dtype:
        raise ValueError(
            f"{name} takes caches of "
            f"{', '.join(str(t)[6:] for t in served)}; got {kv_k.dtype} "
            "(the reference reads every other type as if it were fp8)")
    fk, fv = _flat(name, kv_k), _flat(name, kv_v)
    if x.is_cuda:
        h = decode_step_dense_cuda(packed, x, fk, fv, cache_len, n_head,
                                   whole_s)
        LAUNCHES[name] += 1
    else:
        h = decode_step_dense_plain(packed, x, fk, fv, cache_len, n_head,
                                    whole_s)
    return h, kv_k, kv_v


# int8 packings of unpacked OAR params, by the id of their qkv weight: v1
# takes `params["oar"]` itself, and packs it once, not once a step
_V1_PACKED: Dict[int, Tuple[Any, Params]] = {}


def _packed_once(oar_params: Params) -> Params:
    wq = oar_params["attn"]["qkv"]["wq"]
    key = id(wq)
    hit = _V1_PACKED.get(key)
    if hit is None or hit[0]() is not wq:
        ref = weakref.ref(wq, lambda _, k=key: _V1_PACKED.pop(k, None))
        hit = _V1_PACKED[key] = (ref, pack_decode_weights(oar_params))
    return hit[1]


def fused_decode_step(oar_params: Params, x: torch.Tensor,
                      kv_k: torch.Tensor, kv_v: torch.Tensor, cache_len,
                      n_head: int):
    """v1: x [B, 1, d]; kv_k/kv_v [L, B, S, H, Dh] (or flat) in bf16 or
    float8_e4m3fn; `oar_params` the int8-quantized, UNPACKED `params["oar"]`
    (packed for the kernel at the first call and kept while the weights
    live).  One softmax over the whole of S, its normalized weights rounded
    to bf16.  Returns (h [B, 1, d] bf16 before ln_oar, kv_k, kv_v), the
    caches those passed, the new row written in place."""
    if "wq" not in oar_params["attn"]["qkv"]:
        raise ValueError("fused_decode_step requires int8-quantized OAR "
                         "params (run quantize_params_int8 first)")
    return _dense_step("fused_decode_step", _packed_once(oar_params), x,
                       kv_k, kv_v, cache_len, n_head, whole_s=True)


def fused_decode_step_v2(packed: Params, x: torch.Tensor,
                         kv_k: torch.Tensor, kv_v: torch.Tensor, cache_len,
                         n_head: int):
    """v2: as v1 with packed weights (pack_fused), caches in bf16, int8 on
    the 1/16 grid (dequantized to bf16, not v5's integer logits) or
    float8_e4m3fn, and a flash accumulation over S-blocks whose
    unnormalized weights round to bf16."""
    return _dense_step("fused_decode_step_v2", packed, x, kv_k, kv_v,
                       cache_len, n_head, whole_s=False)


def _step_5d(name: str, packed: Params, x, kv_k, kv_v, cache_len, n_head,
             block_s: int = 0):
    """v3 / v4: v5's arithmetic on the reference's 5-D int8 cache, whose
    memory is the flat cache's; S-blocks from V2_BLOCKS."""
    if kv_k.ndim != 5 or kv_v.ndim != 5:
        raise ValueError(f"{name} takes 5-D caches [L, B, S, H, Dh], got "
                         f"{tuple(kv_k.shape)}")
    h, _, _ = _step(name, packed, x, _flat(name, kv_k), _flat(name, kv_v),
                    cache_len, n_head, block_s=block_s, prefer=V2_BLOCKS)
    return h, kv_k, kv_v


def fused_decode_step_v3(packed: Params, x: torch.Tensor,
                         kv_k: torch.Tensor, kv_v: torch.Tensor, cache_len,
                         n_head: int):
    """v3: the v5 step on 5-D int8 caches [L, B, S, H, Dh] (a contiguous
    5-D cache is the flat cache's memory: the kernel runs on the view).
    Returns (h, kv_k, kv_v), the 5-D caches passed, written in place."""
    if "wfca" in packed:
        raise ValueError("fused_decode_step_v3 takes pack_fused's blocks, "
                         "got the six-stream ones of version='v4'")
    return _step_5d("fused_decode_step_v3", packed, x, kv_k, kv_v,
                    cache_len, n_head)


def fused_decode_step_v4(packed: Params, x: torch.Tensor,
                         kv_k: torch.Tensor, kv_v: torch.Tensor, cache_len,
                         n_head: int, block_s: int = 0):
    """v4: as v3 with `pack_fused_oar_v4`'s six weight streams (wqkv, wproj,
    wfca | wfcb, wpja | wpjb, input-major, which the plain version reads)
    and, under "kernel", the output-major layout the CUDA kernel reads."""
    if "wfca" not in packed:
        raise ValueError("fused_decode_step_v4 takes the six-stream blocks "
                         "of pack_fused(version='v4')")
    return _step_5d("fused_decode_step_v4", packed, x, kv_k, kv_v,
                    cache_len, n_head, block_s)


def fused_decode_step_v6(packed: Params, x: torch.Tensor,
                         kv_k: torch.Tensor, kv_v: torch.Tensor, cache_len,
                         n_head: int, block_s: int = 0):
    """v6: the v5 step on flat int8 caches with the new row put on the 1/16
    grid from its float32 value (v5 rounds it to bf16 first).  The caches
    passed are consumed: they are appended to in place and returned, as
    every step of this package does."""
    if kv_k.ndim != 4:
        raise ValueError("fused_decode_step_v6 requires flat [L, B, S, H*Dh]"
                         " int8 KV storage")
    return _step("fused_decode_step_v6", packed, x, kv_k, kv_v, cache_len,
                 n_head, block_s=block_s, rows_f32=True)


def fused_decode_step_v7(packed: Params, x: torch.Tensor,
                         kv_k: torch.Tensor, kv_v: torch.Tensor, cache_len,
                         n_head: int, block_s: int = 0):
    """v7: the v5 step with one query scale per (scene, head) instead of one
    per scene, on flat int8 caches.  Any B (the reference's B·H <= 128 is
    its lane tile; `Rollout.oar_step` keeps it as the routing rule)."""
    if kv_k.ndim != 4:
        raise ValueError("fused_decode_step_v7 requires flat [L, B, S, H*Dh]"
                         " int8 KV storage")
    return _step("fused_decode_step_v7", packed, x, kv_k, kv_v, cache_len,
                 n_head, block_s=block_s, head_scale=True)


def fused_decode_step_v5(packed: Params, x: torch.Tensor,
                         kv_k: torch.Tensor, kv_v: torch.Tensor,
                         cache_len, n_head: int):
    """One token per scene: x [B, 1, d] → (h [B, 1, d], kv_k, kv_v)."""
    return _step("fused_decode_step_v5", packed, x, kv_k, kv_v, cache_len,
                 n_head)


def fused_decode_step_v5mq(packed: Params, x: torch.Tensor,
                           kv_k: torch.Tensor, kv_v: torch.Tensor,
                           cache_len, n_head: int):
    """Q rows per scene, 1 < Q·n_head <= 128, causal within the chunk."""
    return _step("fused_decode_step_v5mq", packed, x, kv_k, kv_v, cache_len,
                 n_head)


def fused_decode_step_w4(packed: Params, x: torch.Tensor,
                         kv_k: torch.Tensor, kv_v: torch.Tensor,
                         cache_len, n_head: int):
    """`fused_decode_step_v5` with W4A8 weights (pack_fused_w4)."""
    return _step("fused_decode_step_w4", packed, x, kv_k, kv_v, cache_len,
                 n_head)


def fused_decode_step_w4mq(packed: Params, x: torch.Tensor,
                           kv_k: torch.Tensor, kv_v: torch.Tensor,
                           cache_len, n_head: int):
    """`fused_decode_step_v5mq` with W4A8 weights (pack_fused_w4)."""
    return _step("fused_decode_step_w4mq", packed, x, kv_k, kv_v, cache_len,
                 n_head)


def fused_decode_step_v5i4(packed: Params, x: torch.Tensor,
                           kv_k: torch.Tensor, kv_v: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           cache_len, n_head: int):
    """`fused_decode_step_v5` on the int4 cache: kv_k/kv_v [L, B, S, HD/2]
    nibble pairs, k_scale/v_scale [L, B, S, H] float32 → (h, kv_k, kv_v,
    k_scale, v_scale), the new row quantized and written at cache_len."""
    return _step("fused_decode_step_v5i4", packed, x, kv_k, kv_v, cache_len,
                 n_head, k_scale, v_scale)


def fused_decode_step_w4i4(packed: Params, x: torch.Tensor,
                           kv_k: torch.Tensor, kv_v: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           cache_len, n_head: int):
    """`fused_decode_step_v5i4` with W4A8 weights (pack_fused_w4)."""
    return _step("fused_decode_step_w4i4", packed, x, kv_k, kv_v, cache_len,
                 n_head, k_scale, v_scale)


def fused_decode_step_v5mqi4(packed: Params, x: torch.Tensor,
                             kv_k: torch.Tensor, kv_v: torch.Tensor,
                             k_scale: torch.Tensor, v_scale: torch.Tensor,
                             cache_len, n_head: int):
    """`fused_decode_step_v5mq` on the int4 cache (see v5i4)."""
    return _step("fused_decode_step_v5mqi4", packed, x, kv_k, kv_v,
                 cache_len, n_head, k_scale, v_scale)


def fused_decode_step_w4mqi4(packed: Params, x: torch.Tensor,
                             kv_k: torch.Tensor, kv_v: torch.Tensor,
                             k_scale: torch.Tensor, v_scale: torch.Tensor,
                             cache_len, n_head: int):
    """`fused_decode_step_v5mqi4` with W4A8 weights (pack_fused_w4)."""
    return _step("fused_decode_step_w4mqi4", packed, x, kv_k, kv_v,
                 cache_len, n_head, k_scale, v_scale)
