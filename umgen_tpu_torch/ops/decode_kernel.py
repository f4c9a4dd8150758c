"""Fused OAR decode step (port of umgen_tpu/ops/decode_kernel.py, the v5 and
W4A8 families on the flat int8 cache and on the nibble-packed int4 cache).

Replaces eight TPU kernels with one CUDA kernel family, csrc/decode_step.cu
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
    attention over the prefix and the store of the new rows differ.

The wrappers take `params["oar_packed"]` (runtime/quantize.pack_fused or
pack_fused_w4), x [B, Q, d] bf16 and the flat int8 caches [L, B, S, H·Dh]
(the JAX layout; views of a longer cache are accepted), and return (h
[B, Q, d] bf16 before the final layer norm, kv_k, kv_v).  The Q new K/V
rows are written into the caches at `cache_len` IN PLACE — the JAX package
writes them back functionally; the returned caches are the same tensors
that were passed.  Any B·Q is taken (the kernel tiles the rows).  The int4
wrappers take the packed caches [L, B, S, H·Dh/2] int8 and the scale planes
[L, B, S, H] float32 and return (h, kv_k, kv_v, k_scale, v_scale), all four
written in place.

For CUDA tensors the kernel launches or the wrapper raises.  For CPU
tensors the wrappers run `decode_step_plain`: the reference kernel's
arithmetic in plain PyTorch, including its S-block online softmax
(`pick_block_s`) and the bf16 rounding of the softmax weights, with the
integer products done exactly in float64 (float32 is not exact at
K = 3072).  The W4A8 plain version reads JAX's packed layout (wqp4, wfc4,
wpj4, scales4); the kernel reads the output-major repacking of the same
values (`w4k`, `s4k`, runtime/quantize.w4_kernel_layout).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from umgen_tpu_torch.ops import _cuda
from umgen_tpu_torch.runtime.quantize import W4_GROUP, vec_offsets

Params = Dict[str, Any]

KV_INT8_SCALE = 16.0     # fixed-grid int8 KV: step 1/16, range ±7.94
MAX_Q = 8
LAUNCHES = {"fused_decode_step_v5": 0, "fused_decode_step_v5mq": 0,
            "fused_decode_step_w4": 0, "fused_decode_step_w4mq": 0,
            "fused_decode_step_v5i4": 0, "fused_decode_step_v5mqi4": 0,
            "fused_decode_step_w4i4": 0, "fused_decode_step_w4mqi4": 0}


def pick_block_s(S: int, block_s: int = 0) -> int:
    """The reference kernel's S-block size for an S-row cache (the plain
    version reproduces its online-softmax blocking)."""
    bs = block_s if block_s and S % block_s == 0 else S
    if bs == S and not block_s:
        for cand in (552, 512, 416, 384, 368, 256):
            if S % cand == 0:
                return cand
    if bs == S:
        for cand in range(min(S, 640), 63, -8):
            if S % cand == 0:
                return cand
    return bs


def kv_store(x: torch.Tensor) -> torch.Tensor:
    """K/V activations → int8 cache rows: bf16-round, ×16, round, clip."""
    xf = x.to(torch.bfloat16).float() * KV_INT8_SCALE
    return torch.clamp(torch.round(xf), -127, 127).to(torch.int8)


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
    input, from int8 (pack_decode_weights) or W4A8 (pack_fused_oar_w4)
    packing."""
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
                      v_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch; writes the new rows into
    kv_k/kv_v in place and returns h [B, Q, d] bf16.  With k_scale/v_scale
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
    bs = pick_block_s(S)
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
        # queries: one int8 scale per scene over its Q rows
        qb = q.reshape(B, Q, HD)
        sq = _div(qb.abs().amax(dim=(1, 2)), 127.0) + 1e-12       # [B]
        qp = torch.clamp(torch.round(qb / sq[:, None, None]), -127, 127)
        qh = qb.reshape(B, Q, H, Dh)
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
        fac = (sq * cq)[:, None, None, None]
        qpd = qp.reshape(B, Q, H, Dh).double()
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
            kv_k[l, :, cl:cl + Q] = kv_store(k_new).reshape(B, Q, HD)
            kv_v[l, :, cl:cl + Q] = kv_store(v_new).reshape(B, Q, HD)
    return h.to(torch.bfloat16).reshape(B, Q, d)


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


def _argtypes(w4: bool, int4: bool):
    return (_ARGS_HEAD + [_cuda.VOIDP] * (2 if w4 else 4)
            + _ARGS_KV * (2 if int4 else 1) + _ARGS_TAIL)


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
                     v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Launch csrc/decode_step.cu (int8 or W4A8 weights, as packed; int8
    caches, or int4 ones when the scale planes are given); new rows written
    in place."""
    int4 = k_scale is not None
    L, B, S, row = kv_k.shape
    HD = 2 * row if int4 else row
    _, Q, d = x.shape
    H = n_head
    cl = int(cache_len)
    w4 = "wqp4" in packed
    if HD != d or d % H or (d // H) not in (16, 48) or d % 16:
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
    if w4:
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
    lib = _cuda.load()
    lib.umgen_decode_workspace_bytes.argtypes = [_cuda.INT] * 5
    lib.umgen_decode_workspace_bytes.restype = _cuda.INT64
    nbytes = lib.umgen_decode_workspace_bytes(B, Q, d, H, S)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    scale = 1.0 / math.sqrt(d // H)
    fn = _cuda.function(_ENTRIES[w4, int4], _argtypes(w4, int4))
    err = fn(x.data_ptr(), out.data_ptr(), B, Q, d, H, L, vec.data_ptr(),
             *(t.data_ptr() for t in weights), *kv_args, S, cl, scale,
             scale / (7.0 if int4 else KV_INT8_SCALE), ws.data_ptr(),
             _cuda.stream_ptr(x))
    _cuda.check(err, "fused decode step")
    return out


def _step(name: str, packed: Params, x: torch.Tensor, kv_k: torch.Tensor,
          kv_v: torch.Tensor, cache_len, n_head: int,
          k_scale: Optional[torch.Tensor] = None,
          v_scale: Optional[torch.Tensor] = None):
    """The wrapper named `name` (fused_decode_step_{v5|w4}[mq][i4]): checks
    Q and the packing against the name, then launches the kernel (CUDA
    tensors) or runs the plain version (CPU tensors)."""
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
    if x.is_cuda:
        h = decode_step_cuda(packed, x, kv_k, kv_v, cache_len, n_head,
                             k_scale, v_scale)
        LAUNCHES[name] += 1
    else:
        h = decode_step_plain(packed, x, kv_k, kv_v, cache_len, n_head,
                              k_scale, v_scale)
    if k_scale is None:
        return h, kv_k, kv_v
    return h, kv_k, kv_v, k_scale, v_scale


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
