"""Transformer building blocks over parameter dicts (port of
umgen_tpu/models/modules.py: the subset the rollouts and the trainer run).

Parameters are the JAX package's pytree as nested dicts of tensors (see
umgen_tpu_torch/params.py): stacked layers carry a leading L axis and a
stack is applied with a Python loop over `layer(stack, l)` (`apply_stack`,
which can recompute each block in the backward pass).

Weight-layout conventions are the JAX package's: linear y = x @ w + b with
w [in, out]; int8 weight-only leaves are {"wq" int8 [in, out], "ws" f32
[out]}, group-int4 ones {"wq4" int8 [in/2, out] nibble pairs along the
input dim, "ws4" f32 [in/G, out]}; attention uses a fused qkv [d, 3d] + bias
and an output proj + bias; MLPs have no bias; layer norms carry a weight
only (eps 1e-5).  With config.bias the reference flips both: attention
without biases, MLPs with them (`linear` adds a bias where the leaf has
one).

Tensor parallelism (`tp`, a parallel.mesh.Mesh with tp > 1, or None): the
blocks run on this rank's heads and hidden columns, Megatron's split.
`n_head` is then the rank's heads, and every width is read from the
weights (a fused qkv holds the rank's q, k and v columns side by side).
Each row-parallel product (`row_linear`: attention's and the MLP's `proj`)
sums its partial products over the group in float32 before its bias and
its rounding, and each column-parallel product's input passes `tp.copy`
(its gradient summed over the group under autograd).

Numerics follow the reference's: matmuls accumulate in float32 and round to
the activation dtype once (bias added before the rounding), layer norm and
softmax run in float32, and elementwise bf16 ops round after every op.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]


def layer(stack: Params, l: int) -> Params:
    """Layer `l` of a stacked-parameter tree (views, no copies)."""
    if isinstance(stack, dict):
        return {k: layer(v, l) for k, v in stack.items()}
    return stack[l]


def n_layers(stack: Params) -> int:
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return int(stack.shape[0])


# ---------------------------------------------------------------------------
# primitive ops
# ---------------------------------------------------------------------------
def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx]: the rows of a trained table for `idx` of any shape.  Its
    gradient is F.embedding's scatter-add, deterministic on both devices,
    where indexing's `index_put_` accumulates in a thread-dependent order
    on the CPU (and with atomics on the card): a training step gives the
    same bits run after run, with remat and without."""
    return torch.nn.functional.embedding(idx, table)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with float32 accumulation, returned in float32.

    On a CUDA device a bf16 product runs on the tensor cores (float32
    accumulation, bf16 result) — the large TAR-family matmuls are left to
    cuBLAS exactly as the JAX package leaves them to XLA.  On the CPU the
    operands are widened so the float32 sum is rounded once, as XLA's CPU
    backend does."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch.matmul(x, w.to(x.dtype)).float()
    return torch.matmul(x.float(), w.float())


def _weight(p: Params, x: torch.Tensor) -> torch.Tensor:
    """A linear's [in, out] weight, dequantized in the activation dtype
    where it is quantized."""
    if "wq4" in p:
        # group-int4 weights (runtime/quantize.py quantize_params_w4):
        # one layer's [in, out] weight dequantized in the activation dtype,
        # then the same product as the others
        packed = p["wq4"]                               # [in/2, out]
        q = torch.stack([(packed << 4) >> 4, packed >> 4], dim=-2)
        q = q.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                      packed.shape[-1])
        scale = p["ws4"]                                # [in/G, out]
        G = q.shape[-2] // scale.shape[-2]
        w = q.to(x.dtype) * scale.repeat_interleave(G, dim=-2).to(x.dtype)
    elif "wq" in p:
        # weight-only int8: dequantize in the activation dtype (the bf16
        # product rounds exactly as the reference's does)
        w = p["wq"].to(x.dtype) * p["ws"].to(x.dtype)
    else:
        w = p["w"]
    return w


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = matmul_f32(x, _weight(p, x))
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def row_linear(p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """A row-parallel product: x holds this rank's input columns, the
    float32 partial products are summed over the tp group, then the bias
    (whole on every rank) is added once and the sum rounded."""
    if tp is None:
        return linear(p, x)
    y = tp.reduce(matmul_f32(x, _weight(p, x)))
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def col_input(x: torch.Tensor, tp=None) -> torch.Tensor:
    """A column-parallel product's input (tp.copy under tp)."""
    return x if tp is None else tp.copy(x)


def slice_linear_out(p: Params, n: int) -> Params:
    """The first n output columns of a linear's params (raw, int8 or W4):
    the n-step bbox head's step-0 vocab, whose product then computes only
    the slice it keeps."""
    return {k: v[..., :n] for k, v in p.items()}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["w"].float()).to(x.dtype)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """Llama-style RMSNorm (the reference defines it; no published config
    selects it): float32 statistics, the normalized value rounded to x's
    dtype before the weight."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * p["w"].to(x.dtype)


# erfc(z) in float32 as XLA evaluates it (rational approximations on
# |z| < 1, [1, 2) and >= 2); the reference's exact GELU is lowered to this
_ERFC_SMALL = (7.85386146e-05, -0.000801019371, 0.00518832775,
               -0.0268538129, 0.112835854, -0.37612626, 1.12837911)
_ERFC_MID = (0.0232682, -0.138703942, 0.368742466, -0.582473278,
             0.621000469, -0.494451523, 0.340488, -0.274112701, 0.563825965)
_ERFC_LARGE = (-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523,
               0.42184633, -0.282076746, 0.564189494)


def _horner(t: torch.Tensor, coeffs) -> torch.Tensor:
    y = t * coeffs[0] + coeffs[1]
    for c in coeffs[2:]:
        y = y * t + c
    return y


def _erfc_f32(z: torch.Tensor) -> torch.Tensor:
    az = z.abs()
    zz = z * z
    small = 1.0 - z * _horner(zz, _ERFC_SMALL)
    q = 1.0 / zz
    poly = torch.where(az < 2.0, _horner(q, _ERFC_MID),
                       _horner(q, _ERFC_LARGE))
    tail = torch.exp(-zz) * (1.0 / az) * poly
    tail = torch.where(-zz < -88.7228394, torch.zeros_like(tail), tail)
    tail = torch.where(z < 0, 2.0 - tail, tail)
    return torch.where(az < 1.0, small, tail)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    c = float(torch.tensor(math.sqrt(0.5), dtype=dt))
    e = _erfc_f32((-xf) * c).to(dt).float()
    half = (0.5 * xf).to(dt).float()
    return (half * e).to(dt)


class _GeluFn(torch.autograd.Function):
    """`_gelu` with the derivative JAX takes: erfc's own, -2/√π·exp(-z²)
    (lax's jvp rule), not the derivative of the polynomial that evaluates
    it — and no gradient through the branches `_erfc_f32` selects away,
    whose 1/|z| is infinite at z = 0.  d/dx = 0.5·erfc(-cx) + 0.5·x·c·
    (2/√π)·exp(-c²x²), in float32, rounded to x's dtype once."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dt = x.dtype
        xf = x.float()
        c = float(torch.tensor(math.sqrt(0.5), dtype=dt))
        z = (-xf) * c
        e = _erfc_f32(z).to(dt).float()
        d = 0.5 * e + (0.5 * xf) * c * (2.0 / math.sqrt(math.pi)) \
            * torch.exp(-z * z)
        return (g.float() * d).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU, 0.5·x·erfc(-x/√2), with the reference's rounding
    points: the erfc argument stays float32, erfc and the final product
    round to x's dtype.  Under autograd its gradient is erfc's exact one
    (`_GeluFn`)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _GeluFn.apply(x)
    return _gelu(x)


def mlp(p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    return row_linear(p["proj"], gelu(linear(p["fc"], col_input(x, tp))),
                      tp)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_head, d // n_head)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         causal: bool, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over [B, S, H, Dh]: float32 logits,
    scale 1/√Dh, plus `bias` [H, Sq, Sk] where given (the relative temporal
    PE, the JAX package's `sdpa_bias`), bottom-right-aligned causal mask
    when Sq < Sk; the softmax weights round to q's dtype before the value
    product."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()[None]
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)


def qkv(p: Params, x: torch.Tensor, tp=None):
    """The fused projection's q, k and v (each this rank's columns)."""
    y = linear(p, col_input(x, tp))
    return y.split(y.shape[-1] // 3, dim=-1)


def attention(p: Params, x: torch.Tensor, n_head: int, causal: bool,
              attn_impl: Callable = sdpa, tp=None) -> torch.Tensor:
    """Fused-QKV self-attention over [B, S, D]."""
    B, S, _ = x.shape
    q, k, v = qkv(p["qkv"], x, tp)
    y = attn_impl(_split_heads(q, n_head), _split_heads(k, n_head),
                  _split_heads(v, n_head), causal)
    return row_linear(p["proj"], y.reshape(B, S, -1), tp)


def cross_attention(p: Params, q_in: torch.Tensor, kv_in: torch.Tensor,
                    n_head: int, tp=None) -> torch.Tensor:
    """Non-causal cross attention with separate q/k/v projections."""
    B, Sq, _ = q_in.shape
    q_in, kv_in = col_input(q_in, tp), col_input(kv_in, tp)
    q = _split_heads(linear(p["q"], q_in), n_head)
    k = _split_heads(linear(p["k"], kv_in), n_head)
    v = _split_heads(linear(p["v"], kv_in), n_head)
    y = sdpa(q, k, v, causal=False)
    return row_linear(p["proj"], y.reshape(B, Sq, -1), tp)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def block_tar(p: Params, x: torch.Tensor, n_head: int,
              attn_impl: Callable = sdpa, collect_kv: bool = False,
              t_bias: Optional[torch.Tensor] = None, tp=None):
    """Full-window factorized block over [B, T, S, D]: spatial (non-causal
    over S) → temporal (causal over T) → spatial, each with its own pre-LN
    and MLP.  Returns y [B, T, S, D], or with `collect_kv` (y, (k, v)): the
    temporal attention's K/V ([B·S, T, H, Dh] each) for the ring prefill.
    t_bias [H, T, T]: the relative temporal PE's logit bias, on the
    temporal attention only (plain `sdpa`: the kernels take no bias)."""
    B, T, S, D = x.shape

    xs = x.reshape(B * T, S, D)
    xs = xs + attention(p["sa1"], layer_norm(p["ln1"], xs), n_head,
                        causal=False, attn_impl=attn_impl, tp=tp)
    xs = xs + mlp(p["mlp1"], layer_norm(p["ln2"], xs), tp)

    xt = xs.reshape(B, T, S, D).transpose(1, 2).reshape(B * S, T, D)
    q, k, v = qkv(p["ta"]["qkv"], layer_norm(p["ln3"], xt), tp)
    kh = _split_heads(k, n_head)
    vh = _split_heads(v, n_head)
    if t_bias is not None:
        y = sdpa(_split_heads(q, n_head), kh, vh, True, bias=t_bias)
    else:
        y = attn_impl(_split_heads(q, n_head), kh, vh, True)
    xt = xt + row_linear(p["ta"]["proj"], y.reshape(B * S, T, -1), tp)
    xt = xt + mlp(p["mlp2"], layer_norm(p["ln4"], xt), tp)

    xs = xt.reshape(B, S, T, D).transpose(1, 2).reshape(B * T, S, D)
    xs = xs + attention(p["sa2"], layer_norm(p["ln5"], xs), n_head,
                        causal=False, attn_impl=attn_impl, tp=tp)
    xs = xs + mlp(p["mlp3"], layer_norm(p["ln6"], xs), tp)
    out = xs.reshape(B, T, S, D)
    return (out, (kh, vh)) if collect_kv else out


def block_oar(p: Params, x: torch.Tensor, n_head: int,
              attn_impl: Callable = sdpa, tp=None) -> torch.Tensor:
    """The OAR's causal block over a whole frame [B, S, D] (the teacher-
    forced training pass; decoding runs the step kernels)."""
    x = x + attention(p["attn"], layer_norm(p["ln1"], x), n_head,
                      causal=True, attn_impl=attn_impl, tp=tp)
    return x + mlp(p["mlp"], layer_norm(p["ln2"], x), tp)


def apply_stack(stack: Params, x: torch.Tensor, block_fn: Callable,
                remat: bool = False) -> torch.Tensor:
    """x through every layer of a stacked tree, `block_fn(layer_params, h)`
    each.  With `remat` (and autograd recording) each block runs under
    `torch.utils.checkpoint`: its activations are recomputed in the
    backward pass instead of kept (the JAX package's `jax.checkpoint`).  The
    blocks draw no random numbers, so the recomputation is exact."""
    from torch.utils.checkpoint import checkpoint
    remat = remat and torch.is_grad_enabled()
    for l in range(n_layers(stack)):
        p = layer(stack, l)
        x = (checkpoint(block_fn, p, x, use_reentrant=False) if remat
             else block_fn(p, x))
    return x


def saturate_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x → storage `dtype` (a TAR ring or the OAR cache).  float8_e4m3fn
    saturates at ±448: PyTorch's conversion saturates on the CPU only (on
    CUDA it gives NaN, as JAX's does everywhere), so the port clamps first
    and every device stores the same bytes.  K/V of this model stay far
    below 448."""
    if dtype == torch.float8_e4m3fn:
        x = torch.clamp(x, -448.0, 448.0)
    return x.to(dtype)


def q4_pack(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, range [-7, 7]) pairwise along the
    last dim: byte d holds dims (2d | low nibble, 2d+1 | high nibble)."""
    return ((q[..., 1::2] << 4) | (q[..., 0::2] & 0x0F)).to(torch.int8)


def q4_unpack_even(packed: torch.Tensor) -> torch.Tensor:
    """Sign-extended low nibble (the original even dims)."""
    return (packed << 4) >> 4


def q4_unpack_odd(packed: torch.Tensor) -> torch.Tensor:
    """Sign-extended high nibble (the original odd dims)."""
    return packed >> 4


def q2_pack(q: torch.Tensor) -> torch.Tensor:
    """Pack int2 values (int8 storage, range [-2, 1]) four a byte along the
    last dim: byte d holds dims (4d | bits 0-1, 4d+1 | bits 2-3, 4d+2 |
    bits 4-5, 4d+3 | bits 6-7)."""
    return ((q[..., 3::4] << 6) | ((q[..., 2::4] & 0x03) << 4)
            | ((q[..., 1::4] & 0x03) << 2)
            | (q[..., 0::4] & 0x03)).to(torch.int8)


def q2_unpack(packed: torch.Tensor, j: int) -> torch.Tensor:
    """Sign-extended 2-bit field j in [0, 4) (the original dims j::4)."""
    return (packed << (6 - 2 * j)) >> 6 if j < 3 else packed >> 6


def block_tar_decode_deferred(p: Params, x: torch.Tensor, n_head: int,
                              ring_k: torch.Tensor, ring_v: torch.Tensor,
                              slot: int, n_valid: int,
                              attn_impl: Callable = sdpa,
                              ring_scale_k: Optional[torch.Tensor] = None,
                              ring_scale_v: Optional[torch.Tensor] = None,
                              t_bias_ring: Optional[torch.Tensor] = None,
                              t_bias_self: Optional[torch.Tensor] = None,
                              ring_chan_k: Optional[torch.Tensor] = None,
                              ring_chan_v: Optional[torch.Tensor] = None,
                              ring_bits: int = 4, tp=None):
    """One new frame [B, S, D] through a factorized block whose temporal
    attention reads the rings [B·S, T_max, H, Dh] without writing them.

    The ring slot this frame will overwrite is masked out and the frame
    attends itself through a separate rank-1 term.  Returns (y, k_new,
    v_new) with k_new/v_new [B·S, H, Dh] for the caller to store.

    int4 rings: with ring_scale_k/v ([B, T_max, H] dequantization
    multipliers) given, ring_k/v are nibble-packed int8 [B·S, T_max, H,
    Dh/2] (q4_pack).  The contraction is over Dh only, so the per-(scene,
    frame, head) scales fold into the logits (k) and into the softmax
    weights (v, rounded to bf16 with them); no dequantized ring is
    materialized.

    int2 rings (ring_bits=2): ring_k/v are 2-bit-packed int8 [B·S, T_max,
    H, Dh/4] (q2_pack), a stored level q meaning (q + 0.5)·scale·chan with
    ring_chan_k/v [B, H, Dh] the equalizers frozen at the prefill (ones
    where none were taken).  chan is T-independent, so it multiplies the
    query (logits) and the output (values), and the +0.5 offset is a rank-1
    correction (0.5·Σ_d q'_d on the logits, 0.5·Σ_t w_t·s_t on the
    values).

    t_bias_ring [H, T_max] / t_bias_self [H]: the relative temporal PE's
    logit bias of each ring slot (its frame's age) and of the new frame's
    self term (distance 0)."""
    B, S, D = x.shape
    xs = x + attention(p["sa1"], layer_norm(p["ln1"], x), n_head,
                       causal=False, attn_impl=attn_impl, tp=tp)
    xs = xs + mlp(p["mlp1"], layer_norm(p["ln2"], xs), tp)

    xt = xs.reshape(B * S, 1, D)
    q, k_new, v_new = qkv(p["ta"]["qkv"], layer_norm(p["ln3"], xt), tp)
    N, H = B * S, n_head
    Dh = q.shape[-1] // H
    q = q.reshape(N, 1, H, Dh)
    k_new = k_new.reshape(N, H, Dh)
    v_new = v_new.reshape(N, H, Dh)
    T_max = ring_k.shape[1]
    scale = 1.0 / math.sqrt(Dh)

    packed = ring_scale_k is not None

    def fold(t, s_bth):
        """[N, H, 1, T] times per-(B, T, H) factors."""
        t5 = t.reshape(B, S, H, 1, T_max)
        return (t5 * s_bth.permute(0, 2, 1)[:, None, :, None, :]).reshape(
            N, H, 1, T_max)

    if packed and ring_bits == 2:
        # channel-equalized query q'_d = q_d · chan_k[b, h, d]
        qk = q
        if ring_chan_k is not None:
            qk = (q.reshape(B, S, H, Dh)
                  * ring_chan_k[:, None].to(q.dtype)).reshape(N, 1, H, Dh)
        qkf = qk.float()
        lp = 0
        for j in range(4):
            lp = lp + torch.einsum("nqhd,nkhd->nhqk", qkf[..., j::4],
                                   q2_unpack(ring_k, j).float())
        # the +0.5 level offset: a rank-1 logit correction
        lp = (lp + 0.5 * qkf.sum(-1).permute(0, 2, 1)[..., None]) * scale
        lp = fold(lp, ring_scale_k.float())
    elif packed:
        qf = q.float()
        lp = (torch.einsum("nqhd,nkhd->nhqk", qf[..., 0::2],
                           q4_unpack_even(ring_k).float())
              + torch.einsum("nqhd,nkhd->nhqk", qf[..., 1::2],
                             q4_unpack_odd(ring_k).float())) * scale
        lp = fold(lp, ring_scale_k.float())
    else:
        lp = torch.einsum("nqhd,nkhd->nhqk", q.float(),
                          ring_k.float()) * scale
    if t_bias_ring is not None:
        lp = lp + t_bias_ring.float()[None, :, None, :]
    tpos = torch.arange(T_max, device=x.device)
    valid = (tpos < n_valid) & (tpos != slot)
    lp = lp.masked_fill(~valid, float("-inf"))
    # self logit: bf16 products, float32 sum rounded to bf16 (the
    # reference's bf16 reduction), then scaled in float32
    ls = ((q[:, 0] * k_new).float().sum(-1).to(q.dtype).float()
          [:, :, None, None] * scale)
    if t_bias_self is not None:
        ls = ls + t_bias_self.float()[None, :, None, None]
    m = torch.maximum(lp.amax(-1, keepdim=True), ls)
    ep = torch.exp(lp - m)
    es = torch.exp(ls - m)
    denom = ep.sum(-1, keepdim=True) + es
    wp = ep / denom
    wself = (es / denom).to(q.dtype)
    if packed and ring_bits == 2:
        wps = fold(wp, ring_scale_v.float()).to(q.dtype)
        y = torch.stack([torch.einsum("nhqk,nkhd->nqhd", wps.float(),
                                      q2_unpack(ring_v, j).float()
                                      ).to(q.dtype) for j in range(4)],
                        dim=-1).reshape(N, 1, H, Dh)
        # the +0.5 offset adds 0.5·Σ_t w_t·s_t to every channel
        y = y + (0.5 * wps.float().sum(-1).to(q.dtype)).permute(
            0, 2, 1)[..., None]
        if ring_chan_v is not None:
            y = (y.reshape(B, S, H, Dh)
                 * ring_chan_v[:, None].to(q.dtype)).reshape(N, 1, H, Dh)
    elif packed:
        wps = fold(wp, ring_scale_v.float()).to(q.dtype).float()
        y_e = torch.einsum("nhqk,nkhd->nqhd", wps,
                           q4_unpack_even(ring_v).float()).to(q.dtype)
        y_o = torch.einsum("nhqk,nkhd->nqhd", wps,
                           q4_unpack_odd(ring_v).float()).to(q.dtype)
        y = torch.stack([y_e, y_o], dim=-1).reshape(N, 1, H, Dh)
    else:
        y = torch.einsum("nhqk,nkhd->nqhd", wp.to(q.dtype).float(),
                         ring_v.float()).to(q.dtype)
    y = y + wself.transpose(1, 2) * v_new[:, None]
    xt = xt + row_linear(p["ta"]["proj"], y.reshape(N, 1, H * Dh), tp)
    xt = xt + mlp(p["mlp2"], layer_norm(p["ln4"], xt), tp)

    xs = xt.reshape(B, S, D)
    xs = xs + attention(p["sa2"], layer_norm(p["ln5"], xs), n_head,
                        causal=False, attn_impl=attn_impl, tp=tp)
    xs = xs + mlp(p["mlp3"], layer_norm(p["ln6"], xs), tp)
    return xs, k_new, v_new


def decoder_block(p: Params, x: torch.Tensor, ctx: torch.Tensor,
                  n_head: int, tp=None) -> torch.Tensor:
    """Self-attn → cross-attn(queries, scene emb) → MLP over [B, S, D]."""
    x = x + attention(p["self_attn"], layer_norm(p["ln1"], x), n_head,
                      causal=False, tp=tp)
    x = x + cross_attention(p["cross_attn"], layer_norm(p["ln2"], x),
                            layer_norm(p["ln3"], ctx), n_head, tp)
    return x + mlp(p["mlp"], layer_norm(p["ln4"], x), tp)


# ---------------------------------------------------------------------------
# positional encodings
# ---------------------------------------------------------------------------
def position_encoding_init(n_position: int, emb_dim: int,
                           start_index: int = 0) -> np.ndarray:
    """Sinusoid table [n_position, emb_dim] float32 with a zero row at pos
    0.  Callers round it through bf16 (`bf16_round`), as the reference's
    checkpoint tables are."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(emb_dim, dtype=np.float64)[None, :]
    table = (pos + start_index) / np.power(10000.0, 2 * (j // 2) / emb_dim)
    table[0, :] = 0.0
    table[1:, 0::2] = np.sin(table[1:, 0::2])
    table[1:, 1::2] = np.cos(table[1:, 1::2])
    return table.astype(np.float32)


def bf16_round(a: np.ndarray) -> np.ndarray:
    """Round a float32 array to the nearest bf16 value (kept as float32)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()
