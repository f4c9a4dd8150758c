"""Transformer building blocks over parameter dicts (port of
umgen_tpu/models/modules.py, the subset the cached rollout runs).

Parameters are the JAX package's pytree as nested dicts of tensors (see
umgen_tpu_torch/params.py): stacked layers carry a leading L axis and a
stack is applied with a Python loop over `layer(stack, l)`.

Weight-layout conventions are the JAX package's: linear y = x @ w + b with
w [in, out]; int8 weight-only leaves are {"wq" int8 [in, out], "ws" f32
[out]}; attention uses a fused qkv [d, 3d] + bias and an output proj + bias;
MLPs have no bias; layer norms carry a weight only (eps 1e-5).

Numerics follow the reference's: matmuls accumulate in float32 and round to
the activation dtype once (bias added before the rounding), layer norm and
softmax run in float32, and elementwise bf16 ops round after every op.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

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


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "wq" in p:
        # weight-only int8: dequantize in the activation dtype (the bf16
        # product rounds exactly as the reference's does)
        w = p["wq"].to(x.dtype) * p["ws"].to(x.dtype)
    else:
        w = p["w"]
    y = matmul_f32(x, w)
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["w"].float()).to(x.dtype)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU, 0.5·x·erfc(-x/√2), with the reference's rounding
    points: the erfc argument stays float32, erfc and the final product
    round to x's dtype."""
    dt = x.dtype
    xf = x.float()
    c = float(torch.tensor(math.sqrt(0.5), dtype=dt))
    e = _erfc_f32((-xf) * c).to(dt).float()
    half = (0.5 * xf).to(dt).float()
    return (half * e).to(dt)


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["proj"], gelu(linear(p["fc"], x)))


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_head, d // n_head)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         causal: bool) -> torch.Tensor:
    """Scaled dot-product attention over [B, S, H, Dh]: float32 logits,
    scale 1/√Dh, bottom-right-aligned causal mask when Sq < Sk; the
    softmax weights round to q's dtype before the value product."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)


def attention(p: Params, x: torch.Tensor, n_head: int, causal: bool,
              attn_impl: Callable = sdpa) -> torch.Tensor:
    """Fused-QKV self-attention over [B, S, D]."""
    B, S, D = x.shape
    q, k, v = linear(p["qkv"], x).split(D, dim=-1)
    y = attn_impl(_split_heads(q, n_head), _split_heads(k, n_head),
                  _split_heads(v, n_head), causal)
    return linear(p["proj"], y.reshape(B, S, D))


def cross_attention(p: Params, q_in: torch.Tensor, kv_in: torch.Tensor,
                    n_head: int) -> torch.Tensor:
    """Non-causal cross attention with separate q/k/v projections."""
    B, Sq, D = q_in.shape
    q = _split_heads(linear(p["q"], q_in), n_head)
    k = _split_heads(linear(p["k"], kv_in), n_head)
    v = _split_heads(linear(p["v"], kv_in), n_head)
    y = sdpa(q, k, v, causal=False)
    return linear(p["proj"], y.reshape(B, Sq, D))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def block_tar_collect_kv(p: Params, x: torch.Tensor, n_head: int,
                         attn_impl: Callable = sdpa):
    """Full-window factorized block over [B, T, S, D] (spatial → temporal
    causal → spatial) that also returns the temporal-attention K/V
    ([B·S, T, H, Dh] each) for the ring prefill."""
    B, T, S, D = x.shape

    xs = x.reshape(B * T, S, D)
    xs = xs + attention(p["sa1"], layer_norm(p["ln1"], xs), n_head,
                        causal=False, attn_impl=attn_impl)
    xs = xs + mlp(p["mlp1"], layer_norm(p["ln2"], xs))

    xt = xs.reshape(B, T, S, D).transpose(1, 2).reshape(B * S, T, D)
    q, k, v = linear(p["ta"]["qkv"], layer_norm(p["ln3"], xt)).split(
        D, dim=-1)
    kh = _split_heads(k, n_head)
    vh = _split_heads(v, n_head)
    y = attn_impl(_split_heads(q, n_head), kh, vh, True)
    xt = xt + linear(p["ta"]["proj"], y.reshape(B * S, T, D))
    xt = xt + mlp(p["mlp2"], layer_norm(p["ln4"], xt))

    xs = xt.reshape(B, S, T, D).transpose(1, 2).reshape(B * T, S, D)
    xs = xs + attention(p["sa2"], layer_norm(p["ln5"], xs), n_head,
                        causal=False, attn_impl=attn_impl)
    xs = xs + mlp(p["mlp3"], layer_norm(p["ln6"], xs))
    return xs.reshape(B, T, S, D), (kh, vh)


def block_tar_decode_deferred(p: Params, x: torch.Tensor, n_head: int,
                              ring_k: torch.Tensor, ring_v: torch.Tensor,
                              slot: int, n_valid: int,
                              attn_impl: Callable = sdpa):
    """One new frame [B, S, D] through a factorized block whose temporal
    attention reads bf16 rings [B·S, T_max, H, Dh] without writing them.

    The ring slot this frame will overwrite is masked out and the frame
    attends itself through a separate rank-1 term.  Returns (y, k_new,
    v_new) with k_new/v_new [B·S, H, Dh] for the caller to store."""
    B, S, D = x.shape
    xs = x + attention(p["sa1"], layer_norm(p["ln1"], x), n_head,
                       causal=False, attn_impl=attn_impl)
    xs = xs + mlp(p["mlp1"], layer_norm(p["ln2"], xs))

    xt = xs.reshape(B * S, 1, D)
    q, k_new, v_new = linear(p["ta"]["qkv"], layer_norm(p["ln3"], xt)).split(
        D, dim=-1)
    N, H = B * S, n_head
    Dh = D // H
    q = q.reshape(N, 1, H, Dh)
    k_new = k_new.reshape(N, H, Dh)
    v_new = v_new.reshape(N, H, Dh)
    T_max = ring_k.shape[1]
    scale = 1.0 / math.sqrt(Dh)

    lp = torch.einsum("nqhd,nkhd->nhqk", q.float(), ring_k.float()) * scale
    tpos = torch.arange(T_max, device=x.device)
    valid = (tpos < n_valid) & (tpos != slot)
    lp = lp.masked_fill(~valid, float("-inf"))
    # self logit: bf16 products, float32 sum rounded to bf16 (the
    # reference's bf16 reduction), then scaled in float32
    ls = ((q[:, 0] * k_new).float().sum(-1).to(q.dtype).float()
          [:, :, None, None] * scale)
    m = torch.maximum(lp.amax(-1, keepdim=True), ls)
    ep = torch.exp(lp - m)
    es = torch.exp(ls - m)
    denom = ep.sum(-1, keepdim=True) + es
    wp = ep / denom
    wself = (es / denom).to(q.dtype)
    y = torch.einsum("nhqk,nkhd->nqhd", wp.to(q.dtype).float(),
                     ring_v.float()).to(q.dtype)
    y = y + wself.transpose(1, 2) * v_new[:, None]
    xt = xt + linear(p["ta"]["proj"], y.reshape(N, 1, D))
    xt = xt + mlp(p["mlp2"], layer_norm(p["ln4"], xt))

    xs = xt.reshape(B, S, D)
    xs = xs + attention(p["sa2"], layer_norm(p["ln5"], xs), n_head,
                        causal=False, attn_impl=attn_impl)
    xs = xs + mlp(p["mlp3"], layer_norm(p["ln6"], xs))
    return xs, k_new, v_new


def decoder_block(p: Params, x: torch.Tensor, ctx: torch.Tensor,
                  n_head: int) -> torch.Tensor:
    """Self-attn → cross-attn(queries, scene emb) → MLP over [B, S, D]."""
    x = x + attention(p["self_attn"], layer_norm(p["ln1"], x), n_head,
                      causal=False)
    x = x + cross_attention(p["cross_attn"], layer_norm(p["ln2"], x),
                            layer_norm(p["ln3"], ctx), n_head)
    return x + mlp(p["mlp"], layer_norm(p["ln4"], x))


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
