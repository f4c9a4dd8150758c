"""Fused int8 OAR decode step (port of umgen_tpu/ops/decode_kernel.py, the
v5 family on the flat int8 cache).

Replaces two TPU kernels with one CUDA kernel family,
csrc/decode_step.cu (its header says what bounds it on the H100 and how the
design answers that):

  * `fused_decode_step_v5` (decode_kernel.py:1363, pallas_call :1457) —
    one token per scene (Q = 1), every Q = 1 OAR step of the rollout;
  * `fused_decode_step_v5mq` (decode_kernel.py:3411, through `_mq_call`
    :3318, pallas_call :3395) — 1 < Q <= 128 / n_head rows per scene with
    causal attention inside the chunk: the 6-row pose prefill and the
    2-row pushes at segment boundaries.

Both wrappers take the packed weights of runtime/quantize.pack_fused
(`params["oar_packed"]`), x [B, Q, d] bf16 and the flat int8 caches
[L, B, S, H·Dh] (the JAX layout; views of a longer cache are accepted), and
return (h [B, Q, d] bf16 before the final layer norm, kv_k, kv_v).  The
Q new K/V rows are written into the caches at `cache_len` IN PLACE — the
JAX package writes them back functionally; the returned caches are the
same tensors that were passed.

For CUDA tensors the kernel launches or the wrapper raises.  For CPU
tensors the wrappers run `decode_step_plain`: the reference kernel's
arithmetic in plain PyTorch, including its S-block online softmax
(`pick_block_s`) and the bf16 rounding of the softmax weights, with the
int8 × int8 products done exactly in float64 (float32 is not exact at
K = 3072).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from umgen_tpu_torch.ops import _cuda
from umgen_tpu_torch.runtime.quantize import vec_offsets

Params = Dict[str, Any]

KV_INT8_SCALE = 16.0     # fixed-grid int8 KV: step 1/16, range ±7.94
MAX_ROWS = 16            # B·Q rows the kernel takes per step
MAX_Q = 8
LAUNCHES = {"fused_decode_step_v5": 0, "fused_decode_step_v5mq": 0}


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


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------
def _ln(v: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = v.mean(-1, keepdim=True)
    var = (v - mu).square().mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + eps) * w


def _quant_rows(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    sa = v.abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    return torch.clamp(torch.round(v / sa), -127, 127), sa


def _qdot(v: torch.Tensor, wt: torch.Tensor, ws: torch.Tensor,
          b: torch.Tensor = None) -> torch.Tensor:
    """W8A8 product: per-row activation quant, exact integer dot (float64),
    float32 rescale.  wt is output-major [N, K] int8."""
    aq, sa = _quant_rows(v)
    acc = (aq.double() @ wt.double().T).float()
    y = acc * sa * ws
    return y + b if b is not None else y


def _gelu_as(x: torch.Tensor) -> torch.Tensor:
    """x·0.5·(1 + erf(x/√2)) with the reference kernel's A&S erf."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    z = x / 1.41421353816986083984375
    ax = z.abs()
    t = 1.0 / (1.0 + p * ax)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t \
        * torch.exp(-ax * ax)
    return x * 0.5 * (1.0 + torch.sign(z) * y)


def _bf16_add(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (h.to(torch.bfloat16) + y.to(torch.bfloat16)).float()


def decode_step_plain(packed: Params, x: torch.Tensor, kv_k: torch.Tensor,
                      kv_v: torch.Tensor, cache_len: int, n_head: int
                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch; writes the new rows into
    kv_k/kv_v in place and returns h [B, Q, d] bf16."""
    L, B, S, HD = kv_k.shape
    _, Q, d = x.shape
    H = n_head
    Dh = HD // H
    cl = int(cache_len)
    scale = 1.0 / math.sqrt(Dh)
    c16 = scale / KV_INT8_SCALE
    bs = pick_block_s(S)
    off = vec_offsets(d)
    h = x.reshape(B * Q, d).float()
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                   device=x.device))
    for l in range(L):
        vec = packed["vec"][l]

        def v_(name):
            a, b = off[name]
            return vec[a:b]

        qkv = _qdot(_ln(h, v_("ln1")), packed["wqkv"][l], v_("qkv_ws"),
                    v_("qkv_b"))
        q, k_new, v_new = qkv.split(HD, dim=-1)
        # queries: one int8 scale per scene over its Q rows
        qb = q.reshape(B, Q, HD)
        sq = qb.abs().amax(dim=(1, 2)) / 127.0 + 1e-12            # [B]
        qp = torch.clamp(torch.round(qb / sq[:, None, None]), -127, 127)
        qh = qb.reshape(B, Q, H, Dh)
        kh = k_new.reshape(B, Q, H, Dh)
        vh = v_new.reshape(B, Q, H, Dh)
        # intra-chunk causal term initializes the flash state
        lij = torch.einsum("bihd,bjhd->bhij", qh, kh) * scale
        lij = lij.masked_fill(~causal, float("-inf"))
        m = lij.amax(-1)                                           # [B,H,Q]
        p0 = torch.exp(lij - m[..., None])
        den = p0.sum(-1)
        acc = torch.einsum("bhij,bjhd->bhid", p0, vh)              # [B,H,Q,Dh]
        # S-blocks of the int8 prefix, online softmax as the reference
        fac = (sq * c16)[:, None, None, None]
        qpd = qp.reshape(B, Q, H, Dh).double()
        for s0 in range(0, cl, bs):
            s1 = min(s0 + bs, S)
            kb = kv_k[l, :, s0:s1].reshape(B, s1 - s0, H, Dh).double()
            li = torch.einsum("bshd,bqhd->bhqs", kb, qpd).float()
            logits = li * fac
            pos = torch.arange(s0, s1, device=x.device)
            logits = logits.masked_fill(pos >= cl, float("-inf"))
            m_new = torch.maximum(m, logits.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            den = den * corr + p.sum(-1)
            vb = (kv_v[l, :, s0:s1].float() * (1.0 / KV_INT8_SCALE)
                  ).reshape(B, s1 - s0, H, Dh)
            part = torch.einsum("bhqs,bshd->bhqd",
                                p.to(torch.bfloat16).float(), vb)
            acc = acc * corr[..., None] + part
            m = m_new
        y = (acc / den[..., None]).permute(0, 2, 1, 3).reshape(B * Q, HD)

        h = _bf16_add(h, _qdot(y, packed["wproj"][l], v_("proj_ws"),
                               v_("proj_b")))
        hid = _gelu_as(_qdot(_ln(h, v_("ln2")), packed["wfc"][l],
                             v_("fc_ws")))
        h = _bf16_add(h, _qdot(hid, packed["wpj"][l], v_("pj_ws")))

        kv_k[l, :, cl:cl + Q] = kv_store(k_new).reshape(B, Q, HD)
        kv_v[l, :, cl:cl + Q] = kv_store(v_new).reshape(B, Q, HD)
    return h.to(torch.bfloat16).reshape(B, Q, d)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
_ARGTYPES = ([_cuda.VOIDP, _cuda.VOIDP] + [_cuda.INT] * 5
             + [_cuda.VOIDP] * 7 + [_cuda.INT64, _cuda.INT64]
             + [_cuda.INT, _cuda.INT, _cuda.FLOAT, _cuda.FLOAT]
             + [_cuda.VOIDP, _cuda.VOIDP])


def decode_step_cuda(packed: Params, x: torch.Tensor, kv_k: torch.Tensor,
                     kv_v: torch.Tensor, cache_len: int, n_head: int
                     ) -> torch.Tensor:
    """Launch csrc/decode_step.cu; new rows written in place."""
    L, B, S, HD = kv_k.shape
    _, Q, d = x.shape
    H = n_head
    cl = int(cache_len)
    if HD != d or d % H or (d // H) not in (16, 48) or d % 16:
        raise ValueError(f"decode kernel: unsupported widths d={d}, "
                         f"H={H}, cache row {HD}")
    if B * Q > MAX_ROWS or Q > MAX_Q or Q * H > 128:
        raise ValueError(f"decode kernel takes B*Q <= {MAX_ROWS}, "
                         f"Q <= {MAX_Q}, Q*H <= 128; got B={B}, Q={Q}")
    if not 0 <= cl <= S - Q:
        raise ValueError(f"cache_len {cl} + Q {Q} exceeds {S} cache rows")
    if kv_v.shape != kv_k.shape or kv_v.stride() != kv_k.stride():
        raise ValueError("kv_k / kv_v must have the same shape and strides")
    for name, t in (("kv_k", kv_k), ("kv_v", kv_v)):
        if not t.is_cuda or t.dtype != torch.int8:
            raise ValueError(f"decode kernel: {name} must be CUDA int8")
        if t.stride(3) != 1 or t.stride(2) != HD or t.data_ptr() % 16 \
                or t.stride(0) % 16 or t.stride(1) % 16:
            raise ValueError(f"decode kernel: {name} rows must be "
                             "contiguous and 16-byte aligned")
    x = x.contiguous()
    _cuda.require(x, torch.bfloat16, "decode kernel x", align=4)
    _cuda.require(packed["vec"], torch.float32, "decode kernel vec", 4)
    for name in ("wqkv", "wproj", "wfc", "wpj"):
        _cuda.require(packed[name], torch.int8, f"decode kernel {name}")
    if packed["wqkv"].shape != (L, 3 * d, d):
        raise ValueError(f"packed weights {tuple(packed['wqkv'].shape)} do "
                         f"not match L={L}, d={d}")
    lib = _cuda.load()
    lib.umgen_decode_workspace_bytes.argtypes = [_cuda.INT] * 5
    lib.umgen_decode_workspace_bytes.restype = _cuda.INT64
    nbytes = lib.umgen_decode_workspace_bytes(B, Q, d, H, S)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    scale = 1.0 / math.sqrt(d // H)
    fn = _cuda.function("umgen_decode_step", _ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), B, Q, d, H, L,
             packed["vec"].data_ptr(), packed["wqkv"].data_ptr(),
             packed["wproj"].data_ptr(), packed["wfc"].data_ptr(),
             packed["wpj"].data_ptr(), kv_k.data_ptr(), kv_v.data_ptr(),
             kv_k.stride(0), kv_k.stride(1), S, cl, scale,
             scale / KV_INT8_SCALE, ws.data_ptr(), _cuda.stream_ptr(x))
    _cuda.check(err, "fused decode step")
    return out


def _step(name: str, packed: Params, x: torch.Tensor, kv_k: torch.Tensor,
          kv_v: torch.Tensor, cache_len, n_head: int):
    if x.is_cuda:
        h = decode_step_cuda(packed, x, kv_k, kv_v, cache_len, n_head)
        LAUNCHES[name] += 1
    else:
        h = decode_step_plain(packed, x, kv_k, kv_v, cache_len, n_head)
    return h, kv_k, kv_v


def fused_decode_step_v5(packed: Params, x: torch.Tensor,
                         kv_k: torch.Tensor, kv_v: torch.Tensor,
                         cache_len, n_head: int):
    """One token per scene: x [B, 1, d] → (h [B, 1, d], kv_k, kv_v)."""
    if x.shape[1] != 1:
        raise ValueError(f"v5 takes one row per scene, got Q={x.shape[1]}")
    return _step("fused_decode_step_v5", packed, x, kv_k, kv_v, cache_len,
                 n_head)


def fused_decode_step_v5mq(packed: Params, x: torch.Tensor,
                           kv_k: torch.Tensor, kv_v: torch.Tensor,
                           cache_len, n_head: int):
    """Q rows per scene, 1 < Q·n_head <= 128, causal within the chunk."""
    Q = x.shape[1]
    if not 1 < Q * n_head <= 128 or Q < 2:
        raise ValueError(f"v5mq needs 1 < Q and Q*H <= 128, got Q={Q}, "
                         f"H={n_head}")
    return _step("fused_decode_step_v5mq", packed, x, kv_k, kv_v, cache_len,
                 n_head)
