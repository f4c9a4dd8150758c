"""Flash attention over [B, S, H, Dh] (port of umgen_tpu/ops/flash_attention.py).

Replaces the TPU kernel `flash_attention` (umgen_tpu/ops/flash_attention.py:
79, its `pallas_call` at :106) with the hand-written CUDA kernel in
csrc/flash_attention.cu (mma.sync bf16 tiles, online softmax; see the
source's header for what bounds it on the H100 and how the design answers
that).  The kernel takes bf16 tensors with head_dim 48 — the model's width
at every scale the port serves on the card.

`flash_attention(q, k, v, causal)` launches the kernel for CUDA tensors and
raises for anything the kernel does not take; for CPU tensors it runs
`flash_attention_plain`, the same function in plain PyTorch (the JAX
package's `sdpa` numerics: float32 logits, softmax weights rounded to the
input dtype before the value product).
"""

from __future__ import annotations

import math

import torch

from umgen_tpu_torch.models.modules import sdpa
from umgen_tpu_torch.ops import _cuda

HEAD_DIM = 48
# launches of the CUDA kernel (CPU calls do not count); reset by callers
# that want to see which kernels a run went through
LAUNCHES = {"flash_attention": 0}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch (no fully-masked rows occur
    with Sq <= Sk; the kernel returns 0 for such rows)."""
    return sdpa(q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """softmax(q·kᵀ/√Dh)·v for q [B, Sq, H, Dh], k/v [B, Sk, H, Dh];
    causal masks bottom-right aligned."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    if Dh != HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim "
                         f"{HEAD_DIM}, got {Dh}")
    if k.shape != (B, Sk, H, Dh) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        # views of a fused qkv projection are taken as they are: heads
        # Dh apart, dims contiguous, 16-byte aligned rows
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention {name}: expected a CUDA "
                             f"bf16 tensor, got {t.dtype} on {t.device}")
        sb, ss, sh, sd = t.stride()
        if sd != 1 or sh != Dh or ss % 8 or sb % 8 or t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}: unsupported layout "
                             f"(strides {t.stride()})")
        strides += [sb, ss]
    out = torch.empty(B, Sq, H, Dh, dtype=q.dtype, device=q.device)
    fn = _cuda.function("umgen_flash_attention",
                        [_cuda.VOIDP] * 4 + [_cuda.INT] * 5
                        + [_cuda.FLOAT] + [_cuda.INT64] * 6 + [_cuda.VOIDP])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             Sq, Sk, int(causal), 1.0 / math.sqrt(Dh), *strides,
             _cuda.stream_ptr(q))
    _cuda.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
