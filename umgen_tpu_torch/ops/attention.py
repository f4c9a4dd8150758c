"""Attention implementation selection (port of umgen_tpu/ops/attention.py).

The same dispatch rule as the JAX package: attentions over at least
`FLASH_MIN_SK` keys (every spatial S = 1031..2207 attention of the TAR, map,
box and ego stacks) go to the flash-attention kernel; the short temporal
attentions (T <= 20 keys) stay on plain `sdpa`.  There is no silent
fallback: on a CUDA tensor the kernel launches or raises.
"""

from __future__ import annotations

import torch

from umgen_tpu_torch.models.modules import sdpa
from umgen_tpu_torch.ops.flash_attention import flash_attention

FLASH_MIN_SK = 512


def attn_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """`sdpa`'s signature; routes long-key attention to flash_attention."""
    if k.shape[1] >= FLASH_MIN_SK:
        return flash_attention(q, k, v, causal=causal)
    return sdpa(q, k, v, causal)
