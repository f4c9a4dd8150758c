"""Token sampling: top-k / top-p / temperature / greedy (port of
umgen_tpu/models/sampling.py).

Each sampler is fn(generator, logits [..., V]) → tokens [...] (int64).
The noise comes from the given torch.Generator, so torch and JAX draw
different samples from the same seed; greedy decoding is deterministic.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch


def _categorical(generator: Optional[torch.Generator],
                 probs: torch.Tensor) -> torch.Tensor:
    flat = probs.reshape(-1, probs.shape[-1])
    idx = torch.multinomial(flat, 1, generator=generator)
    return idx.reshape(probs.shape[:-1])


def top_k_sample(generator, logits: torch.Tensor, k: int,
                 temp: float = 1.0) -> torch.Tensor:
    """Keep the k largest logits, softmax(·/T), draw one."""
    vals, idx = torch.topk(logits.float(), k, dim=-1)
    choice = _categorical(generator, torch.softmax(vals / temp, dim=-1))
    return torch.gather(idx, -1, choice[..., None])[..., 0]


def top_p_sample(generator, logits: torch.Tensor, p: float,
                 temp: float = 1.0) -> torch.Tensor:
    """Nucleus sampling with the reference's mask polarity: an entry is
    dropped when (cumsum - p_i) > p, so the top token always survives."""
    probs = torch.softmax(logits.float() / temp, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True)
    cum = torch.cumsum(sorted_p, dim=-1)
    sorted_p = torch.where((cum - sorted_p) <= p, sorted_p,
                           torch.zeros_like(sorted_p))
    idx = _categorical(generator, sorted_p / sorted_p.sum(-1, keepdim=True))
    return torch.gather(order, -1, idx[..., None])[..., 0]


def greedy_sample(generator, logits: torch.Tensor) -> torch.Tensor:
    del generator
    return torch.argmax(logits, dim=-1)


def make_sampler(method: str, param=None, temp: float = 1.0) -> Callable:
    """→ fn(generator, logits [..., V]) -> tokens [...] (int64)."""
    if method == "topk":
        return functools.partial(top_k_sample, k=int(param), temp=temp)
    if method == "topp":
        return functools.partial(top_p_sample, p=float(param), temp=temp)
    if method == "greedy":
        return greedy_sample
    raise ValueError(f"unknown sample method {method!r}")
