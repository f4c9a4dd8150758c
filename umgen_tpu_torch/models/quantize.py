"""Training-time quantizers (port of umgen_tpu/models/quantize.py): the
NormEMA vector quantizer the shipped VQ checkpoints were trained with
(l2-normalized codes, EMA codebook updates; ref:projects/tokenizer/
quantize.py:371-479), its cosine k-means codebook init (ref:quantize.py:
23-60) and the KL-VAE posterior `DiagonalGaussian` (ref:quantize.py:
482-533).

The quantizer is a function over an explicit `EMAState`, as in the JAX
package; the straight-through estimator and the stop-gradients are
`.detach()`.  With `axis_name` (a parallel.mesh.Mesh) the code counts and
embed sums are summed over the data-parallel ranks — the JAX package's `lax.psum`, the reference's
all-reduce — so every rank steps the codebook identically.  Random draws take a torch.Generator (the draws differ from
JAX's; ROADMAP Queue 3).

Inference-path quantization (nearest-code lookup) is in models/vq.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch



def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


class EMAState(NamedTuple):
    """Codebook state carried across training steps."""
    embedding: torch.Tensor      # (K, D), l2-normalized rows
    cluster_size: torch.Tensor   # (K,) EMA code-usage counts
    initted: torch.Tensor        # () bool — False until k-means init ran


def init_ema_state(generator: torch.Generator, n_codes: int, dim: int,
                   kmeans_init: bool = False,
                   codebook: Optional[torch.Tensor] = None,
                   device=None) -> EMAState:
    """Random l2-normed init, or zeros awaiting k-means on the first batch
    (ref:quantize.py:290-328); `codebook` given: its rows l2-normed."""
    if codebook is not None:
        emb = l2norm(torch.as_tensor(codebook, dtype=torch.float32,
                                     device=device))
        initted = True
    elif kmeans_init:
        emb = torch.zeros(n_codes, dim, device=device)
        initted = False
    else:
        emb = l2norm(torch.randn(n_codes, dim, generator=generator,
                                 device=device))
        initted = True
    return EMAState(emb, torch.zeros(n_codes, device=emb.device),
                    torch.tensor(initted, device=emb.device))


def kmeans_cosine(generator: torch.Generator, data: torch.Tensor,
                  n_codes: int, iters: int = 10,
                  means: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine-similarity k-means over (N, D) samples → (codebook (K, D),
    cluster sizes (K,)) (ref:quantize.py:23-60: sample init, argmax-sim
    assignment, mean, l2norm; an empty cluster keeps its previous mean).
    The initial means are K samples drawn by `generator` (with replacement
    only when N < K), or `means` where given."""
    n = data.shape[0]
    data = l2norm(data)
    if means is None:
        if n < n_codes:
            idx = torch.randint(n, (n_codes,), generator=generator,
                                device=generator.device)
        else:
            idx = torch.randperm(n, generator=generator,
                                 device=generator.device)[:n_codes]
        means = data[idx.to(data.device)]
    counts = torch.zeros(n_codes, dtype=data.dtype, device=data.device)
    for _ in range(iters):
        assign = torch.argmax(data @ means.T, dim=-1)
        onehot = torch.nn.functional.one_hot(assign, n_codes).to(data.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ data
        means = torch.where(counts[:, None] > 0,
                            l2norm(sums / torch.clamp(counts[:, None],
                                                      min=1.0)),
                            means)
    return means, counts


def norm_ema_quantize(state: EMAState, z: torch.Tensor, *, train: bool,
                      decay: float = 0.99, beta: float = 1.0,
                      eps: float = 1e-5, axis_name=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 EMAState]:
    """One NormEMA-VQ step (ref:quantize.py:414-479).

    z: (..., D) channel-last features → (z_q straight-through, commitment
    loss, indices (...,), new state).  The new state carries no gradient.
    `axis_name`: the parallel.mesh.Mesh whose ranks' code counts and
    embed sums are summed (JAX's `lax.psum` over the axis)."""
    D = z.shape[-1]
    zn = l2norm(z.float())
    zf = zn.reshape(-1, D)
    emb = state.embedding
    with torch.no_grad():
        d = (torch.sum(zf ** 2, 1, keepdim=True) + torch.sum(emb ** 2, 1)
             - 2.0 * zf @ emb.T)
        indices = torch.argmin(d, dim=-1)
        z_q = emb[indices].reshape(z.shape)
        onehot = torch.nn.functional.one_hot(indices, emb.shape[0]).float()
        bins = onehot.sum(0)
        embed_sum = zf.T @ onehot                  # (D, K)
        if axis_name is not None:
            axis_name.all_sum(bins)
            axis_name.all_sum(embed_sum)
        new_cluster = state.cluster_size * decay + bins * (1.0 - decay)
        if train:
            safe_bins = torch.where(bins == 0, torch.ones_like(bins), bins)
            embed_norm = l2norm((embed_sum / safe_bins).T)      # (K, D)
            embed_norm = torch.where((bins == 0)[:, None], emb, embed_norm)
            new_emb = l2norm(emb * decay + embed_norm * (1.0 - decay))
            new_state = EMAState(new_emb, new_cluster, state.initted)
        else:
            new_state = EMAState(emb, new_cluster, state.initted)
    loss = beta * torch.mean((z_q - zn) ** 2)
    z_q = zn + (z_q - zn).detach()                 # straight-through
    return z_q.to(z.dtype), loss, indices.reshape(z.shape[:-1]), new_state


def maybe_kmeans_init(state: EMAState, z: torch.Tensor,
                      generator: torch.Generator, iters: int = 10
                      ) -> EMAState:
    """k-means init on the first batch if the state is uninitialized
    (ref:quantize.py:329-338); reads `initted` on the host, once."""
    if bool(state.initted):
        return state
    with torch.no_grad():
        zf = l2norm(z.detach().float()).reshape(-1, z.shape[-1])
        emb, counts = kmeans_cosine(generator, zf,
                                    state.embedding.shape[0], iters)
    return EMAState(emb, counts.float(),
                    torch.tensor(True, device=emb.device))


class DiagonalGaussian:
    """Diagonal-Gaussian VAE posterior (ref:quantize.py:482-533).

    parameters: (..., 2C) channel-last mean‖logvar (the reference chunks
    dim=1 of NCHW; channel-last is the JAX package's layout)."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.parameters = parameters
        mean, logvar = torch.chunk(parameters, 2, dim=-1)
        self.mean = mean
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.deterministic = deterministic
        if deterministic:
            self.std = self.var = torch.zeros_like(mean)
        else:
            self.std = torch.exp(0.5 * self.logvar)
            self.var = torch.exp(self.logvar)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.mean + self.std * torch.randn(
            self.mean.shape, generator=generator, dtype=self.mean.dtype,
            device=self.mean.device)

    def kl(self, other: Optional["DiagonalGaussian"] = None
           ) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], device=self.mean.device)
        dims = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0
                                   - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var
            + self.var / other.var - 1.0 - self.logvar + other.logvar,
            dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], device=self.mean.device)
        dims = tuple(range(1, self.mean.dim()))
        logtwopi = float(np.log(2.0 * np.pi))
        return 0.5 * torch.sum(logtwopi + self.logvar
                               + (sample - self.mean) ** 2 / self.var,
                               dim=dims)

    def mode(self) -> torch.Tensor:
        return self.mean
