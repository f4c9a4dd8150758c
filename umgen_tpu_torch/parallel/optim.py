"""Optimizers over param trees: the port's counterpart of the optax chains
that umgen_tpu/parallel/train.py:104-129 (AdamW, SGD and sign-SGD behind a
global-norm clip) and umgen_tpu/tools/train_vq.py:103 (Adam) build.

Written as optax is, plain functions on nested dicts of tensors: a
`Transform` is `init(params) → state` and `update(updates, state, params) →
(updates, state)`; `chain` runs transforms in order, `apply_updates` adds
the result to the params.  A state is a tuple of the chained transforms'
states, each a dict of tensors ({} where optax's is `EmptyState`), so it
saves and restores leaf by leaf (runtime/checkpoint.py).

Why not torch.optim: the JAX trainer's params and Adam moments are bf16
(ModelConfig.param_dtype is never read, ROADMAP Queue 3), and
torch.optim.AdamW rounds in another order — it decays p first, updates
the moments with `lerp_` and folds the bias corrections into the step
size.  Here every operation is optax's, in the leaf's dtype:

  * a Python constant meets a leaf as optax's weakly typed scalar does:
    rounded to the leaf's dtype first (b1 = 0.9 is 0.8984375 on a bf16
    leaf, b2 = 0.999 is 1.0);
  * mu = (1-b1)·g + b1·mu, nu = (1-b2)·g² + b2·nu;
  * mu_hat = mu / (1 - b1^count), the bias correction in float32, cast to
    the leaf's dtype before the division;
  * u = mu_hat / (sqrt(nu_hat) + eps), then u + wd·p on every leaf (no
    mask), then u · -lr(count), the schedule read at the count before the
    step and cast to the leaf's dtype;
  * p = (p + u) in p's dtype;
  * the global-norm clip: g if norm < max_norm else (g / norm)·max_norm,
    norm = sqrt(Σ sum(g²)) over the leaves in JAX's flattening order (dict
    keys sorted), each leaf's sum in its own dtype (torch.nn.utils'
    clip_grad_norm_ scales by max_norm / (norm + 1e-6) instead).

Counts are int32 tensors on the params' device and the schedule is
evaluated there: an update never waits on the host.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import torch

Params = Dict[str, Any]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of nested dicts / lists (the same structure in
    every tree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The leaves in JAX's flattening order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def _as(x: float, dtype: torch.dtype) -> float:
    """A Python constant as optax applies it to a `dtype` leaf: rounded to
    that dtype (JAX's weak typing).  Multiplying by the rounded value
    in PyTorch's float arithmetic then rounds as XLA does."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _scalar(like: torch.Tensor, x: float) -> torch.Tensor:
    """A float32 0-d tensor on `like`'s device (a fill, no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _count(params: Params) -> torch.Tensor:
    leaf = next(tree_leaves(params))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: init → end over transition_steps, then end;
    a constant init_value when transition_steps <= 0."""
    def schedule(count):
        if transition_steps <= 0:
            return _scalar(count, init_value)
        c = torch.clamp(count, 0, transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(count):
        c = torch.clamp(count.float(), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine to end_value at decay_steps.
    A schedule maps an int32 count tensor to a float32 tensor."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                alpha)

    def schedule(count):
        return torch.where(count < warmup_steps, warm(count),
                           cos(count - warmup_steps))

    return schedule


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ_leaves sum(leaf²)) as optax.global_norm: each leaf's sum in
    the leaf's dtype, the running total promoted as JAX promotes it."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + leaf.square().sum()
    return torch.sqrt(total)


def _empty(params) -> Dict:
    return {}


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(updates, state, params=None):
        norm = global_norm(updates)
        keep = norm < max_norm
        return tree_map(lambda t: torch.where(
            keep, t, (t / norm.to(t.dtype)) * _as(max_norm, t.dtype)),
            updates), state

    return Transform(_empty, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        return {"count": _count(params), "mu": zeros,
                "nu": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        count = state["count"] + 1
        cf = count.float()
        bc1 = 1 - torch.pow(_scalar(cf, b1), cf)
        bc2 = 1 - torch.pow(_scalar(cf, b2), cf)

        def moment(g, t, decay, order):
            gg = g if order == 1 else g * g
            return _as(1 - decay, g.dtype) * gg + _as(decay, t.dtype) * t

        mu = tree_map(lambda g, t: moment(g, t, b1, 1), updates, state["mu"])
        nu = tree_map(lambda g, t: moment(g, t, b2, 2), updates, state["nu"])
        out = tree_map(
            lambda m, v: (m / bc1.to(m.dtype))
            / (torch.sqrt((v / bc2.to(v.dtype)) + 0.0) + _as(eps, v.dtype)),
            mu, nu)
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(updates, state, params):
        return tree_map(lambda g, p: g + _as(weight_decay, p.dtype) * p,
                        updates, params), state

    return Transform(_empty, update)


def scale_by_schedule(step_size: Schedule) -> Transform:
    """updates · step_size(count), the step size cast to each leaf's dtype
    first; count is the number of earlier updates."""
    def init(params):
        return {"count": _count(params)}

    def update(updates, state, params=None):
        s = step_size(state["count"])
        return (tree_map(lambda g: s.to(g.dtype) * g, updates),
                {"count": state["count"] + 1})

    return Transform(init, update)


def scale(step_size: float) -> Transform:
    def update(updates, state, params=None):
        return tree_map(lambda g: step_size * g, updates), state

    return Transform(_empty, update)


def sign() -> Transform:
    def update(updates, state, params=None):
        return tree_map(torch.sign, updates), state

    return Transform(_empty, update)


def identity() -> Transform:
    return Transform(_empty, lambda updates, state, params=None:
                     (updates, state))


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return Transform(init, update)


def grads(loss: torch.Tensor, params: Params) -> Params:
    """d loss / d params as a tree like `params` (autograd leaves).  A
    leaf the loss does not reach gets zeros, as JAX's gradient gives it
    (PyTorch's would be None)."""
    leaves = list(tree_leaves(params))
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, got)}
    return tree_map(lambda t: by_id[id(t)], params)


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# the chains the JAX package builds
# ---------------------------------------------------------------------------
def _learning_rate(lr) -> Transform:
    """optax.scale_by_learning_rate: a schedule or a constant, negated."""
    if callable(lr):
        return scale_by_schedule(lambda count: -1 * lr(count))
    return scale(-1 * lr)


def adamw(learning_rate, weight_decay: float = 1e-4, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8) -> Transform:
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 _learning_rate(learning_rate))


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    return chain(scale_by_adam(b1, b2, eps), _learning_rate(learning_rate))


def sgd(learning_rate) -> Transform:
    return chain(identity(), _learning_rate(learning_rate))


def sign_sgd(learning_rate: Schedule) -> Transform:
    """The JAX trainer's stateless sign-SGD: sign(g) · -lr(count)."""
    return chain(sign(), scale_by_schedule(lambda s: -learning_rate(s)))
