"""Param-store checkpointing for native save / load and train resume (port
of umgen_tpu/runtime/checkpoint.py).

The JAX package stores its trees with orbax; the port stores the same
nested dicts of tensors with `torch.save` and reads them back with
`torch.load(weights_only=True)`.  Neither store reads the other's files
(orbax needs JAX; ROADMAP Queue 3).  The reference's own checkpoints are
read by runtime/torch_import.py.

* `save_params` / `load_params` — a param tree (or any tree of tensors);
* `save_train_state` / `load_train_state` — params + buffers + optimizer
  state (parallel/optim.py's tree: tuples of dicts, restored leaf by leaf)
  + step, for resuming a run.

A checkpoint is one file at `path`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from umgen_tpu_torch.parallel.optim import tree_map

Params = Dict[str, Any]


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_structure(v) for v in tree)
    return None


def save_params(path: str, params: Params) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(params, path)
    return path


def load_params(path: str, like: Optional[Params] = None,
                host: bool = False) -> Params:
    """Restore a tree.  `host=True` gives CPU tensors; `like` (a tree of
    the same structure) puts each leaf on its counterpart's device;
    otherwise each leaf returns to the device it was saved from."""
    path = os.path.abspath(path)
    tree = torch.load(path, map_location="cpu" if host or like is not None
                      else None, weights_only=True)
    if like is None:
        return tree
    if _structure(tree) != _structure(like):
        raise ValueError(f"{path} does not hold a tree of the structure "
                         "given by `like`")

    def place(t, ref):
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{path}: a leaf {tuple(t.shape)} {t.dtype} "
                             f"where `like` has {tuple(ref.shape)} "
                             f"{ref.dtype}")
        return t.to(ref.device)

    return tree_map(place, tree, like)


def save_train_state(path: str, state) -> str:
    """state: umgen_tpu_torch.parallel.train.TrainState."""
    tree = {"params": tree_map(lambda t: t.detach(), state.params),
            "buffers": state.buffers, "opt_state": state.opt_state,
            "step": state.step}
    return save_params(path, tree)


def load_train_state(path: str, like) -> Any:
    """Restore a TrainState onto the devices of `like` (a TrainState of
    the same run, e.g. `UMGenTrainer.init_state`'s): every leaf, the
    optimizer state's included, is checked against its counterpart and
    restored in place of it; the params come back as autograd leaves."""
    from umgen_tpu_torch.parallel.train import TrainState
    tree = load_params(path, like={
        "params": like.params, "buffers": like.buffers,
        "opt_state": like.opt_state, "step": like.step})
    params = tree_map(lambda t: t.requires_grad_(True), tree["params"])
    return TrainState(params, tree["buffers"], tree["opt_state"],
                      tree["step"])
