"""Training step: the teacher-forced next-scene objective (port of
umgen_tpu/parallel/train.py).

The public reference is inference-only; the JAX package added training,
and this is its port on one card.  The objective mirrors the paper's
two-network factorization, term by term as the JAX package computes it:

  * ego loss — the ego net's 3 query logits of every window slot t against
    the next action, pose[t+1];
  * TAR loss — each non-pose segment's TAR content logits of slot t
    against frame t+1's tokens, plus 0.1 × the cross entropy of its BOS /
    EOS separators (the reference's "d_loss"), averaged over the segments;
  * OAR loss — the teacher-forced causal pass over the final frame's full
    2207-token stream with the TAR prior added, averaged over the
    segments, weighted by oar_loss_weight.

The backward pass is autograd's.  No kernel of the port is on this path:
the JAX trainer runs XLA attention (`use_pallas_attention=False`) and no
Pallas kernel has a backward, so the port trains on its plain `sdpa`,
cuBLAS products and the exact GELU's derivative; a kernel reached under
autograd raises (ops/flash_attention.py, ops/decode_kernel.py).  With
config.remat each block is recomputed in the backward pass.  A step
updates the state's tensors in place (JAX donates them) and reads nothing
back to the host: the metrics stay tensors on the device.

Data and tensor parallelism (`jit_train_step(mesh)`, a parallel.mesh.
Mesh): the counterpart of the JAX package's GSPMD step at any (dp, tp),
which computes the global batch's gradient.  Every rank takes its dp
index's rows of the global batch and runs the loss there; the gradients
are all-reduced over the dp group to their mean before the clip.  Every
loss term is a plain mean over its rows (`_ce`), so equal shards average
to the global batch's loss.  Under tp > 1 the trainer is built on the
mesh (`UMGenTrainer(mesh=)`) and the state is the rank's blocks
(`shard_state`): the model runs split (UMGen.on_mesh), each head's logits
gathered over the group before the loss, and Megatron's conjugate
collectives make every replicated leaf's gradient whole on every rank; the
clip's global norm is the whole tree's (`mesh.global_norm`: each split
leaf's squares summed over the group, each replicated leaf counted once),
as optax.global_norm over JAX's global arrays.  AdamW works elementwise
on the blocks.  The replicated leaves and their moments stay equal on
every rank; the metrics are the dp ranks' mean.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch

from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.parallel import optim

Params = Dict[str, Any]

HEAD_TAR = {"map": "head_tar_map", "bbox3d": "head_tar_bbox3d",
            "image": "head_tar_img", "pose": "head_tar_pose"}
HEAD_AR = {"pose": "head_ar_pose", "map": "head_ar_map",
           "bbox3d": "head_ar_bbox3d", "image": "head_ar_img"}


class TrainState(NamedTuple):
    params: Params          # trainable (no buffers)
    buffers: Params
    opt_state: Any
    step: torch.Tensor      # int32 0-d, on the params' device


def shard_state(mesh, state: TrainState) -> TrainState:
    """A rank's blocks of a whole TrainState (params and optimizer state;
    parallel.mesh.Mesh.shard_params), the params autograd leaves again."""
    with torch.no_grad():
        params = mesh.shard_params(optim.tree_map(lambda t: t.detach(),
                                                  state.params))
        opt = mesh.shard_params(state.opt_state)
    return TrainState(optim.tree_map(lambda t: t.requires_grad_(True),
                                     params), state.buffers, opt, state.step)


def whole_state(mesh, state: TrainState) -> TrainState:
    """The whole TrainState from every tp rank's blocks (a collective:
    every rank of the group calls it)."""
    with torch.no_grad():
        return TrainState(
            mesh.unshard_params(optim.tree_map(lambda t: t.detach(),
                                               state.params)),
            state.buffers, mesh.unshard_params(state.opt_state), state.step)


def split_params(params: Params) -> Tuple[Params, Params]:
    trainable = {k: v for k, v in params.items() if k != "buffers"}
    return trainable, params["buffers"]


def frame_stream(layout: SequenceLayout,
                 frame_tokens: Dict[str, torch.Tensor]) -> torch.Tensor:
    """{mod: [B, content_len]} → [B, seq_len] with the separators."""
    first = frame_tokens[layout.mod_order[0]]
    B = first.shape[0]
    cols = []
    for seg in layout.segments:
        cols += [torch.full((B, 1), seg.bos, dtype=torch.long,
                            device=first.device),
                 frame_tokens[seg.mod].long(),
                 torch.full((B, 1), seg.eos, dtype=torch.long,
                            device=first.device)]
    return torch.cat(cols, dim=1)


def _ce(logits: torch.Tensor, targets: torch.Tensor,
        label_smooth: float = 0.0) -> torch.Tensor:
    """Mean cross entropy in float32; label_smooth > 0 mixes that much
    uniform mass into the target: -((1-ls)·mean(log p[target]) +
    ls·mean(log p)) (the JAX trainer's verifier-sharpness cap)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tl = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if label_smooth > 0.0:
        return -((1.0 - label_smooth) * tl.mean()
                 + label_smooth * logp.mean())
    return -tl.mean()


class UMGenTrainer:
    def __init__(self, model: UMGen,
                 learning_rate: float = 1e-4,
                 weight_decay: float = 0.01,
                 warmup_steps: int = 1000,
                 total_steps: int = 100_000,
                 grad_clip: float = 1.0,
                 optimizer: str = "adamw",
                 oar_label_smooth: float = 0.0,
                 oar_loss_weight: float = 1.0,
                 mesh=None):
        """mesh: the parallel.mesh.Mesh of a tensor-parallel run (tp > 1):
        the model runs on it and the clip measures the whole tree's norm
        (`mesh.global_norm`); a data-parallel mesh is given to
        `jit_train_step` alone."""
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        if self.mesh is not None:
            model = model.on_mesh(mesh)
        self.model = model
        self.rollout = Rollout(model)
        self.layout = model.layout
        self.oar_label_smooth = oar_label_smooth
        self.oar_loss_weight = oar_loss_weight
        warmup_steps = min(warmup_steps, max(total_steps // 10, 1))
        self.schedule = optim.warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_steps,
            max(total_steps, warmup_steps + 1),
            end_value=learning_rate * 0.1)
        self.norm = self.mesh.global_norm if self.mesh is not None else \
            optim.global_norm
        if optimizer == "sign_sgd":
            # stateless: no clipping, no decay
            self.tx = optim.sign_sgd(self.schedule)
            return
        if optimizer == "sgd":
            inner = optim.sgd(self.schedule)
        elif optimizer == "adamw":
            inner = optim.adamw(self.schedule, weight_decay=weight_decay)
        else:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.tx = optim.chain(
            optim.clip_by_global_norm(grad_clip, norm=self.norm), inner)

    # ------------------------------------------------------------------
    def init_state(self, params: Params) -> TrainState:
        """The state of a run from `params` (the full tree, buffers
        included): the trainable leaves become autograd leaves."""
        trainable, buffers = split_params(params)
        trainable = optim.tree_map(
            lambda t: t.detach().requires_grad_(True), trainable)
        with torch.no_grad():
            opt_state = self.tx.init(trainable)
        leaf = next(optim.tree_leaves(trainable))
        return TrainState(trainable, buffers, opt_state,
                          torch.zeros((), dtype=torch.int32,
                                      device=leaf.device))

    # ------------------------------------------------------------------
    def loss_fn(self, trainable: Params, buffers: Params,
                batch: Dict[str, torch.Tensor], rng=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {mod: [B, T, content_len]} raw clip tokens, T >= 3.
        `rng` is accepted as the JAX trainer's is, and unused as there."""
        model, lo = self.model, self.layout
        params = dict(trainable)
        params["buffers"] = buffers

        raw_in = {m: batch[m][:, :-1] for m in lo.mod_order}
        shifted = dict(raw_in)
        shifted["pose"] = batch["pose"][:, 1:]

        # ego loss: window slot t predicts action a_t = pose[t+1]
        ego_emb = model.forward_ego_net(params, raw_in)       # [B, W, 3, D]
        ego_loss = _ce(model.head(params, "head_ego", ego_emb),
                       batch["pose"][:, 1:])

        # TAR: slot t holds frame t's content (+ action a_t) and predicts
        # frame t+1's content
        tar_emb = model.tar_cascade(params, shifted)["tar_emb"]
        tar_loss = 0.0
        n_terms = 0
        for seg in lo.segments:
            if seg.mod == "pose":       # the ego net supervises the action
                continue
            emb = tar_emb[seg.mod]
            if seg.mod == "bbox3d":     # the n-step head's step-0 slice
                logits = model.tar_bbox_logits(params, emb[:, :, 1:-1])
            else:
                logits = model.head(params, HEAD_TAR[seg.mod],
                                    emb[:, :, 1:-1])
            tar_loss = tar_loss + _ce(logits, batch[seg.mod][:, 1:])
            # the separators' loss (ref:UMGen.py:558-582)
            d_logits = model.head(params, "head_tar_aux", torch.stack(
                [emb[:, :, 0], emb[:, :, -1]], dim=2))
            d_tgt = torch.full(d_logits.shape[:-1], seg.eos,
                               dtype=torch.long, device=emb.device)
            d_tgt[..., 0] = seg.bos
            tar_loss = tar_loss + 0.1 * _ce(d_logits, d_tgt)
            n_terms += 1
        tar_loss = tar_loss / max(n_terms, 1)

        # OAR on the final frame
        prior_seq = torch.cat([tar_emb[s.mod][:, -1] for s in lo.segments],
                              dim=1)
        target = {m: batch[m][:, -1] for m in lo.mod_order}
        oar_in = self.rollout.oar_inputs_from_tokens(
            params, frame_stream(lo, target), prior_seq)
        h = model.oar_forward(params, oar_in)                 # [B, S, D]
        oar_loss = 0.0
        for seg in lo.segments:
            # the output at input p-1 predicts position p
            h_seg = h[:, seg.content_start - 1:seg.content_end]
            oar_loss = oar_loss + _ce(
                model.head(params, HEAD_AR[seg.mod], h_seg),
                target[seg.mod], self.oar_label_smooth)
        oar_loss = oar_loss / len(lo.segments)

        loss = ego_loss + tar_loss + self.oar_loss_weight * oar_loss
        return loss, {"loss": loss, "ego_loss": ego_loss,
                      "tar_loss": tar_loss, "oar_loss": oar_loss}

    # ------------------------------------------------------------------
    def grads(self, state: TrainState, batch: Dict[str, torch.Tensor]
              ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        """(gradients of every trainable leaf, metrics).  A leaf the loss
        does not reach gets zeros, as JAX's gradient gives it."""
        with torch.enable_grad():
            loss, metrics = self.loss_fn(state.params, state.buffers, batch)
            grads = optim.grads(loss, state.params)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   rng=None, mesh=None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step: the state's params and optimizer state are updated in
        place and returned in a new TrainState; metrics are device
        tensors, `grad_norm` the norm of the raw gradients (before the
        clip).  Under `mesh` the batch is the global one: this rank's rows
        are its loss, and the gradients and metrics are the dp ranks' mean
        (under tp the state is the rank's blocks and the model the trainer's
        on the mesh: `UMGenTrainer(mesh=)`)."""
        if mesh is not None:
            batch = {k: mesh.shard(v) for k, v in batch.items()}
        grads, metrics = self.grads(state, batch)
        if mesh is not None:
            mesh.tree_mean(grads)
            mesh.tree_mean(metrics)
        with torch.no_grad():
            updates, opt_state = self.tx.update(grads, state.opt_state,
                                                state.params)
            new = optim.apply_updates(state.params, updates)
            optim.tree_map(lambda p, n: p.copy_(n), state.params, new)
            optim.tree_map(lambda s, n: s.copy_(n), state.opt_state,
                           opt_state)
            metrics["grad_norm"] = self.norm(grads)
            state.step.add_(1)
        return state, metrics

    # ------------------------------------------------------------------
    def jit_train_step(self, mesh=None):
        """The step the CLI calls.  The JAX package jits it with the state
        donated; here it runs eagerly and updates the state in place.
        With a mesh it takes the global batch (above); a mesh with tp > 1
        must be the trainer's own (`UMGenTrainer(mesh=)`, also the default),
        and the state the rank's blocks (`shard_state`)."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            return self.train_step
        if mesh.tp > 1 and mesh is not self.mesh:
            raise ValueError(
                f"tp={mesh.tp}: a tensor-parallel step needs the trainer "
                f"built on its mesh, UMGenTrainer(model, mesh=mesh)")
        return functools.partial(self.train_step, mesh=mesh)
