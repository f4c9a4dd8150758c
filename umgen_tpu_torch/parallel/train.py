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

The dp / tp mesh step of the JAX package is not ported: `jit_train_step`
with a mesh raises NotPortedError (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from umgen_tpu_torch.layout import SequenceLayout
from umgen_tpu_torch.models import modules as nn
from umgen_tpu_torch.models.rollout import Rollout
from umgen_tpu_torch.models.umgen import UMGen, NotPortedError
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
                 oar_loss_weight: float = 1.0):
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
        self.tx = optim.chain(optim.clip_by_global_norm(grad_clip), inner)

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
        ego_loss = _ce(nn.linear(params["head_ego"], ego_emb),
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
            logits = nn.linear(params[HEAD_TAR[seg.mod]], emb[:, :, 1:-1])
            tar_loss = tar_loss + _ce(logits, batch[seg.mod][:, 1:])
            # the separators' loss (ref:UMGen.py:558-582)
            d_logits = nn.linear(params["head_tar_aux"], torch.stack(
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
                nn.linear(params[HEAD_AR[seg.mod]], h_seg),
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
                   rng=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step: the state's params and optimizer state are updated in
        place and returned in a new TrainState; metrics are device
        tensors, `grad_norm` the norm of the raw gradients (before the
        clip)."""
        grads, metrics = self.grads(state, batch)
        with torch.no_grad():
            updates, opt_state = self.tx.update(grads, state.opt_state,
                                                state.params)
            new = optim.apply_updates(state.params, updates)
            optim.tree_map(lambda p, n: p.copy_(n), state.params, new)
            optim.tree_map(lambda s, n: s.copy_(n), state.opt_state,
                           opt_state)
            metrics["grad_norm"] = optim.global_norm(grads)
            state.step.add_(1)
        return state, metrics

    # ------------------------------------------------------------------
    def jit_train_step(self, mesh=None):
        """The step the CLI calls.  The JAX package jits it with the state
        donated; here it runs eagerly and updates the state in place.  The
        dp / tp mesh path is not ported."""
        if mesh is not None:
            raise NotPortedError(
                "a training mesh (dp / tp) is ROADMAP Queue 1 item 5, "
                "'Multi-GPU and runtime'")
        return self.train_step
