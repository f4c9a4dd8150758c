"""Speculative decoding of a frame's segments with the TAR prior as draft
(port of umgen_tpu/models/speculative.py).

The TAR network already gives, for every frame position, logits trained to
predict that position's token, so its heads are a free, position-wise
independent draft model for the OAR decode: draft K tokens from the TAR
head at the next K positions, verify them in ONE multi-query OAR step
(causal inside the chunk: inputs [prev, embed(draft_0..K-2)]), and keep the
longest accepted prefix under the lossless rejection scheme — the emitted
stream is distributed as sequential sampling from the OAR.  Greedy mode
reproduces the sequential greedy stream up to float32 ties between the
Q = 1 and Q = K sum orders.

With the fused kernels on, a verify chunk is one `Rollout.oar_step` at Q =
K: the multi-query kernels (v5mq, w4mq, and v5mqi4 / w4mqi4 on the int4
cache) stream each weight and KV block once for all K queries.

Cache discipline: each chunk pushes K inputs at cache rows [c0+pos-1,
c0+pos+K-2].  On partial acceptance the next chunk's writes start at
c0+new_pos-1 <= the old tail and overwrite the stale rows before any read
can see them (`oar_step` reads rows < cache_len and writes AT cache_len);
the cache carries K slack rows for the writes past a segment's end
(`Rollout.init_kv`).

The JAX package runs a segment as one `lax.while_loop` on the device.  Here
it is a host loop over chunks with the chunk's tensors on the device and one
host sync a chunk: the accepted length (with, on the bbox segment, whether
the collision rule killed the box the chunk completes).  The random draws
come from the caller's torch.Generator in the JAX package's order of uses
(drafts, the control drafts on the bbox segment, the acceptance uniforms,
the residual), so only greedy runs compare token for token.  Greedy
decisions (the draft tables, the verify's targets) go through the rollout's
greedy samplers, where a test can record and replay them.

The JAX package writes a chunk's tokens with a clamping
`dynamic_update_slice`, so that in a segment's last K - 1 positions its
chunk lands early and leaves zeros; the port writes where the chunk starts.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from umgen_tpu_torch.models import modules as nn
from umgen_tpu_torch.ops.collision import candidate_collides

Params = Dict[str, Any]

# a bbox verify chunk spans at most one box completion (11 tokens a box)
MAX_BBOX_K = 11


def topk_dist(logits: torch.Tensor, k: int, temp: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [..., V] → (probs [..., k], idx [..., k]) of the top-k
    renormalized sampling distribution."""
    vals, idx = torch.topk(logits.float(), k, dim=-1)
    return torch.softmax(vals / temp, dim=-1), idx


def dist_prob_of(token: torch.Tensor, p: torch.Tensor, idx: torch.Tensor
                 ) -> torch.Tensor:
    """Probability of `token` [...] under the sparse (p, idx) dist."""
    return torch.where(idx == token[..., None], p,
                       torch.zeros_like(p)).sum(-1)


def _scatter_dense(p: torch.Tensor, idx: torch.Tensor, V: int
                   ) -> torch.Tensor:
    """[B, k] sparse → [B, V] dense."""
    out = torch.zeros(p.shape[0], V, dtype=torch.float32, device=p.device)
    return out.scatter_add_(1, idx, p.float())


class SpecTelemetry(NamedTuple):
    chunks: int          # verify steps executed
    accepted: int        # accepted draft tokens (the lockstep minimum)


def _categorical(generator, probs: torch.Tensor) -> torch.Tensor:
    """One draw a row of probs [..., n] (rows need not be normalized)."""
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])


def _draw(generator, p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One token a row of the sparse dists (p, idx) [..., k]."""
    choice = _categorical(generator, p)
    return torch.gather(idx, -1, choice[..., None])[..., 0]


def _residual(generator, p_dense: torch.Tensor, q_dense: torch.Tensor
              ) -> torch.Tensor:
    """A draw from the normalized (p − q)+ [B, V]; uniform where p == q
    (the JAX package's categorical over log(resid + 1e-30))."""
    resid = torch.clamp(p_dense - q_dense, min=0.0)
    resid = resid / torch.clamp(resid.sum(-1, keepdim=True), min=1e-30)
    return _categorical(generator, resid + 1e-30)


def _pad_tables(a: torch.Tensor, K: int, value) -> torch.Tensor:
    """[B, n, ...] → [B, n + K, ...], the K appended rows `value` (chunk
    slices near the segment end stay in bounds)."""
    pad = torch.full((a.shape[0], K) + tuple(a.shape[2:]), value,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=1)


def _pad_dist(p: torch.Tensor, idx: torch.Tensor, K: int):
    """Sparse dist tables padded by K positions of token 0 with p = 1."""
    p = _pad_tables(p, K, 0.0)
    p[:, -K:, 0] = 1.0
    return p, _pad_tables(idx, K, 0)


def _local_prior(prior_seq: torch.Tensor, c0: int, n: int, K: int):
    """Index i ↔ global input index c0 - 1 + i, i in [0, n + K)."""
    return _pad_tables(prior_seq[:, c0 - 1:c0 + n], K - 1, 0.0)


def _lockstep(ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ok [B, K] → (each scene's accepted prefix [B], the batch minimum, a
    0-dim device tensor: the batch advances in lockstep)."""
    n_accept = torch.cumprod(ok.long(), dim=1).sum(1)
    return n_accept, n_accept.min()


def _col(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """a[:, j] for a 0-dim index tensor j (no host sync)."""
    return a.index_select(1, j.reshape(1))[:, 0]


def _verify(rollout, params: Params, mod: str, head_ar: str, drafts, prev,
            pri, pos: int, c0: int, kv_k, kv_v, K: int) -> torch.Tensor:
    """One multi-query verify step: inputs [prev, embed(draft_0..K-2)] at
    cache row c0 + pos - 1 → the OAR head's logits [B, K, V]."""
    demb = rollout._embed_token(params, mod, drafts[:, :-1])
    x = torch.cat([prev, (demb + pri[:, pos + 1:pos + K]).to(prev.dtype)],
                  dim=1)
    h, _, _ = rollout.oar_step(params, x, kv_k, kv_v, cache_len=c0 + pos - 1)
    return nn.linear(params[head_ar], h)


def _emit(tokens, drafts, boundary, n_min: int, pos: int, n_emit: int):
    """Write the chunk's emitted tokens: the accepted drafts, then at
    column n_min the boundary token."""
    emit = drafts.clone()
    if n_min < emit.shape[1]:
        emit[:, n_min] = boundary
    tokens[:, pos:pos + n_emit] = emit[:, :n_emit]


def _next_input(rollout, params, mod, tokens, pri, new_pos, dt):
    """embed(last emitted token) + its prior: the next chunk's first
    input."""
    n = tokens.shape[1]
    last = tokens[:, min(max(new_pos - 1, 0), n - 1)]
    return (rollout._embed_token(params, mod, last)[:, None, :]
            + pri[:, new_pos:new_pos + 1]).to(dt)


def decode_segment_speculative(rollout, params: Params, seg, state,
                               prior_seq: torch.Tensor, head_ar: str,
                               head_tar: str, k: int, temp: float, K: int,
                               greedy: bool, generator=None):
    """A map or image segment → (state', tokens [B, content_len],
    SpecTelemetry)."""
    B = state.prev_emb.shape[0]
    n, c0, mod = seg.content_len, seg.content_start, seg.mod
    dt = state.prev_emb.dtype
    draft_logits = nn.linear(params[head_tar], prior_seq[:, c0 - 1:c0 - 1 + n])
    if greedy:
        argmax = rollout._samplers[mod]
        d_tok = _pad_tables(argmax(generator, draft_logits), K, 0)
    else:
        d_p, d_idx = _pad_dist(*topk_dist(draft_logits, k, temp), K)
    pri = _local_prior(prior_seq, c0, n, K)
    tokens = torch.zeros(B, n, dtype=torch.long, device=prior_seq.device)
    prev = state.prev_emb
    pos = chunks = accepted = 0
    while pos < n:
        sl = slice(pos, pos + K)
        if greedy:
            drafts = d_tok[:, sl]
        else:
            dp, di = d_p[:, sl], d_idx[:, sl]
            drafts = _draw(generator, dp, di)
            draft_prob = dist_prob_of(drafts, dp, di)
        t_logits = _verify(rollout, params, mod, head_ar, drafts, prev, pri,
                           pos, c0, state.kv_k, state.kv_v, K)
        if greedy:
            target = argmax(generator, t_logits)
            ok = drafts == target
        else:
            t_p, t_idx = topk_dist(t_logits, k, temp)
            u = torch.rand(B, K, generator=generator, device=drafts.device)
            ok = u < dist_prob_of(drafts, t_p, t_idx) / torch.clamp(
                draft_prob, min=1e-30)
        n_accept, n_min_d = _lockstep(ok)
        j = torch.clamp(n_min_d, max=K - 1)
        if greedy:
            corrected = _col(target, j)
        else:
            V = t_logits.shape[-1]
            corrected = _residual(
                generator, _scatter_dense(_col(t_p, j), _col(t_idx, j), V),
                _scatter_dense(_col(dp, j), _col(di, j), V))
        # elements rejected after the batch minimum keep their accepted
        # draft at the boundary column (their surplus re-drafts next
        # chunk, which leaves the distribution unchanged); only those
        # rejected there emit the corrected token
        boundary = torch.where(n_accept > n_min_d, _col(drafts, j),
                               corrected)
        n_min = int(n_min_d)                    # the chunk's one host sync
        n_emit = min(n_min + 1, K, n - pos)
        _emit(tokens, drafts, boundary, n_min, pos, n_emit)
        pos += n_emit
        chunks += 1
        accepted += n_min
        prev = _next_input(rollout, params, mod, tokens, pri, pos, dt)
    return state._replace(prev_emb=prev), tokens, SpecTelemetry(chunks,
                                                                accepted)


def decode_bbox_segment_speculative(rollout, params: Params, seg, state,
                                    prior_seq: torch.Tensor,
                                    prev_frame_bbox: torch.Tensor,
                                    tar_box_logits: torch.Tensor,
                                    control_mask: torch.Tensor, K: int,
                                    greedy: bool, generator=None):
    """Speculative decode of the bbox segment (660 positions) under the
    sequential decode rules (Rollout._decode_bbox_segment):

    * target: the pad→TAR merge rule makes the emitted marginal a mixture —
      for an object alive last frame P(t) = P_oar(t)·[t != pad] +
      P_oar(pad)·P_tar(t) (both top-k renormalized), else plain top-k OAR;
    * control-overridden slots sample the pad-masked TAR head on both sides
      (draft == target, always accepted); no-born positions are a delta at
      <pad> on both sides;
    * the collision rule constraint applies to each completed box: chunks
      are clamped to K <= 11, so at most one box completes in a chunk; on a
      kill acceptance is cut at the completion, so every later position
      re-drafts conditioned on the rewritten <pad>s (already-written K/V of
      killed tokens is not recomputed, as in the sequential path).

    → (state', tokens [B, 660], SpecTelemetry)."""
    from umgen_tpu_torch.models.rollout import MAX_BOXES

    cfg = rollout.config
    B = state.prev_emb.shape[0]
    n, c0 = seg.content_len, seg.content_start
    dev, dt = prior_seq.device, state.prev_emb.dtype
    pad = cfg.bbox3d_vocab_size - 1
    k, temp, V = cfg.top_k, cfg.sfmx_temp, cfg.bbox3d_vocab_size
    K = min(K, MAX_BBOX_K)
    merge_on = cfg.merge_ar_tar and not cfg.only_ar
    buf = params["buffers"]

    # per-position draft tables (+K pad rows so chunk slices stay in bounds)
    ctrl_logits = tar_box_logits.clone()
    ctrl_logits[:, :, -1] = float("-inf")
    if greedy:
        argmax = rollout._samplers["bbox3d"]
        d0 = _pad_tables(argmax(generator, tar_box_logits), K, 0)
        c0_tok = _pad_tables(argmax(generator, ctrl_logits), K, 0)
    else:
        d_p, d_idx = _pad_dist(*topk_dist(tar_box_logits, k, temp), K)
        c_p, c_idx = _pad_dist(*topk_dist(ctrl_logits, k, temp), K)
    # per-position flags (the padded region: free, not control, not newborn)
    obj = torch.clamp((torch.arange(n, device=dev) + 1) // 11, max=60)
    is_ctrl_tab = _pad_tables(control_mask[:, obj], K, False)
    prev_pad_tab = _pad_tables(prev_frame_bbox == pad, K, False)
    pri = _local_prior(prior_seq, c0, n, K)

    # collision buffers: slot 0 = the ego box
    boxes = torch.zeros(B, MAX_BOXES, 10, device=dev)
    boxes[:, 0] = rollout._ego_box.to(dev)
    bvalid = torch.zeros(B, MAX_BOXES, dtype=torch.bool, device=dev)
    bvalid[:, 0] = True
    nbox = torch.ones(B, dtype=torch.long, device=dev)
    slots = torch.arange(MAX_BOXES, device=dev)
    tokens = torch.zeros(B, n, dtype=torch.long, device=dev)
    prev = state.prev_emb
    pos = chunks = accepted = 0

    def q_of(tok, dp, di, cp, ci, is_ctrl, prev_pad):
        """Draft probability of `tok` under the per-position switch."""
        q = torch.where(is_ctrl, dist_prob_of(tok, cp, ci),
                        dist_prob_of(tok, dp, di))
        if cfg.no_born:
            q = torch.where(prev_pad, (tok == pad).float(), q)
        return q

    def p_of(tok, tp, ti, dp, di, cp, ci, is_ctrl, prev_pad):
        """Target probability: top-k OAR composed with the decode rules."""
        p = dist_prob_of(tok, tp, ti)
        if merge_on:
            p_merge = (p * (tok != pad)
                       + dist_prob_of(torch.full_like(tok, pad), tp, ti)
                       * dist_prob_of(tok, dp, di))
            p = torch.where(~prev_pad & ~is_ctrl, p_merge, p)
        p = torch.where(is_ctrl, dist_prob_of(tok, cp, ci), p)
        if cfg.no_born:
            p = torch.where(prev_pad, (tok == pad).float(), p)
        return p

    def rule_target(t, d_best, c_best, is_ctrl, prev_pad):
        """The greedy target: the OAR's argmax under the decode rules."""
        if merge_on:
            t = torch.where((t == pad) & ~prev_pad & ~is_ctrl, d_best, t)
        t = torch.where(is_ctrl, c_best, t)
        if cfg.no_born:
            t = torch.where(prev_pad, torch.full_like(t, pad), t)
        return t

    def dense_pair(j, t_p, t_idx, dp, di, cp, ci, is_ctrl, prev_pad):
        """(p, q) [B, V] dense at the boundary column j."""
        ctrl_j, ppad_j = _col(is_ctrl, j), _col(prev_pad, j)
        q_tar = _scatter_dense(_col(dp, j), _col(di, j), V)
        q_ctrl = _scatter_dense(_col(cp, j), _col(ci, j), V)
        p_dense = _scatter_dense(_col(t_p, j), _col(t_idx, j), V)
        if merge_on:
            p_m = p_dense.clone()
            p_m[:, pad] = 0.0
            p_m = p_m + p_dense[:, pad:pad + 1] * q_tar
            p_dense = torch.where((~ppad_j & ~ctrl_j)[:, None], p_m, p_dense)
        p_dense = torch.where(ctrl_j[:, None], q_ctrl, p_dense)
        q_dense = torch.where(ctrl_j[:, None], q_ctrl, q_tar)
        if cfg.no_born:
            delta = torch.zeros(B, V, device=dev)
            delta[:, pad] = 1.0
            p_dense = torch.where(ppad_j[:, None], delta, p_dense)
            q_dense = torch.where(ppad_j[:, None], delta, q_dense)
        return p_dense, q_dense

    while pos < n:
        sl = slice(pos, pos + K)
        is_ctrl, prev_pad = is_ctrl_tab[:, sl], prev_pad_tab[:, sl]
        if greedy:
            drafts = torch.where(is_ctrl, c0_tok[:, sl], d0[:, sl])
        else:
            dp, di, cp, ci = d_p[:, sl], d_idx[:, sl], c_p[:, sl], c_idx[:, sl]
            base = _draw(generator, dp, di)
            ctrl = _draw(generator, cp, ci)
            drafts = torch.where(is_ctrl, ctrl, base)
        if cfg.no_born:
            drafts = torch.where(prev_pad, torch.full_like(drafts, pad),
                                 drafts)
        t_logits = _verify(rollout, params, "bbox3d", "head_ar_bbox3d",
                           drafts, prev, pri, pos, c0, state.kv_k,
                           state.kv_v, K)
        if greedy:
            target = rule_target(argmax(generator, t_logits), d0[:, sl],
                                 c0_tok[:, sl], is_ctrl, prev_pad)
            ok = drafts == target
        else:
            t_p, t_idx = topk_dist(t_logits, k, temp)
            draft_prob = q_of(drafts, dp, di, cp, ci, is_ctrl, prev_pad)
            u = torch.rand(B, K, generator=generator, device=dev)
            ok = u < p_of(drafts, t_p, t_idx, dp, di, cp, ci, is_ctrl,
                          prev_pad) / torch.clamp(draft_prob, min=1e-30)
        n_accept, n_min_d = _lockstep(ok)
        j = torch.clamp(n_min_d, max=K - 1)
        if greedy:
            corrected = _col(target, j)
        else:
            corrected = _residual(generator, *dense_pair(
                j, t_p, t_idx, dp, di, cp, ci, is_ctrl, prev_pad))
        boundary = torch.where(n_accept > n_min_d, _col(drafts, j),
                               corrected)

        # the rule constraint at the box this chunk may complete, computed
        # before the sync as if that completion were emitted
        i_c = pos + (10 - pos) % 11             # first attribute 10 >= pos
        kill = None
        if cfg.rule_constrain and i_c < min(pos + K, n):
            kk = torch.arange(K, device=dev)
            chunk = torch.where(kk[None] == n_min_d, boundary[:, None],
                                drafts)         # valid up to column n_min
            lo = i_c - 10
            win = torch.cat([tokens[:, lo:pos],
                             chunk[:, max(lo - pos, 0):i_c - pos + 1]], dim=1)
            attr = torch.clamp(win[:, :10], 0, 1023)
            cand = buf["agent_bin_mid"][attr] * buf["agent_span"] \
                + buf["agent_lo"]
            collide = candidate_collides(cand, boxes, bvalid)
            alive = win[:, -1] != pad
            kill = alive & prev_pad_tab[:, i_c] & (collide | (nbox + 1 > 30))
            keep = alive & ~kill
            n_min, kill_any = torch.stack([n_min_d, kill.any().long()]
                                          ).tolist()     # the host sync
        else:
            n_min = int(n_min_d)                         # the host sync
        n_emit = min(n_min + 1, K, n - pos)
        _emit(tokens, drafts, boundary, n_min, pos, n_emit)
        if kill is not None and i_c < pos + n_emit:
            put = (slots[None] == nbox[:, None]) & keep[:, None]
            boxes = torch.where(put[..., None], cand[:, None], boxes)
            bvalid = bvalid | put
            nbox = nbox + keep.long()
            tokens[:, i_c - 10:i_c + 1] = torch.where(
                kill[:, None], torch.full_like(win, pad), win)
            if kill_any:
                # a kill rewrites the emitted stream: everything after the
                # completion re-drafts next chunk, conditioned on the pads
                n_emit = i_c - pos + 1
        pos += n_emit
        chunks += 1
        accepted += n_min
        prev = _next_input(rollout, params, "bbox3d", tokens, pri, pos, dt)
    return state._replace(prev_emb=prev), tokens, SpecTelemetry(chunks,
                                                                accepted)
