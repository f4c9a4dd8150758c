"""The frame step: ego → TAR cascade → OAR token decode (port of
umgen_tpu/models/rollout.py, the temporal-cache path).

The JAX package compiles a whole frame into one XLA program; the port runs
the same schedule eagerly: a Python loop over the frame's positions, each
step one fused decode-kernel call plus the head, the sampler and the next
input's embedding, all on the device.  Static per-position facts (the
modality, the bbox object/attribute, whether a box completes) are Python
values from the SequenceLayout, so no step waits on the host.

Decode-order bookkeeping (1-indexed positions after the task slot): input
index k carries embed(token_k) + prior_seq[k] (the task embedding at k=0);
sampling position p feeds input k = p-1 with the KV cache holding inputs
0..p-2.  Separators are forced, never sampled.

The OAR KV cache is the flat int8 [L, B, 2208, H·Dh] of the fused decode
kernel, updated in place (the JAX package threads it functionally).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from umgen_tpu.config import EGO_WHL, TASK_NAME_ID
from umgen_tpu_torch.models import modules as nn
from umgen_tpu_torch.models.sampling import make_sampler
from umgen_tpu_torch.models.umgen import UMGen
from umgen_tpu_torch.ops import decode_kernel as dk
from umgen_tpu_torch.ops.collision import candidate_collides
from umgen_tpu_torch.params import torch_dtype

Params = Dict[str, Any]

MAX_BOXES = 62   # ego + 60 slots + candidate headroom


class OarState(NamedTuple):
    """The OAR decode's state within one frame."""
    kv_k: torch.Tensor        # [L, B, S, H·Dh]
    kv_v: torch.Tensor
    prev_emb: torch.Tensor    # [B, 1, D] input embedding for the next step


class FrameOutputs(NamedTuple):
    tokens: torch.Tensor       # [B, seq_len] sampled/forced stream
    pose_tokens: torch.Tensor  # [B, 3] ego tokens used this frame
    # the frame's ego logits [B, 3, 1024] and TAR priors [B, 2207, D]
    ego_logits: Optional[torch.Tensor] = None
    prior_seq: Optional[torch.Tensor] = None


class Rollout:
    """Per-frame generation on the cached path."""

    def __init__(self, model: UMGen):
        self.model = model
        self.config = cfg = model.config
        self.layout = model.layout
        if cfg.sample_method == "greedy":
            self._samplers = {m: make_sampler("greedy")
                              for m in ("pose", "map", "bbox3d", "image")}
        else:
            def param(k):
                return k if cfg.sample_method == "topk" else cfg.top_p

            self._samplers = {
                "pose": make_sampler(cfg.sample_method, param(cfg.top_k),
                                     cfg.sfmx_temp),
                "map": make_sampler(cfg.sample_method, param(cfg.top_k_map),
                                    cfg.sfmx_temp),
                "bbox3d": make_sampler(cfg.sample_method, param(cfg.top_k),
                                       cfg.sfmx_temp),
                # image sampling is top-k 16 regardless of the method
                "image": make_sampler("topk", cfg.top_k_image,
                                      cfg.sfmx_temp),
            }
        ego = EGO_WHL["nuplan"]
        self._ego_box = torch.tensor(
            [0, 0, 0, ego["l"], ego["w"], ego["h"], 0, 0, 0, 0],
            dtype=torch.float32)

    # ------------------------------------------------------------------
    # OAR plumbing
    # ------------------------------------------------------------------
    def init_kv(self, B: int, device=None):
        """Flat [L, B, 2208, H·Dh] caches in the OAR cache dtype (int8 for
        the fused kernel)."""
        cfg = self.config
        shape = (cfg.n_oar_layer, B, self.layout.input_len,
                 cfg.n_head * cfg.head_dim)
        dt = torch.int8 if cfg.oar_cache_dtype == "int8" \
            else torch_dtype(cfg.oar_cache_dtype)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    def oar_step(self, params: Params, x: torch.Tensor, kv_k: torch.Tensor,
                 kv_v: torch.Tensor, cache_len: int):
        """Push Q new inputs x [B, Q, D] through the OAR stack; their K/V
        land in the caches at cache_len.  Q = 1 goes to the fused v5
        kernel, 1 < Q·H <= 128 to v5mq; anything else runs the eager body.
        Returns (ln_oar(h) [B, Q, D], kv_k, kv_v)."""
        cfg = self.config
        Q, H = x.shape[1], cfg.n_head
        if (cfg.fused_oar_kernel and "oar_packed" in params
                and kv_k.dtype == torch.int8 and Q * H <= 128):
            fused = (dk.fused_decode_step_v5 if Q == 1
                     else dk.fused_decode_step_v5mq)
            h, kv_k, kv_v = fused(params["oar_packed"], x, kv_k, kv_v,
                                  cache_len, n_head=H)
            return nn.layer_norm(params["ln_oar"], h), kv_k, kv_v
        return self._oar_step_eager(params, x, kv_k, kv_v, cache_len)

    def _oar_step_eager(self, params, x, kv_k, kv_v, cache_len: int):
        """The reference's multi-row XLA body: every layer attends [prefix
        < cache_len ‖ causal new block] with the int8 prefix dequantized
        from the 1/16 grid.  It is the plain counterpart of the fused step
        in the JAX package's own terms."""
        cfg = self.config
        H, Dh = cfg.n_head, cfg.head_dim
        B, Q, D = x.shape
        S = kv_k.shape[2]
        scale = 1.0 / math.sqrt(Dh)
        int8 = kv_k.dtype == torch.int8
        kpos = torch.arange(S, device=x.device)
        prefix_valid = kpos < cache_len
        self_mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                          device=x.device))

        def load(c):
            c = c.reshape(B, S, H, Dh)
            return (c.float() * (1.0 / dk.KV_INT8_SCALE)).to(x.dtype) \
                if int8 else c.to(x.dtype)

        def store(t):
            return dk.kv_store(t) if int8 else t.to(kv_k.dtype)

        h = x
        stack = params["oar"]
        for l in range(nn.n_layers(stack)):
            p = nn.layer(stack, l)
            q, k_new, v_new = nn.linear(p["attn"]["qkv"],
                                        nn.layer_norm(p["ln1"], h)).split(
                D, dim=-1)
            q = q.reshape(B, Q, H, Dh)
            k_new = k_new.reshape(B, Q, H, Dh)
            v_new = v_new.reshape(B, Q, H, Dh)
            lp = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              load(kv_k[l]).float()) * scale
            lp = lp.masked_fill(~prefix_valid, float("-inf"))
            ls = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k_new.float()) * scale
            ls = ls.masked_fill(~self_mask, float("-inf"))
            m = torch.maximum(lp.amax(-1, keepdim=True),
                              ls.amax(-1, keepdim=True))
            ep = torch.exp(lp - m)
            es = torch.exp(ls - m)
            denom = ep.sum(-1, keepdim=True) + es.sum(-1, keepdim=True)
            wp = (ep / denom).to(x.dtype)
            ws = (es / denom).to(x.dtype)
            y = (torch.einsum("bhqk,bkhd->bqhd", wp.float(),
                              load(kv_v[l]).float()).to(x.dtype)
                 + torch.einsum("bhqk,bkhd->bqhd", ws.float(),
                                v_new.float()).to(x.dtype))
            h = h + nn.linear(p["attn"]["proj"], y.reshape(B, Q, D))
            h = h + nn.mlp(p["mlp"], nn.layer_norm(p["ln2"], h))
            kv_k[l, :, cache_len:cache_len + Q] = store(k_new).reshape(
                B, Q, H * Dh)
            kv_v[l, :, cache_len:cache_len + Q] = store(v_new).reshape(
                B, Q, H * Dh)
        return nn.layer_norm(params["ln_oar"], h), kv_k, kv_v

    def _embed_token(self, params: Params, mod: str,
                     token: torch.Tensor) -> torch.Tensor:
        """token → next-step OAR input embedding (no positional terms)."""
        if mod == "pose":
            return params["buffers"]["fouier_pe"][token]
        if mod == "map":
            return nn.mlp(params["map_mlp_pre"],
                          params["buffers"]["map_codebook"][token])
        if mod == "bbox3d":
            return params["be"][token]
        if mod == "image":
            return nn.mlp(params["img_mlp_pre"],
                          params["buffers"]["img_codebook"][token])
        raise ValueError(mod)

    def _aux_emb(self, params: Params, aux_id: int, B: int) -> torch.Tensor:
        axe = params["axe"]
        return axe[aux_id][None, None].expand(B, 1, axe.shape[-1])

    # While decoding a segment the cache never grows past the segment's
    # end, so the steps get a prefix VIEW of it (writes land in the full
    # cache).  The kernel reads only rows < cache_len either way; the view
    # keeps the plain version's S-blocking identical to the reference's.
    def _sliced(self, state: OarState, kv_len: int) -> OarState:
        return OarState(state.kv_k[:, :, :kv_len], state.kv_v[:, :, :kv_len],
                        state.prev_emb)

    def _unsliced(self, full: OarState, part: OarState) -> OarState:
        return OarState(full.kv_k, full.kv_v, part.prev_emb)

    # ------------------------------------------------------------------
    # segments
    # ------------------------------------------------------------------
    def _decode_plain_segment(self, params, mod, seg, state: OarState,
                              prior_seq, head_name, generator):
        """Sample a contiguous run of same-modality content positions."""
        sampler = self._samplers[mod]
        tokens = []
        prev = state.prev_emb
        for i in range(seg.content_len):
            p = seg.content_start + i
            h, _, _ = self.oar_step(params, prev, state.kv_k, state.kv_v,
                                    cache_len=p - 1)
            token = sampler(generator, nn.linear(params[head_name], h[:, -1]))
            prev = (self._embed_token(params, mod, token)[:, None, :]
                    + prior_seq[:, p:p + 1]).to(prev.dtype)
            tokens.append(token)
        return state._replace(prev_emb=prev), torch.stack(tokens, dim=1)

    def _decode_forced_segment(self, params, mod, seg, state: OarState,
                               prior_seq, forced: torch.Tensor):
        """Teacher-force a whole segment to `forced` [B, content_len]: one
        causal multi-row push of the known inputs extends the cache exactly
        as if the tokens had been sampled."""
        c0, L = seg.content_start, seg.content_len
        dt = state.prev_emb.dtype
        forced = forced.long()
        emb = self._embed_token(params, mod, forced[:, :L - 1])
        x = torch.cat([state.prev_emb,
                       (emb + prior_seq[:, c0:c0 + L - 1]).to(dt)], dim=1)
        self.oar_step(params, x, state.kv_k, state.kv_v, cache_len=c0 - 1)
        last = (self._embed_token(params, mod, forced[:, L - 1:L])
                + prior_seq[:, c0 + L - 1:c0 + L])
        return state._replace(prev_emb=last.to(dt)), forced

    def _decode_bbox_segment(self, params, seg, state: OarState, prior_seq,
                             prev_frame_bbox, tar_box_logits, control_mask,
                             generator):
        """660 bbox positions with the reference's decode rules:

        * control override: controlled slots sample the TAR head with <pad>
          masked out (object id from the BOS position, so a category token
          maps to the NEXT object — the reference's quirk);
        * pad→TAR merge rule: an OAR <pad> for an object alive last frame
          is resampled from the TAR head;
        * no-born rule (optional);
        * rule constraint: at each box completion the decoded box is tested
          against the boxes accepted so far (+ ego); a NEWBORN that
          collides, or arrives past 30 boxes, has its 11 tokens rewritten
          to <pad> (already-written KV is not recomputed)."""
        cfg = self.config
        sampler = self._samplers["bbox3d"]
        pad = cfg.bbox3d_vocab_size - 1
        dev = state.prev_emb.device
        B = state.prev_emb.shape[0]
        buf = params["buffers"]
        boxes = torch.zeros(B, MAX_BOXES, 10, device=dev)
        boxes[:, 0] = self._ego_box.to(dev)
        bvalid = torch.zeros(B, MAX_BOXES, dtype=torch.bool, device=dev)
        bvalid[:, 0] = True
        nbox = torch.ones(B, dtype=torch.long, device=dev)
        win = torch.full((B, 11), pad, dtype=torch.long, device=dev)
        tokens = torch.zeros(B, seg.content_len, dtype=torch.long,
                             device=dev)
        slots = torch.arange(MAX_BOXES, device=dev)
        prev = state.prev_emb

        for i in range(seg.content_len):
            p = seg.content_start + i
            h, _, _ = self.oar_step(params, prev, state.kv_k, state.kv_v,
                                    cache_len=p - 1)
            tok_ar = sampler(generator,
                             nn.linear(params["head_ar_bbox3d"], h[:, -1]))
            prev_tok = prev_frame_bbox[:, i]
            is_ctrl = control_mask[:, (i + 1) // 11]
            tar_logits = tar_box_logits[:, i]
            nopad = tar_logits.clone()
            nopad[:, -1] = float("-inf")
            token = torch.where(is_ctrl, sampler(generator, nopad), tok_ar)
            if cfg.merge_ar_tar and not cfg.only_ar:
                tok_tar = sampler(generator, tar_logits)
                merge = (token == pad) & (prev_tok != pad) & ~is_ctrl
                token = torch.where(merge, tok_tar, token)
            if cfg.no_born:
                token = torch.where(prev_tok == pad,
                                    torch.full_like(token, pad), token)
            win = torch.cat([win[:, 1:], token[:, None]], dim=1)
            tokens[:, i] = token

            if cfg.rule_constrain and i % 11 == 10:
                attr = torch.clamp(win[:, :10], 0, 1023)
                cand = buf["agent_bin_mid"][attr] * buf["agent_span"] \
                    + buf["agent_lo"]
                collide = candidate_collides(cand, boxes, bvalid)
                alive = token != pad
                kill = alive & (prev_tok == pad) & (collide | (nbox + 1 > 30))
                keep = alive & ~kill
                put = (slots[None] == nbox[:, None]) & keep[:, None]
                boxes = torch.where(put[..., None], cand[:, None], boxes)
                bvalid = bvalid | put
                nbox = nbox + keep.long()
                tokens[:, i - 10:i + 1] = torch.where(
                    kill[:, None], torch.full_like(win, pad),
                    tokens[:, i - 10:i + 1])
                token = torch.where(kill, torch.full_like(token, pad), token)
                win = torch.where(kill[:, None], torch.full_like(win, pad),
                                  win)
            prev = (self._embed_token(params, "bbox3d", token)[:, None, :]
                    + prior_seq[:, p:p + 1]).to(prev.dtype)
        return state._replace(prev_emb=prev), tokens

    # ------------------------------------------------------------------
    # full frame
    # ------------------------------------------------------------------
    def _finish_frame(self, params: Params, prior_seq: torch.Tensor,
                      ego_tokens: torch.Tensor,
                      prev_frame_bbox: Optional[torch.Tensor],
                      control_mask: torch.Tensor, generator,
                      forced_tokens: Optional[Dict[str, torch.Tensor]] = None
                      ) -> FrameOutputs:
        """The OAR decode of one frame given its TAR priors."""
        cfg, lo = self.config, self.layout
        B = prior_seq.shape[0]
        dev = prior_seq.device
        dt = torch_dtype(cfg.dtype)
        tar_box_logits = None
        if any(s.mod == "bbox3d" for s in lo.segments):
            bseg = lo.segment("bbox3d")
            tar_box_logits = nn.linear(
                params["head_tar_bbox3d"],
                prior_seq[:, bseg.start:bseg.content_end])   # [B, 660, V]

        kv_k, kv_v = self.init_kv(B, device=dev)
        # prefill: [task, pose_bos, p1, p2, p3, pose_eos]
        pseg = lo.segment("pose")
        task_emb = params["tske"][TASK_NAME_ID[cfg.task]][None, None].expand(
            B, 1, cfg.n_embd)
        prefill = torch.cat([task_emb, self._aux_emb(params, pseg.bos, B),
                             self._embed_token(params, "pose", ego_tokens),
                             self._aux_emb(params, pseg.eos, B)],
                            dim=1).to(dt)
        n_pre = prefill.shape[1]
        self.oar_step(params, prefill + prior_seq[:, :n_pre], kv_k, kv_v,
                      cache_len=0)

        tokens = torch.zeros(B, lo.seq_len + 1, dtype=torch.long, device=dev)
        tokens[:, pseg.start] = pseg.bos
        tokens[:, pseg.start + 1:pseg.end] = ego_tokens
        tokens[:, pseg.end] = pseg.eos

        segs = [s for s in lo.segments if s.mod != "pose"]
        state = OarState(kv_k, kv_v,
                         (self._aux_emb(params, segs[0].bos, B)
                          + prior_seq[:, segs[0].start:segs[0].start + 1]
                          ).to(dt))
        head_for = {"map": "head_ar_map", "image": "head_ar_img",
                    "bbox3d": "head_ar_bbox3d"}
        forced_tokens = forced_tokens or {}
        for si, seg in enumerate(segs):
            tokens[:, seg.start] = seg.bos
            forced = forced_tokens.get(seg.mod)
            part = self._sliced(state, min(seg.end, state.kv_k.shape[2]))
            if forced is not None:
                part, seg_tokens = self._decode_forced_segment(
                    params, seg.mod, seg, part, prior_seq, forced)
            elif seg.mod == "bbox3d":
                # the merge rule reads the control-OVERWRITTEN last frame
                part, seg_tokens = self._decode_bbox_segment(
                    params, seg, part, prior_seq, prev_frame_bbox,
                    tar_box_logits, control_mask, generator)
            else:
                part, seg_tokens = self._decode_plain_segment(
                    params, seg.mod, seg, part, prior_seq, head_for[seg.mod],
                    generator)
            state = self._unsliced(state, part)
            tokens[:, seg.content_start:seg.content_end + 1] = seg_tokens
            tokens[:, seg.end] = seg.eos

            if si + 1 < len(segs):
                # push [embed(last sampled), EOS] to extend the cache to
                # input index seg.end, then hand the next segment its BOS
                nxt = segs[si + 1]
                eos_emb = (self._aux_emb(params, seg.eos, B)
                           + prior_seq[:, seg.end:seg.end + 1]).to(dt)
                self.oar_step(params, torch.cat([state.prev_emb, eos_emb],
                                                dim=1),
                              state.kv_k, state.kv_v, cache_len=seg.end - 1)
                state = state._replace(prev_emb=(
                    self._aux_emb(params, nxt.bos, B)
                    + prior_seq[:, nxt.start:nxt.start + 1]).to(dt))
        return FrameOutputs(tokens=tokens[:, 1:], pose_tokens=ego_tokens)

    def _control_setup(self, frame_bbox, control_bbox, B):
        """Agent-control overwrite of a [B, 660] frame + the [B, 61]
        control mask."""
        control_mask = torch.zeros(B, 61, dtype=torch.bool,
                                   device=frame_bbox.device)
        if control_bbox is not None:
            valid = control_bbox != -1
            frame_bbox = torch.where(valid, control_bbox, frame_bbox)
            control_mask[:, :60] = valid.reshape(B, 60, 11).any(dim=2)
        return frame_bbox, control_mask

    def frame_step_prefill(self, params: Params,
                           inputs: Dict[str, torch.Tensor], generator,
                           pose_override=None, control_bbox=None,
                           forced_tokens=None):
        """First cached step: ingest the raw window {mod: [B, T, len]}
        (starting at absolute frame 0) into the rings, then decode one
        frame.  Returns (FrameOutputs, cache)."""
        model = self.model
        B, T = inputs["pose"].shape[:2]
        if "bbox3d" in inputs:
            # the control overwrite persists into the rings (the
            # reference mutates its window in place)
            last_bbox, control_mask = self._control_setup(
                inputs["bbox3d"][:, -1], control_bbox, B)
            inputs = dict(inputs)
            inputs["bbox3d"] = torch.cat([inputs["bbox3d"][:, :-1],
                                          last_bbox[:, None]], dim=1)
        else:
            last_bbox = None
            control_mask = torch.zeros(B, 61, dtype=torch.bool,
                                       device=inputs["pose"].device)
        ego_logits, cache = model.prefill_ego_cache(params, inputs, {})
        ego_tokens = (self._samplers["pose"](generator, ego_logits)
                      if pose_override is None else pose_override)
        shifted = dict(inputs)
        shifted["pose"] = torch.cat([inputs["pose"], ego_tokens[:, None]],
                                    dim=1)[:, 1:]
        pri = model.prefill_tar_caches(params, shifted, cache)
        cache = pri["cache"]
        cache["frames"] = T
        out = self._finish_frame(params, pri["prior_seq"], ego_tokens,
                                 last_bbox, control_mask, generator,
                                 forced_tokens=forced_tokens)
        return out._replace(ego_logits=ego_logits,
                            prior_seq=pri["prior_seq"]), cache

    def frame_step_cached(self, params: Params,
                          newest_frame: Dict[str, torch.Tensor], cache: Dict,
                          generator, pose_override=None, control_bbox=None,
                          forced_tokens=None):
        """Steady-state step: ingest ONE raw frame {mod: [B, 1, len]} (the
        frame generated last, pose = motion into it) and decode the next.
        Returns (FrameOutputs, cache); the rings are updated in place."""
        model = self.model
        B = newest_frame["pose"].shape[0]
        abs_frame = int(cache["frames"])
        if "bbox3d" in newest_frame:
            last_bbox, control_mask = self._control_setup(
                newest_frame["bbox3d"][:, 0], control_bbox, B)
            newest_frame = dict(newest_frame)
            newest_frame["bbox3d"] = last_bbox[:, None]
        else:
            last_bbox = None
            control_mask = torch.zeros(B, 61, dtype=torch.bool,
                                       device=newest_frame["pose"].device)
        ego_logits, cache = model.ego_logits_cached(params, newest_frame,
                                                    cache, abs_frame)
        ego_tokens = (self._samplers["pose"](generator, ego_logits)
                      if pose_override is None else pose_override)
        shifted = dict(newest_frame)
        shifted["pose"] = ego_tokens[:, None]
        pri = model.tar_priors_cached(params, shifted, cache, abs_frame)
        cache = pri["cache"]
        cache["frames"] = abs_frame + 1
        out = self._finish_frame(params, pri["prior_seq"], ego_tokens,
                                 last_bbox, control_mask, generator,
                                 forced_tokens=forced_tokens)
        return out._replace(ego_logits=ego_logits,
                            prior_seq=pri["prior_seq"]), cache
