"""The comparison that decides `correct`: the reference replays the scenes
the program generated and judges what the timed frames produced.

For each judged scene the reference ingests the scene's frames (the given
history, then the program's served frames) under the cell's window
semantics, and for each judged frame compares

  * `prior_err`: the TAR cascade's priors [S, D], ‖program − reference‖ /
    ‖reference‖, the worst scene-frame;
  * `ego_err`: the ego logits [3, V], the same measure;
  * `token_gap`: every token the program drew (the ego action, the map,
    agent and image tokens, the agent decode's pad→TAR redraws), against
    the reference's logits of the same position, the OAR run over the frame
    as the decode fed it: by how much the drawn token's logit lies below
    the reference's k-th best (the sampler's top k; 0 inside it), the
    widest gap;
  * `rule_mismatch`: positions where the served stream differs from what
    the draws give under the decode's rules, the reference deciding them
    itself (separators; the pad→TAR merge; the rule constraint: a newborn
    box that collides with the boxes kept so far or the ego box, or comes
    past 30, is rewritten to <pad>) — an exact count.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.model import EGO_LWH, Reference


# ---------------------------------------------------------------------------
# the agent decode's rules
# ---------------------------------------------------------------------------
def _corners(box: np.ndarray) -> np.ndarray:
    """(..., 10) boxes x y z l w h yaw … → BEV corners (..., 4, 2), yaw
    negated (the decode's convention), clockwise from the minimal point."""
    base = np.array([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]],
                    np.float32)
    c = base * box[..., None, 3:5]
    a = -box[..., 6]
    cs, sn = np.cos(a)[..., None], np.sin(a)[..., None]
    x = c[..., 0] * cs - c[..., 1] * sn
    y = c[..., 0] * sn + c[..., 1] * cs
    return np.stack([x, y], -1) + box[..., None, 0:2]


def _orient(a, b, c):
    return ((c[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0])
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def collides(cand: np.ndarray, boxes: np.ndarray) -> bool:
    """Does box `cand` (10,) overlap any of `boxes` (N, 10)?  A proper
    crossing of two edges, or all of one box's corners strictly inside the
    other; boxes at x >= 63 (decoded <pad>) never collide."""
    if cand[0] >= 63.0 or len(boxes) == 0:
        return False
    boxes = boxes[boxes[:, 0] < 63.0]
    if len(boxes) == 0:
        return False
    a = _corners(boxes)                        # (N, 4, 2)
    b = _corners(cand)                         # (4, 2)
    a1, b1 = np.roll(a, -1, axis=-2), np.roll(b, -1, axis=-2)
    A, An = a[:, :, None], a1[:, :, None]      # edges of a: (N, 4, 1, 2)
    C, Cn = b[None, None], b1[None, None]      # edges of b: (1, 1, 4, 2)
    cross = (((_orient(A, Cn, C) > 0) != (_orient(An, Cn, C) > 0))
             & ((_orient(A, An, C) > 0) != (_orient(A, An, Cn) > 0)))
    hit = cross.any(axis=(1, 2))

    def inside(big, big1, pts):
        """all pts (.., P, 2) strictly inside the clockwise box big."""
        vec = big1 - big                                    # (.., 4, 2)
        dx = big[..., :, None, 0] - pts[..., None, :, 0]
        dy = big[..., :, None, 1] - pts[..., None, :, 1]
        crs = vec[..., :, None, 1] * dx - vec[..., :, None, 0] * dy
        return (crs < 0).all(axis=(-1, -2))

    hit |= inside(a, a1, np.broadcast_to(b, a.shape))
    hit |= inside(np.broadcast_to(b, a.shape), np.broadcast_to(b1, a.shape),
                  a)
    return bool(hit.any())


def agent_rules(ar: np.ndarray, tar: np.ndarray, prev: np.ndarray, pad: int,
                mids: np.ndarray, lo: np.ndarray, span: np.ndarray):
    """The agent segment's tokens from the OAR's draws `ar` [660] and the
    TAR head's redraws `tar` [660], given the previous frame's agent tokens
    `prev`: an OAR <pad> where the slot was alive is replaced by the
    redraw; at each box's 11th token a newborn (its slot <pad> last frame)
    that collides with the kept boxes (the ego box first) or would be the
    31st is rewritten to <pad>.  → (served [660], fed [660]: the tokens the
    decode embedded — a rewritten box's first ten keep their draws, their
    K/V already written)."""
    merged = np.where((ar == pad) & (prev != pad), tar, ar)
    served, fed = merged.copy(), merged.copy()
    kept = [np.array([0, 0, 0, EGO_LWH[0], EGO_LWH[1], EGO_LWH[2],
                      0, 0, 0, 0], np.float32)]
    for i in range(10, len(ar), 11):
        box = merged[i - 10:i + 1]
        alive = box[10] != pad
        if not alive:
            continue
        cand = mids[np.clip(box[:10], 0, 1023)] * span + lo
        kill = prev[i] == pad and (len(kept) + 1 > 30
                                   or collides(cand, np.stack(kept)))
        if kill:
            served[i - 10:i + 1] = pad
            fed[i] = pad
        else:
            kept.append(cand.astype(np.float32))
    return served, fed


# ---------------------------------------------------------------------------
# judging a frame
# ---------------------------------------------------------------------------
def _gap(logits: torch.Tensor, tokens: torch.Tensor, k: int) -> torch.Tensor:
    """logits [N, V], tokens [N] → per row max(0, k-th best − logit of the
    token)."""
    kth = torch.topk(logits, k, dim=-1).values[:, -1]
    got = logits.gather(1, tokens[:, None].long())[:, 0]
    return torch.clamp(kth - got, min=0)


def _rel(a, b) -> float:
    """‖a − b‖ / ‖b‖."""
    return float(torch.linalg.vector_norm(a.float() - b)
                 / torch.linalg.vector_norm(b))


def streams(ref: Reference, m: Dict, got: Dict, prev_bbox: np.ndarray):
    """What the served frame should be given the program's draws, and what
    the decode fed the OAR: → (expect [S], fed [S], draws)."""
    served = np.asarray(got["served"]).astype(np.int64)
    d = {k: np.asarray(v).astype(np.int64) for k, v in got["draws"].items()}
    expect, fed = served.copy(), served.copy()
    b = ref.w["buffers"]
    pad = m["bbox3d_vocab_size"] - 1
    for mod, start, end, bos, eos in ref.segs:
        expect[start - 1] = fed[start - 1] = bos
        expect[end - 1] = fed[end - 1] = eos
        c = slice(start, end - 1)                       # content, 0-based
        if mod == "bbox3d":
            expect[c], fed[c] = agent_rules(
                d["bbox_ar"], d["bbox_tar"], prev_bbox.astype(np.int64),
                pad, b["agent_bin_mid"].cpu().numpy(),
                b["agent_lo"].cpu().numpy(), b["agent_span"].cpu().numpy())
        else:
            expect[c] = fed[c] = d[mod]
    return expect, fed, d


def head_logits(ref: Reference, h, prior):
    """{draw name: (logits [N, V] of the positions it was drawn at, k)}
    from the OAR output h and the priors: the AR heads of each content
    position (row p-1 predicts p), the agent TAR head on the prior of the
    input before."""
    m, out = ref.m, {}
    names = {"map": ("head_ar_map", m["top_k_map"]),
             "image": ("head_ar_img", m["top_k_image"]),
             "bbox3d": ("head_ar_bbox3d", m["top_k"])}
    for mod, start, end, _, _ in ref.segs:
        if mod in names:
            head, k = names[mod]
            key = "bbox_ar" if mod == "bbox3d" else mod
            out[key] = (ref.head(head, h[start:end - 1]), k)
            if mod == "bbox3d":
                out["bbox_tar"] = (ref.head("head_tar_bbox3d",
                                            prior[start:end - 1]), k)
    return out


class Judge:
    """Accumulates a run's compared numbers over its judged frames."""

    def __init__(self):
        self.prior_err = 0.0
        self.ego_err = 0.0
        self.token_gap = 0.0
        self.rule_mismatch = 0

    def numbers(self) -> Dict[str, float]:
        return {"prior_err": self.prior_err, "ego_err": self.ego_err,
                "token_gap": self.token_gap,
                "rule_mismatch": self.rule_mismatch}

    def frame(self, ref: Reference, prior_ref, ego_ref, got: Dict,
              prev_bbox: np.ndarray) -> None:
        """One judged scene-frame.  got: the program's "prior" [S, D],
        "ego" [3, V], "served" [S] (positions 1..S), "draws" {pose [3],
        map, bbox_ar, bbox_tar, image}."""
        dev = prior_ref.device
        m = ref.m
        self.prior_err = max(self.prior_err,
                             _rel(got["prior"].to(dev), prior_ref))
        self.ego_err = max(self.ego_err, _rel(got["ego"].to(dev), ego_ref))
        expect, fed, d = streams(ref, m, got, prev_bbox)
        h = ref.oar(torch.as_tensor(fed, device=dev), prior_ref)
        gaps = [_gap(ego_ref, torch.as_tensor(d["pose"], device=dev),
                     m["top_k"])]
        pad = m["bbox3d_vocab_size"] - 1
        used = torch.as_tensor((d["bbox_ar"] == pad) & (prev_bbox != pad),
                               device=dev)
        for key, (logits, k) in head_logits(ref, h, prior_ref).items():
            tok = torch.as_tensor(d[key], device=dev)
            if key == "bbox_tar":            # only the redraws the rule used
                logits, tok = logits[used], tok[used]
            if len(tok):
                gaps.append(_gap(logits, tok, k))
        self.token_gap = max(self.token_gap, float(torch.cat(gaps).max()))
        self.rule_mismatch += int((expect != np.asarray(got["served"])).sum())

    def control_frame(self, ref: Reference, ctl: Reference, got: Dict,
                      prev_bbox: np.ndarray, outs) -> None:
        """The control in the program's place on one scene-frame: ctl's
        priors and ego logits against ref's, and, on the positions and fed
        tokens of the program's frame, the gap of the worst token ctl's top
        k would draw from (its k-th best) below ref's k-th best."""
        (prior_r, ego_r), (prior_c, ego_c) = outs
        m, dev = ref.m, prior_r.device
        self.prior_err = max(self.prior_err, _rel(prior_c, prior_r))
        self.ego_err = max(self.ego_err, _rel(ego_c, ego_r))
        _, fed, _ = streams(ref, m, got, prev_bbox)
        fed = torch.as_tensor(fed, device=dev)
        lr = head_logits(ref, ref.oar(fed, prior_r), prior_r)
        lc = head_logits(ctl, ctl.oar(fed, prior_c), prior_c)
        gaps = []
        pairs = [(ego_r, ego_c, m["top_k"])] + [
            (lr[key][0], lc[key][0], lr[key][1]) for key in lr]
        for a, b, k in pairs:
            worst = torch.topk(b, k, dim=-1).indices[:, -1]
            gaps.append(_gap(a, worst, k))
        self.token_gap = max(self.token_gap, float(torch.cat(gaps).max()))


def replay(ref: Reference, frames: List[Dict[str, np.ndarray]], judged,
           mode: str, window: int, device):
    """Replay one scene and yield (frame index, prior [S, D], ego logits
    [3, V]) of each judged frame.  frames: F_0 .. F_N, each {mod: [n]
    tokens} (the history, then what the program served); judged: the frame
    indices to judge; mode "cached" (the rings hold `window` frames, each
    frame's K/V computed once as it was ingested) or "recompute" (each
    frame from the whole `window`-frame window before it).  The TAR
    cascade reads frame t with the pose of frame t + 1 (the action leading
    out of it)."""
    def stack(fs, shifted_from=None):
        out = {mod: torch.as_tensor(np.stack([f[mod] for f in fs]),
                                    device=device)
               for mod in fs[0]}
        if shifted_from is not None:
            out["pose"] = torch.as_tensor(
                np.stack([f["pose"] for f in shifted_from]), device=device)
        return out

    if mode == "recompute":
        for f in sorted(judged):
            win = frames[f - window:f]
            ego, _ = ref.ego(stack(win), 0)
            prior, _ = ref.cascade(stack(win, frames[f - window + 1:f + 1]), 0)
            yield f, prior, ego
        return
    if mode != "cached":
        raise ValueError(f"unknown window semantics {mode!r}")
    ego_past: Optional[list] = None
    tar_past: Optional[dict] = None
    keep = window - 1

    def slide(past, new):
        if past is None:
            return [tuple(t[:, -keep:] for t in kv) for kv in new]
        return [tuple(torch.cat([p, n], 1)[:, -keep:] for p, n in zip(pk, nk))
                for pk, nk in zip(past, new)]

    for a in range(max(judged)):
        ego, new_ego = ref.ego(stack(frames[a:a + 1]), a, ego_past)
        prior, new_tar = ref.cascade(stack(frames[a:a + 1],
                                           frames[a + 1:a + 2]), a, tar_past)
        if a + 1 in judged:
            yield a + 1, prior, ego
        ego_past = slide(ego_past, new_ego)
        tar_past = {k: slide(None if tar_past is None else tar_past[k], v)
                    for k, v in new_tar.items()}


def judge_scene(ref: Reference, frames, judged: Dict[int, Dict], mode: str,
                window: int, judge: Judge, device,
                ctl: Optional[Reference] = None) -> None:
    """Judge one scene's frames (judged: {frame index: the program's
    outputs}); with `ctl`, judge the control in the program's place."""
    runs = [replay(r, frames, judged, mode, window, device)
            for r in ((ref,) if ctl is None else (ref, ctl))]
    for outs in zip(*runs):
        f = outs[0][0]
        prev = frames[f - 1]["bbox3d"]
        if ctl is None:
            judge.frame(ref, outs[0][1], outs[0][2], judged[f], prev)
        else:
            judge.control_frame(ref, ctl, judged[f], prev,
                                [o[1:] for o in outs])
