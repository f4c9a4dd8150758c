"""A plain float32 reference of UMGen, written from the layer equations.

It imports nothing of the program and nothing of JAX.  It is given the raw
weights and tables the benchmark made (benchmark/weights.py) and the
configuration's sizes, and works out everything else itself: the weights'
quantization as the configuration states it, the TAR rings, the OAR cache.

One scene at a time, float32 throughout (TF32 off), with the storage formats
the configuration states modelled where they hold state across frames or
steps: int4 TAR rings (per frame, layer and head: amax / 7) and the int8
OAR cache (a fixed 1/16 grid).  Departures from the model as the program
runs it: activations are float32, not bf16; the decode kernels' int8
activation and query quantization is not modelled; GELU is `erf`'s, not a
polynomial's.

The model: a frame is 2207 tokens (pose, map, agents, image, each wrapped
in BOS / EOS).  An ego net (a TAR-type stack over the raw frames, then 3
learned queries cross-attending the newest frame) gives the ego action.  A
TAR cascade (a trunk and map and box refinement stacks of factorized
blocks: spatial, causal temporal, spatial attention, each with an MLP) over
the frames, the pose slot shifted to the action leading out of each frame,
gives one prior a position.  The OAR, a causal transformer over the frame's
positions, adds the prior to each input's token embedding; its heads give
the next token's logits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LINEAR_NAMES = {"qkv", "proj", "fc", "q", "k", "v"}
KV_INT8_STEP = 1.0 / 16.0
# ego box (l, w, h) of the nuplan ego vehicle
EGO_LWH = (5.176, 2.297, 1.777)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def quant_int8(w: torch.Tensor) -> torch.Tensor:
    """Per output channel symmetric int8 (amax over the input dim / 127),
    dequantized in float32."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(w / s), -127, 127) * s


def quant_w4(w: torch.Tensor, group: int = 128) -> torch.Tensor:
    """Group-`group` symmetric int4 in [-7, 7] along the input dim (amax /
    7 a group and output column), dequantized in float32."""
    w = w.float()
    *lead, K, N = w.shape
    G = min(group, K)
    wg = w.reshape(*lead, K // G, G, N)
    s = torch.clamp(wg.abs().amax(dim=-2, keepdim=True) / 7.0, min=1e-8)
    return (torch.clamp(torch.round(wg / s), -7, 7) * s).reshape(*lead, K, N)


QUANTIZERS = {"int8": quant_int8, "w4": quant_w4}


def prepare_weights(raw: Dict, recipe: List) -> Dict:
    """The raw tree in float32, each linear weight of the subtrees a recipe
    step names replaced by its quantized value.  recipe: [[kind, [keys]],
    ...] in order, kind "int8" or "w4", each from the raw weights."""
    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return t.float()

    out = f32(raw)

    def walk(t, r, name, q):
        if isinstance(t, dict):
            if "w" in t and (name in LINEAR_NAMES or name.startswith("head_")):
                return {**t, "w": q(r["w"])}
            return {k: walk(v, r[k], k, q) for k, v in t.items()}
        return t

    for kind, keys in recipe:
        for key in keys:
            if key in out:
                out[key] = walk(out[key], raw[key], key, QUANTIZERS[kind])
    return out


def layer(stack: Dict, l: int) -> Dict:
    if isinstance(stack, dict):
        return {k: layer(v, l) for k, v in stack.items()}
    return stack[l]


def n_layers(stack: Dict) -> int:
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return int(stack.shape[0])


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------
def exact(x):
    return x


def rounder(dtype: str = "float32"):
    """Activation rounding: none in float32; "float8_e4m3fn" rounds each
    activation through fp8 (the precision below bf16), for the control."""
    if dtype == "float32":
        return exact
    dt = getattr(torch, dtype)
    return lambda x: x.to(dt).float()


def ln(p, x, r=exact):
    return r(F.layer_norm(x, x.shape[-1:], p["w"], None, 1e-5))


def lin(p, x, r=exact):
    y = x @ p["w"]
    return r(y + p["b"] if "b" in p else y)


def mlp(p, x, r=exact):
    return lin(p["proj"], r(F.gelu(lin(p["fc"], x, r))), r)


def heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """[..., S, H·Dh] → [..., H, S, Dh]."""
    *lead, S, D = x.shape
    return x.reshape(*lead, S, H, D // H).transpose(-3, -2)


def merge(y: torch.Tensor) -> torch.Tensor:
    """[..., H, S, Dh] → [..., S, H·Dh]."""
    *lead, H, S, Dh = y.shape
    return y.transpose(-3, -2).reshape(*lead, S, H * Dh)


def softmax_attend(q, k, v, mask=None, r=exact):
    """softmax(q·kᵀ/√Dh [+ mask]) · v over the last two dims (the logits
    and the softmax in float32; the weights and the output rounded by
    r)."""
    logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return r(r(torch.softmax(logits, dim=-1)) @ v)


def self_attention(p, x, H, chunk: int = 4, r=exact):
    """Non-causal fused-qkv attention over the S axis of x [N, S, D], N in
    chunks (the [N, H, S, S] logits stay small)."""
    out = []
    for i in range(0, x.shape[0], chunk):
        q, k, v = lin(p["qkv"], x[i:i + chunk], r).chunk(3, dim=-1)
        out.append(merge(softmax_attend(heads(q, H), heads(k, H),
                                        heads(v, H), r=r)))
    return lin(p["proj"], torch.cat(out, dim=0), r)


def ring_int4(t: torch.Tensor) -> torch.Tensor:
    """One frame's K or V [S, H, Dh] as the int4 ring stores it: per head
    amax over the frame's positions and dims / 7, rounded, in [-7, 7]."""
    s = torch.clamp(t.abs().amax(dim=(0, 2), keepdim=True), min=1e-6) \
        * (1.0 / 7.0)
    return torch.clamp(torch.round(t / s), -7, 7) * s


def store_ring(t: torch.Tensor, ring: str) -> torch.Tensor:
    if ring == "int4":
        return ring_int4(t)
    if ring == "none":
        return t
    raise ValueError(f"unknown ring format {ring!r}")


def block_tar(p, x, H, past: Optional[Tuple] = None, ring: str = "none",
              r=exact):
    """x [T, S, D] frames through a factorized block: spatial attention and
    MLP, temporal attention (frame t sees `past`'s stored frames [S, P, H,
    Dh] and new frames 0..t), MLP, spatial attention and MLP.  → (y, (k, v)
    [S, T, H, Dh] of the new frames, as the ring stores them)."""
    T, S, D = x.shape
    x = r(x + self_attention(p["sa1"], ln(p["ln1"], x, r), H, r=r))
    x = r(x + mlp(p["mlp1"], ln(p["ln2"], x, r), r))
    xt = x.transpose(0, 1)                                 # [S, T, D]
    q, k, v = lin(p["ta"]["qkv"], ln(p["ln3"], xt, r), r).chunk(3, dim=-1)
    Dh = D // H
    k4, v4 = k.reshape(S, T, H, Dh), v.reshape(S, T, H, Dh)
    P = 0 if past is None else past[0].shape[1]
    keys = k4 if past is None else torch.cat([past[0], k4], dim=1)
    vals = v4 if past is None else torch.cat([past[1], v4], dim=1)
    mask = (torch.arange(P + T, device=x.device)[None, :]
            <= torch.arange(T, device=x.device)[:, None] + P)
    y = softmax_attend(heads(q, H), keys.transpose(1, 2), vals.transpose(1, 2),
                       mask, r)
    xt = r(xt + lin(p["ta"]["proj"], merge(y), r))
    xt = r(xt + mlp(p["mlp2"], ln(p["ln4"], xt, r), r))
    x = xt.transpose(0, 1)
    x = r(x + self_attention(p["sa2"], ln(p["ln5"], x, r), H, r=r))
    x = r(x + mlp(p["mlp3"], ln(p["ln6"], x, r), r))
    stored = [torch.stack([store_ring(a[:, t], ring) for t in range(T)], 1)
              for a in (k4, v4)]
    return x, stored


def decoder_block(p, x, ctx, H, r=exact):
    """3 queries x [3, D]: self-attention, cross-attention to ctx [S, D],
    MLP."""
    x = r(x + self_attention(p["self_attn"], ln(p["ln1"], x, r)[None], H,
                             r=r)[0])
    c = p["cross_attn"]
    kv = ln(p["ln3"], ctx, r)
    y = softmax_attend(heads(lin(c["q"], ln(p["ln2"], x, r), r), H),
                       heads(lin(c["k"], kv, r), H),
                       heads(lin(c["v"], kv, r), H), r=r)
    x = r(x + lin(c["proj"], merge(y), r))
    return r(x + mlp(p["mlp"], ln(p["ln4"], x, r), r))


def warp_map(feat: torch.Tensor, pose_diff: torch.Tensor,
             res: float = 4.0) -> torch.Tensor:
    """Action-aware map alignment: feat [T, 1024, C] (a 32×32 grid, row
    major), pose_diff [T, 3] metric (dx, dy, dθ) → the features resampled
    (bilinear, zero outside) through the affine map rotating by -dθ and
    translating by (-dy, -dx) / res cells in normalized coordinates."""
    T, S, C = feat.shape
    n = int(round(S ** 0.5))
    th = pose_diff[:, 2]
    dxn = 2.0 * (pose_diff[:, 0] / res) / n
    dyn = 2.0 * (pose_diff[:, 1] / res) / n
    c, s = torch.cos(-th), torch.sin(-th)
    mat = torch.stack([torch.stack([c, -s, -dyn], -1),
                       torch.stack([s, c, -dxn], -1)], 1)
    grid = F.affine_grid(mat, (T, C, n, n), align_corners=False)
    img = feat.reshape(T, n, n, C).permute(0, 3, 1, 2)
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(T, S, C)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class Reference:
    """UMGen in float32 for one scene at a time.  m: the configuration's
    "model" block; w: prepare_weights' tree; ring / oar_cache: the storage
    of the TAR rings ("int4" or "none") and of the OAR cache ("int8" or
    "none"); act: the activations' rounding ("float32": none; the
    control's "float8_e4m3fn")."""

    def __init__(self, m: Dict, w: Dict, ring: str, oar_cache: str,
                 act: str = "float32"):
        self.m, self.w, self.ring, self.oar_cache = m, w, ring, oar_cache
        self.r = rounder(act)
        self.H = m["n_head"]
        self.segs = []              # (mod, start, end, bos, eos), 1-indexed
        pos = 0
        for mod, n, bos, eos in m["layout"]:
            self.segs.append((mod, pos + 1, pos + n + 2, bos, eos))
            pos += n + 2
        self.S = pos
        self.seg = {s[0]: s for s in self.segs}

    # --- embeddings -------------------------------------------------------
    def _map_feat(self, tok, grid_pe):
        b = self.w["buffers"]
        f = mlp(self.w["map_mlp_pre"], b["map_codebook"][tok], self.r)
        return self.r(f + b["grid_center_pe"]) if grid_pe else f

    def tar_input(self, frames: Dict, mods, grid_pe: bool, warp: bool,
                  t_offset: int):
        """frames {mod: [T, n]} → (emb [T, S', D], warped map [T, 1024, D]
        or None): each modality embedded and wrapped in its BOS / EOS, the
        map warped by the frames' pose and added to itself, + the sequence
        and temporal PEs."""
        w, b = self.w, self.w["buffers"]
        T = frames["pose"].shape[0]
        parts, warped = [], None
        for mod in mods:
            tok = frames[mod].long()
            if mod == "pose":
                f = b["fouier_pe"][tok]
            elif mod == "map":
                f = self._map_feat(tok, grid_pe)
                if warp:
                    warped = warp_map(f, self.pose_diff(frames["pose"]))
                    f = self.r(warped + f)
            elif mod == "bbox3d":
                f = w["be"][tok]
                boxes = tok.reshape(T, -1, 11)
                pe = (b["bbox_spatial_pe"][boxes[..., 0]]
                      + b["bbox_spatial_pe"][boxes[..., 1]])
                f = self.r(f + pe.repeat_interleave(11, dim=1))
            elif mod == "image":
                f = mlp(w["img_mlp_pre"], b["img_codebook"][tok], self.r)
            else:
                raise ValueError(mod)
            _, _, _, bos, eos = self.seg[mod]
            D = f.shape[-1]
            parts += [w["axe"][bos].expand(T, 1, D), f,
                      w["axe"][eos].expand(T, 1, D)]
        emb = torch.cat(parts, dim=1)
        idx = torch.clamp(torch.arange(T, device=emb.device) + t_offset,
                          max=self.m["max_frame_len"] - 1)
        emb = emb + w["spe"][:emb.shape[1]][None] + w["tpe"][idx][:, None]
        return self.r(emb), warped

    def pose_diff(self, pose_tok):
        b = self.w["buffers"]
        mids = b["ego_bin_mid"][torch.clamp(pose_tok.long(), 0, 1023)]
        return mids * b["ego_std"] + b["ego_mean"]

    # --- stacks -----------------------------------------------------------
    def run_stack(self, name, emb, past):
        """emb [T, S', D] through stack `name` → (ln(out) of the last frame
        [S', D], the new frames' stored K/V a layer).  past: a list a
        layer of stored (k, v) [S', P, H, Dh], or None."""
        stack = self.w[name]
        h, new = emb, []
        for l in range(n_layers(stack)):
            h, kv = block_tar(layer(stack, l), h, self.H,
                              None if past is None else past[l], self.ring,
                              self.r)
            new.append(kv)
        return ln(self.w["ln_" + name], h[-1], self.r), new

    def ego(self, raw: Dict, t_offset: int, past=None):
        """The ego net over raw frames {mod: [T, n]} (their own pose) →
        (logits [3, pose vocab] of the last frame's action, the ego stack's
        new K/V)."""
        emb, _ = self.tar_input(raw, [s[0] for s in self.segs], False, False,
                                t_offset)
        ctx, new = self.run_stack("ego_tar", emb, past)
        w = self.w
        t = min(t_offset + emb.shape[0] - 1, self.m["max_frame_len"] - 1)
        q = self.r(w["egoe"] + w["spe"][:3] + w["tpe"][t])
        for l in range(n_layers(w["ego_ca"])):
            q = decoder_block(layer(w["ego_ca"], l), q, ctx, self.H, self.r)
        return lin(w["head_ego"], ln(w["ln_ego"], q, self.r)), new

    def cascade(self, shifted: Dict, t_offset: int, past=None):
        """The TAR cascade over frames {mod: [T, n]} whose pose slot holds
        the action out of each frame → (prior [S, D] of the last frame,
        {stack: new K/V})."""
        mods = [s[0] for s in self.segs]
        new = {}

        def run(name, emb):
            out, new[name] = self.run_stack(
                name, emb, None if past is None else past[name])
            return out

        emb, _ = self.tar_input(shifted, mods, True, True, t_offset)
        trunk = run("tar", emb)
        emb_m, warped = self.tar_input(shifted, ["pose", "map"], False, True,
                                       t_offset)
        n_pose = self.seg["pose"][2]                        # 5
        map_out = run("map_tar", emb_m)[n_pose:]
        emb_b, _ = self.tar_input(shifted, ["pose", "map", "bbox3d"], False,
                                  True, t_offset)
        n_map = self.seg["map"][2]                          # 1031
        box_out = run("box_tar", emb_b)[n_map:]
        map_out = torch.cat([map_out[:1], self.r(map_out[1:-1] + warped[-1]),
                             map_out[-1:]])
        by = {"pose": trunk[:n_pose], "map": map_out, "bbox3d": box_out,
              "image": trunk[self.seg["image"][1] - 1:]}
        return torch.cat([by[s[0]] for s in self.segs]), new

    # --- OAR --------------------------------------------------------------
    def _embed(self, mod, tok):
        w, b = self.w, self.w["buffers"]
        if mod == "pose":
            return b["fouier_pe"][tok]
        if mod == "map":
            return mlp(w["map_mlp_pre"], b["map_codebook"][tok], self.r)
        if mod == "bbox3d":
            return w["be"][tok]
        return mlp(w["img_mlp_pre"], b["img_codebook"][tok], self.r)

    def oar(self, fed: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
        """The OAR's causal pass over one frame: fed [S] the tokens of
        positions 1..S as the decode embedded them, prior [S, D] → ln_oar(h)
        [S, D], row p-1 predicting position p.  Input 0 is the task
        embedding; input k the token at position k's embedding (its BOS /
        EOS at a separator); each + prior[k].  K/V of earlier pushes are
        read from the cache's storage, a push's own rows exactly: the
        prefill's first six inputs are one push, the last content input
        and the EOS of the map and agent segments another."""
        w, dev = self.w, prior.device
        parts = [w["tske"][self.m["task_id"]][None]]
        for mod, start, end, bos, eos in self.segs:
            parts += [w["axe"][bos][None],
                      self._embed(mod, fed[start:end - 1].long()),
                      w["axe"][eos][None]]
        r = self.r
        x = r(torch.cat(parts)[:self.S] + prior)
        push = torch.arange(self.S, device=dev)
        push[:self.seg["pose"][2] + 1] = 0
        for mod, start, end, _, _ in self.segs[1:-1]:
            push[end] = end - 1
        same = push[:, None] == push[None, :]
        causal = torch.tril(torch.ones(self.S, self.S, dtype=torch.bool,
                                       device=dev))
        stack, H = w["oar"], self.H
        for l in range(n_layers(stack)):
            p = layer(stack, l)
            q, k, v = (heads(a, H) for a in
                       lin(p["attn"]["qkv"], ln(p["ln1"], x, r), r).chunk(3, -1))
            if self.oar_cache == "int8":
                kq, vq = (torch.clamp(torch.round(a / KV_INT8_STEP), -127, 127)
                          * KV_INT8_STEP for a in (k, v))
            else:
                kq, vq = k, v
            sc = 1.0 / math.sqrt(q.shape[-1])
            logits = torch.where(same, q @ k.transpose(-1, -2),
                                 q @ kq.transpose(-1, -2)) * sc
            a = r(torch.softmax(logits.masked_fill(~causal, float("-inf")),
                                -1))
            y = r((a * same) @ v + (a * ~same) @ vq)
            x = r(x + lin(p["attn"]["proj"], merge(y), r))
            x = r(x + mlp(p["mlp"], ln(p["ln2"], x, r), r))
        return ln(w["ln_oar"], x, r)

    def head(self, name, h):
        return lin(self.w[name], h)
