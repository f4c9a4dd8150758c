"""Weight-only int8 quantization and the decode kernel's weight packing
(port of umgen_tpu/runtime/quantize.py, the int8 path).

`quantize_params_int8` turns the selected subtrees' linear weights into
{"wq" int8 [in, out], "ws" f32 [out]} with per-output-channel symmetric
scales — the same arithmetic as the JAX package.  `pack_decode_weights`
lays the quantized OAR stack out for csrc/decode_step.cu: per-layer vectors
in one float32 block and every weight matrix transposed to output-major, so
the kernel's dp4a dot products read the input dimension contiguously.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

Params = Dict[str, Any]

DECODE_KEYS = ("oar", "head_ar_map", "head_ar_img", "head_ar_bbox3d",
               "head_ar_pose", "head_ar_aux")
LINEAR_NAMES = {"qkv", "proj", "fc", "q", "k", "v"}


def _quantize_linear(p: Params) -> Params:
    w = p["w"].float()
    amax = w.abs().amax(dim=-2, keepdim=True)          # per out channel
    scale = torch.clamp(amax / 127.0, min=1e-8)
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out = {"wq": wq, "ws": scale.squeeze(-2)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_params_int8(params: Params,
                         keys: Iterable[str] = DECODE_KEYS) -> Params:
    """Params with the selected subtrees' linear weights in int8
    (default: the decode-bound OAR stack and the AR heads)."""
    def walk(t, name):
        if isinstance(t, dict):
            if "w" in t and (name in LINEAR_NAMES
                             or name.startswith("head_")):
                return _quantize_linear(t)
            return {k: walk(v, k) for k, v in t.items()}
        return t

    out = dict(params)
    for key in keys:
        if key in params:
            out[key] = walk(params[key], key)
    return out


def vec_offsets(d: int) -> Dict[str, tuple]:
    """Column ranges of the packed per-layer vector block [L, 15d]."""
    names = [("ln1", d), ("ln2", d), ("qkv_ws", 3 * d), ("qkv_b", 3 * d),
             ("proj_ws", d), ("proj_b", d), ("fc_ws", 4 * d), ("pj_ws", d)]
    off, table = 0, {}
    for n, w in names:
        table[n] = (off, off + w)
        off += w
    table["__total__"] = off
    return table


def pack_decode_weights(oar: Params) -> Params:
    """Int8 OAR stack (quantize_params_int8's params["oar"]) → the decode
    kernel's layout: {"vec": [L, 15d] f32, "wqkv": [L, 3d, d], "wproj":
    [L, d, d], "wfc": [L, 4d, d], "wpj": [L, d, 4d]} int8, output-major."""
    if "wq" not in oar["attn"]["qkv"]:
        raise ValueError("pack_decode_weights needs the int8-quantized OAR "
                         "stack (run quantize_params_int8 first)")
    L, d, _ = oar["attn"]["qkv"]["wq"].shape
    parts = {"ln1": oar["ln1"]["w"], "ln2": oar["ln2"]["w"],
             "qkv_ws": oar["attn"]["qkv"]["ws"],
             "qkv_b": oar["attn"]["qkv"]["b"],
             "proj_ws": oar["attn"]["proj"]["ws"],
             "proj_b": oar["attn"]["proj"]["b"],
             "fc_ws": oar["mlp"]["fc"]["ws"],
             "pj_ws": oar["mlp"]["proj"]["ws"]}
    off = vec_offsets(d)
    vec = torch.cat([parts[n].float().reshape(L, off[n][1] - off[n][0])
                     for n in parts], dim=1).contiguous()

    def t(wq):
        return wq.transpose(1, 2).contiguous()

    return {"vec": vec, "wqkv": t(oar["attn"]["qkv"]["wq"]),
            "wproj": t(oar["attn"]["proj"]["wq"]),
            "wfc": t(oar["mlp"]["fc"]["wq"]),
            "wpj": t(oar["mlp"]["proj"]["wq"])}


def pack_fused(params: Params) -> Params:
    """Add the decode kernel's ``oar_packed`` blocks to int8 params."""
    out = dict(params)
    out["oar_packed"] = pack_decode_weights(params["oar"])
    return out
