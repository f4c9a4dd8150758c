"""Weight quantization and the decode kernel's weight packing (port of
umgen_tpu/runtime/quantize.py and of decode_kernel.py's W4A8 packer).

`pack_fused(params, kv_dtype, version)` keeps the reference's arguments;
`pack_fused_oar_v4` its six-stream packing for v4.

`quantize_params_int8` turns the selected subtrees' linear weights into
{"wq" int8 [in, out], "ws" f32 [out]} with per-output-channel symmetric
scales — the same arithmetic as the JAX package (`DECODE_KEYS`, or
`ALL_STACK_KEYS` for int8 on every stack).  `quantize_params_w4` (the CLI's
`--tar_w4`) turns the TAR-family stacks' into group-128 int4 {"wq4" [in/2,
out], "ws4" [in/128, out]}.  `pack_decode_weights` lays the
quantized OAR stack out for csrc/decode_step.cu: per-layer vectors in one
float32 block and every weight matrix transposed to output-major, so the
kernel's dp4a dot products read the input dimension contiguously.

W4A8: `pack_fused_oar_w4` packs the RAW OAR weights exactly as the JAX
package does (group-128 symmetric int4 in [-7, 7], group pairs (2j, 2j+1)
nibble-packed low/high, all group scales in one [L, 3G, 4d] block, G =
d/128); `w4_kernel_layout` repacks those values output-major for the
kernel; `pack_fused_w4` adds both to the params.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

Params = Dict[str, Any]

DECODE_KEYS = ("oar", "head_ar_map", "head_ar_img", "head_ar_bbox3d",
               "head_ar_pose", "head_ar_aux")
ALL_STACK_KEYS = DECODE_KEYS + (
    "tar", "map_tar", "box_tar", "ego_tar", "ego_ca", "map_mlp_pre",
    "img_mlp_pre", "head_tar_map", "head_tar_img", "head_tar_bbox3d",
    "head_tar_n_step_bbox3d", "head_tar_pose", "head_tar_aux", "head_ego")
TAR_STACK_KEYS = ("tar", "map_tar", "box_tar", "ego_tar", "ego_ca")
W4_GROUP = 128
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


def _quantize_linear_w4(p: Params, group: int = W4_GROUP) -> Params:
    """{"w": [..., in, out], "b"?} → {"wq4": int8 [..., in/2, out], "ws4":
    f32 group scales [..., in/G, out], "b"?}: group-G (G = min(group, in))
    symmetric int4 in [-7, 7] along the input dim, rows (2i, 2i+1)
    nibble-packed low/high — the bytes and scales of the JAX package's
    `_quantize_linear_w4` (the scale an IEEE division by 7 on every
    device)."""
    w = p["w"].float()
    *lead, K, N = w.shape
    G = min(group, K)
    wg = w.reshape(*lead, K // G, G, N)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, 7.0), min=1e-8)
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    q = q.reshape(*lead, K, N)
    packed = ((q[..., 1::2, :] << 4) | (q[..., 0::2, :] & 0x0F)).to(
        torch.int8)
    out = {"wq4": packed, "ws4": scale.squeeze(-2)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_params_w4(params: Params,
                       keys: Iterable[str] = TAR_STACK_KEYS) -> Params:
    """Group-128 int4 weights for the selected subtrees (default the
    TAR-family stacks), read by `modules.linear`'s dequantizing branch (the
    TAR cascade has no decode kernel).  Leaves already in int8 are
    re-quantized from their dequantized values, as the JAX package does."""
    def walk(t, name):
        if isinstance(t, dict):
            if name in LINEAR_NAMES or name.startswith("head_"):
                if "w" in t:
                    return _quantize_linear_w4(t)
                if "wq" in t:
                    # ws [..., out] scales wq [..., in, out] per column
                    keep = {"w": t["wq"].float()
                            * t["ws"].float()[..., None, :]}
                    if "b" in t:
                        keep["b"] = t["b"]
                    return _quantize_linear_w4(keep)
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


def check_decode_biases(oar: Params) -> None:
    """The decode kernels' vec block holds the attention projections'
    biases and no MLP bias: the published configuration's (bias=False).
    Under bias=True (attention without biases, MLPs with them) the JAX
    package's packers raise KeyError: 'b' (umgen_tpu/ops/decode_kernel.py
    reads p["attn"]["qkv"]["b"] unconditionally); the port refuses by
    name, and bias=True serves on the unfused decode."""
    if "b" not in oar["attn"]["qkv"] or "b" in oar["mlp"]["fc"]:
        raise ValueError(
            "bias=True: the fused decode kernels carry the attention biases "
            "and no MLP bias (the JAX package's packers raise KeyError: "
            "'b' here); run bias=True without --fused_oar")


def pack_decode_weights(oar: Params) -> Params:
    """Int8 OAR stack (quantize_params_int8's params["oar"]) → the decode
    kernel's layout: {"vec": [L, 15d] f32, "wqkv": [L, 3d, d], "wproj":
    [L, d, d], "wfc": [L, 4d, d], "wpj": [L, d, 4d]} int8, output-major."""
    if "wq" not in oar["attn"]["qkv"]:
        raise ValueError("pack_decode_weights needs the int8-quantized OAR "
                         "stack (run quantize_params_int8 first)")
    check_decode_biases(oar)
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


def pack_fused_oar_v4(oar: Params) -> Params:
    """Int8 OAR stack → the reference's six weight streams for v4, input-
    major as quantized ({"vec", "wqkv" [L, d, 3d], "wproj" [L, d, d], "wfca"
    | "wfcb" [L, d, 2d] the column halves of fc, "wpja" | "wpjb" [L, 2d, d]
    the row halves of pj}; the plain version reads these), plus "kernel":
    `pack_decode_weights`' output-major layout of the same values, which the
    CUDA kernel reads.  The streams' names overlap the kernel layout's
    ("wqkv", "wproj") with the other orientation; "wfca" tells them apart."""
    kernel = pack_decode_weights(oar)
    d = oar["attn"]["qkv"]["wq"].shape[1]
    wfc, wpj = oar["mlp"]["fc"]["wq"], oar["mlp"]["proj"]["wq"]
    return {"vec": kernel["vec"], "wqkv": oar["attn"]["qkv"]["wq"],
            "wproj": oar["attn"]["proj"]["wq"],
            "wfca": wfc[:, :, :2 * d].contiguous(),
            "wfcb": wfc[:, :, 2 * d:].contiguous(),
            "wpja": wpj[:, :2 * d].contiguous(),
            "wpjb": wpj[:, 2 * d:].contiguous(), "kernel": kernel}


def pack_fused(params: Params, kv_dtype: str = "int8",
               version: str = "v3") -> Params:
    """Add the fused decode kernels' ``oar_packed`` blocks to int8 params,
    with the reference's arguments: an int8 cache with ``version="v4"``
    gets `pack_fused_oar_v4`'s six streams; everything else — v5 / v7 / v3
    on int8 caches, v2 on bf16 / fp8 ones — the one layout of
    `pack_decode_weights` (the reference's `pack_fused_oar` blocks differ
    from it only in orientation)."""
    out = dict(params)
    if kv_dtype == "int8" and version == "v4":
        out["oar_packed"] = pack_fused_oar_v4(params["oar"])
    else:
        out["oar_packed"] = pack_decode_weights(params["oar"])
    return out


# ---------------------------------------------------------------------------
# W4A8 OAR weights
# ---------------------------------------------------------------------------
def _quantize_w4_groups(w: torch.Tensor):
    """[K, N] float → (packed int8 [K/2, N], scales f32 [K/128, N]): input
    group g's int4 values in [-7, 7]; packed row j·128 + i holds group 2j's
    row i in its low nibble and group 2j+1's in its high nibble."""
    K, N = w.shape
    G = K // W4_GROUP
    wg = w.float().reshape(G, W4_GROUP, N)
    scale = torch.clamp(wg.abs().amax(dim=1, keepdim=True) / 7.0, min=1e-8)
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int16)
    packed = ((q[1::2] << 4) | (q[0::2] & 0xF)).to(torch.int8)
    return packed.reshape(K // 2, N), scale[:, 0, :]


def pack_fused_oar_w4(oar_raw: Params) -> Params:
    """RAW (bf16/float32 "w") stacked OAR params → JAX's W4A8 blocks:
    {"vec" [L, 15d] f32 (the ws slots ones), "wqp4" [L, d/2, 4d] (qkv ‖
    proj), "wfc4" [L, d/2, 4d], "wpj4" [L, 2d, d] int8, "scales4" [L, 3G,
    4d] f32}: rows 0:G the qkv‖proj group scales, G:2G fc's, 2G:3G pj's 4G
    groups laid [G, 4d] (group g at row 2G + g//4, columns (g%4)·d)."""
    p = oar_raw
    if "w" not in p["attn"]["qkv"]:
        raise ValueError("pack_fused_oar_w4 quantizes the RAW OAR weights, "
                         "not int8 ones")
    check_decode_biases(p)
    L, d, _ = p["attn"]["qkv"]["w"].shape
    if d % (2 * W4_GROUP):
        raise ValueError(f"W4A8 packing needs d % {2 * W4_GROUP} == 0, "
                         f"got d={d}")
    G = d // W4_GROUP
    wqp = torch.cat([p["attn"]["qkv"]["w"], p["attn"]["proj"]["w"]], dim=-1)
    dev = wqp.device
    qp4 = torch.empty(L, d // 2, 4 * d, dtype=torch.int8, device=dev)
    fc4 = torch.empty(L, d // 2, 4 * d, dtype=torch.int8, device=dev)
    pj4 = torch.empty(L, 2 * d, d, dtype=torch.int8, device=dev)
    scales = torch.empty(L, 3 * G, 4 * d, dtype=torch.float32, device=dev)
    for ll in range(L):
        qp4[ll], scales[ll, :G] = _quantize_w4_groups(wqp[ll])
        fc4[ll], scales[ll, G:2 * G] = _quantize_w4_groups(
            p["mlp"]["fc"]["w"][ll])
        pj4[ll], s_pj = _quantize_w4_groups(p["mlp"]["proj"]["w"][ll])
        scales[ll, 2 * G:] = s_pj.reshape(G, 4 * d)
    ones = torch.ones(L, 4 * d, device=dev)
    parts = {"ln1": p["ln1"]["w"], "ln2": p["ln2"]["w"],
             "qkv_ws": ones[:, :3 * d], "qkv_b": p["attn"]["qkv"]["b"],
             "proj_ws": ones[:, :d], "proj_b": p["attn"]["proj"]["b"],
             "fc_ws": ones, "pj_ws": ones[:, :d]}
    off = vec_offsets(d)
    vec = torch.cat([parts[n].float().reshape(L, off[n][1] - off[n][0])
                     for n in parts], dim=1).contiguous()
    return {"vec": vec, "wqp4": qp4, "wfc4": fc4, "wpj4": pj4,
            "scales4": scales}


def w4_kernel_layout(packed: Params) -> Params:
    """JAX's W4A8 blocks → csrc/decode_step.cu's (the same values):
    {"w4k" [L, 6d²] int8: per layer the qkv [3d, d/2], proj [d, d/2], fc
    [4d, d/2] and pj [d, 2d] blocks output-major (column n's packed bytes
    contiguous, in JAX's row order); "s4k" [L, 12·d·G] f32: their group
    scales qkv [3d, G], proj [d, G], fc [4d, G], pj [d, 4G]}."""
    L, _, d4 = packed["wqp4"].shape
    d = d4 // 4
    G = d // W4_GROUP
    sc = packed["scales4"]

    def t(a):
        return a.transpose(1, 2).reshape(L, -1)

    w4k = torch.cat([t(packed["wqp4"][..., :3 * d]),
                     t(packed["wqp4"][..., 3 * d:]), t(packed["wfc4"]),
                     t(packed["wpj4"])], dim=1).contiguous()
    s_pj = sc[:, 2 * G:].reshape(L, 4 * G, d)
    s4k = torch.cat([t(sc[:, :G, :3 * d]), t(sc[:, :G, 3 * d:]),
                     t(sc[:, G:2 * G]), t(s_pj)], dim=1).contiguous()
    return {"w4k": w4k, "s4k": s4k}


def pack_fused_w4(params: Params, raw_oar: Params) -> Params:
    """Add the W4A8 ``oar_packed`` blocks (kernels fused_decode_step_w4 /
    w4mq): JAX's layout, which the plain version reads, plus the kernel's.
    ``raw_oar``: the UN-quantized OAR subtree — int4 group quantization
    starts from the raw weights, not the int8 ones; the rest of ``params``
    may already be int8."""
    packed = pack_fused_oar_w4(raw_oar)
    out = dict(params)
    out["oar_packed"] = {**packed, **w4_kernel_layout(packed)}
    return out
