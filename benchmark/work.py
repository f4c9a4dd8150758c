"""The yardstick's arithmetic: the card's peaks, the least time a kernel's
work can take, and the model FLOPs of a generated frame.

`H100_*`, `bound`, `flash_work` and `decode_work` are frozen copies of
chip_smoke.py:369-478 (`H100_BYTES_S` … `H100_FP32_FLOPS` at :369-372,
`_bound` at :442, `flash_work` at :452, `decode_work` at :461): the program
may change, the yardstick does not.  `frame_flops` counts the model's
operations from the layer equations (2 FLOPs a multiply-add), after the
pattern of chip_smoke.py:1651 `train_step_flops`, for one generated frame of
one scene under the cell's window semantics.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates: HBM bytes/s, bf16 tensor-core
# FLOP/s, int8 OP/s, float32 FLOP/s outside the tensor cores
H100_BYTES_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_FP32_FLOPS = 67e12


def bound(nbytes: float, ops_s: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and `ops_s`, the operations over the peak of their type, in seconds."""
    byte_s = nbytes / H100_BYTES_S
    return {"bound_ms": 1e3 * max(byte_s, ops_s),
            "bound_by": "bytes" if byte_s >= ops_s else "operations"}


def flash_work(B, Sq, Sk, causal, H=16, Dh=48):
    """(bytes, seconds of operations at the bf16 peak) of one attention
    call: q, k, v read and o written in bf16; QKᵀ and PV at 2 FLOPs a
    multiply-add, over the keys a causal query sees."""
    nbytes = 2 * B * H * Dh * (2 * Sq + 2 * Sk)
    pairs = Sq * Sk - (Sq * (Sq - 1) // 2 if causal else 0)
    return nbytes, 4 * B * H * pairs * Dh / H100_BF16_FLOPS


def decode_work(name, L, d, H, B, Q, cl, kv="int8"):
    """(bytes, seconds of operations) of one decode step: every layer's
    weights and vector block, the cl cached rows of K and V per scene (int8
    and fp8: d bytes a row; bf16: 2d; int4: d/2 bytes + H float32 scales),
    the Q new rows written, x read and h written; the four products as int8
    operations, the attention's QKᵀ as int8 and its PV as bf16 ones (v1 and
    v2, which read their cache as bf16: both as bf16)."""
    w4, i4 = name.startswith("w4"), name.endswith("i4")
    dense = name in ("v1", "v2")
    weights = 6 * d * d + 12 * d * (d // 128) * 4 if w4 else 12 * d * d
    row = 2 * (d // 2 + 4 * H) if i4 else 4 * d if kv == "bfloat16" else 2 * d
    nbytes = L * (weights + 15 * d * 4 + B * (cl + Q) * row) + 4 * B * Q * d
    keys = cl + (Q + 1) / 2            # prefix + the causal chunk, per query
    qk_rate = H100_BF16_FLOPS if dense else H100_INT8_OPS
    ops_s = L * B * Q * (2 * 12 * d * d / H100_INT8_OPS
                         + 2 * keys * d / qk_rate
                         + 2 * keys * d / H100_BF16_FLOPS)
    return nbytes, ops_s


# ---------------------------------------------------------------------------
# model FLOPs of one generated frame
# ---------------------------------------------------------------------------
def _tar_stack(L: int, D: int, S: int, keys_t: float, T: int) -> float:
    """L factorized blocks over T frames of S tokens: per token 36·D²
    multiply-adds of projections and MLPs, two spatial attentions over S
    keys (QKᵀ and PV: 4·S·D) and a temporal one over `keys_t` keys per
    token on average (2·keys_t·D)."""
    per_token = 36 * D * D + 4 * S * D + 2 * keys_t * D
    return 2.0 * L * T * S * per_token


def _embed_mlp(D: int, d_in: int, n: int) -> float:
    """A token-embedding MLP (d_in → 4D → D) over n tokens."""
    return 2.0 * n * (d_in * 4 * D + 4 * D * D)


def frame_flops(m: Dict, segments: Dict[str, int], mode: str,
                window: int) -> float:
    """Model FLOPs of one generated frame of one scene.

    m: the configuration's sizes (n_embd, n_*_layer, vocabularies,
    n_map_embd, n_img_embd); segments: content tokens per modality (pose
    3, map 1024, bbox3d 660, image 512); mode "cached": the newest frame
    through every TAR-family stack against `window`-frame rings (keys: the
    ring's other frames and itself), "recompute": the whole `window`-frame
    window through every stack, causal in time.  Then the ego queries, the
    OAR's 2207 inputs (a causal prefix each), the heads of the sampled
    positions and the bbox segment's TAR head, and the embedding MLPs of
    the TAR inputs and of each decoded map / image token."""
    D = m["n_embd"]
    S = sum(n + 2 for n in segments.values())              # 2207
    s_map = segments["pose"] + 2 + segments["map"] + 2     # 1031
    s_box = s_map + segments["bbox3d"] + 2                 # 1693
    if mode == "cached":
        T, keys_t = 1, float(window)
    elif mode == "recompute":
        T, keys_t = window, (window + 1) / 2.0
    else:
        raise ValueError(f"unknown window semantics {mode!r}")
    fl = 0.0
    fl += _tar_stack(m["n_tar_layer"], D, S, keys_t, T)
    fl += _tar_stack(m["n_ego_tar_layer"], D, S, keys_t, T)
    fl += _tar_stack(m["n_map_tar_layer"], D, s_map, keys_t, T)
    fl += _tar_stack(m["n_box_tar_layer"], D, s_box, keys_t, T)
    # ego queries (3) over the newest frame: self- and cross-attention
    q = 3
    fl += 2.0 * m["n_ego_ca_layer"] * (14 * D * D * q + 2 * D * D * S
                                       + 2 * q * q * D + 2 * q * S * D)
    fl += 2.0 * q * D * m["pose_vocab_size"]
    # TAR inputs: the map embedding MLP in each of the three cascade
    # stacks and the ego stack's, the image's in the trunk and ego stack
    fl += T * (4 * _embed_mlp(D, m["n_map_embd"], segments["map"])
               + 2 * _embed_mlp(D, m["n_img_embd"], segments["image"]))
    # OAR: S inputs, each attending its causal prefix
    L = m["n_oar_layer"]
    fl += 2.0 * L * (12 * D * D * S + 2 * D * S * (S + 1) / 2.0)
    vocab = {"map": m["map_vocab_size"], "bbox3d": m["bbox3d_vocab_size"],
             "image": m["img_vocab_size"]}
    for mod, v in vocab.items():
        fl += 2.0 * segments[mod] * D * v
    fl += 2.0 * segments["bbox3d"] * D * m["bbox3d_vocab_size"]
    fl += _embed_mlp(D, m["n_map_embd"], segments["map"])
    fl += _embed_mlp(D, m["n_img_embd"], segments["image"])
    return fl
