"""Configuration dataclasses and derived sequence-layout constants.

Replaces the reference's three-stage config pipeline (config-as-code module +
argparse + merge/derive helpers, ref:projects/configs/UMGen_config_evaluation.py,
ref:projects/tools/infer_fun.py:84-159) with plain dataclasses.  All derived
constants (per-modality vocab/token-length tables, BOS/EOS ids, layer counts
per model scale) are computed here so the rest of the framework sees a single
immutable config object.

This file is the port's own copy of umgen_tpu/config.py (the port imports
nothing of the JAX package); only the imports differ, and
tests/test_torch_import.py holds its values to the original's.  Where a
comment below gives a time, a rate or a memory size, it describes the JAX
package on a TPU v5e and is no measurement of this port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Modality orders per task (ref:projects/configs/UMGen_config_evaluation.py:331-337)
# ---------------------------------------------------------------------------
TASKS: Dict[str, Tuple[str, ...]] = {
    "pose_map_bbox3d_image": ("pose", "map", "bbox3d", "image"),
    "pose_map_bbox3d": ("pose", "map", "bbox3d"),
    "pose_map": ("pose", "map"),
    "bbox3d": ("bbox3d",),
}

# Task-name → task-token id (ref:UMGen_config_evaluation.py:149-152)
TASK_NAME_ID: Dict[str, int] = {
    "pose_map_bbox3d_image": 6,
    "pose_map_bbox3d": 5,
    "pose_map": 4,
    "bbox3d": 0,
}
TASK_NUM = 7

# BOS/EOS aux-vocab ids per modality (ref:projects/tools/infer_fun.py:99-104)
BOS_EOS: Dict[str, Tuple[int, int]] = {
    "pose": (0, 1),
    "map": (2, 3),
    "bbox3d": (4, 5),
    "image": (6, 7),
}

# Ego bbox size used by the collision rule (ref:projects/models/UMGen.py:9-12)
EGO_WHL = {
    "nuplan": {"w": 2.297, "l": 5.176, "h": 1.777},
    "waymo": {"w": 2.33, "l": 5.28, "h": 2.33},
}

# Agent categories (ref:projects/configs/category.txt)
CATEGORIES: Tuple[str, ...] = ("vehicle", "bicycle", "pedestrian")

# Per-attribute normalization ranges (ref:UMGen_config_evaluation.py:126-137)
NORMALIZE_RANGE: Dict[str, Tuple[float, float]] = {
    "bbox_posi_x": (-64.0, 64.0),
    "bbox_posi_y": (-64.0, 64.0),
    "bbox_posi_z": (-5.0, 5.0),
    "bbox_wlh_l": (0.0, 15.0),
    "bbox_wlh_w": (0.0, 4.0),
    "bbox_wlh_h": (0.0, 5.0),
    "bbox_yaw": (-3.14, 3.14),
    "bbox_speed_x": (-20.0, 20.0),
    "bbox_speed_y": (-15.0, 15.0),
    "bbox_speed_z": (-0.3, 0.3),
}
BBOX_ATTR_KEYS: Tuple[str, ...] = tuple(NORMALIZE_RANGE.keys())

# Ego pose normalization: standardize with mean 0, std (10, 4, 1)
# (ref:UMGen_config_evaluation.py:223-231)
EGO_MEAN: Tuple[float, ...] = (0.0, 0.0, 0.0)
EGO_STD: Tuple[float, ...] = (10.0, 4.0, 1.0)

# Scalar bin tables (ref:UMGen_config_evaluation.py:123,147)
EGO_BINS: Tuple[float, float, int] = (-1.0, 1.0, 1024)
AGENT_BINS: Tuple[float, float, int] = (0.0, 1.0, 1024)

# Map / image token grids (ref:infer_fun.py:112-118)
MAP_HW: Tuple[int, int] = (32, 32)
IMG_HW: Tuple[int, int] = (16, 32)

# Map raster geometry: 32x32 cells over a 128 m square, 4 m/cell
# (ref:UMGen.py:140,321 `res=4.0`)
MAP_SPACE_SIZE_M: float = 128.0

NUM_ATTRIBUTES = 10          # scalar attributes per box (ref:infer_fun.py:95)
TOKENS_PER_BOX = 11          # 10 attributes + category
PAD_TO_LENGTH = 60           # object slots per frame (ref:infer_fun.py:96)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture + sampling hyperparameters of the UMGen-class model.

    Defaults mirror the reference's "larger" (UMGen_Large, ~2.4B params)
    evaluation config (ref:UMGen_config_evaluation.py:27-38,344-430).
    """

    # --- core dims ---
    n_embd: int = 768
    n_head: int = 16
    n_map_embd: int = 16      # VQ codebook dim projected up via GMLP
    n_img_embd: int = 16

    # --- layer counts (per model scale; see `scaled`) ---
    n_tar_layer: int = 36
    n_oar_layer: int = 36
    n_ego_tar_layer: int = 12
    n_ego_ca_layer: int = 12
    n_map_tar_layer: int = 24
    n_box_tar_layer: int = 24

    # --- vocabularies ---
    aux_vocab_size: int = 8          # BOS/EOS tokens for 4 modalities
    pose_vocab_size: int = 1024
    map_vocab_size: int = 8192
    img_vocab_size: int = 8192
    bbox3d_vocab_size: int = 1028    # 1024 bins + 3 categories + <pad>=1027

    # --- sequence / task ---
    task: str = "pose_map_bbox3d_image"
    max_frame_len: int = 100         # temporal-PE table length
    cond_frame: int = 20             # sliding window length
    pad_to_length: int = PAD_TO_LENGTH
    num_attributes: int = NUM_ATTRIBUTES

    # --- structural flags (ref:UMGen_config_evaluation.py:7-20) ---
    bias: bool = False               # NB: attention projections use NOT bias
    split_map_tar: bool = True
    split_box_tar: bool = True
    map_transform: bool = True       # action-aware map alignment
    add_posi_embedd: bool = True     # bbox x/y spatial PE
    add_spatial_pos_embedd_on_map: bool = True
    merge_ar_tar: bool = True        # pad→TAR fallback rule
    only_ar: bool = False
    no_born: bool = False
    rule_constrain: bool = True
    # multi-step TAR bbox prediction (ref:UMGen_config_evaluation.py:17,
    # UMGen.py:221-226): n_step > 1 widens the bbox TAR head to
    # n_step*vocab columns ("head_tar_n_step_bbox3d"); inference uses
    # step-0 logits (ref:UMGen.py:1098-1101).  Checkpoints ship n_step=1.
    n_step: int = 1

    # --- sampling (ref:UMGen_config_evaluation.py:86-92,442-449) ---
    sample_method: str = "topk"      # "topk" | "topp"
    top_k: int = 5
    top_k_map: int = 5
    top_k_image: int = 16            # hardcoded in reference (ref:UMGen.py:103)
    top_p: float = 0.4
    sfmx_temp: float = 1.0

    # --- numerics ---
    dtype: str = "bfloat16"          # activation/param compute dtype
    param_dtype: str = "float32"     # master param dtype

    # --- perf knobs (new in this framework; no reference equivalent) ---
    # "recompute": reference-faithful — rerun every TAR stack over the full
    #   window each frame (ref:UMGen.py:1479-1494 recomputes; kvcache_t is
    #   always None, ref:UMGen.py:767).
    # "temporal_cache": cache TAR temporal-attention K/V across frames so each
    #   new frame only pushes its own 2207 tokens through the TAR cascade
    #   (~20x TAR FLOP reduction). Requires rolling temporal PEs.
    tar_mode: str = "recompute"
    # storage dtype of the TAR temporal KV rings ("bfloat16" |
    # "float8_e4m3fn" | "int4"); fp8 halves the ~10.5 GB
    # (larger-scale, B=1) ring footprint so cache + params fit one v5e
    # chip.  "int4" halves it again (nibble-packed int8 storage +
    # per-(layer, scene, frame, head) dequant scales folded into the
    # attention logits) — the rings cap the scene batch per chip, so int4
    # is what unlocks B=4 at the full 20-frame window.
    tar_cache_dtype: str = "bfloat16"
    # storage dtype of the OAR decode KV cache; at batched rollouts the
    # per-step prefix reads (36 layers x 6.8 MB x B) dominate — fp8 halves
    # that traffic
    oar_cache_dtype: str = "bfloat16"
    use_pallas_attention: bool = True
    # lax.scan unroll factors for the OAR decode.  TPU while-loops carry a
    # fixed ~0.1 ms per-iteration sync cost; with 36 layers × 2202 positions
    # that overhead alone is ~8 s/frame.  Fully unrolling the layer scan
    # (0 = full) keeps ONE while-iteration per decoded token.  (Unrolling
    # the POSITION scan was measured slower — leave at 1.)
    oar_layer_unroll: int = 0
    oar_pos_unroll: int = 1
    # chunked prefill: ingest the conditioning window into the TAR rings
    # frame-by-frame instead of one full-window program.  Mathematically
    # identical (cached == recompute pre-slide); peak memory drops from the
    # whole [B, T, S, D] window's activations to one frame's — required
    # for scene batches B>=6 on a 16 GB chip.  Costs ~T extra dispatches
    # once per rollout.
    chunked_prefill: bool = False
    # TAR temporal ring length; None = cond_frame (20).  Smaller windows
    # trade temporal context for ring memory (~265 MB fp8 per frame per
    # scene at the larger scale), enabling batched cached rollouts on one
    # chip.
    tar_cache_window: Optional[int] = None
    # ring-exactness refresh: every N generated frames, rebuild the
    # ego/TAR rings by re-ingesting the last `window` frames with
    # window-relative indices — the frame decoded right after a refresh
    # sees EXACTLY the reference's sliding-window recompute semantics
    # (ref:UMGen.py:1600-1603), bounding the documented
    # StreamingLLM-style post-slide drift to at most N frames.  Cost:
    # (window-1) cascade ingests per refresh (~one recompute frame every
    # N frames).  0 = never refresh (pure ring retention, the fastest
    # serving default); 1 = exact sliding window every frame.
    tar_cache_refresh: int = 0
    # temporal-PE clamp for the cached path: frame slots index
    # min(abs_frame, tpe_clamp) so rollouts deeper than a checkpoint's
    # trained window never hit untrained tpe rows (the diagnosed root
    # cause of the r3 speculative-acceptance depth collapse).  None =
    # clamp at max_frame_len - 1.  Serving sets this to
    # trained_window - 1 from checkpoint metadata (see models/umgen.py
    # add_pos_emb for the reference-semantics argument).
    tpe_clamp: Optional[int] = None
    # temporal-PE mode (VERDICT r4 task 4 — window-relative re-anchoring
    # as a first-class mechanism, not a refresh crutch):
    #  "absolute"  — reference semantics: a learned [max_frame_len, D]
    #    table added to the token embeddings by absolute frame slot
    #    (ref:UMGen.py:483-515).  Cached K/V bake the slot embedding in,
    #    so deep cached rollouts either index untrained rows or (with
    #    tpe_clamp) saturate every deep frame to the SAME slot — a
    #    distribution no training run produces (the measured
    #    acceptance/agreement decay at depth, PERFORMANCE.md).
    #  "relative"  — temporal position enters ONLY at the temporal-
    #    attention logits, as a learned per-head bias indexed by the
    #    query-key frame DISTANCE (tpe_rel [n_head, max_frame_len]).
    #    Cached K/V are PE-free and ring distances are bounded by the
    #    window, so a depth-1000 cached frame is distributionally
    #    IDENTICAL to a window-anchored one — re-anchoring by
    #    construction.  Owned-checkpoint only (the reference's torch
    #    weights have no tpe_rel); default stays "absolute" for
    #    reference-weight parity.
    temporal_pe_mode: str = "absolute"
    # experimental single-launch Pallas decode step (ops/decode_kernel);
    # currently slower than the XLA path on v5e — off by default
    fused_oar_kernel: bool = False
    # 4 selects the W4A8 fused kernel (group-128 int4 weights, ~4-8%
    # per-matmul rel err vs <2% for int8) — an opt-in serving knob
    oar_weight_bits: int = 8
    # fused decode kernel generation on the flat int8 cache: 5 (per-scene
    # attention loop — the default; measured at the HBM DMA floor for the
    # rollout's segment shapes) or 7 (block-diagonal batched attention —
    # one MXU dot pair per (layer, S-block) for ALL scenes; needs
    # B*n_head <= 128.  Its B×-redundant logit/AV dots make it compute-
    # bound at B>=4: scan-timed 2.53 vs 5's 1.18 ms/step at B=4 S=2207)
    oar_kernel_version: int = 5
    # v5 batch-group size: split the batch into groups of this size on an
    # innermost grid dimension (weight fetches shared across groups, KV
    # blocks shrink to the group) so the kernel fits VMEM at large B.
    # 0 = whole batch; B=8 needs 2 or 4.
    oar_batch_block: int = 0
    # speculative decoding for the map/image segments: the TAR prior is a
    # position-wise draft model (it is trained to predict exactly these
    # positions); chunks of K drafts verify in ONE multi-query OAR step,
    # amortizing the 255 MB/step weight stream over accepted tokens.
    # Lossless (rejection-scheme) — the output distribution equals
    # sequential sampling.  0 disables.
    speculative_k: int = 0
    # also draft the bbox segment (660 positions) when speculative_k > 0.
    # The target there is the merge-rule OAR/TAR mixture; control and
    # no-born positions are deterministic deltas, and the collision rule
    # constraint applies at box completions with acceptance truncated at
    # kills — still lossless (greedy reproduces the sequential stream,
    # tested).  Chunks are clamped to <= 11 so at most one box completes
    # per verify step.
    speculative_bbox: bool = True

    # --- training-only ---
    dropout: float = 0.0
    remat: bool = False              # jax.checkpoint on blocks during training

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def mod_order(self) -> Tuple[str, ...]:
        return TASKS[self.task]

    def __post_init__(self):
        if self.tar_cache_refresh > 0 and self.tar_cache_window == 1:
            raise ValueError(
                "tar_cache_refresh requires tar_cache_window >= 2: a "
                "1-frame ring keeps no history to re-ingest, so the "
                "refresh would silently never fire")

    @property
    def sample_img(self) -> bool:
        return "image" in self.task

    def scaled(self, scale: str) -> "ModelConfig":
        """Return a copy with layer counts for a named model scale.

        Mirrors ref:projects/tools/infer_fun.py:141-157 ("stander" | "larger"
        | hidden "debug" one-layer scale).  Adds "tiny" for fast unit tests.
        """
        if scale == "larger":
            upd = dict(n_tar_layer=36, n_oar_layer=36)
        elif scale == "stander":
            upd = dict(n_tar_layer=24, n_oar_layer=24)
        elif scale == "debug":
            upd = dict(
                n_tar_layer=1, n_oar_layer=1, n_map_tar_layer=1,
                n_box_tar_layer=1, n_ego_tar_layer=1, n_ego_ca_layer=1,
            )
        elif scale == "tiny":
            upd = dict(
                n_tar_layer=1, n_oar_layer=1, n_map_tar_layer=1,
                n_box_tar_layer=1, n_ego_tar_layer=1, n_ego_ca_layer=1,
                n_embd=64, n_head=4,
            )
        else:
            raise ValueError(f"unknown model scale: {scale!r}")
        return dataclasses.replace(self, **upd)

    def replace(self, **kwargs) -> "ModelConfig":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Rollout settings (ref:projects/tools/infer_fun.py:56-81)."""

    infer_task: str = "video"        # "video" | "control"
    num_new_frames: int = 30
    cond_frames: int = 20            # max window
    input_cond_frames: int = 20      # video: 20, control: 13
    max_objects: int = 100
    seed: int = 0
    batch_size: int = 1              # parallel scene rollouts per step

    @staticmethod
    def for_task(infer_task: str, set_num_new_frames: int = 30,
                 **kwargs) -> "InferConfig":
        if infer_task == "video":
            return InferConfig(
                infer_task="video", num_new_frames=set_num_new_frames,
                input_cond_frames=20, **kwargs)
        if "control" in infer_task:
            return InferConfig(
                infer_task=infer_task, num_new_frames=30,
                input_cond_frames=13, **kwargs)
        return InferConfig(
            infer_task=infer_task, num_new_frames=set_num_new_frames,
            input_cond_frames=20, **kwargs)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset settings (ref:plugin/data/datasets/UMGen_nuplan_dataset.py)."""

    data_root: Tuple[str, ...] = ("data/tokenized_origin_scenes",)
    block_size: int = 50             # cond + new frames
    sampling_gap: int = 4
    start_index: int = 10
    control_test: bool = False
    views: Tuple[str, ...] = ("CAM_F0",)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for scale-out.

    Axes: `dp` shards scene rollouts (batch), `tp` shards attention heads /
    FFN columns and the per-head KV cache.  The reference's only parallelism
    is implicit Lightning data-parallel (ref:tools/model_pl.py:13); here both
    axes are first-class and compile to ICI collectives.
    """

    dp: int = 1
    tp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp
