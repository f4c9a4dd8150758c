"""Scene-clip → token-dict pipeline.

Replaces the reference transform chain SplitAttriute → Normalize →
MergeAttribute → Normalize_Standard → BBox3DTokenizer → DigitalBinsTokenizer
→ ToTensor (ref:UMGen_config_evaluation.py:247-257) with one vectorized
pipeline object that also provides the inverse (token → metric) path used by
decode/visualization and by the in-graph rule constraint.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from umgen_tpu_torch.data.normalize import MinMaxNormalizer, StandardNormalizer
from umgen_tpu_torch.data.tokenizers import (
    BBox3DTokenizer,
    DigitalBinsTokenizer,
    default_bbox3d_tokenizer,
    default_ego_tokenizer,
)


class ScenePipeline:
    """Encodes raw scene clips into the model token dict and back."""

    def __init__(self,
                 ego_tokenizer: DigitalBinsTokenizer = None,
                 bbox_tokenizer: BBox3DTokenizer = None,
                 ego_norm: StandardNormalizer = None,
                 agent_norm: MinMaxNormalizer = None):
        self.ego_tok = ego_tokenizer or default_ego_tokenizer()
        self.bbox_tok = bbox_tokenizer or default_bbox3d_tokenizer()
        self.ego_norm = ego_norm or StandardNormalizer()
        self.agent_norm = agent_norm or MinMaxNormalizer()

    # --- encode ----------------------------------------------------------
    def encode(self,
               pose: np.ndarray,
               map_tokens: np.ndarray,
               bboxes: Sequence[np.ndarray],
               categories: Sequence[Sequence[str]],
               track_ids: Sequence[np.ndarray],
               image_tokens: np.ndarray = None) -> Dict[str, np.ndarray]:
        """Raw clip → token dict.

        pose: (T, 3) metric ego motion (dx, dy, dheading)
        map_tokens: (T, 1024) VQ indices (already tokenized upstream)
        bboxes: T × (N_t, 10) metric agent attributes
        categories: T × N_t class names
        track_ids: T × (N_t,) persistent ids
        image_tokens: (T, 512) VQ indices or None
        """
        norm_boxes = [
            self.agent_norm.normalize(b) if np.asarray(b).size else b
            for b in bboxes
        ]
        data = {
            "pose": self.ego_tok.encode(self.ego_norm.normalize(pose)),
            "map": np.asarray(map_tokens, dtype=np.int64),
            "bbox3d": self.bbox_tok.encode_clip(norm_boxes, categories,
                                                track_ids),
        }
        if image_tokens is not None:
            data["image"] = np.asarray(image_tokens, dtype=np.int64)
        return data

    # --- decode ----------------------------------------------------------
    def decode_pose(self, pose_tokens: np.ndarray) -> np.ndarray:
        """(..., 3) tokens → metric ego motion (ref:UMGen.py:1008-1024)."""
        return self.ego_norm.unnormalize(self.ego_tok.decode(pose_tokens))

    def decode_bboxes(self, bbox_tokens: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(..., 660) tokens → (metric (..., 60, 10), cat ids, valid mask).

        Matches model_pl.decode_tokens keep_order/no_special semantics
        (ref:tools/model_pl.py:372-397): attr tokens are clipped into the bin
        range before decode, slot identity preserved."""
        tokens = np.asarray(bbox_tokens).copy()
        pad = self.bbox_tok.pad_token
        lo = self.bbox_tok.start
        hi = lo + self.bbox_tok.vocab_size - 1
        mask = tokens != pad
        tokens[mask] = np.clip(tokens[mask], lo, hi)
        values, cat_ids, valid = self.bbox_tok.decode_slots(tokens)
        metric = self.agent_norm.unnormalize(values)
        return metric, cat_ids, valid

    # --- constants for the jitted graph ----------------------------------
    def device_constants(self) -> Dict[str, np.ndarray]:
        """Lookup tables letting pose/bbox decode run inside jit."""
        return {
            "ego_bin_midpoints": self.ego_tok.decode_table(),
            "ego_mean": self.ego_norm.mean,
            "ego_std": self.ego_norm.std,
            "agent_bin_midpoints": self.bbox_tok.bins_tok.decode_table(),
            "agent_lo": self.agent_norm.lo,
            "agent_span": self.agent_norm.span,
        }
