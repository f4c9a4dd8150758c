"""Static per-frame sequence layout.

The frame token sequence has a fixed interleaved layout (task `pose_map_
bbox3d_image`): every position's modality, separator-status and forced aux
token are known at *trace time*.  The reference rediscovers this layout per
step with Python dict lookups inside the token loop
(ref:projects/models/UMGen.py:976-992 `d_token_pos`/`pos_mod`); here it is
precomputed once into numpy tables so the whole decode compiles into
per-modality `lax.scan` segments with no data-dependent control flow.

Positions are 1-indexed after the task embedding, matching the reference
(`curr_seq_len` starts at 1, ref:UMGen.py:1209-1211).  For the full task:

    segment      positions      content
    pose         1..5           BOS, 3 pose tokens, EOS
    map          6..1031        BOS, 1024 map tokens, EOS
    bbox3d       1032..1693     BOS, 60*11 box tokens, EOS
    image        1694..2207     BOS, 512 image tokens, EOS

(ref:projects/tools/infer_fun.py:112-118).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from umgen_tpu_torch.config import BOS_EOS, TASKS, ModelConfig

# Content-token counts per modality (ref:infer_fun.py:112-118)
CONTENT_LEN: Dict[str, int] = {
    "pose": 3,
    "map": 32 * 32,
    "bbox3d": 60 * 11,
    "image": 16 * 32,
}


def token_len(mod: str) -> int:
    """Per-modality segment length including BOS/EOS."""
    return CONTENT_LEN[mod] + 2


@dataclasses.dataclass(frozen=True)
class Segment:
    mod: str
    start: int        # 1-indexed position of the BOS separator
    end: int          # 1-indexed position of the EOS separator (inclusive)
    bos: int          # aux vocab id
    eos: int

    @property
    def content_start(self) -> int:
        return self.start + 1

    @property
    def content_end(self) -> int:     # inclusive
        return self.end - 1

    @property
    def content_len(self) -> int:
        return self.end - self.start - 1


class SequenceLayout:
    """All static tables for one task's frame layout."""

    def __init__(self, task: str):
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}")
        self.task = task
        self.mod_order: Tuple[str, ...] = TASKS[task]

        self.segments: List[Segment] = []
        pos = 0
        for mod in self.mod_order:
            bos, eos = BOS_EOS[mod]
            start = pos + 1
            end = start + token_len(mod) - 1
            self.segments.append(Segment(mod, start, end, bos, eos))
            pos = end
        self.seq_len = pos                      # sampled positions (2207)
        self.input_len = pos + 1                # + task embedding slot

        # d_token_pos: position → forced aux id (ref:UMGen.py:976-984)
        self.sep_pos: Dict[int, int] = {}
        for seg in self.segments:
            self.sep_pos[seg.start] = seg.bos
            self.sep_pos[seg.end] = seg.eos

        # pos_mod: position → modality (ref:UMGen.py:986-992)
        mod_id = np.zeros(self.seq_len + 1, dtype=np.int32)
        is_sep = np.zeros(self.seq_len + 1, dtype=bool)
        sep_token = np.zeros(self.seq_len + 1, dtype=np.int32)
        for i, seg in enumerate(self.segments):
            mod_id[seg.start:seg.end + 1] = i
            is_sep[seg.start] = is_sep[seg.end] = True
            sep_token[seg.start] = seg.bos
            sep_token[seg.end] = seg.eos
        self.mod_id = mod_id          # [seq_len+1], index by 1-based position
        self.is_sep = is_sep
        self.sep_token = sep_token

        self._by_mod = {s.mod: s for s in self.segments}

    def segment(self, mod: str) -> Segment:
        return self._by_mod[mod]

    def pos_mod(self, pos: int) -> str:
        """Modality of a 1-indexed position (reference pos_mod semantics)."""
        return self.segments[int(self.mod_id[pos])].mod

    # --- bbox-segment helpers -------------------------------------------
    @property
    def bbox_content_start(self) -> int:
        """First bbox content position; == 1033 for the full task.

        The reference hardcodes `bbox_tokens_start_index = 1032` (the BOS
        position) and computes object ids as
        ``(curr_seq_len - 1032) // 11`` (ref:UMGen.py:1082-1084).
        """
        return self._by_mod["bbox3d"].content_start

    def bbox_object_and_attr(self, pos: int) -> Tuple[int, int]:
        """(object slot, attribute index) of a bbox content position.

        Matches ref:UMGen.py:1084 `(curr - 1032) // 11` for the object id and
        ref:UMGen.py:1288-1293 `(curr - 1032) % 11` for the completion check
        (attr == 10, the category token, completes a box):
        ``(pos - bos_pos - 1)`` ranges over 0..659.
        """
        off = pos - self._by_mod["bbox3d"].start - 1
        return off // 11, off % 11

    def control_object_id(self, pos: int) -> int:
        """Object id as the reference's *control* path computes it:
        ``(curr_seq_len - 1032) // 11`` (ref:UMGen.py:1083-1084).

        NB this differs from the true slot mapping for category tokens: box
        k's 11th (category) token lands on object ``k+1`` under this formula.
        Preserved as observable control behavior.
        """
        return (pos - self._by_mod["bbox3d"].start) // 11

    def slices(self) -> Dict[str, slice]:
        """0-indexed content slices into the length-`seq_len` token stream
        (positions shifted down by 1 so position 1 → index 0)."""
        return {
            s.mod: slice(s.content_start - 1, s.content_end)
            for s in self.segments
        }


def layout_for(config: ModelConfig) -> SequenceLayout:
    return SequenceLayout(config.task)
