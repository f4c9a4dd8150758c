"""Scalar tokenizers: value↔token codecs for ego pose and agent boxes.

Behavior-compatible rebuild of the reference tokenizer stack
(ref:plugin/data/transforms/tokenizer.py) as vectorized numpy:

* ``DigitalBinsTokenizer`` — bin continuous values with ``np.digitize`` over
  an ``np.linspace`` table; decode returns bin midpoints
  (ref:tokenizer.py:316-354).
* ``TextTokenizer`` — category names ↔ vocab ids (ref:tokenizer.py:357-436).
* ``BBox3DTokenizer`` — composes both over the 11-token box layout
  (10 binned attributes + 1 category), with persistent 60-slot assignment by
  track id across a clip ("bbox slotting", ref:tokenizer.py:809-952).

Token id spaces (full task config): bins 0..1023, categories 1024..1026,
<pad> = 1027.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from umgen_tpu_torch.config import AGENT_BINS, CATEGORIES, EGO_BINS

Array = np.ndarray


class DigitalBinsTokenizer:
    """Quantize continuous values into linspace bins.

    encode: ``np.digitize(x, bins)`` clipped to [0, vocab_size-1], + start
    (ref:tokenizer.py:316-330).  Note digitize returns the count of bin edges
    <= x, so values below bins[0] map to 0 and above bins[-1] clip to
    vocab_size-1 — identical clipping to the reference.

    decode: midpoint of the bin edges bracketing the token
    (ref:tokenizer.py:332-354): ``(bins[clip(t-1)] + bins[clip(t)]) / 2``.
    """

    def __init__(self, bins: Sequence[Tuple[float, float, int]],
                 seq_len: int, start: int = 0,
                 pad_to_length: Optional[int] = None):
        self.bins = np.concatenate([np.linspace(*b) for b in bins])
        self._start = start
        self._vocab_size = self.bins.shape[0]
        self._seq_len = seq_len
        self.pad_to_length = pad_to_length
        # <pad> appended after the bin vocab only when padding is requested
        # (ref:tokenizer.py:39-42)
        self.pad_token = (start + self._vocab_size
                          if pad_to_length is not None else None)

    # --- vocab bookkeeping (ref:tokenizer.py:50-84) ---
    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    @property
    def seq_len(self) -> int:
        return self._seq_len

    @property
    def start(self) -> int:
        return self._start

    def __len__(self) -> int:
        return self._vocab_size + (1 if self.pad_token is not None else 0)

    def encode(self, values: Array) -> Array:
        values = np.asarray(values)
        tokens = np.digitize(values, self.bins)
        return np.clip(tokens, 0, self._vocab_size - 1) + self._start

    def decode(self, tokens: Array) -> Array:
        """Bin-midpoint decode, `keep_order=True` semantics (no special-token
        stripping; out-of-range tokens clip to the edge bins)."""
        tokens = np.asarray(tokens) - self._start
        if tokens.size == 0:
            return np.array([])
        right = np.clip(tokens, 0, self.bins.shape[0] - 1)
        left = np.clip(tokens - 1, 0, self.bins.shape[0] - 1)
        return (self.bins[left] + self.bins[right]) / 2

    def decode_table(self) -> Array:
        """Midpoint value for every token id — used to fold pose decode into
        the on-device graph (kills the reference's per-frame GPU→CPU round
        trip, ref:UMGen.py:1008-1024)."""
        ids = np.arange(self._vocab_size)
        right = np.clip(ids, 0, self.bins.shape[0] - 1)
        left = np.clip(ids - 1, 0, self.bins.shape[0] - 1)
        return ((self.bins[left] + self.bins[right]) / 2).astype(np.float32)


class IdentityTokenizer:
    """Pass-through codec for pre-tokenized data (offset + length handling,
    ref:tokenizer.py:176-251)."""

    def __init__(self, vocab_size: int, seq_len: int, start: int = 0,
                 pad_to_length: Optional[int] = None):
        self._start = start
        self._vocab_size = vocab_size
        self._seq_len = seq_len
        self.pad_to_length = pad_to_length
        self.pad_token = (start + vocab_size
                          if pad_to_length is not None else None)

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    @property
    def seq_len(self) -> int:
        return self._seq_len

    def encode(self, raw_tokens: Array) -> Array:
        tokens = np.asarray(raw_tokens) + self._start
        if self.pad_to_length is not None:
            flat = tokens.reshape(tokens.shape[0], -1) if tokens.ndim > 1 \
                else tokens[None]
            if flat.shape[-1] < self.pad_to_length:
                pad = np.full(flat.shape[:-1]
                              + (self.pad_to_length - flat.shape[-1],),
                              self.pad_token)
                flat = np.concatenate([flat, pad], axis=-1)
            tokens = flat[: , :self.pad_to_length] if tokens.ndim > 1 \
                else flat[0, :self.pad_to_length]
        return tokens

    def decode(self, tokens: Array) -> Array:
        tokens = np.asarray(tokens)
        if self.pad_token is not None:
            tokens = tokens[tokens != self.pad_token]
        tokens = tokens - self._start
        assert tokens.size == 0 or (tokens.min() >= 0
                                    and tokens.max() < self._vocab_size)
        return tokens


class TextTokenizer:
    """Category vocabulary codec (ref:tokenizer.py:357-436)."""

    def __init__(self, vocab: Sequence[str], start: int = 0):
        self.vocab = list(vocab)
        self._start = start

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def start(self) -> int:
        return self._start

    def encode(self, names: Sequence[str]) -> Array:
        return np.array([self.vocab.index(n) for n in names],
                        dtype=np.int64) + self._start

    def decode(self, tokens: Array) -> List[str]:
        """`keep_order=True` semantics: out-of-range ids → "none"
        (ref:tokenizer.py:426-436)."""
        out = []
        for t in np.asarray(tokens).reshape(-1) - self._start:
            if 0 <= t < len(self.vocab):
                out.append(self.vocab[int(t)])
            else:
                out.append("none")
        return out


class BBox3DTokenizer:
    """Agent-stream codec: 60 persistent object slots × 11 tokens.

    Composes a bins tokenizer (10 attributes, normalized to [0,1], 1024 bins)
    and a category tokenizer (3 classes).  ``slot_frames`` assigns each track
    id a stable slot for the whole clip; objects absent in a frame become
    all-<pad> rows (ref:tokenizer.py:442-952).
    """

    def __init__(self,
                 bins: Sequence[Tuple[float, float, int]] = (AGENT_BINS,),
                 categories: Sequence[str] = CATEGORIES,
                 start: int = 0,
                 pad_to_length: int = 60,
                 bbox_size: int = 10):
        self.bbox_size = bbox_size
        self.pad_to_length = pad_to_length
        self.bins_tok = DigitalBinsTokenizer(bins, seq_len=bbox_size,
                                             start=start)
        self.cat_tok = TextTokenizer(categories,
                                     start=start + self.bins_tok.vocab_size)
        self._start = start
        self._vocab_size = self.bins_tok.vocab_size + self.cat_tok.vocab_size
        # vocab layout: [bins | categories | <pad>]  → pad = 1027
        self.pad_token = start + self._vocab_size
        self.tokens_per_box = bbox_size + 1

    @property
    def start(self) -> int:
        return self._start

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    @property
    def seq_len(self) -> int:
        return self.pad_to_length * self.tokens_per_box

    def __len__(self) -> int:
        return self._vocab_size + 1  # + <pad>  (== 1028)

    # --- encode ----------------------------------------------------------
    def encode_frame(self, bbox: Array, categories: Sequence[str]) -> Array:
        """(N, 10) normalized attrs + N category names → (N, 11) tokens."""
        bbox = np.asarray(bbox, dtype=np.float32).reshape(-1, self.bbox_size)
        attr = self.bins_tok.encode(bbox)
        cat = self.cat_tok.encode(categories).reshape(-1, 1)
        return np.concatenate([attr, cat], axis=-1)

    def assign_slots(self, track_ids: Sequence[Array]) -> Dict[int, int]:
        """First-appearance-ordered track→slot map, capped at 60 slots
        (ref:tokenizer.py:824-849)."""
        all_ids: List[int] = []
        seen = set()
        for frame_ids in track_ids:
            for tid in np.asarray(frame_ids).reshape(-1):
                tid = int(tid)
                if tid not in seen:
                    seen.add(tid)
                    all_ids.append(tid)
        all_ids = all_ids[: self.pad_to_length]
        return {tid: i for i, tid in enumerate(all_ids)}

    def slot_frames(self, frame_tokens: Sequence[Array],
                    track_ids: Sequence[Array],
                    slot_map: Optional[Dict[int, int]] = None) -> Array:
        """Scatter per-frame (N_t, 11) token rows into (T, 60, 11) slots;
        missing objects are all-<pad> rows (ref:tokenizer.py:913-952)."""
        if slot_map is None:
            slot_map = self.assign_slots(track_ids)
        T = len(frame_tokens)
        out = np.full((T, self.pad_to_length, self.tokens_per_box),
                      self.pad_token, dtype=np.int64)
        for t, (toks, tids) in enumerate(zip(frame_tokens, track_ids)):
            tids = np.asarray(tids).reshape(-1)
            for row, tid in zip(np.asarray(toks).reshape(-1,
                                self.tokens_per_box), tids):
                slot = slot_map.get(int(tid))
                if slot is not None:
                    out[t, slot] = row
        return out

    def encode_clip(self, bboxes: Sequence[Array],
                    categories: Sequence[Sequence[str]],
                    track_ids: Sequence[Array]) -> Array:
        """Full clip encode → (T, 660) flat token stream."""
        frame_tokens = []
        for bbox, cats in zip(bboxes, categories):
            if np.asarray(bbox).size == 0:
                frame_tokens.append(
                    np.zeros((0, self.tokens_per_box), dtype=np.int64))
            else:
                frame_tokens.append(self.encode_frame(bbox, cats))
        slotted = self.slot_frames(frame_tokens, track_ids)
        return slotted.reshape(slotted.shape[0], -1)

    # --- decode ----------------------------------------------------------
    def decode_slots(self, tokens: Array) -> Tuple[Array, Array, Array]:
        """(..., 660) tokens → (values (..., 60, 10), cat ids (..., 60),
        valid mask (..., 60)).  keep_order/no_special semantics
        (ref:tokenizer.py:741-774): slot identity preserved; a slot is valid
        iff none of its 11 tokens is <pad>."""
        tokens = np.asarray(tokens)
        shape = tokens.shape[:-1]
        boxes = tokens.reshape(*shape, self.pad_to_length, self.tokens_per_box)
        valid = ~np.any(boxes == self.pad_token, axis=-1)
        values = self.bins_tok.decode(boxes[..., :-1])
        cat_ids = boxes[..., -1] - self.cat_tok.start
        return values, cat_ids, valid

    def decode_single_box(self, tokens: Array) -> Tuple[Array, str]:
        """One 11-token box → (10 attr values, category name)
        (ref:tokenizer.py:679-687)."""
        tokens = np.asarray(tokens).reshape(-1)
        values = self.bins_tok.decode(tokens[:-1])
        cat = self.cat_tok.decode(tokens[-1:])[0]
        return values, cat


def default_ego_tokenizer() -> DigitalBinsTokenizer:
    """Ego pose codec: 3 values, 1024 bins over [-1, 1]
    (ref:UMGen_config_evaluation.py:188-194)."""
    return DigitalBinsTokenizer([EGO_BINS], seq_len=3, start=0)


def default_bbox3d_tokenizer() -> BBox3DTokenizer:
    """Agent codec: 1024 bins over [0, 1], 60 slots
    (ref:UMGen_config_evaluation.py:196-204)."""
    return BBox3DTokenizer()
