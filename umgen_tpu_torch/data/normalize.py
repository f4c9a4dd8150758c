"""Value normalizers (ref:plugin/data/transforms/normalize.py).

* ``StandardNormalizer`` — (x - mean) / std, used for ego pose with
  std (10, 4, 1) (ref:normalize.py:7-76, UMGen_config_evaluation.py:223-231).
* ``MinMaxNormalizer`` — per-attribute (x - min)/(max - min) to [0, 1], used
  for the 10 agent attributes (ref:normalize.py:79-229).

Both expose their parameters as flat arrays so un/normalization can run
inside the jitted decode graph (the reference does this on host per frame,
ref:UMGen.py:1008-1024).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from umgen_tpu_torch.config import BBOX_ATTR_KEYS, EGO_MEAN, EGO_STD, NORMALIZE_RANGE


class StandardNormalizer:
    def __init__(self, mean: Sequence[float] = EGO_MEAN,
                 std: Sequence[float] = EGO_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, dtype=np.float32) - self.mean) / self.std

    def unnormalize(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float32) * self.std + self.mean


class MinMaxNormalizer:
    def __init__(self,
                 ranges: Dict[str, Tuple[float, float]] = NORMALIZE_RANGE,
                 keys: Sequence[str] = BBOX_ATTR_KEYS):
        self.keys = tuple(keys)
        lo = np.array([ranges[k][0] for k in self.keys], dtype=np.float32)
        hi = np.array([ranges[k][1] for k in self.keys], dtype=np.float32)
        self.lo, self.hi = lo, hi
        self.span = hi - lo

    def normalize(self, x: np.ndarray) -> np.ndarray:
        """(..., n_attr) raw values → [0, 1] (ref:normalize.py:117-134).
        Out-of-range values are NOT clipped here; the bins tokenizer clips."""
        return (np.asarray(x, dtype=np.float32) - self.lo) / self.span

    def unnormalize(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float32) * self.span + self.lo
