"""Quantitative generation metrics.

* ``MMDMetric`` — Gaussian-kernel maximum mean discrepancy between generated
  and reference attribute distributions (ref:plugin/misc/misc.py:484-558);
  the paper's agent-realism metric.  Accumulates per-scenario scores.
* ``scene_attribute_views`` — split decoded boxes into the attribute groups
  the reference evaluates: posi / whl / yaw / speed / cat
  (ref:UMGen_config_evaluation.py:57-61, misc.py:13-73).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

ATTRIBUTE_SLICES = {
    "posi": slice(0, 3),
    "whl": slice(3, 6),
    "yaw": slice(6, 7),
    "speed": slice(7, 10),
}


def scene_attribute_views(boxes: np.ndarray,
                          cat_ids: np.ndarray) -> Dict[str, np.ndarray]:
    """(N, 10) metric boxes + (N,) category ids → attribute views."""
    views = {k: np.asarray(boxes[:, s], dtype=np.float64)
             for k, s in ATTRIBUTE_SLICES.items()}
    views["cat"] = np.asarray(cat_ids, dtype=np.float64).reshape(-1, 1)
    return views


def gaussian_kernel_sum(x: np.ndarray, y: np.ndarray, kernel_mul: float,
                        kernel_num: int) -> np.ndarray:
    """Multi-bandwidth RBF kernel matrix over the concatenated samples
    (ref:misc.py:507-535; bandwidth = mean pairwise sq-distance heuristic)."""
    total = np.concatenate([x, y], axis=0)
    d2 = ((total[:, None, :] - total[None, :, :]) ** 2).sum(-1)
    bandwidth = d2.sum() / (len(x) * len(y))
    bandwidth /= kernel_mul ** (kernel_num // 2)
    ks = [np.exp(-d2 / (bandwidth * kernel_mul ** i + 1e-12))
          for i in range(kernel_num)]
    return sum(ks)


def mmd_score(source: np.ndarray, target: np.ndarray,
              kernel_mul: float = 1.0, kernel_num: int = 1) -> float:
    """Unbiased-ish MMD^2 estimate (ref:misc.py:537-556)."""
    n, m = len(source), len(target)
    if n == 0 or m == 0:
        return 0.0
    K = gaussian_kernel_sum(source, target, kernel_mul, kernel_num)
    xx = K[:n, :n].mean()
    yy = K[n:, n:].mean()
    xy = K[:n, n:].mean()
    yx = K[n:, :n].mean()
    return float(xx + yy - xy - yx)


class MMDMetric:
    """Accumulates per-scenario MMD over selected attribute groups."""

    def __init__(self, attributes: Sequence[str] = ("posi", "whl", "yaw",
                                                    "speed", "cat"),
                 kernel_mul: float = 1.0, kernel_num: int = 1):
        self.attributes = tuple(attributes)
        self.kernel_mul = kernel_mul
        self.kernel_num = kernel_num
        self.scores: Dict[str, List[float]] = {a: [] for a in self.attributes}

    def reset(self):
        self.scores = {a: [] for a in self.attributes}

    def update(self, pred_boxes: np.ndarray, pred_cats: np.ndarray,
               real_boxes: np.ndarray, real_cats: np.ndarray):
        pv = scene_attribute_views(pred_boxes.reshape(-1, 10),
                                   pred_cats.reshape(-1))
        rv = scene_attribute_views(real_boxes.reshape(-1, 10),
                                   real_cats.reshape(-1))
        for a in self.attributes:
            self.scores[a].append(mmd_score(rv[a], pv[a], self.kernel_mul,
                                            self.kernel_num))

    def average(self) -> Dict[str, float]:
        return {a: float(np.mean(s)) if s else 0.0
                for a, s in self.scores.items()}
