"""Frame-to-frame SE(2) box transforms and auxiliary encodings.

Rebuild of ref:plugin/data/transforms/token_transform.py and the
`ego_transform` helper in common.py:197-243: re-express agent boxes from
frame t's ego coordinates in frame t+1's, used when `box_transform=True`
(off in the shipped eval config but part of the model surface,
ref:UMGen.py:35-38, 739-750).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def se2_matrix(dx: float, dy: float, dtheta: float) -> np.ndarray:
    """Homogeneous transform of frame t+1's origin seen from frame t."""
    c, s = np.cos(dtheta), np.sin(dtheta)
    return np.array([
        [c, -s, 0.0, dx],
        [s, c, 0.0, dy],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ])


def transform_boxes_to_next_frame(boxes: np.ndarray,
                                  pose_diff: np.ndarray) -> np.ndarray:
    """Express (N, >=7) metric boxes of frame t in frame t+1's ego coords.

    pose_diff: (3,) ego motion (dx, dy, dtheta) from frame t to t+1.
    Positions rotate/translate by the inverse motion; yaw decreases by
    dtheta; velocities rotate (size unchanged).
    """
    boxes = np.asarray(boxes, dtype=np.float32)
    if boxes.size == 0:
        return boxes
    out = boxes.copy()
    dx, dy, dth = [float(v) for v in pose_diff]
    inv = np.linalg.inv(se2_matrix(dx, dy, dth))
    pts = np.concatenate([boxes[:, 0:3],
                          np.ones((len(boxes), 1))], axis=1)
    out[:, 0:3] = (inv @ pts.T).T[:, :3]
    out[:, 6] = boxes[:, 6] - dth
    if boxes.shape[1] >= 9:
        c, s = np.cos(-dth), np.sin(-dth)
        vx, vy = boxes[:, 7].copy(), boxes[:, 8].copy()
        out[:, 7] = c * vx - s * vy
        out[:, 8] = s * vx + c * vy
    return out


def generate_radius_mask(positions: np.ndarray, radius: float
                         ) -> np.ndarray:
    """(N, 2) positions → (N, N) bool mask of pairs within `radius`
    (ref:token_transform.py generate_radius_mask; used by the optional
    local-attention variant)."""
    d = np.linalg.norm(positions[:, None, :] - positions[None, :, :],
                       axis=-1)
    return d <= radius


def fourier_encode(x: np.ndarray, n_bands: int = 6,
                   max_freq: float = 10.0) -> np.ndarray:
    """Fourier feature encoding (ref:token_transform.py FourierEncoding):
    (..., d) → (..., d * (2*n_bands + 1))."""
    x = np.asarray(x, dtype=np.float32)
    freqs = np.linspace(1.0, max_freq / 2.0, n_bands, dtype=np.float32)
    ang = x[..., None] * freqs * np.pi         # (..., d, n_bands)
    enc = np.concatenate([np.sin(ang), np.cos(ang), x[..., None]], axis=-1)
    return enc.reshape(*x.shape[:-1], -1)
