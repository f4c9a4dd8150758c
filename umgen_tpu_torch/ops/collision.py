"""BEV box collision tests on the device (port of umgen_tpu/ops/collision.py,
the rule-constraint subset).

The same geometry as the JAX package: a collision is a proper crossing of
any pair of edges, or one clockwise rectangle strictly containing the
other's corners; boundary contact does not count.  Fixed-shape tensor ops,
so the bbox decode loop never leaves the device.
"""

from __future__ import annotations

import torch


def bev_corners(centers: torch.Tensor, dims: torch.Tensor,
                angles: torch.Tensor) -> torch.Tensor:
    """centers (..., 2), dims (..., 2) [l, w], yaw (...) → corners
    (..., 4, 2), clockwise from the minimal point."""
    base = torch.tensor([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5],
                         [0.5, -0.5]], dtype=torch.float32,
                        device=centers.device)
    corners = base * dims[..., None, :]
    c, s = torch.cos(angles), torch.sin(angles)
    rot = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)],
                      -2)
    corners = torch.einsum("...kj,...ji->...ki", corners, rot)
    return corners + centers[..., None, :]


def _orient(a, b, c):
    return ((c[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0])
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def pairwise_collision(corners_a: torch.Tensor,
                       corners_b: torch.Tensor) -> torch.Tensor:
    """corners_a (..., N, 4, 2) vs corners_b (..., K, 4, 2) → bool
    (..., N, K)."""
    a1 = torch.roll(corners_a, -1, dims=-2)
    b1 = torch.roll(corners_b, -1, dims=-2)
    A = corners_a[..., :, None, :, None, :]
    Bn = a1[..., :, None, :, None, :]
    C = corners_b[..., None, :, None, :, :]
    D = b1[..., None, :, None, :, :]
    acd = _orient(A, D, C) > 0
    bcd = _orient(Bn, D, C) > 0
    abc = _orient(A, Bn, C) > 0
    abd = _orient(A, Bn, D) > 0
    cross_any = ((acd != bcd) & (abc != abd)).any(-1).any(-1)

    def contains(big, big_next, pts):
        vec = -(big - big_next)
        dx = big[..., :, None, 0] - pts[..., None, :, 0]
        dy = big[..., :, None, 1] - pts[..., None, :, 1]
        crs = vec[..., :, None, 1] * dx - vec[..., :, None, 0] * dy
        return (crs < 0).all(-1).all(-1)

    a_in = contains(corners_a[..., :, None, :, :], a1[..., :, None, :, :],
                    corners_b[..., None, :, :, :])
    b_in = contains(corners_b[..., None, :, :, :], b1[..., None, :, :, :],
                    corners_a[..., :, None, :, :])
    return cross_any | a_in | b_in


def boxes_to_corners(bbox: torch.Tensor, negate_yaw: bool) -> torch.Tensor:
    """bbox (..., 10) x y z l w h yaw vx vy vz → BEV corners (..., 4, 2)."""
    yaw = -bbox[..., 6] if negate_yaw else bbox[..., 6]
    return bev_corners(bbox[..., 0:2], bbox[..., 3:5], yaw)


def candidate_collides(candidate: torch.Tensor, buffer: torch.Tensor,
                       buffer_valid: torch.Tensor) -> torch.Tensor:
    """Does `candidate` (B, 10) collide with any valid box of `buffer`
    (B, N, 10)?  Boxes with x >= 63 (decoded <pad> rows) are ignored on
    both sides.  → bool (B,)."""
    cand_ok = candidate[..., 0] < 63.0
    buf_ok = buffer_valid & (buffer[..., 0] < 63.0)
    cc = boxes_to_corners(candidate, negate_yaw=True)       # (B, 4, 2)
    bc = boxes_to_corners(buffer, negate_yaw=True)          # (B, N, 4, 2)
    col = pairwise_collision(bc, cc[:, None])[..., 0]       # (B, N)
    return (col & buf_ok).any(-1) & cand_ok
