"""BEV box collision tests (port of umgen_tpu/ops/collision.py).

The same geometry as the JAX package: a collision is a proper crossing of
any pair of edges, or one clockwise rectangle strictly containing the
other's corners; boundary contact does not count.  Two halves:

  * the rule constraint, fixed-shape tensor ops on the device, so the bbox
    decode loop never leaves it (`candidate_collides`);
  * the host-side metrics, numpy (`collision_matrix`, `BoxOverlap` — the
    collision rate — `box_iou_3d` and `generate_collision_attribute`,
    ref:misc.py:314-736).  The JAX package's optional C++ helper for the
    matrix (umgen_tpu/native/) is not ported yet (ROADMAP.md: 'VQ
    detokenizers, videos and metrics'); the numpy path gives the same
    matrix.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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
    # bf16 boxes (a checkpoint's decode tables are cast to its dtype)
    # promote to float32 here, as jnp.einsum promotes them
    corners = torch.einsum("...kj,...ji->...ki", corners,
                           rot.to(corners.dtype))
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


# ---------------------------------------------------------------------------
# host-side metrics (numpy)
# ---------------------------------------------------------------------------
def _bev_corners_np(centers, dims, angles):
    """`bev_corners` in numpy, float32."""
    base = np.asarray([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]],
                      dtype=np.float32)
    corners = base * dims[..., None, :]
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
    corners = np.einsum("...kj,...ji->...ki", corners, rot)
    return corners + centers[..., None, :]


def _pairwise_collision_np(corners_a, corners_b):
    """`pairwise_collision` in numpy: (N, 4, 2) vs (K, 4, 2) → bool
    (N, K)."""
    a1 = np.roll(corners_a, -1, axis=-2)
    b1 = np.roll(corners_b, -1, axis=-2)
    A = corners_a[:, None, :, None, :]
    Bn = a1[:, None, :, None, :]
    C = corners_b[None, :, None, :, :]
    D = b1[None, :, None, :, :]
    acd = _orient(A, D, C) > 0
    bcd = _orient(Bn, D, C) > 0
    abc = _orient(A, Bn, C) > 0
    abd = _orient(A, Bn, D) > 0
    cross_any = np.any((acd != bcd) & (abc != abd), axis=(-1, -2))

    def contains(big, big_next, pts):
        vec = -(big - big_next)
        dx = big[..., :, None, 0] - pts[..., None, :, 0]
        dy = big[..., :, None, 1] - pts[..., None, :, 1]
        crs = vec[..., :, None, 1] * dx - vec[..., :, None, 0] * dy
        return np.all(crs < 0, axis=(-1, -2))

    a_in = contains(corners_a[:, None], a1[:, None], corners_b[None])
    b_in = contains(corners_b[None, :], b1[None, :], corners_a[:, None])
    return cross_any | a_in | b_in


def collision_matrix(boxes: np.ndarray) -> np.ndarray:
    """(N, 10) metric boxes → (N, N) bool collision matrix (numpy)."""
    return collision_matrix_np(np.asarray(boxes, dtype=np.float32))


def collision_matrix_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 10) metric boxes → (N, N) bool collision matrix (yaw as-is,
    matching compute_overlap_count, ref:misc.py:643-695)."""
    if len(boxes) == 0:
        return np.zeros((0, 0), dtype=bool)
    corners = _bev_corners_np(boxes[:, 0:2].astype(np.float32),
                              boxes[:, 3:5].astype(np.float32),
                              boxes[:, 6].astype(np.float32))
    mat = _pairwise_collision_np(corners, corners)
    np.fill_diagonal(mat, False)
    return mat


def box_vertices(centers: np.ndarray, whl: np.ndarray,
                 yaw: np.ndarray) -> np.ndarray:
    """(N, 3) centers, (N, 3) l/w/h, (N,) yaw → (N, 8, 3) box corners,
    bottom face first, counter-clockwise in BEV (ref:misc.py:76-125;
    callers pass the negated yaw, ref:misc.py:388)."""
    l2, w2, h2 = (whl[:, 0] / 2, whl[:, 1] / 2, whl[:, 2] / 2)
    sx = np.array([-1, 1, 1, -1, -1, 1, 1, -1], np.float32)
    sy = np.array([-1, -1, 1, 1, -1, -1, 1, 1], np.float32)
    sz = np.array([-1, -1, -1, -1, 1, 1, 1, 1], np.float32)
    corners = np.stack([sx[None] * l2[:, None], sy[None] * w2[:, None],
                        sz[None] * h2[:, None]], axis=-1)  # (N, 8, 3)
    c, s = np.cos(yaw), np.sin(yaw)
    # corners @ [[c, -s, 0], [s, c, 0], [0, 0, 1]] per box (ref row-vector
    # convention: einsum("ijk,ikl->ijl", corners, R))
    x = corners[..., 0] * c[:, None] + corners[..., 1] * s[:, None]
    y = -corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    out = np.stack([x, y, corners[..., 2]], axis=-1)
    return out + centers[:, None, :]


def _convex_poly_area(poly: np.ndarray) -> float:
    """Shoelace area of an (M, 2) polygon (any winding)."""
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_poly_halfplane(poly: np.ndarray, a: np.ndarray,
                         b: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: keep the part of `poly` left of edge a→b."""
    if len(poly) == 0:
        return poly
    d = (b[0] - a[0]) * (poly[:, 1] - a[1]) \
        - (b[1] - a[1]) * (poly[:, 0] - a[0])
    out = []
    n = len(poly)
    for i in range(n):
        j = (i + 1) % n
        if d[i] >= 0:
            out.append(poly[i])
            if d[j] < 0:
                t = d[i] / (d[i] - d[j])
                out.append(poly[i] + t * (poly[j] - poly[i]))
        elif d[j] >= 0:
            t = d[i] / (d[i] - d[j])
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out, np.float64).reshape(-1, 2)


def _ccw(poly: np.ndarray) -> np.ndarray:
    x, y = poly[:, 0], poly[:, 1]
    if np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)) < 0:
        return poly[::-1]
    return poly


def box_iou_3d(verts1: np.ndarray, verts2: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 8, 3) × (M, 8, 3) box vertices → (intersection volume, 3D IoU),
    both (N, M).

    Stand-in for the reference's pytorch3d ``box3d_overlap``
    wrapper (ref:misc.py:128-140): boxes are upright (yaw-only rotation), so
    the exact 3D intersection is (BEV convex-polygon intersection area) ×
    (z-extent overlap).  Host-side metric path; N ≤ 61 keeps the pairwise
    Sutherland–Hodgman clip cheap.
    """
    verts1 = np.asarray(verts1, np.float64)
    verts2 = np.asarray(verts2, np.float64)
    n, m = len(verts1), len(verts2)
    inter = np.zeros((n, m))
    polys1 = [_ccw(v[:4, :2]) for v in verts1]
    polys2 = [_ccw(v[:4, :2]) for v in verts2]
    z1 = verts1[:, :, 2].min(1), verts1[:, :, 2].max(1)
    z2 = verts2[:, :, 2].min(1), verts2[:, :, 2].max(1)
    areas1 = np.array([_convex_poly_area(p) for p in polys1])
    areas2 = np.array([_convex_poly_area(p) for p in polys2])
    vol1 = areas1 * (z1[1] - z1[0])
    vol2 = areas2 * (z2[1] - z2[0])
    for i in range(n):
        for j in range(m):
            dz = min(z1[1][i], z2[1][j]) - max(z1[0][i], z2[0][j])
            if dz <= 0:
                continue
            poly = polys1[i]
            clip = polys2[j]
            for k in range(4):
                poly = _clip_poly_halfplane(poly, clip[k],
                                            clip[(k + 1) % 4])
                if len(poly) == 0:
                    break
            inter[i, j] = _convex_poly_area(poly) * dz
    union = vol1[:, None] + vol2[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    return inter, iou


def generate_collision_attribute(frames, time_steps: int = 20,
                                 sampling_gap: int = 1,
                                 speed_scale: float = 1.0,
                                 stop_speed: float = 0.05,
                                 box_scale: float = 1.0,
                                 mode: str = "2d",
                                 iou_threshold: int = 0):
    """Per-agent time-to-first-collision under constant-velocity rollout.

    Training-data prep equivalent of ref:misc.py:314-472 ("2d" mode): for
    each frame's boxes, extrapolate positions along (vx, vy) for
    `time_steps` steps and record the first step at which each box collides
    with another; `time_steps` means "never".  Stopped-vs-stopped and
    tiny-box collisions are forgiven (ref:misc.py:440-455).

    ``mode="3d"`` uses the IoU-based test instead (ref:misc.py:380-417):
    height clamped to 1, z set to 1, collision iff the count of partners
    with IoU > 0 exceeds ``iou_threshold``; no stopped/tiny forgiveness.

    frames: sequence of (N_t, 10) metric boxes → list of (N_t,) int arrays.
    """
    out = []
    for boxes in frames:
        boxes = np.asarray(boxes, dtype=np.float32).reshape(-1, 10)
        n = len(boxes)
        first = np.full(n, time_steps, np.int32)
        if n == 0:
            out.append(first)
            continue
        vx, vy = boxes[:, 7].copy(), boxes[:, 8].copy()
        stopped = (np.abs(vx) <= stop_speed) & (vy <= stop_speed)
        small = (boxes[:, 3] * box_scale <= 1) & (boxes[:, 4]
                                                  * box_scale <= 1)
        vx[np.abs(vx) <= stop_speed] = 0
        vy[np.abs(vy) <= stop_speed] = 0
        for t in range(1, time_steps + 1):
            b = boxes.copy()
            b[:, 0] = boxes[:, 0] + vx * t * sampling_gap * speed_scale
            b[:, 1] = boxes[:, 1] + vy * t * sampling_gap * speed_scale
            if mode == "3d":
                centers = np.stack([b[:, 0], b[:, 1],
                                    np.ones(n, np.float32)], axis=1)
                whl = boxes[:, 3:6].copy() * box_scale
                whl[:, 2] = 1.0
                verts = box_vertices(centers, whl, -boxes[:, 6])
                _, iou = box_iou_3d(verts, verts)
                np.fill_diagonal(iou, 0.0)
                hit = (iou > 0).sum(axis=1) > iou_threshold
            else:
                b[:, 3:5] *= box_scale
                b[:, 6] = -boxes[:, 6]   # the prep negates yaw (ref:429)
                mat = collision_matrix(b)
                hit = mat.any(axis=1)
                # forgive stopped-vs-stopped-only and tiny-box collisions
                for i in np.where(hit)[0]:
                    partners = np.where(mat[i])[0]
                    if stopped[i] and np.all(stopped[partners]):
                        hit[i] = False
                    elif small[i] and np.any(small[partners]):
                        hit[i] = False
            newly = hit & (first == time_steps)
            first[newly] = t - 1
        out.append(first)
    return out


class BoxOverlap:
    """Collision-rate metric (ref:misc.py:561-736)."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale
        self.ratio_all = []
        self.ratio_scenario_all = []

    def reset(self):
        self.ratio_all, self.ratio_scenario_all = [], []

    def update(self, frames):
        """frames: sequence of (N_t, 10) metric box arrays."""
        total_n, total_c = 0, 0
        for boxes in frames:
            boxes = np.asarray(boxes, dtype=np.float32)
            if boxes.size == 0:
                self.ratio_all.append(0.0)
                continue
            boxes = boxes.reshape(-1, boxes.shape[-1])
            scaled = boxes.copy()
            scaled[:, 3:5] *= self.scale
            mat = collision_matrix(scaled)
            ncol = int((mat.any(axis=1)).sum())
            self.ratio_all.append(ncol / len(boxes))
            total_n += len(boxes)
            total_c += ncol
        if total_n:
            self.ratio_scenario_all.append(total_c / total_n)

    def average(self):
        r = float(np.mean(self.ratio_all)) if self.ratio_all else 0.0
        rs = (float(np.mean(self.ratio_scenario_all))
              if self.ratio_scenario_all else 0.0)
        return r, rs
