"""Action-aware map alignment: affine warp of BEV map features (port of
umgen_tpu/ops/warp.py).

torch's affine_grid + grid_sample (align_corners=False, zero padding) is
the reference recipe; this module evaluates the same bilinear taps with the
JAX package's arithmetic order (float32 coordinates, four masked taps
summed in order), so the warped map agrees with the JAX package value for
value rather than to a tolerance.  It is plain tensor code, not a kernel.
"""

from __future__ import annotations

import torch


def _bilinear_sample_zeros(feat: torch.Tensor, fx: torch.Tensor,
                           fy: torch.Tensor) -> torch.Tensor:
    """feat [N, H, W, C] sampled at pixel coords fx/fy [N, H, W]; taps
    outside the grid contribute zero."""
    N, H, W, C = feat.shape
    rows = feat.reshape(N * H * W, C)
    base = (torch.arange(N, device=feat.device) * (H * W))[:, None, None]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx1 = fx - x0
    wy1 = fy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def tap(xi, yi, w):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(xi, 0, W - 1).long()
        yc = torch.clamp(yi, 0, H - 1).long()
        # a row lookup, whose backward (the trainer's scatter-add into the
        # map features) is deterministic on both devices
        g = torch.nn.functional.embedding(base + yc * W + xc, rows)
        return g * (w * inb.to(w.dtype))[..., None]

    return (tap(x0, y0, wx0 * wy0) + tap(x0 + 1, y0, wx1 * wy0)
            + tap(x0, y0 + 1, wx0 * wy1) + tap(x0 + 1, y0 + 1, wx1 * wy1))


def affine_grid_sample(feat: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """affine_grid + grid_sample, channels-last: feat [N, H, W, C], mat
    [N, 2, 3] mapping output normalized coords to source coords."""
    N, H, W, C = feat.shape
    dev = feat.device
    u = (2.0 * torch.arange(W, device=dev, dtype=torch.float32) + 1.0) / W \
        - 1.0
    v = (2.0 * torch.arange(H, device=dev, dtype=torch.float32) + 1.0) / H \
        - 1.0
    uu = u[None, :].expand(H, W)
    vv = v[:, None].expand(H, W)
    m = mat.float()
    xs = (m[:, 0, 0, None, None] * uu + m[:, 0, 1, None, None] * vv
          + m[:, 0, 2, None, None])
    ys = (m[:, 1, 0, None, None] * uu + m[:, 1, 1, None, None] * vv
          + m[:, 1, 2, None, None])
    fx = ((xs + 1.0) * W - 1.0) / 2.0
    fy = ((ys + 1.0) * H - 1.0) / 2.0
    return _bilinear_sample_zeros(feat.float(), fx, fy).to(feat.dtype)


def build_affine_matrices(pose_diff: torch.Tensor, hw: int,
                          res: float = 4.0) -> torch.Tensor:
    """Ego motion [N, 3] (dx, dy, dθ metric) → affine matrices [N, 2, 3]:
    rotation by -θ, row-0 translation -dy_n, row-1 -dx_n with
    d*_n = 2·(d*/res)/hw."""
    theta = pose_diff[:, 2]
    dxn = 2.0 * (pose_diff[:, 0] / res) / hw
    dyn = 2.0 * (pose_diff[:, 1] / res) / hw
    c = torch.cos(-theta)
    s = torch.sin(-theta)
    row0 = torch.stack([c, -s, -dyn], dim=-1)
    row1 = torch.stack([s, c, -dxn], dim=-1)
    return torch.stack([row0, row1], dim=1)


def affine_warp_map(map_feat: torch.Tensor, pose_diff: torch.Tensor,
                    res: float = 4.0) -> torch.Tensor:
    """map_feat [B, T, S, C] (S = H·W row-major, H == W), pose_diff
    [B, T, 3] → warped features of the same shape and dtype."""
    B, T, S, C = map_feat.shape
    H = W = int(round(S ** 0.5))
    feat = map_feat.reshape(B * T, H, W, C)
    mat = build_affine_matrices(pose_diff.reshape(B * T, 3), H, res)
    return affine_grid_sample(feat, mat).reshape(B, T, S, C)
