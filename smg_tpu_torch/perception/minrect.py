"""Minimum-area rotated rectangles of instance masks, batched.

Port of smg_tpu/perception/minrect.py: the row/column extreme pixels of
each mask are projected onto 180 rotated axis pairs; the angle of least
bounding area wins (first minimum on ties, like jnp.argmin).
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_ANGLES = 180
_BIG = 1e9


def _angle_table(device):
    """theta, cos, sin (180,) f32. Rounded once from float64 so that they
    are the correctly rounded values of the f32 angles."""
    theta = np.arange(N_ANGLES, dtype=np.float32) * np.float32(
        math.pi / 2.0 / N_ANGLES)
    t64 = theta.astype(np.float64)
    return tuple(
        torch.as_tensor(a.astype(np.float32), device=device)
        for a in (theta, np.cos(t64), np.sin(t64))
    )


def _extreme_points(mask: torch.Tensor):
    """mask (M, H, W) bool -> points (M, 2H + 2W, 2) (x=col, y=row), valid."""
    M, H, W = mask.shape
    dev = mask.device
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    big = torch.tensor(_BIG, device=dev)
    row_any = mask.any(dim=2)
    row_min = torch.where(mask, cols[None, None, :], big).amin(dim=2)
    row_max = torch.where(mask, cols[None, None, :], -big).amax(dim=2)
    col_any = mask.any(dim=1)
    col_min = torch.where(mask, rows[None, :, None], big).amin(dim=1)
    col_max = torch.where(mask, rows[None, :, None], -big).amax(dim=1)
    rr = rows[None].expand(M, H)
    cc = cols[None].expand(M, W)
    pts = torch.cat(
        [
            torch.stack([row_min, rr], dim=2),
            torch.stack([row_max, rr], dim=2),
            torch.stack([cc, col_min], dim=2),
            torch.stack([cc, col_max], dim=2),
        ],
        dim=1,
    )
    valid = torch.cat([row_any, row_any, col_any, col_any], dim=1)
    return pts, valid


def min_area_rects(masks: torch.Tensor):
    """Min-area rotated rects of masks (M, H, W) (minrect.py:58-110).

    Returns corners (M, 4, 2), center (M, 2), size (M, 2), angle (M,).
    Empty masks give zeros.
    """
    pts, valid = _extreme_points(masks)
    x, y = pts[..., 0], pts[..., 1]                        # (M, P)
    theta, c, s = _angle_table(masks.device)
    u = x[..., None] * c + y[..., None] * s                # (M, P, K)
    v = -x[..., None] * s + y[..., None] * c
    vm = valid[..., None]
    umin = torch.where(vm, u, _BIG).amin(dim=1)            # (M, K)
    umax = torch.where(vm, u, -_BIG).amax(dim=1)
    vmin = torch.where(vm, v, _BIG).amin(dim=1)
    vmax = torch.where(vm, v, -_BIG).amax(dim=1)
    area = (umax - umin) * (vmax - vmin)

    k = torch.argmin(area, dim=1)                          # (M,)
    take = lambda t: torch.gather(t, 1, k[:, None])[:, 0]  # noqa: E731
    ck, sk = c[k], s[k]
    u0, u1, v0, v1 = take(umin), take(umax), take(vmin), take(vmax)

    def back(uu, vv):
        return torch.stack([uu * ck - vv * sk, uu * sk + vv * ck], dim=-1)

    corners = torch.stack(
        [back(u0, v0), back(u0, v1), back(u1, v1), back(u1, v0)], dim=1)
    center = back(0.5 * (u0 + u1), 0.5 * (v0 + v1))
    size = torch.stack([v1 - v0, u1 - u0], dim=-1)
    any_valid = valid.any(dim=1)
    corners = torch.where(any_valid[:, None, None], corners,
                          torch.zeros_like(corners))
    center = torch.where(any_valid[:, None], center, torch.zeros_like(center))
    size = torch.where(any_valid[:, None], size, torch.zeros_like(size))
    return corners, center, size, theta[k]
