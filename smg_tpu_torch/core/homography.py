"""Planar homographies: the DLT fit from 4 point pairs and dense warps
(port of smg_tpu/core/homography.py).

The reference builds its heightmaps by fitting a perspective transform
from four image corners to the 224 x 224 / 448 x 448 frames and warping
(reference code/utils.py:49-66, cv2.getPerspectiveTransform +
cv2.warpPerspective). Here the fit is an 8 x 8 linear solve in float32
and the warp a gather with nearest or bilinear sampling, on the image's
device, over any leading batch dimensions.
"""

from __future__ import annotations

import torch


def fit_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """H (3, 3) with dst ~ H @ src for 4 point pairs (4, 2) of (x, y):
    the DLT with h22 = 1 (cv2.getPerspectiveTransform, utils.py:58-59,66)."""
    src = torch.as_tensor(src, dtype=torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device)
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    A_top = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=1)
    A_bot = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=1)
    A = torch.cat([A_top, A_bot], dim=0)                        # (8, 8)
    h = torch.linalg.solve(A, torch.cat([u, v]))
    return torch.cat([h, ones[:1]]).reshape(3, 3)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """H (3, 3) applied to points (..., 2) -> (..., 2)."""
    x, y = pts[..., 0], pts[..., 1]
    denom = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    u = (H[0, 0] * x + H[0, 1] * y + H[0, 2]) / denom
    v = (H[1, 0] * x + H[1, 1] * y + H[1, 2]) / denom
    return torch.stack([u, v], dim=-1)


def warp_perspective(img: torch.Tensor, H: torch.Tensor, out_shape: tuple[int, int],
                     mode: str = "bilinear") -> torch.Tensor:
    """Warp img (..., H_in, W_in, C), any leading dims, or one gray image
    (H_in, W_in), by H into (..., out_h, out_w, C) or (out_h, out_w).

    cv2.warpPerspective semantics: destination pixel (u, v) samples the
    source at H^-1 (u, v); samples outside the source are 0. Nearest
    rounds half to even (torch.round, as jnp.round).
    """
    out_h, out_w = out_shape
    dev = img.device
    Hinv = torch.linalg.inv(H.to(device=dev, dtype=torch.float32))
    vv, uu = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev),
                            indexing="ij")
    src_xy = apply_homography(Hinv, torch.stack([uu, vv], dim=-1))   # (oh, ow, 2)
    sx, sy = src_xy[..., 0], src_xy[..., 1]

    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    lead = x.shape[:-3]
    in_h, in_w, C = x.shape[-3:]
    imgf = x.reshape((-1, in_h, in_w, C)).float()

    def sample(ix, iy):
        return imgf[:, iy.clamp(0, in_h - 1), ix.clamp(0, in_w - 1)]

    if mode == "nearest":
        ix = torch.round(sx).to(torch.int64)
        iy = torch.round(sy).to(torch.int64)
        out = sample(ix, iy)
        valid = (ix >= 0) & (ix < in_w) & (iy >= 0) & (iy < in_h)
    else:
        x0 = torch.floor(sx).to(torch.int64)
        y0 = torch.floor(sy).to(torch.int64)
        fx = (sx - x0)[..., None]
        fy = (sy - y0)[..., None]
        out = (sample(x0, y0) * (1 - fx) * (1 - fy)
               + sample(x0 + 1, y0) * fx * (1 - fy)
               + sample(x0, y0 + 1) * (1 - fx) * fy
               + sample(x0 + 1, y0 + 1) * fx * fy)
        valid = (sx >= 0) & (sx <= in_w - 1) & (sy >= 0) & (sy <= in_h - 1)

    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    out = out.reshape(lead + (out_h, out_w, C))
    if squeeze:
        out = out[..., 0]
    return out.to(img.dtype) if img.is_floating_point() else out
