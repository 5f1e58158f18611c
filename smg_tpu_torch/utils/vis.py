"""Visualization and export helpers (port of smg_tpu/utils/vis.py, numpy
only; the outputs are those of the JAX module, byte for byte):

- `pcwrite`          <- the reference's utils.py:85-107 (binary .ply
  point-cloud export), and `read_ply` to read one back;
- `affordance_grid`  <- utils.get_affordance_vis (utils.py:110-136): the
  per-rotation affordance maps tiled into one image, a ring at the argmax
  (an array; no OpenCV colormap);
- `color_difference` <- utils.get_difference (utils.py:139-165): the share
  of key-colour pixels whose nearest key colour is unchanged;
- `overlay_masks`    <- the masks.py:137-161 visualization of the reference
  (mask tint + box outlines), rendered to an array instead of the
  reference's blocking plt.show() (masks.py:164-168).
"""

from __future__ import annotations

import struct

import numpy as np


def pcwrite(xyz_pts: np.ndarray, filename: str,
            rgb_pts: np.ndarray | None = None) -> None:
    """Write an Nx3 point cloud (+ optional Nx3 uint8 colors) to binary .ply.

    Parity: reference utils.py:85-107.
    """
    xyz_pts = np.asarray(xyz_pts, np.float32)
    assert xyz_pts.ndim == 2 and xyz_pts.shape[1] == 3, xyz_pts.shape
    if rgb_pts is None:
        rgb_pts = np.full(xyz_pts.shape, 255, np.uint8)
    rgb_pts = np.asarray(rgb_pts, np.uint8)
    assert rgb_pts.shape == xyz_pts.shape

    with open(filename, "wb") as f:
        f.write(b"ply\n")
        f.write(b"format binary_little_endian 1.0\n")
        f.write(f"element vertex {xyz_pts.shape[0]}\n".encode())
        for prop in ("float x", "float y", "float z"):
            f.write(f"property {prop}\n".encode())
        for prop in ("uchar red", "uchar green", "uchar blue"):
            f.write(f"property {prop}\n".encode())
        f.write(b"end_header\n")
        for p, c in zip(xyz_pts, rgb_pts):
            f.write(struct.pack("<fffBBB", p[0], p[1], p[2],
                                int(c[0]), int(c[1]), int(c[2])))


def read_ply(filename: str):
    """Read back a pcwrite .ply -> (xyz (N, 3), rgb (N, 3))."""
    with open(filename, "rb") as f:
        n = None
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            if line == b"end_header":
                break
        xyz = np.zeros((n, 3), np.float32)
        rgb = np.zeros((n, 3), np.uint8)
        for i in range(n):
            x, y, z, r, g, b = struct.unpack("<fffBBB", f.read(15))
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
    return xyz, rgb


def affordance_grid(
    affordances: np.ndarray,        # (R, H, W) in [0, 1]
    input_images: np.ndarray,       # (R, H, W, 3) in [0, 1]
    best_pix_ind,                   # (rot, row, col)
    cols: int = 4,
) -> np.ndarray:
    """Tile rotation-wise affordance overlays into one (gH, gW, 3) image.

    Parity: utils.get_affordance_vis (utils.py:110-136) — affordance as a
    red-channel heat overlay at 50% opacity, a circle marking the argmax.
    """
    affordances = np.clip(np.asarray(affordances, np.float32), 0.0, 1.0)
    imgs = np.asarray(input_images, np.float32)
    R, H, W = affordances.shape
    rows = max(1, (R + cols - 1) // cols)
    grid = np.zeros((rows * H, cols * W, 3), np.float32)
    br, py, px = int(best_pix_ind[0]), int(best_pix_ind[1]), int(best_pix_ind[2])
    yy, xx = np.mgrid[0:H, 0:W]
    for r in range(R):
        heat = np.stack(
            [affordances[r], 0.2 * affordances[r],
             1.0 - affordances[r]], axis=-1,
        )
        vis = 0.5 * imgs[r] + 0.5 * heat
        if r == br:
            ring = np.abs(np.sqrt((yy - py) ** 2 + (xx - px) ** 2) - 7.0) < 1.5
            vis[ring] = (1.0, 0.0, 0.0)
        gr, gc = divmod(r, cols)
        grid[gr * H:(gr + 1) * H, gc * W:(gc + 1) * W] = vis
    return grid


def color_difference(
    color_heightmap: np.ndarray,
    bg_color_heightmap: np.ndarray,
    color_space: np.ndarray,
) -> float:
    """Fraction of key-color pixels whose nearest key color is unchanged.

    Parity: utils.get_difference (utils.py:139-165) including the black
    sentinel appended to the color space and the index-shift trick that
    prevents black-matching pixels from ever counting as equal.
    """
    cs = np.concatenate(
        [np.asarray(color_space, float), np.zeros((1, 3))], axis=0
    )  # (C+1, 3)
    hm = np.asarray(color_heightmap, float) / 255.0
    bg = np.asarray(bg_color_heightmap, float) / 255.0
    d_hm = np.linalg.norm(hm[None] - cs[:, None, None], axis=3)
    d_bg = np.linalg.norm(bg[None] - cs[:, None, None], axis=3)
    m_hm = np.argmin(d_hm, axis=0)
    m_bg = np.argmin(d_bg, axis=0)
    m_hm[m_hm == cs.shape[0] - 1] = cs.shape[0] + 1
    m_bg[m_bg == cs.shape[0] - 1] = cs.shape[0] + 2
    return float((m_hm == m_bg).sum()) / float((m_bg < cs.shape[0]).sum())


def overlay_masks(
    color_img: np.ndarray,          # (H, W, 3) in [0, 1]
    masks: np.ndarray,              # (N, H, W) bool
    boxes: np.ndarray,              # (N, 2, 2)
    valid: np.ndarray,              # (N,)
) -> np.ndarray:
    """Instance-overlay image: tinted masks + box outlines (to array), one
    fixed random colour per slot."""
    img = np.asarray(color_img, np.float32).copy()
    N = masks.shape[0]
    colors = np.random.RandomState(0).rand(N, 3)
    for i in range(N):
        if not valid[i]:
            continue
        img[masks[i]] = 0.7 * img[masks[i]] + 0.3 * colors[i]
        (x1, y1), (x2, y2) = boxes[i].astype(int)
        x1, x2 = np.clip([x1, x2], 0, img.shape[1] - 1)
        y1, y2 = np.clip([y1, y2], 0, img.shape[0] - 1)
        img[y1:y2 + 1, [x1, x2]] = (0.0, 1.0, 0.0)
        img[[y1, y2], x1:x2 + 1] = (0.0, 1.0, 0.0)
    return img
