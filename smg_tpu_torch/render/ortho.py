"""Orthographic heightmap + instance rasterizer (port of smg_tpu/render/ortho.py).

One vertical ray per pixel against every object primitive, batched over
scenes; a Python loop over the 12 object slots carries the z-buffer.
The strict `height > best_h` z-test keeps the lower slot index on ties
(ortho.py:81).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from smg_tpu_torch.core import rotation as rot
from smg_tpu_torch.physics.state import WORKSPACE, Objects
from smg_tpu_torch.render import raycast

TABLE_COLOR = np.array([0.35, 0.35, 0.38])
RAY_TOP = 0.5


def pixel_grid(resolution: int = 224, device=None):
    """Pixel-center world (x, y) grids, (H, W) each (ortho.py:33-44)."""
    wl = WORKSPACE
    res_x = (wl[0, 1] - wl[0, 0]) / resolution
    res_y = (wl[1, 1] - wl[1, 0]) / resolution
    ar = torch.arange(resolution, device=device)
    xs = wl[0, 0] + (ar + 0.5) * res_x
    ys = wl[1, 0] + (ar + 0.5) * res_y
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return xx, yy


def render_heightmap(obj: Objects, resolution: int = 224):
    """Heightmaps, instance ids and colors of B scenes (ortho.py:47-98).

    Returns depth (B, H, W) f32, ids (B, H, W) int32 (-1 = table) and
    color (B, H, W, 3) f32.
    """
    dev = obj.pos.device
    B, n = obj.pos.shape[:2]
    H = W = resolution
    xx, yy = pixel_grid(resolution, dev)
    origins = torch.stack([xx, yy, torch.full_like(xx, RAY_TOP)],
                          dim=-1).reshape(-1, 3)               # (P, 3)
    P = origins.shape[0]
    d_world = origins.new_tensor([0.0, 0.0, -1.0])
    Rm = rot.quat2rotm(obj.quat)                                # (B, N, 3, 3)
    visible = obj.on_table

    best_h = torch.full((B, P), -math.inf, device=dev)
    best = torch.zeros((B, P), dtype=torch.int32, device=dev)
    for i in range(n):
        R_i = Rm[:, i]                                          # (B, 3, 3)
        o_local = (origins[None] - obj.pos[:, i, None, :]) @ R_i
        d_local = (R_i.transpose(1, 2) @ d_world)[:, None, :]  # (B, 1, 3)
        t = raycast.ray_primitive(
            o_local, d_local.expand_as(o_local),
            obj.shape_type[:, i, None], obj.half_extents[:, i, None, :],
        )                                                       # (B, P)
        height = RAY_TOP - t
        ok = visible[:, i, None] & torch.isfinite(t)
        height = torch.where(ok, height, torch.full_like(height, -math.inf))
        take = height > best_h
        best_h = torch.where(take, height, best_h)
        best = torch.where(take, torch.full_like(best, i), best)

    hit = best_h > 0.0
    depth = torch.where(hit, best_h, torch.zeros_like(best_h)).reshape(B, H, W)
    ids = torch.where(hit, best, torch.full_like(best, -1)).reshape(B, H, W)
    obj_color = torch.gather(
        obj.color, 1, best.long()[..., None].expand(B, P, 3))
    table = torch.as_tensor(TABLE_COLOR, dtype=torch.float32, device=dev)
    color = torch.where(hit[..., None], obj_color, table).reshape(B, H, W, 3)
    return depth, ids.to(torch.int32), color


def instance_masks(ids: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Per-slot boolean masks (..., n_slots, H, W) from an id buffer
    (..., H, W) (ortho.py:101-103)."""
    slots = torch.arange(n_slots, device=ids.device, dtype=ids.dtype)
    return ids[..., None, :, :] == slots[:, None, None]


def upsample2x(img: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an (H, W, ...) image: the 224 -> 448 mask
    frame (ortho.py:106-110; reference utils.py:41, trainer.py:165)."""
    return img.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
