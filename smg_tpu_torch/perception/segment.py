"""Exact instance segmentation from the renderer's id buffer.

Port of smg_tpu/perception/segment.py on B scenes at once: masks,
visibility gate, min-area rects, AABBs and int-truncated centers
(segment.py:74-76).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from smg_tpu_torch.perception import minrect
from smg_tpu_torch.physics.state import Objects, _Batched

MIN_VISIBLE_PIXELS = 16


@dataclass
class Segmentation(_Batched):
    masks: torch.Tensor        # (B, N, H, W) bool
    valid: torch.Tensor        # (B, N) bool
    number: torch.Tensor       # (B,) int32
    boxes: torch.Tensor        # (B, N, 2, 2)
    centers: torch.Tensor      # (B, N, 2)
    box_corners: torch.Tensor  # (B, N, 4, 2)
    rect_sizes: torch.Tensor   # (B, N, 2)
    rect_angles: torch.Tensor  # (B, N)


def segment(obj: Objects, ids: torch.Tensor) -> Segmentation:
    """Segmentation of B scenes from ids (B, H, W) int32."""
    B, H, W = ids.shape
    n = obj.pos.shape[1]
    dev = ids.device
    masks = ids[:, None] == torch.arange(n, device=dev)[None, :, None, None]
    pix = masks.sum(dim=(2, 3))
    valid = obj.on_table & (pix >= MIN_VISIBLE_PIXELS)

    corners, _, sizes, angles = minrect.min_area_rects(masks.reshape(B * n, H, W))
    corners = corners.reshape(B, n, 4, 2)
    sizes = sizes.reshape(B, n, 2)
    angles = angles.reshape(B, n)

    cols = torch.arange(W, dtype=torch.float32, device=dev)
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    big = torch.tensor(1e9, device=dev)
    x1 = torch.where(masks, cols, big).amin(dim=(2, 3))
    x2 = torch.where(masks, cols, -big).amax(dim=(2, 3))
    y1 = torch.where(masks, rows[:, None], big).amin(dim=(2, 3))
    y2 = torch.where(masks, rows[:, None], -big).amax(dim=(2, 3))
    boxes = torch.stack(
        [torch.stack([x1, y1], -1), torch.stack([x2, y2], -1)], dim=2)
    v2 = valid[..., None]
    boxes = torch.where(v2[..., None], boxes, torch.zeros_like(boxes))
    centers = torch.where(v2, corners.mean(dim=2), torch.zeros_like(corners[:, :, 0]))
    centers = centers.to(torch.int32).to(torch.float32)
    return Segmentation(
        masks=masks & valid[..., None, None],
        valid=valid,
        number=valid.sum(dim=1).to(torch.int32),
        boxes=boxes,
        centers=centers,
        box_corners=torch.where(v2[..., None], corners, torch.zeros_like(corners)),
        rect_sizes=torch.where(v2, sizes, torch.zeros_like(sizes)),
        rect_angles=torch.where(valid, angles, torch.zeros_like(angles)),
    )
