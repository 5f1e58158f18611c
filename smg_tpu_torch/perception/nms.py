"""Greedy IoU non-maximum suppression over fixed slots, batched over
scenes (port of smg_tpu/perception/nms.py).

The reference's py_cpu_nms (reference code/NMS.py:8-59) has quirks that
the learned-detection path keeps exactly:
  * candidates are visited in slot index order after the area gate, not
    in score order (the score sort is commented out, NMS.py:25);
  * the area gate uses the raw (x2 - x1)(y2 - y1) with strict > / <, while
    IoU uses +1-inclusive pixel areas.

Boxes are (B, N, 2, 2) [(x1, y1), (x2, y2)]; the greedy pass is one loop
over the N slots, each step updating all B scenes.
"""

from __future__ import annotations

import torch


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (B, N, N) of (B, N, 2, 2) corner boxes, with the
    reference's +1-inclusive areas (NMS.py:23,35-38)."""
    x1, y1 = boxes[..., 0, 0], boxes[..., 0, 1]
    x2, y2 = boxes[..., 1, 0], boxes[..., 1, 1]
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = torch.clamp(xx2 - xx1 + 1.0, min=0.0)
    h = torch.clamp(yy2 - yy1 + 1.0, min=0.0)
    inter = w * h
    return inter / (areas[..., :, None] + areas[..., None, :] - inter)


def nms(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float = 0.40,
        min_area: float | None = None, max_area: float | None = None) -> torch.Tensor:
    """Greedy NMS keep mask (B, N) bool.

    boxes (B, N, 2, 2); valid (B, N), the candidates (standing in for the
    score threshold the reference applied upstream, masks.py:40);
    iou_thresh 0.40 at masks.py:73; min_area / max_area the area gate
    (None skips a side). Slot i is kept when it is still alive on its
    turn; it then suppresses every later candidate with IoU > iou_thresh.
    """
    n = boxes.shape[-3]
    x1, y1 = boxes[..., 0, 0], boxes[..., 0, 1]
    x2, y2 = boxes[..., 1, 0], boxes[..., 1, 1]
    raw_area = (x2 - x1) * (y2 - y1)
    alive = valid.clone()
    if min_area is not None:
        alive &= raw_area > min_area
    if max_area is not None:
        alive &= raw_area < max_area
    iou = iou_matrix(boxes)
    keep = torch.zeros_like(alive)
    for i in range(n):
        take = alive[..., i].clone()
        keep[..., i] = take
        alive &= ~(take[..., None] & (iou[..., i, :] > iou_thresh))
        alive[..., i] = False
    return keep
