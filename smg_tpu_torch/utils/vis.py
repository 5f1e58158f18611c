"""Visualization helpers (port of smg_tpu/utils/vis.py, numpy only).

- `overlay_masks` <- the masks.py:137-161 visualization of the reference
  (mask tint + box outlines), rendered to an array instead of the
  reference's blocking plt.show() (masks.py:164-168).

The JAX module's other helpers (`pcwrite`, `read_ply`, `affordance_grid`,
`color_difference`) have no caller in the port yet.
"""

from __future__ import annotations

import numpy as np


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
