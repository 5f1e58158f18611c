"""Camera constants and the posed pinhole camera (port of parts of
smg_tpu/core/camera.py).

- reference constants (reference code/robot.py:86-103, utils.py:41-57):
  the hardcoded intrinsics, the sensor's depth range and frame size, the
  heightmap geometry and the workspace ROI;
- `Camera` with `overhead()` and `reference_overhead()` (camera.py:59-125),
  the camera that `render/persp.py::render_rgbd` renders through.

The perspective pipeline (`get_pointcloud`, `get_heightmap`,
`global_position`, `heightmap_pixel_to_world`) waits for ROADMAP.md
section 1, item 5.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from smg_tpu_torch.core import rotation as rot

# Hardcoded intrinsics, reference code/robot.py:99.
DEFAULT_INTRINSICS = np.array(
    [[618.62, 0.0, 320.0], [0.0, 618.62, 240.0], [0.0, 0.0, 1.0]],
    dtype=np.float32,
)
# Vision-sensor depth range, reference code/robot.py:237-239.
Z_NEAR, Z_FAR = 0.01, 10.0
IMAGE_H, IMAGE_W = 480, 640

# Heightmap geometry, reference code/utils.py:41-57.
HEIGHTMAP_SIZE = 224
# The four source-image corners of the workspace ROI (sim values).
ROI_SRC = np.array(
    [[110.0, 0.0], [110.0, 400.0], [510.0, 400.0], [510.0, 0.0]],
    dtype=np.float32,
)

# Workspace limits, reference code/main.py:31.
WORKSPACE_LIMITS = np.array(
    [[-0.724, -0.276], [-0.224, 0.224], [-0.0001, 0.4]], dtype=np.float32
)
HEIGHTMAP_RESOLUTION = 0.002  # m / px, reference main.py:433


def _down_pose(x: float, y: float, height: float) -> torch.Tensor:
    """Camera-to-robot pose looking straight down from (x, y, height):
    camera x -> robot -x, y -> robot +y, z -> robot -z, a 180 degree
    rotation about the robot y axis (float32, as JAX computes it)."""
    R = rot.angle_axis2rotm(torch.tensor(math.pi), [0.0, 1.0, 0.0])
    pose = torch.eye(4)
    pose[:3, :3] = R
    pose[:3, 3] = torch.tensor([x, y, height])
    return pose


@dataclass(frozen=True)
class Camera:
    """A posed pinhole camera. `pose` maps camera frame -> robot frame."""

    intrinsics: torch.Tensor  # (3, 3)
    pose: torch.Tensor        # (4, 4)

    @staticmethod
    def overhead(
        height: float = 0.5,
        center_xy: tuple[float, float] = (-0.5, 0.0),
    ) -> "Camera":
        """A straight-down camera over the workspace center: the stand-in
        for the scene's `Vision_sensor_persp` (reference robot.py:89-98)."""
        return Camera(intrinsics=torch.as_tensor(DEFAULT_INTRINSICS),
                      pose=_down_pose(center_xy[0], center_xy[1], height))

    @staticmethod
    def reference_overhead() -> "Camera":
        """The overhead camera whose fliplr'd image maps the workspace
        exactly onto ROI_SRC.

        The reference reads its camera pose from the sim scene
        (robot.py:86-103) and flips the raw frames (robot.py:226,234); its
        hardcoded ROI corners (utils.py:49-50) therefore pin the pose: the
        workspace x-span [-0.724, -0.276] lands at post-flip columns
        [110, 510] and the y-span at rows [0, 400]. Solving the pinhole
        model gives height fx * 0.448 / 400 = 0.6929 m and a center offset
        of (+0.0101, +0.0448) from the workspace center.
        """
        fx = float(DEFAULT_INTRINSICS[0, 0])
        cx = float(DEFAULT_INTRINSICS[0, 2])
        cy = float(DEFAULT_INTRINSICS[1, 2])
        x_min, x_max = (float(WORKSPACE_LIMITS[0, 0]),
                        float(WORKSPACE_LIMITS[0, 1]))
        y_min = float(WORKSPACE_LIMITS[1, 0])
        # Post-flip columns u = (W - 1) - px; ROI_SRC x corners 110 / 510.
        u0, u1 = float(ROI_SRC[0, 0]), float(ROI_SRC[2, 0])
        v0 = float(ROI_SRC[0, 1])
        px0 = (IMAGE_W - 1) - u0          # pre-flip column of x_min
        px1 = (IMAGE_W - 1) - u1          # pre-flip column of x_max
        height = fx * (x_max - x_min) / (px0 - px1)
        x0 = x_min + (px0 - cx) * height / fx
        y0 = y_min + (cy - v0) * height / fx
        return Camera(intrinsics=torch.as_tensor(DEFAULT_INTRINSICS),
                      pose=_down_pose(x0, y0, height))
