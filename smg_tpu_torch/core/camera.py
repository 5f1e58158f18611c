"""Camera constants and the posed pinhole camera (port of parts of
smg_tpu/core/camera.py).

- reference constants (reference code/robot.py:86-103, utils.py:41-57):
  the hardcoded intrinsics, the sensor's depth range and frame size, the
  heightmap geometry and the workspace ROI;
- `Camera` with `overhead()` and `reference_overhead()` (camera.py:59-125),
  the camera that `render/persp.py::render_rgbd` renders through;
- the perspective parity path (camera.py:128-242): `get_pointcloud`,
  `transform_points`, `get_heightmap` (RGB-D frame -> the 224 and 448
  heightmaps through the fixed workspace homographies, core/homography.py),
  `global_position` and `heightmap_pixel_to_world`. They take one frame
  or a batch of them (leading dims) on the frame's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from smg_tpu_torch.core import homography as hg
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
COLORMASK_SIZE = 448
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


def get_pointcloud(depth_img: torch.Tensor, intrinsics) -> torch.Tensor:
    """Back-project depth (..., H, W) into camera-frame points (..., H*W, 3)
    in image order (reference utils.py:12-35; colors stay aligned by that
    order)."""
    K = torch.as_tensor(intrinsics, dtype=depth_img.dtype, device=depth_img.device)
    im_h, im_w = depth_img.shape[-2:]
    pix_y, pix_x = torch.meshgrid(
        torch.arange(im_h, dtype=depth_img.dtype, device=depth_img.device),
        torch.arange(im_w, dtype=depth_img.dtype, device=depth_img.device),
        indexing="ij")
    x = (pix_x - K[0, 2]) * depth_img / K[0, 0]
    y = (pix_y - K[1, 2]) * depth_img / K[1, 1]
    return torch.stack([x, y, depth_img], dim=-1).flatten(-3, -2)


def transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """A rigid transform (4, 4) applied to points (..., 3)."""
    return pts @ pose[:3, :3].T + pose[:3, 3]


def _roi_homographies(device):
    """A_hm (ROI -> 224), A_mask (ROI -> 448) and A_htor (224 -> ROI)."""
    src = torch.as_tensor(ROI_SRC, device=device)
    s = float(HEIGHTMAP_SIZE)
    dst_hm = torch.tensor([[0.0, 0.0], [0.0, s], [s, s], [s, 0.0]], device=device)
    dst_mask = dst_hm * (COLORMASK_SIZE / HEIGHTMAP_SIZE)
    return (hg.fit_homography(src, dst_hm), hg.fit_homography(src, dst_mask),
            hg.fit_homography(dst_hm, src))


def get_heightmap(color_img: torch.Tensor, depth_img: torch.Tensor, cam_intrinsics,
                  cam_pose):
    """RGB-D frame(s) (..., H, W, 3), (..., H, W) -> (color_hm 224, depth_hm
    224, color_448, depth_448, A_htor) (reference utils.py:38-68).

    The depth heightmap holds world-frame z (height above the table),
    warped by the fixed workspace homography with bilinear sampling
    (cv2.warpPerspective's default INTER_LINEAR, utils.py:62-65); A_htor
    maps heightmap pixels back to frame pixels for `global_position`.
    """
    dev = depth_img.device
    pose = torch.as_tensor(cam_pose, dtype=torch.float32, device=dev)
    pts = transform_points(pose, get_pointcloud(depth_img, cam_intrinsics))
    world_z = pts[..., 2].reshape(depth_img.shape)
    A_hm, A_mask, A_htor = _roi_homographies(dev)
    hm = (HEIGHTMAP_SIZE, HEIGHTMAP_SIZE)
    mask = (COLORMASK_SIZE, COLORMASK_SIZE)
    # A single depth frame is one gray image; a batch gets a channel dim.
    z = world_z if world_z.dim() == 2 else world_z[..., None]
    unz = (lambda t: t) if world_z.dim() == 2 else (lambda t: t[..., 0])
    return (hg.warp_perspective(color_img, A_hm, hm),
            unz(hg.warp_perspective(z, A_hm, hm)),
            hg.warp_perspective(color_img, A_mask, mask),
            unz(hg.warp_perspective(z, A_mask, mask)),
            A_htor)


def global_position(pix_mask_position, A_htor: torch.Tensor, cam_intrinsics, cam_pose,
                    depth_img: torch.Tensor) -> torch.Tensor:
    """Heightmap pixel (rot, row, col) -> robot-frame position (3,) of one
    frame (reference utils.py:70-81): A_htor maps the 224-frame pixel to
    the source image, truncated to int as the reference does, the depth
    there is back-projected through the camera pose."""
    dev = depth_img.device
    K = torch.as_tensor(cam_intrinsics, dtype=torch.float32, device=dev)
    pose = torch.as_tensor(cam_pose, dtype=torch.float32, device=dev)
    pix = torch.as_tensor(pix_mask_position, device=dev)
    col = pix[2].to(A_htor.dtype)
    row = pix[1].to(A_htor.dtype)
    denom = col * A_htor[2, 0] + row * A_htor[2, 1] + A_htor[2, 2]
    px = (col * A_htor[0, 0] + row * A_htor[0, 1] + A_htor[0, 2]) / denom
    py = (col * A_htor[1, 0] + row * A_htor[1, 1] + A_htor[1, 2]) / denom
    pxi = px.to(torch.int32)
    pyi = py.to(torch.int32)
    z = depth_img[pyi.long(), pxi.long()]
    x = (pxi - K[0, 2]) * z / K[0, 0]
    y = (pyi - K[1, 2]) * z / K[1, 1]
    return pose[:3, :3] @ torch.stack([x, y, z]) + pose[:3, 3]


def heightmap_pixel_to_world(row, col, workspace_limits=None,
                             resolution: float = HEIGHTMAP_RESOLUTION):
    """Heightmap pixel -> world (x, y) on the workspace grid: the linear
    map of the orthographic rasterizer's layout (row indexes y, col x)."""
    wl = WORKSPACE_LIMITS if workspace_limits is None else workspace_limits
    x = float(wl[0][0]) + (torch.as_tensor(col, dtype=torch.float32) + 0.5) * resolution
    y = float(wl[1][0]) + (torch.as_tensor(row, dtype=torch.float32) + 0.5) * resolution
    return x, y
