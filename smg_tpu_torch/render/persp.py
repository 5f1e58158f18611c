"""Perspective RGB-D raycaster: the CoppeliaSim vision sensor's frame
(port of smg_tpu/render/persp.py).

Renders the 640 x 480 RGB-D frame that the reference's `get_camera_data`
returned over RPC (reference code/robot.py:218-241, zNear/zFar =
0.01/10) from one scene's objects, through render/raycast.py.
"""

from __future__ import annotations

import torch

from smg_tpu_torch.core import camera as cam
from smg_tpu_torch.core import rotation as rot
from smg_tpu_torch.physics.state import Objects
from smg_tpu_torch.render import raycast
from smg_tpu_torch.render.ortho import TABLE_COLOR


def render_rgbd(
    obj: Objects,
    camera: cam.Camera,
    height: int = cam.IMAGE_H,
    width: int = cam.IMAGE_W,
):
    """Render (color (H, W, 3), depth (H, W)) of one scene's objects
    (fields (N, ...)) through a pinhole camera, on the objects' device.

    Depth is the camera-frame z of the nearest surface (what the
    reference's depth buffer holds after the zNear/zFar rescale);
    background rays return the table-plane depth.
    """
    dev = obj.pos.device
    K = camera.intrinsics.to(dev)
    pose = camera.pose.to(dev)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    # Camera-frame ray directions with z = 1, so t is camera-frame depth.
    dirs_cam = torch.stack(
        [(px - cx) / fx, (py - cy) / fy, torch.ones_like(px)], dim=-1
    ).reshape(-1, 3)                                           # (P, 3)
    Rcw = pose[:3, :3]
    origin_w = pose[:3, 3]
    dirs_w = dirs_cam @ Rcw.T                                  # (P, 3)

    Rm = rot.quat2rotm(obj.quat)                               # (N, 3, 3)
    o_local = (torch.einsum("nji,j->ni", Rm, origin_w)
               - torch.einsum("nji,nj->ni", Rm, obj.pos))[:, None, :]
    d_local = torch.einsum("nji,pj->npi", Rm, dirs_w)          # (N, P, 3)

    t = raycast.ray_primitive(
        o_local.expand_as(d_local), d_local,
        obj.shape_type[:, None], obj.half_extents[:, None, :],
    )                                                          # (N, P)
    t = torch.where(obj.on_table[:, None], t, torch.full_like(t, raycast.INF))

    # Table plane z = 0: origin_z + t * dz = 0.
    t_table = raycast._safe_div(-origin_w[2], dirs_w[:, 2])
    t_table = torch.where(t_table >= 0.0, t_table,
                          torch.full_like(t_table, raycast.INF))

    t_obj, best = torch.min(t, dim=0)
    t_near = torch.minimum(t_obj, t_table)
    obj_hit = (t_obj <= t_table) & torch.isfinite(t_obj)

    depth = torch.where(torch.isfinite(t_near), t_near,
                        torch.full_like(t_near, 10.0))
    table = torch.as_tensor(TABLE_COLOR, dtype=torch.float32, device=dev)
    color = torch.where(obj_hit[:, None], obj.color[best], table)
    return color.reshape(height, width, 3), depth.reshape(height, width)


def render_reference_rgbd(obj: Objects, camera: cam.Camera | None = None):
    """The frames the reference's `get_camera_data` returns: render through
    the ROI-consistent camera and fliplr both buffers (reference
    robot.py:218-241 flips the sim sensor's images; utils.py:49-50's ROI
    corners are calibrated on the flipped frames)."""
    if camera is None:
        camera = cam.Camera.reference_overhead()
    color, depth = render_rgbd(obj, camera)
    return color.flip(1), depth.flip(1), camera
