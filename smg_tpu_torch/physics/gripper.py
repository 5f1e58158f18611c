"""Kinematic SMG gripper: FK of the four tendon-coupled fingers + pads.

Port of smg_tpu/physics/gripper.py on batched grippers (leading B).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from smg_tpu_torch.core import tendon
from smg_tpu_torch.physics.state import Gripper

P = tendon.DEFAULT

SPHERES_PER_FINGER = 2 * tendon.DEFAULT.segments_per_finger + 1
N_FINGERS = 4
PALM_SPHERES = 1
N_GRIPPER_SPHERES = PALM_SPHERES + N_FINGERS * SPHERES_PER_FINGER  # 37

FINGER_RADIUS = 0.0095
PALM_RADIUS = P.D0 / 2.0
PALM_DROP = 0.02
PAD_OFFSET = P.sucker_height

FINGER_AZIMUTHS = np.arange(N_FINGERS) * (np.pi / 2.0)


def _azimuths(device):
    a = torch.as_tensor(FINGER_AZIMUTHS, dtype=torch.float32, device=device)
    return torch.cos(a), torch.sin(a)


def collider_radii(device) -> torch.Tensor:
    """(G,) collider radii: the palm, then 36 finger spheres."""
    r = torch.full((N_GRIPPER_SPHERES,), FINGER_RADIUS, dtype=torch.float32,
                   device=device)
    r[0] = PALM_RADIUS
    return r


def _to_world(g: Gripper, local: torch.Tensor) -> torch.Tensor:
    """local (B, n, 3) tool-frame points -> world (B, n, 3)."""
    R = g.tool_rotm()
    return g.pos[:, None, :] + local @ R.transpose(1, 2)


def collider_spheres(g: Gripper):
    """World-frame collider spheres (gripper.py:51-84): centers (B, G, 3),
    radii (G,), G = N_GRIPPER_SPHERES. The per-scene path's form (the
    tool rotation as a matrix product); collider_spheres_soa is the
    batched stepper's."""
    r_j, z_j = tendon.finger_chain_points(g.curl)                  # (B, 5)
    r_chain = torch.cat([r_j, 0.5 * (r_j[:, :-1] + r_j[:, 1:])], dim=1)
    z_chain = torch.cat([z_j, 0.5 * (z_j[:, :-1] + z_j[:, 1:])], dim=1)
    ca, sa = _azimuths(g.pos.device)
    fx = ca[None, :, None] * r_chain[:, None, :]                   # (B, 4, 9)
    fy = sa[None, :, None] * r_chain[:, None, :]
    fz = (-PALM_DROP - z_chain[:, None, :]).expand_as(fx)
    B = fx.shape[0]
    fingers = torch.stack([fx, fy, fz], dim=-1).reshape(B, -1, 3)
    local = torch.cat([torch.zeros_like(fingers[:, :1]), fingers], dim=1)
    return _to_world(g, local), collider_radii(g.pos.device)


def fingertip_positions(g: Gripper) -> torch.Tensor:
    """(B, 4, 3) world fingertip positions (gripper.py:87-98)."""
    r_chain, z_chain = tendon.finger_chain_points(g.curl)
    r_tip, z_tip = r_chain[:, -1:], z_chain[:, -1:]
    ca, sa = _azimuths(g.pos.device)
    local = torch.stack(
        [ca[None] * r_tip, sa[None] * r_tip,
         (-PALM_DROP - z_tip).expand(-1, N_FINGERS)], dim=-1
    )
    return _to_world(g, local)


def pad_tip_positions(g: Gripper) -> torch.Tensor:
    """(B, 4, 3) world suction-pad tip positions (gripper.py:101-124)."""
    r_chain, z_chain = tendon.finger_chain_points(g.curl)
    r_tip, z_tip = r_chain[:, -1:], z_chain[:, -1:]
    dr = r_chain[:, -1:] - r_chain[:, -2:-1]
    dz = z_chain[:, -1:] - z_chain[:, -2:-1]
    seg_norm = torch.sqrt(dr * dr + dz * dz) + 1e-9
    ur, uz = dr / seg_norm, dz / seg_norm
    ca, sa = _azimuths(g.pos.device)
    tip_r = r_tip + PAD_OFFSET * ur
    tip_z = z_tip + PAD_OFFSET * uz
    local = torch.stack(
        [ca[None] * tip_r, sa[None] * tip_r,
         (torch.full_like(tip_z, -PALM_DROP) - tip_z).expand(-1, N_FINGERS)],
        dim=-1,
    )
    return _to_world(g, local)


def grasp_tip_position(g: Gripper) -> torch.Tensor:
    """(B, 3) center of the fingertip circle (gripper.py:127-134)."""
    return fingertip_positions(g).mean(dim=1)


def cage_radius(curl: torch.Tensor) -> torch.Tensor:
    r_chain, _ = tendon.finger_chain_points(curl)
    return r_chain[..., -1]


def cage_depth(curl: torch.Tensor) -> torch.Tensor:
    _, z_chain = tendon.finger_chain_points(curl)
    return PALM_DROP + z_chain[..., -1]


def _quadrant(angle: torch.Tensor):
    a = torch.remainder(angle, 2 * math.pi)
    q = torch.full(a.shape, 4, dtype=torch.int64, device=a.device)
    for k, lim in reversed(list(enumerate(
            [math.pi / 4, 3 * math.pi / 4, 5 * math.pi / 4, 7 * math.pi / 4]))):
        q = torch.where(a < lim, torch.full_like(q, k), q)
    return a, q


def suction_pad_for_yaw(angle: torch.Tensor) -> torch.Tensor:
    """Pad index by approach-yaw quadrant (gripper.py:149-162)."""
    _, q = _quadrant(angle)
    return torch.where(q == 4, torch.zeros_like(q), q).to(torch.int32)


def tool_angle_for_suction(angle: torch.Tensor) -> torch.Tensor:
    """Tool z-rotation for the selected pad (gripper.py:165-173)."""
    a, q = _quadrant(angle)
    offsets = torch.tensor(
        [0.0, math.pi / 2, math.pi, 3 * math.pi / 2, 2 * math.pi],
        dtype=a.dtype, device=a.device,
    )
    return a - offsets[q]


def tool_angle_for_grasp(rotation_angle: torch.Tensor) -> torch.Tensor:
    return torch.where(
        rotation_angle <= math.pi / 2,
        rotation_angle - math.pi / 4,
        rotation_angle - 3 * math.pi / 4,
    )


def collider_spheres_soa(pos_b, yaw_b, tilt_b, curl_b):
    """Batched SoA collider spheres, scenes minor (gripper.py:190-244).

    Args: pos_b (B, 3), yaw_b (B,), tilt_b (B, 2), curl_b (B,).
    Returns (gx, gy, gz) each (G, B) and radii (G,).
    """
    B = yaw_b.shape[0]
    dev = pos_b.device
    r_j, z_j = tendon.finger_chain_points(curl_b)          # (B, 5)
    r_mid = 0.5 * (r_j[:, :-1] + r_j[:, 1:])
    z_mid = 0.5 * (z_j[:, :-1] + z_j[:, 1:])
    r_chain = torch.cat([r_j, r_mid], dim=1).T             # (9, B)
    z_chain = torch.cat([z_j, z_mid], dim=1).T

    ca, sa = _azimuths(dev)
    fx = (ca[:, None, None] * r_chain[None]).reshape(-1, B)   # (36, B)
    fy = (sa[:, None, None] * r_chain[None]).reshape(-1, B)
    fz = (-PALM_DROP - z_chain[None]).expand(N_FINGERS, -1, -1).reshape(-1, B)

    zero = torch.zeros(1, B, dtype=pos_b.dtype, device=dev)
    lx = torch.cat([zero, fx])
    ly = torch.cat([zero, fy])
    lz = torch.cat([zero, fz])

    cy_, sy_ = torch.cos(yaw_b), torch.sin(yaw_b)
    cx_, sx_ = torch.cos(tilt_b[:, 0]), torch.sin(tilt_b[:, 0])
    cb_, sb_ = torch.cos(tilt_b[:, 1]), torch.sin(tilt_b[:, 1])
    r00 = cy_ * cb_ - sy_ * sx_ * sb_
    r01 = -sy_ * cx_
    r02 = cy_ * sb_ + sy_ * sx_ * cb_
    r10 = sy_ * cb_ + cy_ * sx_ * sb_
    r11 = cy_ * cx_
    r12 = sy_ * sb_ - cy_ * sx_ * cb_
    r20 = -cx_ * sb_
    r21 = sx_
    r22 = cx_ * cb_

    gx = pos_b[:, 0][None] + r00[None] * lx + r01[None] * ly + r02[None] * lz
    gy = pos_b[:, 1][None] + r10[None] * lx + r11[None] * ly + r12[None] * lz
    gz = pos_b[:, 2][None] + r20[None] * lx + r21[None] * ly + r22[None] * lz
    return gx, gy, gz, collider_radii(dev)
