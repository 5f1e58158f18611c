"""Tendon-drive model of the SMG's enveloping fingers.

Port of smg_tpu/core/tendon.py. The forward map `opening_distance` is the
uniform-curvature formula; the inverse `pre_rotate_angle` is the same
fixed-iteration Newton solve (12 steps from theta_s - pi/100), with the
derivative written out in closed form where JAX used jax.grad.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SMGParams:
    """Geometry of the soft multimodal gripper (tendon.py:28-49)."""

    torspring_angle: float = float(np.deg2rad(110.0))
    H: float = (47.0 + 6.0 + 55.0) / 1000.0
    D: float = 116.0 / 1000.0
    finger_length: float = 118.0 / 1000.0
    finger_width: float = 28.77 / 1000.0
    finger_depth: float = 18.29 / 1000.0
    sucker_height: float = 10.0 / 1000.0
    num_fingers: int = 4
    segments_per_finger: int = 4

    @property
    def D0(self) -> float:
        return self.D - self.finger_depth

    @property
    def max_close_angle(self) -> float:
        return float(np.pi / 2.5)


DEFAULT = SMGParams()


def opening_distance(rotate_angle: torch.Tensor, p: SMGParams = DEFAULT) -> torch.Tensor:
    """Fingertip opening d [m] for a tendon curl [rad] (tendon.py:55-72)."""
    rot = rotate_angle
    a0 = p.torspring_angle - math.pi / 2.0
    x = p.torspring_angle - rot
    small = torch.abs(rot) < 1e-6
    safe_rot = torch.where(small, torch.ones_like(rot), rot)
    ratio = (math.cos(a0) - torch.sin(x)) / safe_rot
    ratio = torch.where(small, torch.full_like(rot, math.cos(p.torspring_angle)),
                        ratio)
    return p.D0 - 2.0 * p.finger_length * ratio


def _opening_derivative(rot: torch.Tensor, p: SMGParams) -> torch.Tensor:
    """d opening / d rot: -2L (cos(x) rot - (cos a0 - sin x)) / rot^2,
    x = theta_s - rot; zero in the |rot| < 1e-6 branch (constant there)."""
    a0 = p.torspring_angle - math.pi / 2.0
    x = p.torspring_angle - rot
    small = torch.abs(rot) < 1e-6
    safe_rot = torch.where(small, torch.ones_like(rot), rot)
    num = torch.cos(x) * safe_rot - (math.cos(a0) - torch.sin(x))
    d = -2.0 * p.finger_length * num / (safe_rot * safe_rot)
    return torch.where(small, torch.zeros_like(rot), d)


def max_opening(p: SMGParams = DEFAULT) -> float:
    return p.D0 + 2.0 * p.finger_length * float(
        np.sin(p.torspring_angle - np.pi / 2.0)
    )


def pre_rotate_angle(
    distance: torch.Tensor, p: SMGParams = DEFAULT, newton_iters: int = 12
) -> torch.Tensor:
    """Tendon curl [rad] that sets the fingertip opening to `distance`.

    tendon.py:82-110: sqrt(2) diagonal factor, 0.03 m floor, 0 when the
    fingers are already open enough.
    """
    d_target = torch.clamp(distance * math.sqrt(2.0), min=0.03)
    no_close = d_target >= max_opening(p)
    rot = torch.full_like(d_target, p.torspring_angle - math.pi / 100.0)
    for _ in range(newton_iters):
        fr = opening_distance(rot, p) - d_target
        dfr = _opening_derivative(rot, p)
        step = fr / torch.where(torch.abs(dfr) < 1e-9,
                                torch.full_like(dfr, 1e-9), dfr)
        rot = torch.clamp(rot - step, 1e-4, p.torspring_angle - 1e-3)
    return torch.where(no_close, torch.zeros_like(rot), rot)


def finger_joint_angles(rotate_angle: torch.Tensor, p: SMGParams = DEFAULT) -> torch.Tensor:
    """Per-joint bend (..., segments) for a total curl (...,): the joints of
    a finger move in lockstep, rotate_angle / segments each (tendon.py:113-121;
    reference robot.py:253-280)."""
    rot = torch.as_tensor(rotate_angle)
    return (rot / p.segments_per_finger)[..., None].repeat_interleave(
        p.segments_per_finger, dim=-1)


def finger_chain_points(rotate_angle: torch.Tensor, p: SMGParams = DEFAULT):
    """In-plane finger polyline (tendon.py:124-150): (r, z), each (..., 5)."""
    rot = rotate_angle
    nseg = p.segments_per_finger
    seg_len = p.finger_length / nseg
    a0 = p.torspring_angle - math.pi / 2.0
    i = torch.arange(1, nseg + 1, device=rot.device)
    seg_angle = a0 - (i * rot[..., None] / nseg)
    dr = seg_len * torch.sin(seg_angle)
    dz = seg_len * torch.cos(seg_angle)
    r0 = torch.full(rot.shape + (1,), p.D0 / 2.0, dtype=rot.dtype,
                    device=rot.device)
    z0 = torch.zeros_like(r0)
    r = torch.cat([r0, r0 + torch.cumsum(dr, dim=-1)], dim=-1)
    z = torch.cat([z0, z0 + torch.cumsum(dz, dim=-1)], dim=-1)
    return r, z
