"""Quaternion and rotation math on batched tensors.

Port of smg_tpu/core/rotation.py (the parts the act step uses). JAX vmaps
the per-matrix functions; here every function takes leading batch axes.
Quaternions are (w, x, y, z), unit-norm, Hamilton convention.
"""

from __future__ import annotations

import math

import torch


def angle_axis2rotm(angle: torch.Tensor, axis) -> torch.Tensor:
    """Rodrigues rotation: angle (...,), fixed axis (3,) -> (..., 3, 3).

    Same arithmetic as rotation.py:62-76: cos I + (1 - cos) a a^T + sin K.
    """
    axis = torch.as_tensor(axis, dtype=angle.dtype, device=angle.device)
    axis = axis / (torch.linalg.norm(axis) + 1e-12)
    sina, cosa = torch.sin(angle), torch.cos(angle)
    zero = torch.zeros((), dtype=angle.dtype, device=angle.device)
    K = torch.stack([
        torch.stack([zero, -axis[2], axis[1]]),
        torch.stack([axis[2], zero, -axis[0]]),
        torch.stack([-axis[1], axis[0], zero]),
    ])
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    outer = axis[:, None] * axis[None, :]
    c = cosa[..., None, None]
    return c * eye + (1.0 - c) * outer + sina[..., None, None] * K


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2; shapes (..., 4)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """axis (..., 3), angle (...,) -> quaternion (..., 4)."""
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-12)
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    half = 0.5 * yaw
    zeros = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)


def quat2rotm(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def rotm2quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4), w >= 0.

    Shepperd's method (rotation.py:166-206): the four candidate
    reconstructions are computed and the one of the dominant squared
    magnitude is selected (first max on ties, like jnp.argmax).
    """
    r = lambda i, j: R[..., i, j]  # noqa: E731
    t = r(0, 0) + r(1, 1) + r(2, 2)
    qw2 = torch.clamp(1.0 + t, min=0.0) / 4.0
    qx2 = torch.clamp(1.0 + r(0, 0) - r(1, 1) - r(2, 2), min=0.0) / 4.0
    qy2 = torch.clamp(1.0 - r(0, 0) + r(1, 1) - r(2, 2), min=0.0) / 4.0
    qz2 = torch.clamp(1.0 - r(0, 0) - r(1, 1) + r(2, 2), min=0.0) / 4.0
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    w, x, y, z = (torch.sqrt(m) for m in (qw2, qx2, qy2, qz2))
    cands = torch.stack([
        torch.stack([w, (r(2, 1) - r(1, 2)) / (4 * w),
                     (r(0, 2) - r(2, 0)) / (4 * w),
                     (r(1, 0) - r(0, 1)) / (4 * w)], -1),
        torch.stack([(r(2, 1) - r(1, 2)) / (4 * x), x,
                     (r(0, 1) + r(1, 0)) / (4 * x),
                     (r(0, 2) + r(2, 0)) / (4 * x)], -1),
        torch.stack([(r(0, 2) - r(2, 0)) / (4 * y),
                     (r(0, 1) + r(1, 0)) / (4 * y), y,
                     (r(1, 2) + r(2, 1)) / (4 * y)], -1),
        torch.stack([(r(1, 0) - r(0, 1)) / (4 * z),
                     (r(0, 2) + r(2, 0)) / (4 * z),
                     (r(1, 2) + r(2, 1)) / (4 * z), z], -1),
    ], dim=-2)                                        # (..., 4 cand, 4)
    k = torch.argmax(mags, dim=-1)
    q = torch.gather(
        cands, -2, k[..., None, None].expand(*k.shape, 1, 4)
    ).squeeze(-2)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """First-order exponential-map update, renormalised (rotation.py:209-221)."""
    angle = torch.linalg.norm(omega, dim=-1, keepdim=True)
    half = 0.5 * angle * dt
    k = 0.5 * dt * torch.sinc(half / math.pi)
    dq = torch.cat([torch.cos(half), omega * k], dim=-1)
    out = quat_mul(dq, q)
    return out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-12)
