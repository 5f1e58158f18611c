"""Rotation math on batched tensors: Euler angles, rotation matrices,
axis-angle, quaternions.

Port of smg_tpu/core/rotation.py, itself the reference's NumPy helpers
(reference code/utils.py:169-302) plus the quaternion algebra of the
stepper. JAX vmaps the per-matrix functions; here every function takes
leading batch axes, and the device follows the inputs. Quaternions are
(w, x, y, z), unit-norm, Hamilton convention, rotating column vectors by
R(q) @ v.
"""

from __future__ import annotations

import math

import torch


def euler2rotm(theta: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrices (..., 3, 3), R = Rz(c) @
    Ry(b) @ Rx(a) (rotation.py:23-38; reference code/utils.py:169-183)."""
    a, b, c = theta.unbind(-1)
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    r = torch.stack(
        [
            cc * cb, cc * sb * sa - sc * ca, cc * sb * ca + sc * sa,
            sc * cb, sc * sb * sa + cc * ca, sc * sb * ca - cc * sa,
            -sb, cb * sa, cb * ca,
        ],
        dim=-1,
    )
    return r.reshape(*theta.shape[:-1], 3, 3)


def rotm2euler(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> Euler angles (..., 3), the inverse
    of euler2rotm with the reference's singular branch taken elementwise
    (rotation.py:41-54; reference code/utils.py:196-212)."""
    sy = torch.sqrt(R[..., 0, 0] * R[..., 0, 0] + R[..., 1, 0] * R[..., 1, 0])
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                    torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


def is_rotm(R: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Whether each R (..., 3, 3) is a rotation matrix: ||R^T R - I|| < tol
    (rotation.py:224-227; reference code/utils.py:187-192)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return torch.linalg.norm(R.transpose(-1, -2) @ R - eye, dim=(-2, -1)) < tol


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


def rotm2angle_axis(R: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotation matrices (..., 3, 3) -> (angle (...,), axis (..., 3)), read
    from the quaternion form, which is stable at 0 and pi; +z where the
    angle is 0 (rotation.py:79-94; reference code/utils.py:239-302)."""
    q = rotm2quat(R)
    v = torch.linalg.norm(q[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(v, q[..., 0])
    axis = q[..., 1:] / (v[..., None] + 1e-12)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return angle, torch.where(angle[..., None] < 1e-8, z, axis)


def quat_identity(device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The identity rotation (1, 0, 0, 0)."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


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


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4):
    v + 2w (u x v) + 2 u x (u x v) (rotation.py:123-129)."""
    w, u = q[..., :1], q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q."""
    return quat_rotate(quat_conj(q), v)


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
