"""Dense branchless contact model: penalty normal forces + smooth Coulomb
(port of smg_tpu/physics/contact.py), batched over scenes (leading B).

Contacts are compliant spring-dampers between sphere compounds: object
sphere vs table plane, object sphere vs object sphere (same object
masked), gripper sphere vs object sphere (the gripper is kinematic).
Friction is smooth Coulomb, F_t = -mu |F_n| tanh(|v_t| / v_eps) v_hat.

This is the per-scene formulation that `stepper.physics_step` runs: every
pair term of a scene as dense (B, S, T) tensors summed over T here, with
no K1 and no scene-minor transpose. The batched stepper
(stepper.physics_step_batched, K1) is held to it.

- `table_forces`, `object_object_forces`, `gripper_object_forces`: the
  class-by-class reference semantics (contact.py:93-212);
- `fused_contact_forces`: all three classes in one flat sweep, S = N*K
  object spheres as rows, T = S + G sources as columns (contact.py:230-329).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from smg_tpu_torch.core import rotation as rot
from smg_tpu_torch.physics.state import Objects


@dataclass(frozen=True)
class ContactParams:
    """Soft-contact gains, tuned for explicit stability at dt = 1 ms
    (contact.py:29-52)."""

    kn: float = 800.0         # normal stiffness per contact [N/m]
    zeta: float = 0.6         # damping ratio
    mu: float = 0.8           # Coulomb friction coefficient
    v_eps: float = 0.01       # friction smoothing velocity [m/s]
    mu_gripper: float = 0.6   # gripper-object friction
    table_z: float = 0.0
    contact_share: float = 4.0  # expected simultaneous contacts per object
    max_pen: float = 0.006      # [m] penetration depth cap for the spring
    max_vn: float = 0.5         # [m/s] normal-velocity cap for the damper


DEFAULT_PARAMS = ContactParams()


def world_spheres(obj: Objects):
    """Compound spheres in the world frame (state.py:96-109): centers
    (B, N, K, 3), radii (B, N, K), velocities (B, N, K, 3)."""
    R = rot.quat2rotm(obj.quat)                                     # (B, N, 3, 3)
    centers = obj.pos[:, :, None, :] + torch.einsum("bnij,bnkj->bnki", R,
                                                    obj.sph_offsets)
    arm = centers - obj.pos[:, :, None, :]
    vels = obj.vel[:, :, None, :] + torch.linalg.cross(
        obj.omega[:, :, None, :].expand_as(arm), arm, dim=-1)
    return centers, obj.sph_radii, vels


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x, dim=-1)


def _pair_forces(p_a, v_a, r_a, p_b, v_b, r_b, mass_eff, prm: ContactParams):
    """Penalty force ON a FROM b for broadcast sphere sets (contact.py:58-90):
    (..., 3) positions and velocities, (...) radii and masses -> (..., 3)."""
    d = p_a - p_b
    dist = _norm(d)
    pen = (r_a + r_b) - dist
    n = d / (dist + 1e-9)[..., None]
    vrel = v_a - v_b
    vn = torch.clamp((vrel * n).sum(dim=-1), -prm.max_vn, prm.max_vn)
    cn = 2.0 * prm.zeta * torch.sqrt(prm.kn * mass_eff / prm.contact_share)
    fn_mag = torch.clamp(prm.kn * torch.clamp(pen, max=prm.max_pen) - cn * vn, min=0.0)
    fn_mag = torch.where(pen > 0.0, fn_mag, torch.zeros_like(fn_mag))
    f_n = fn_mag[..., None] * n
    vt = vrel - vn[..., None] * n
    vt_mag = _norm(vt)
    ft_mag = prm.mu * fn_mag * torch.tanh(vt_mag / prm.v_eps)
    f_t = -ft_mag[..., None] * vt / (vt_mag + 1e-9)[..., None]
    return f_n + f_t


def table_forces(obj: Objects, prm: ContactParams = DEFAULT_PARAMS):
    """Ground-plane contacts of every compound sphere: (force, torque),
    each (B, N, 3) about each object's COM."""
    centers, radii, vels = world_spheres(obj)
    pen = radii - (centers[..., 2] - prm.table_z)
    vn = torch.clamp(vels[..., 2], -prm.max_vn, prm.max_vn)
    cn = 2.0 * prm.zeta * torch.sqrt(prm.kn * obj.mass[..., None] / prm.contact_share)
    fn = torch.clamp(prm.kn * torch.clamp(pen, max=prm.max_pen) - cn * vn, min=0.0)
    fn = torch.where(pen > 0.0, fn, torch.zeros_like(fn))
    vt = torch.cat([vels[..., :2], torch.zeros_like(vels[..., 2:])], dim=-1)
    vt_mag = _norm(vt)
    ft = prm.mu * fn * torch.tanh(vt_mag / prm.v_eps)
    f = torch.stack([-ft * vt[..., 0] / (vt_mag + 1e-9),
                     -ft * vt[..., 1] / (vt_mag + 1e-9), fn], dim=-1)   # (B, N, K, 3)
    arm = centers - obj.pos[:, :, None, :]
    torque = torch.linalg.cross(arm, f, dim=-1)
    return f.sum(dim=2), torque.sum(dim=2)


def object_object_forces(obj: Objects, prm: ContactParams = DEFAULT_PARAMS):
    """All-pairs object-object sphere contacts, same-object pairs and dead
    objects masked: the dense (B, N, K, N, K) sweep. (force, torque), each
    (B, N, 3)."""
    centers, radii, vels = world_spheres(obj)
    N = radii.shape[1]
    pa, pb = centers[:, :, :, None, None, :], centers[:, None, None, :, :, :]
    va, vb = vels[:, :, :, None, None, :], vels[:, None, None, :, :, :]
    ra, rb = radii[:, :, :, None, None], radii[:, None, None, :, :]
    ma = obj.mass[:, :, None, None, None]
    mb = obj.mass[:, None, None, :, None]
    f = _pair_forces(pa, va, ra, pb, vb, rb, ma * mb / (ma + mb), prm)
    live = obj.active & ~obj.removed
    eye = torch.eye(N, dtype=torch.bool, device=live.device)
    mask = ((~eye)[None, :, None, :, None] & live[:, :, None, None, None]
            & live[:, None, None, :, None])
    f = torch.where(mask[..., None], f, torch.zeros_like(f))
    arm = centers[:, :, :, None, None, :] - obj.pos[:, :, None, None, None, :]
    torque = torch.linalg.cross(arm.expand_as(f), f, dim=-1)
    return f.sum(dim=(2, 3, 4)), torque.sum(dim=(2, 3, 4))


def _gripper_params(prm: ContactParams) -> ContactParams:
    return dataclasses.replace(prm, mu=prm.mu_gripper)


def gripper_object_forces(obj: Objects, grip_centers, grip_radii, grip_vels,
                          prm: ContactParams = DEFAULT_PARAMS):
    """Forces from the kinematic gripper spheres (grip_centers and
    grip_vels (B, G, 3), grip_radii (G,)) onto the objects. Returns
    (force (B, N, 3), torque (B, N, 3), load per gripper sphere (B, G))."""
    centers, radii, vels = world_spheres(obj)
    pa, va, ra = centers[:, :, :, None, :], vels[:, :, :, None, :], radii[..., None]
    pb, vb = grip_centers[:, None, None, :, :], grip_vels[:, None, None, :, :]
    rb = grip_radii.expand(grip_centers.shape[:2])[:, None, None, :]
    meff = obj.mass[:, :, None, None]     # the gripper's mass is infinite
    f = _pair_forces(pa, va, ra, pb, vb, rb, meff, _gripper_params(prm))
    live = obj.active & ~obj.removed & (obj.attached == 0)
    f = torch.where(live[:, :, None, None, None], f, torch.zeros_like(f))
    arm = centers[:, :, :, None, :] - obj.pos[:, :, None, None, :]
    torque = torch.linalg.cross(arm.expand_as(f), f, dim=-1)
    load = _norm(f).sum(dim=(1, 2))
    return f.sum(dim=(2, 3)), torque.sum(dim=(2, 3)), load


def fused_contact_forces(obj: Objects, grip_centers, grip_radii, grip_vels,
                         prm: ContactParams = DEFAULT_PARAMS):
    """Total contact force and torque on each object, (B, N, 3) each, from
    the table, every other object and the kinematic gripper in one flat
    sweep (contact.py:230-329): rows are the S = N*K object spheres,
    columns the S object spheres then the G gripper spheres."""
    centers, radii, vels = world_spheres(obj)
    B, N, K = radii.shape
    S = N * K
    G = grip_centers.shape[1]
    dev = radii.device

    live = obj.active & ~obj.removed
    receives = live & (obj.attached == 0)

    cx, cy, cz = (centers[..., i].reshape(B, S) for i in range(3))
    vx, vy, vz = (vels[..., i].reshape(B, S) for i in range(3))
    r_row = radii.reshape(B, S)
    owner = torch.arange(N, device=dev).repeat_interleave(K)             # (S,)
    m_row = obj.mass.repeat_interleave(K, dim=1)                          # (B, S)
    live_row = receives.repeat_interleave(K, dim=1)

    sx = torch.cat([cx, grip_centers[..., 0]], dim=1)                     # (B, T)
    sy = torch.cat([cy, grip_centers[..., 1]], dim=1)
    sz = torch.cat([cz, grip_centers[..., 2]], dim=1)
    svx = torch.cat([vx, grip_vels[..., 0]], dim=1)
    svy = torch.cat([vy, grip_vels[..., 1]], dim=1)
    svz = torch.cat([vz, grip_vels[..., 2]], dim=1)
    r_col = torch.cat([r_row, grip_radii.expand(B, G)], dim=1)
    owner_col = torch.cat([owner, torch.full((G,), -1, dtype=owner.dtype, device=dev)])
    live_col = torch.cat([live.repeat_interleave(K, dim=1),
                          torch.ones(B, G, dtype=torch.bool, device=dev)], dim=1)
    is_grip_col = torch.cat([torch.zeros(S, dtype=torch.bool, device=dev),
                             torch.ones(G, dtype=torch.bool, device=dev)])
    m_col = torch.cat([m_row, torch.full((B, G), float("inf"), device=dev)], dim=1)
    mu_col = torch.where(is_grip_col, prm.mu_gripper, prm.mu)

    dx = cx[:, :, None] - sx[:, None, :]
    dy = cy[:, :, None] - sy[:, None, :]
    dz = cz[:, :, None] - sz[:, None, :]
    dist2 = dx * dx + dy * dy + dz * dz
    inv_dist = torch.rsqrt(dist2 + 1e-18)
    dist = dist2 * inv_dist
    pen = (r_row[:, :, None] + r_col[:, None, :]) - dist
    pair_ok = ((owner[:, None] != owner_col[None, :])[None]
               & live_row[:, :, None] & live_col[:, None, :] & (pen > 0.0))

    nx, ny, nz = dx * inv_dist, dy * inv_dist, dz * inv_dist
    rvx = vx[:, :, None] - svx[:, None, :]
    rvy = vy[:, :, None] - svy[:, None, :]
    rvz = vz[:, :, None] - svz[:, None, :]
    vn = torch.clamp(rvx * nx + rvy * ny + rvz * nz, -prm.max_vn, prm.max_vn)
    mr, mc = m_row[:, :, None], m_col[:, None, :]
    meff = (mr * mc) / (mr + mc)
    meff = torch.where(torch.isfinite(meff), meff, mr.expand_as(meff))
    cn = 2.0 * prm.zeta * torch.sqrt(prm.kn * meff / prm.contact_share)
    fn = torch.clamp(prm.kn * torch.clamp(pen, max=prm.max_pen) - cn * vn, min=0.0)
    fn = torch.where(pair_ok, fn, torch.zeros_like(fn))

    tx, ty, tz = rvx - vn * nx, rvy - vn * ny, rvz - vn * nz
    vt2 = tx * tx + ty * ty + tz * tz
    inv_vt = torch.rsqrt(vt2 + 1e-18)
    ft = mu_col[None, None, :] * fn * torch.tanh(vt2 * inv_vt / prm.v_eps)
    fx = fn * nx - ft * tx * inv_vt
    fy = fn * ny - ft * ty * inv_vt
    fz = fn * nz - ft * tz * inv_vt

    # Table contact per row sphere, added before the per-object reduce.
    pen_t = r_row - (cz - prm.table_z)
    vn_t = torch.clamp(vz, -prm.max_vn, prm.max_vn)
    cn_t = 2.0 * prm.zeta * torch.sqrt(prm.kn * m_row / prm.contact_share)
    fn_t = torch.clamp(prm.kn * torch.clamp(pen_t, max=prm.max_pen) - cn_t * vn_t, min=0.0)
    fn_t = torch.where((pen_t > 0.0) & live_row, fn_t, torch.zeros_like(fn_t))
    vtm = torch.sqrt(vx * vx + vy * vy + 1e-18)
    ft_t = prm.mu * fn_t * torch.tanh(vtm / prm.v_eps) / vtm

    fsx = fx.sum(dim=2) - ft_t * vx
    fsy = fy.sum(dim=2) - ft_t * vy
    fsz = fz.sum(dim=2) + fn_t

    ox, oy, oz = (obj.pos[..., i].repeat_interleave(K, dim=1) for i in range(3))
    ax, ay, az = cx - ox, cy - oy, cz - oz
    tqx = ay * fsz - az * fsy
    tqy = az * fsx - ax * fsz
    tqz = ax * fsy - ay * fsx

    per_obj = lambda t: t.reshape(B, N, K).sum(dim=2)  # noqa: E731
    force = torch.stack([per_obj(fsx), per_obj(fsy), per_obj(fsz)], dim=-1)
    torque = torch.stack([per_obj(tqx), per_obj(tqy), per_obj(tqz)], dim=-1)
    return force, torque
