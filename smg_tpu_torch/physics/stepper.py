"""The rigid-body stepper: step(scenes, gripper_target) -> scenes (port of
smg_tpu/physics/stepper.py), on scenes with a leading B axis.

Two formulations of one physics step, which differ only in the contact
sweep:
- `physics_step` / `run_steps` / `settle` (stepper.py:83-176): the
  per-scene reference path. The gripper's colliders come from
  gripper.collider_spheres and the contacts from
  contact.fused_contact_forces, dense pair terms per scene.
- `physics_step_batched` / `run_steps_batched` (stepper.py:262-417): the
  per-step SoA state prep (scenes minor), the K1 contact sweep
  (ops/contact.py), the table contact and the torques. The executor of the
  act and training steps.
Both share the servo, the semi-implicit integration and the attachment
kinematics. Any batch size works. The JAX package pins the two bit-equal
on its CPU (tests/test_physics.py:243-257); the port's are held to each
other in tests/test_torch_contact_vmap.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from smg_tpu_torch.core import rotation as rot
from smg_tpu_torch.ops import contact as contact_op
from smg_tpu_torch.physics import contact as ct
from smg_tpu_torch.physics import gripper as gr
from smg_tpu_torch.physics.contact import ContactParams  # also stepper.ContactParams
from smg_tpu_torch.physics.state import (
    FREE,
    LIFT_SUCCESS_Z,
    WORKSPACE,
    Gripper,
    Objects,
    Scene,
)


@dataclass(frozen=True)
class StepperParams:
    dt: float = 1e-3
    gravity: float = -9.81
    contact: ContactParams = field(default_factory=ContactParams)
    lin_damping: float = 0.15
    ang_damping: float = 2.0
    max_vel: float = 3.0
    max_omega: float = 30.0
    servo_v: float = 0.004
    servo_w: float = 0.06
    servo_curl: float = 0.015


DEFAULT = StepperParams()


def _servo_gripper(g: Gripper, target: Gripper, p: StepperParams) -> Gripper:
    """Rate-limited kinematic move toward a target pose (stepper.py:55-71)."""
    d = target.pos - g.pos
    dist = torch.linalg.norm(d, dim=-1, keepdim=True)
    step = torch.clamp(dist, max=p.servo_v)
    new_pos = g.pos + d / (dist + 1e-9) * step

    def ang_step(cur, tgt, rate):
        return cur + torch.clamp(tgt - cur, -rate, rate)

    return Gripper(
        pos=new_pos,
        yaw=ang_step(g.yaw, target.yaw, p.servo_w),
        tilt=ang_step(g.tilt, target.tilt, p.servo_w),
        curl=ang_step(g.curl, target.curl, p.servo_curl),
    )


def _attached_pose(g: Gripper, obj: Objects):
    """World pose attached objects follow (stepper.py:74-80)."""
    R = g.tool_rotm()                                   # (B, 3, 3)
    q_tool = rot.rotm2quat(R)                           # (B, 4)
    pos = g.pos[:, None, :] + obj.attach_pos @ R.transpose(1, 2)
    quat = rot.quat_mul(q_tool[:, None, :], obj.attach_quat)
    return pos, quat


def _integrate_objects(obj: Objects, force: torch.Tensor, torque: torch.Tensor,
                       g_new: Gripper, p: StepperParams) -> Objects:
    """Semi-implicit integration + attachment kinematics (stepper.py:107-151)."""
    live = obj.active & ~obj.removed
    free = (live & (obj.attached == FREE))[..., None]

    acc = force / obj.mass[..., None]
    acc = acc + acc.new_tensor([0.0, 0.0, p.gravity])
    vel = obj.vel + p.dt * acc
    vel = vel * (1.0 - p.lin_damping * p.dt)
    speed = torch.linalg.norm(vel, dim=-1, keepdim=True)
    vel = vel * torch.clamp(p.max_vel / (speed + 1e-9), max=1.0)
    vel = torch.where(free, vel, torch.zeros_like(vel))
    pos = obj.pos + p.dt * vel

    R = rot.quat2rotm(obj.quat)                         # (B, N, 3, 3)
    w_body = torch.einsum("bnji,bnj->bni", R, obj.omega)
    L_world = torch.einsum("bnij,bnj->bni", R, obj.inertia * w_body)
    tau_eff = torque - torch.linalg.cross(obj.omega, L_world, dim=-1)
    tau_body = torch.einsum("bnji,bnj->bni", R, tau_eff)
    omega_dot = torch.einsum(
        "bnij,bnj->bni", R, tau_body / torch.clamp(obj.inertia, min=1e-10)
    )
    omega = obj.omega + p.dt * omega_dot
    omega = omega * (1.0 - p.ang_damping * p.dt)
    wmag = torch.linalg.norm(omega, dim=-1, keepdim=True)
    omega = omega * torch.clamp(p.max_omega / (wmag + 1e-9), max=1.0)
    omega = torch.where(free, omega, torch.zeros_like(omega))
    quat = rot.quat_integrate(obj.quat, omega, p.dt)
    quat = torch.where(free, quat, obj.quat)
    pos = torch.where(free, pos, obj.pos)

    att_pos, att_quat = _attached_pose(g_new, obj)
    is_att = (live & (obj.attached != FREE))[..., None]
    pos = torch.where(is_att, att_pos, pos)
    quat = torch.where(is_att, att_quat, quat)
    return obj.replace(pos=pos, quat=quat, vel=vel, omega=omega)


def contact_forces(obj: Objects, g_old: Gripper, g_new: Gripper,
                   p: StepperParams = DEFAULT):
    """The per-scene path's contact force and torque on each object, (B,
    N, 3) each: the gripper's colliders at g_new, their velocities by
    finite difference from g_old, the dense sweep (stepper.py:90-101)."""
    c_new, radii = gr.collider_spheres(g_new)
    c_old, _ = gr.collider_spheres(g_old)
    return ct.fused_contact_forces(obj, c_new, radii, (c_new - c_old) / p.dt, p.contact)


def physics_step(scene: Scene, gripper_target: Gripper,
                 p: StepperParams = DEFAULT) -> Scene:
    """One physics step of the per-scene path (stepper.py:83-104): the
    gripper servoed toward its target, the dense contact sweep, the
    integration."""
    g_new = _servo_gripper(scene.gripper, gripper_target, p)
    force, torque = contact_forces(scene.objects, scene.gripper, g_new, p)
    new_obj = _integrate_objects(scene.objects, force, torque, g_new, p)
    return scene.replace(objects=new_obj, gripper=g_new, t=scene.t + 1)


def run_steps(scene: Scene, gripper_target: Gripper, n_steps: int,
              p: StepperParams = DEFAULT) -> Scene:
    """n_steps of physics_step (a Python loop where JAX scanned)."""
    for _ in range(n_steps):
        scene = physics_step(scene, gripper_target, p)
    return scene


def settle(scene: Scene, n_steps: int = 300, p: StepperParams = DEFAULT) -> Scene:
    """Let free objects come to rest, the gripper held where it is."""
    return run_steps(scene, scene.gripper, n_steps, p)


def _world_spheres_soa(obj: Objects):
    """Batched world spheres, scenes minor (stepper.py:262-310).

    Returns (cx cy cz vx vy vz rad mass live), each (S, B), and the torque
    arms (ax, ay, az), each (S, B).
    """
    B, N, K = obj.sph_radii.shape
    S = N * K
    qw, qx, qy, qz = (obj.quat[..., i].T for i in range(4))    # (N, B)
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    ox, oy, oz = (obj.sph_offsets[..., i].permute(1, 2, 0) for i in range(3))
    px, py, pz = (obj.pos[..., i].T for i in range(3))

    ax = r00[:, None] * ox + r01[:, None] * oy + r02[:, None] * oz
    ay = r10[:, None] * ox + r11[:, None] * oy + r12[:, None] * oz
    az = r20[:, None] * ox + r21[:, None] * oy + r22[:, None] * oz
    cx = (px[:, None] + ax).reshape(S, B)
    cy = (py[:, None] + ay).reshape(S, B)
    cz = (pz[:, None] + az).reshape(S, B)

    lvx, lvy, lvz = (obj.vel[..., i].T for i in range(3))
    wx, wy, wz = (obj.omega[..., i].T for i in range(3))
    vx = (lvx[:, None] + wy[:, None] * az - wz[:, None] * ay).reshape(S, B)
    vy = (lvy[:, None] + wz[:, None] * ax - wx[:, None] * az).reshape(S, B)
    vz = (lvz[:, None] + wx[:, None] * ay - wy[:, None] * ax).reshape(S, B)

    rad = obj.sph_radii.permute(1, 2, 0).reshape(S, B)
    mass = obj.mass.T.repeat_interleave(K, dim=0)
    live = (obj.active & ~obj.removed).T.to(cx.dtype).repeat_interleave(K, 0)
    arm = (ax.reshape(S, B), ay.reshape(S, B), az.reshape(S, B))
    return (cx, cy, cz, vx, vy, vz, rad, mass, live), arm


def contact_forces_batched(obj: Objects, g_old: Gripper, g_new: Gripper,
                           p: StepperParams = DEFAULT):
    """The batched stepper's contact force and torque on each object, (B,
    N, 3) each (stepper.py:324-396): the SoA state prep, K1 over every
    object and gripper sphere, the table contact, the per-object reduce.
    The counterpart of contact.fused_contact_forces on gripper.collider_spheres."""
    B, N, K = obj.sph_radii.shape
    gx1, gy1, gz1, grad = gr.collider_spheres_soa(
        g_new.pos, g_new.yaw, g_new.tilt, g_new.curl)
    gx0, gy0, gz0, _ = gr.collider_spheres_soa(g_old.pos, g_old.yaw, g_old.tilt,
                                               g_old.curl)
    gvx = (gx1 - gx0) / p.dt
    gvy = (gy1 - gy0) / p.dt
    gvz = (gz1 - gz0) / p.dt
    G = grad.shape[0]

    row, arm = _world_spheres_soa(obj)
    cx, cy, cz, vx, vy, vz, rad, mass, live_s = row
    receives = obj.active & ~obj.removed & (obj.attached == FREE)
    recv_s = receives.T.to(cx.dtype).repeat_interleave(K, dim=0)
    row_state = (cx, cy, cz, vx, vy, vz, rad, mass, recv_s)
    ones_g = torch.ones((G, B), dtype=cx.dtype, device=cx.device)
    col_state = (
        torch.cat([cx, gx1]), torch.cat([cy, gy1]), torch.cat([cz, gz1]),
        torch.cat([vx, gvx]), torch.cat([vy, gvy]), torch.cat([vz, gvz]),
        torch.cat([rad, grad[:, None] * ones_g]),
        torch.cat([mass, ones_g]), torch.cat([live_s, ones_g]),
    )
    prm = p.contact
    fx, fy, fz = contact_op.pairwise_forces(
        row_state, col_state, K,
        kn=prm.kn, zeta=prm.zeta, share=prm.contact_share, mu=prm.mu,
        mu_grip=prm.mu_gripper, v_eps=prm.v_eps, max_pen=prm.max_pen,
        max_vn=prm.max_vn,
    )

    # Table contact per row sphere.
    pen_t = rad - (cz - prm.table_z)
    vn_t = torch.clamp(vz, -prm.max_vn, prm.max_vn)
    cn_t = 2.0 * prm.zeta * torch.sqrt(prm.kn * mass / prm.contact_share)
    fn_t = torch.clamp(prm.kn * torch.clamp(pen_t, max=prm.max_pen)
                       - cn_t * vn_t, min=0.0)
    fn_t = torch.where((pen_t > 0.0) & (recv_s > 0.0), fn_t,
                       torch.zeros_like(fn_t))
    vtm = torch.sqrt(vx * vx + vy * vy + 1e-18)
    ft_t = prm.mu * fn_t * torch.tanh(vtm / prm.v_eps) / vtm
    fx = fx - ft_t * vx
    fy = fy - ft_t * vy
    fz = fz + fn_t

    ax, ay, az = arm
    tqx = (ay * fz - az * fy).reshape(N, K, B).sum(1)
    tqy = (az * fx - ax * fz).reshape(N, K, B).sum(1)
    tqz = (ax * fy - ay * fx).reshape(N, K, B).sum(1)
    fox = fx.reshape(N, K, B).sum(1)
    foy = fy.reshape(N, K, B).sum(1)
    foz = fz.reshape(N, K, B).sum(1)
    force = torch.stack([fox, foy, foz], dim=-1).transpose(0, 1)   # (B, N, 3)
    torque = torch.stack([tqx, tqy, tqz], dim=-1).transpose(0, 1)
    return force, torque


def physics_step_batched(scenes: Scene, gripper_target: Gripper,
                         p: StepperParams = DEFAULT) -> Scene:
    """One physics step for a batch of scenes (stepper.py:313-401)."""
    g_new = _servo_gripper(scenes.gripper, gripper_target, p)
    force, torque = contact_forces_batched(scenes.objects, scenes.gripper, g_new, p)
    new_obj = _integrate_objects(scenes.objects, force, torque, g_new, p)
    return scenes.replace(objects=new_obj, gripper=g_new, t=scenes.t + 1)


def run_steps_batched(scenes: Scene, gripper_target: Gripper, n_steps: int,
                      p: StepperParams = DEFAULT) -> Scene:
    """n_steps of physics_step_batched (a Python loop where JAX scanned)."""
    for _ in range(n_steps):
        scenes = physics_step_batched(scenes, gripper_target, p)
    return scenes


# ---------------------------------------------------------------------------
# Attachment switching and episode predicates (stepper.py:179-248)
# ---------------------------------------------------------------------------


def attach(obj: Objects, g: Gripper, slot_mask: torch.Tensor, mode: int) -> Objects:
    """Weld masked slots (B, N) to the tool frame in their current pose."""
    R = g.tool_rotm()
    q_tool = rot.rotm2quat(R)
    rel_pos = (obj.pos - g.pos[:, None, :]) @ R
    rel_quat = rot.quat_mul(rot.quat_conj(q_tool)[:, None, :], obj.quat)
    m = slot_mask[..., None]
    zero = torch.zeros_like(obj.vel)
    return obj.replace(
        attached=torch.where(slot_mask, torch.full_like(obj.attached, mode),
                             obj.attached),
        attach_pos=torch.where(m, rel_pos, obj.attach_pos),
        attach_quat=torch.where(m, rel_quat, obj.attach_quat),
        vel=torch.where(m, zero, obj.vel),
        omega=torch.where(m, zero, obj.omega),
    )


def detach_all(obj: Objects) -> Objects:
    return obj.replace(attached=torch.zeros_like(obj.attached))


def lift_success_mask(obj: Objects, thresh: float = LIFT_SUCCESS_Z) -> torch.Tensor:
    """Objects lifted above the success threshold, (B, N) (stepper.py:208-212)."""
    return obj.on_table & (obj.pos[..., 2] > thresh)


def fallen_mask(obj: Objects, thresh: float = 0.001) -> torch.Tensor:
    return obj.on_table & (obj.pos[..., 2] < thresh) & (obj.attached == FREE)


def resurrect_fallen(obj: Objects, drop_z: float = 0.08) -> Objects:
    """Teleport fallen objects back above the table (stepper.py:220-234)."""
    fallen = fallen_mask(obj)[..., None]
    lifted = torch.cat([obj.pos[..., :2],
                        torch.full_like(obj.pos[..., 2:], drop_z)], dim=-1)
    zero = torch.zeros_like(obj.vel)
    return obj.replace(
        pos=torch.where(fallen, lifted, obj.pos),
        vel=torch.where(fallen, zero, obj.vel),
        omega=torch.where(fallen, zero, obj.omega),
    )


def sim_stable(g: Gripper, margin: float = 0.1) -> torch.Tensor:
    """Gripper-within-workspace check (stepper.py:237-248), (B,) bool."""
    tip = gr.grasp_tip_position(g)
    wl = WORKSPACE
    return (
        (tip[:, 0] > wl[0, 0] - margin) & (tip[:, 0] < wl[0, 1] + margin)
        & (tip[:, 1] > wl[1, 0] - margin) & (tip[:, 1] < wl[1, 1] + margin)
        & (tip[:, 2] > wl[2, 0]) & (tip[:, 2] < wl[2, 1])
    )
