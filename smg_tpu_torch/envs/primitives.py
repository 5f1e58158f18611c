"""Scripted grasp / suction / envelop-then-suck primitives, batched over
scenes (port of smg_tpu/envs/primitives.py).

Each primitive is a fixed sequence of phases; each phase servos the
gripper toward a target pose while the physics steps. Captures are
constraint switches gated by geometry (the envelop and suction capture
tests); success bookkeeping is the reference's (robot.py:378-392,420-553).

The pieces (phase lengths, per-scene stage targets, stage gating, the
capture tests, the teleport-out of lifted objects) serve both executors.
`grasp`, `suction`, `grasp_first`, `suction_first` and
`grasp_then_suction` run their phases on the per-scene stepper
(stepper.run_steps), as smg_env.execute does; envs/batched.py runs the
same program on the K1 stepper. `enabled` (B,) gates a whole stage per
scene: a disabled scene holds its entry pose and captures nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from smg_tpu_torch.core import rotation as rot
from smg_tpu_torch.core import tendon
from smg_tpu_torch.physics import gripper as gr
from smg_tpu_torch.physics import stepper
from smg_tpu_torch.physics.state import (
    ATTACHED_GRASP,
    ATTACHED_SUCTION,
    FREE,
    LIFT_SUCCESS_Z,
    PARK_POS,
    Gripper,
    Scene,
)

FULL_CLOSE = math.pi / 2.5

APPROACH_MARGIN = 0.2
TIP_TARGET_Z = 0.008
PAD_PRESS = 0.004
SUCTION_SKIN = 0.010


@dataclass(frozen=True)
class PrimitiveParams:
    """Stepper gains + phase step counts (primitives.py:58-76)."""

    stepper: stepper.StepperParams = field(default_factory=stepper.StepperParams)
    steps_move_above: int = 130
    steps_preclose: int = 95
    steps_descend: int = 65
    steps_squeeze: int = 55
    steps_lift: int = 65
    steps_pad_align: int = 45
    steps_finish: int = 40

    @property
    def steps_per_act(self) -> int:
        """Physics steps of one batched act step: the envelop stage
        (move, pre-close, descend, squeeze, lift), the suction stage
        (move, pad-align, descend, lift) and the finish."""
        return (2 * self.steps_move_above + self.steps_preclose
                + 2 * self.steps_descend + self.steps_squeeze
                + 2 * self.steps_lift + self.steps_pad_align
                + self.steps_finish)


DEFAULT = PrimitiveParams()


def _phase(scene: Scene, target: Gripper, n: int, p: PrimitiveParams) -> Scene:
    return stepper.run_steps(scene, target, n, p.stepper)


def _grip(pos, yaw, tilt, curl) -> Gripper:
    """A target pose; a float curl applies to every scene."""
    if not isinstance(curl, torch.Tensor):
        curl = torch.full_like(yaw, curl)
    return Gripper(pos=pos, yaw=yaw, tilt=tilt, curl=curl)


def _all(scene: Scene) -> torch.Tensor:
    return torch.ones(scene.batch_size, dtype=torch.bool, device=scene.device)


def _object_min_width(obj) -> torch.Tensor:
    return 2.0 * torch.minimum(obj.half_extents[..., 0], obj.half_extents[..., 1])


def _one_best(eligible: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """eligible (B, N) & the eligible slot of least dist (first on ties)."""
    best = torch.argmin(torch.where(eligible, dist, torch.full_like(dist, math.inf)),
                        dim=1)
    slots = torch.arange(eligible.shape[1], device=eligible.device)
    return eligible & (slots[None] == best[:, None])


def _envelop_capture_mask(scene: Scene, pre_curl, final_curl) -> torch.Tensor:
    """Which single object the squeeze captured, (B, N) (primitives.py:103-126)."""
    obj, g = scene.objects, scene.gripper
    d_axis = torch.linalg.norm(obj.pos[..., :2] - g.pos[:, None, :2], dim=-1)
    cage_pre = gr.cage_radius(pre_curl)[:, None]
    open_pre = tendon.opening_distance(pre_curl)[:, None]
    open_final = tendon.opening_distance(final_curl)[:, None]
    w_obj = _object_min_width(obj)
    top = obj.pos[..., 2] + obj.half_extents[..., 2]
    eligible = (
        obj.on_table
        & (obj.attached == FREE)
        & (d_axis < cage_pre * 0.9 + 0.012)
        & (open_pre >= w_obj - 0.005)
        & (open_final < w_obj + 0.010)
        & (top > TIP_TARGET_Z + 0.005)
    )
    return _one_best(eligible, d_axis)


def _suction_capture_mask(scene: Scene, pad_id) -> torch.Tensor:
    """Which single object the selected pad attached to (primitives.py:129-143)."""
    obj = scene.objects
    B = pad_id.shape[0]
    bidx = torch.arange(B, device=pad_id.device)
    tip = gr.pad_tip_positions(scene.gripper)[bidx, pad_id.long()]  # (B, 3)
    Rm = rot.quat2rotm(obj.quat)
    local = torch.einsum("bnji,bnj->bni", Rm, tip[:, None, :] - obj.pos)
    inside = (torch.abs(local) <= obj.half_extents + SUCTION_SKIN).all(dim=-1)
    eligible = obj.on_table & (obj.attached == FREE) & inside
    d = torch.linalg.norm(obj.pos - tip[:, None, :], dim=-1)
    return _one_best(eligible, d)


def _teleport_out_lifted(scene: Scene, enabled: torch.Tensor) -> Scene:
    """Held objects lifted above the success threshold go to the shelf
    (primitives.py:151-181). enabled (B,) bool."""
    obj = scene.objects
    z = obj.pos[..., 2]
    n = z.shape[1]
    take = (obj.on_table & (obj.attached != FREE) & (z > LIFT_SUCCESS_Z)
            & enabled[:, None])
    slots = torch.arange(n, dtype=torch.float32, device=z.device)
    park = torch.as_tensor(PARK_POS, dtype=torch.float32, device=z.device)
    shelf = park[None, :] + torch.stack(
        [torch.zeros_like(slots), 0.1 * slots, torch.zeros_like(slots)], -1)
    t3 = take[..., None]
    zero = torch.zeros_like(obj.vel)
    return scene.replace(objects=obj.replace(
        pos=torch.where(t3, shelf[None], obj.pos),
        vel=torch.where(t3, zero, obj.vel),
        omega=torch.where(t3, zero, obj.omega),
        removed=obj.removed | take,
        attached=torch.where(take, torch.full_like(obj.attached, FREE),
                             obj.attached),
    ))


def grasp_stage_params(open_distance, position, rotation_angle):
    """Per-scene scalars of the enveloping sequence (primitives.py:200-214)."""
    tool_yaw = gr.tool_angle_for_grasp(rotation_angle)
    narrow = open_distance < 0.08
    factor = torch.where(narrow, 1.3, 1.2)
    pre_curl = tendon.pre_rotate_angle(open_distance * factor)
    final_curl = torch.where(narrow, torch.full_like(pre_curl, FULL_CLOSE),
                             pre_curl + math.pi / 5)
    final_curl = torch.clamp(final_curl, max=FULL_CLOSE)
    descend_z = TIP_TARGET_Z + gr.cage_depth(pre_curl)
    above = torch.stack([position[:, 0], position[:, 1],
                         descend_z + APPROACH_MARGIN], dim=-1)
    down = torch.stack([position[:, 0], position[:, 1], descend_z], dim=-1)
    return tool_yaw, pre_curl, final_curl, above, down


def suction_stage_params(cur_curl, position, rotation_angle, finger_angle):
    """Per-scene scalars of the sucking sequence (primitives.py:217-239)."""
    pad_id = gr.suction_pad_for_yaw(rotation_angle)
    tool_yaw = gr.tool_angle_for_suction(rotation_angle)
    curl = torch.where(
        finger_angle == 1.0, torch.full_like(cur_curl, FULL_CLOSE),
        torch.where(finger_angle == 0.0, cur_curl, finger_angle),
    )
    r_j, z_j = tendon.finger_chain_points(curl)
    dr = r_j[..., -1] - r_j[..., -2]
    dz = z_j[..., -1] - z_j[..., -2]
    mis = torch.atan2(dr, dz)
    zero = torch.zeros_like(mis)
    tilt = torch.stack(
        [torch.where(pad_id == 1, -mis, torch.where(pad_id == 3, mis, zero)),
         torch.where(pad_id == 0, mis, torch.where(pad_id == 2, -mis, zero))],
        dim=-1,
    )
    B = curl.shape[0]
    probe = Gripper(pos=torch.zeros(B, 3, device=curl.device), yaw=tool_yaw,
                    tilt=tilt, curl=curl)
    bidx = torch.arange(B, device=curl.device)
    pad_off = gr.pad_tip_positions(probe)[bidx, pad_id.long()]
    touch = position + position.new_tensor([0.0, 0.0, -PAD_PRESS]) - pad_off
    above = touch + position.new_tensor([0.0, 0.0, APPROACH_MARGIN])
    return pad_id, tool_yaw, tilt, curl, touch, above


def gate_target(target: Gripper, hold: Gripper, enabled: torch.Tensor) -> Gripper:
    """Disabled scenes hold the entry pose (primitives.py:242-249)."""
    return hold.where(enabled, target)


def _finish(scene: Scene, p: PrimitiveParams = DEFAULT) -> Scene:
    """Detach everything, resurrect fallen objects, open the gripper and
    let the table settle (primitives.py:184-197, robot.py:489-508)."""
    obj = stepper.resurrect_fallen(stepper.detach_all(scene.objects))
    scene = scene.replace(objects=obj)
    open_target = scene.gripper.replace(curl=torch.zeros_like(scene.gripper.curl))
    return _phase(scene, open_target, p.steps_finish, p)


def grasp(scene: Scene, open_distance, position, rotation_angle,
          p: PrimitiveParams = DEFAULT, enabled=None):
    """The enveloping sequence (primitives.py:257-321, robot.py:555-626):
    open_distance (B,), position (B, 3) surface points, rotation_angle
    (B,). Returns (scene, success (B,), reached curl (B,)); the scene still
    holds what it captured. enabled (B,) bool, default all."""
    enabled = _all(scene) if enabled is None else enabled
    hold = scene.gripper
    tool_yaw, pre_curl, final_curl, above, down = grasp_stage_params(
        open_distance, position, rotation_angle)
    zero_tilt = torch.zeros_like(hold.tilt)

    def go(sc, pos, curl, n):
        return _phase(sc, gate_target(_grip(pos, tool_yaw, zero_tilt, curl), hold,
                                      enabled), n, p)

    scene = go(scene, above, 0.0, p.steps_move_above)        # travel, open
    scene = go(scene, above, pre_curl, p.steps_preclose)     # pre-close
    scene = go(scene, down, pre_curl, p.steps_descend)       # descend
    scene = go(scene, down, final_curl, p.steps_squeeze)     # squeeze
    cap = _envelop_capture_mask(scene, pre_curl, final_curl) & enabled[:, None]
    scene = scene.replace(objects=stepper.attach(scene.objects, scene.gripper, cap,
                                                 ATTACHED_GRASP))
    scene = go(scene, above, final_curl, p.steps_lift)       # lift
    obj = scene.objects
    lifted = (obj.on_table & (obj.attached == ATTACHED_GRASP)
              & (obj.pos[..., 2] > LIFT_SUCCESS_Z))
    success = (lifted.any(dim=1) & enabled).to(torch.float32)
    return _teleport_out_lifted(scene, enabled), success, final_curl


def suction(scene: Scene, position, rotation_angle, finger_angle,
            p: PrimitiveParams = DEFAULT, enabled=None):
    """The sucking sequence (primitives.py:324-370, robot.py:629-713):
    finger_angle (B,) 1 -> full close, 0 -> keep, else that curl. Returns
    (scene, success (B,)) with the sucked object still attached."""
    enabled = _all(scene) if enabled is None else enabled
    hold = scene.gripper
    pad_id, tool_yaw, tilt, curl, touch, above = suction_stage_params(
        scene.gripper.curl, position, rotation_angle, finger_angle)
    zero_tilt = torch.zeros_like(tilt)

    def go(sc, pos, tl, n):
        return _phase(sc, gate_target(_grip(pos, tool_yaw, tl, curl), hold, enabled),
                      n, p)

    scene = go(scene, above, zero_tilt, p.steps_move_above)  # travel + yaw
    scene = go(scene, above, tilt, p.steps_pad_align)        # pad-align tilt
    scene = go(scene, touch, tilt, p.steps_descend)          # descend to touch
    cap = _suction_capture_mask(scene, pad_id) & enabled[:, None]
    success = cap.any(dim=1).to(torch.float32)
    scene = scene.replace(objects=stepper.attach(scene.objects, scene.gripper, cap,
                                                 ATTACHED_SUCTION))
    scene = go(scene, above, zero_tilt, p.steps_lift)        # lift + untilt
    return scene, success


def grasp_first(scene: Scene, open_distance, position, rotation_angle,
                p: PrimitiveParams = DEFAULT):
    """robot.grasp_first (robot.py:474-510): grasp, bookkeeping, 0 / 1."""
    scene, success, _ = grasp(scene, open_distance, position, rotation_angle, p)
    return _finish(scene, p), success


def suction_first(scene: Scene, position, rotation_angle,
                  p: PrimitiveParams = DEFAULT):
    """robot.suction_first (robot.py:512-553): suck, lift, 0 / 1."""
    scene, success = suction(scene, position, rotation_angle,
                             torch.ones_like(rotation_angle), p)
    scene = _teleport_out_lifted(scene, _all(scene))
    return _finish(scene, p), success


def grasp_then_suction(scene: Scene, open_distance, grasp_position,
                       grasp_rotation_angle, suction_position,
                       suction_rotation_angle, p: PrimitiveParams = DEFAULT):
    """robot.grasp_then_suction (robot.py:420-471): envelop one object,
    keep holding, suck a second; reward 2.5 both / 0.5 one / 0 none."""
    scene, g_succ, reached_curl = grasp(scene, open_distance, grasp_position,
                                        grasp_rotation_angle, p)
    # On a failed grasp the fingers stay at the reached angle for the
    # suction retry (robot.py:424-428).
    finger_angle = torch.where(g_succ > 0, torch.zeros_like(reached_curl), reached_curl)
    scene, s_succ = suction(scene, suction_position, suction_rotation_angle,
                            finger_angle, p)
    scene = _finish(_teleport_out_lifted(scene, _all(scene)), p)
    reward = torch.where((g_succ > 0) & (s_succ > 0), 2.5,
                         torch.where((g_succ > 0) | (s_succ > 0), 0.5, 0.0))
    return scene, reward
