"""Scripted grasp / suction primitive pieces, batched over scenes.

Port of the parts of smg_tpu/envs/primitives.py that the batched executor
(envs/batched.py) uses: phase lengths, per-scene stage targets, stage
gating, the envelop and suction capture tests, and the teleport-out of
lifted objects. The per-scene `grasp` / `suction` / `*_first` wrappers run
on the per-scene stepper, which is not ported yet.
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
