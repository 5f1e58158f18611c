"""Batched primitive execution over the K1 stepper.

Port of smg_tpu/envs/batched.py::execute_batched: the unified grasp /
suction / envelop-then-suck program over B scenes, ten physics phases of
stepper.run_steps_batched (755 steps at the default phase lengths), with
per-scene stage gating, captures, rewards {0, 1} for grasp and suction and
{0, 0.5, 2.5} for ETS (batched.py:143-146), the teleport-out above z 0.11
and the fallen-object resurrection. Any batch size works.
"""

from __future__ import annotations

import torch

from smg_tpu_torch.envs import primitives as prim
from smg_tpu_torch.envs.smg_env import Geometry, StepOutcome
from smg_tpu_torch.physics import stepper
from smg_tpu_torch.physics.state import (
    ATTACHED_GRASP,
    ATTACHED_SUCTION,
    LIFT_SUCCESS_Z,
    Gripper,
    Scene,
)
from smg_tpu_torch.policy.arbitrate import (
    ACTION_ETS,
    ACTION_GRASP,
    ACTION_SUCTION,
    ActionChoice,
)


def execute_batched(scenes: Scene, choice: ActionChoice, geom: Geometry,
                    p: prim.PrimitiveParams = prim.DEFAULT):
    """Batched equivalent of vmap(smg_env.execute) (batched.py:46-156)."""
    is_g = choice.action == ACTION_GRASP
    is_s = choice.action == ACTION_SUCTION
    is_e = choice.action == ACTION_ETS
    en1 = is_g | is_e
    en2 = is_s | is_e

    def run(sc, tgt, n):
        return stepper.run_steps_batched(sc, tgt, n, p.stepper)

    # ---- Envelop stage ----
    hold1 = scenes.gripper
    tool_yaw, pre_curl, final_curl, above, down = prim.grasp_stage_params(
        geom.open_distance, geom.grasp_position, geom.grasp_angle)
    zero_tilt = torch.zeros_like(hold1.tilt)
    zero_curl = torch.zeros_like(pre_curl)

    def gated(pos, yaw, tilt, curl):
        return prim.gate_target(
            Gripper(pos=pos, yaw=yaw, tilt=tilt, curl=curl), hold1, en1)

    scenes = run(scenes, gated(above, tool_yaw, zero_tilt, zero_curl),
                 p.steps_move_above)
    scenes = run(scenes, gated(above, tool_yaw, zero_tilt, pre_curl),
                 p.steps_preclose)
    scenes = run(scenes, gated(down, tool_yaw, zero_tilt, pre_curl),
                 p.steps_descend)
    scenes = run(scenes, gated(down, tool_yaw, zero_tilt, final_curl),
                 p.steps_squeeze)
    cap = prim._envelop_capture_mask(scenes, pre_curl, final_curl) & en1[:, None]
    scenes = scenes.replace(objects=stepper.attach(
        scenes.objects, scenes.gripper, cap, ATTACHED_GRASP))
    scenes = run(scenes, gated(above, tool_yaw, zero_tilt, final_curl),
                 p.steps_lift)
    obj = scenes.objects
    lifted = (obj.on_table & (obj.attached == ATTACHED_GRASP)
              & (obj.pos[..., 2] > LIFT_SUCCESS_Z))
    g_succ = (lifted.any(dim=1) & en1).to(torch.float32)
    scenes = prim._teleport_out_lifted(scenes, en1)

    # ---- Suction stage ----
    finger_angle = torch.where(
        is_s, torch.ones_like(final_curl),
        torch.where(g_succ > 0, torch.zeros_like(final_curl), final_curl))
    hold2 = scenes.gripper
    pad_id, s_yaw, tilt, s_curl, touch, s_above = prim.suction_stage_params(
        scenes.gripper.curl, geom.suction_position, geom.suction_angle,
        finger_angle)

    def gated2(pos, yaw, tl, curl):
        return prim.gate_target(
            Gripper(pos=pos, yaw=yaw, tilt=tl, curl=curl), hold2, en2)

    scenes = run(scenes, gated2(s_above, s_yaw, zero_tilt, s_curl),
                 p.steps_move_above)
    scenes = run(scenes, gated2(s_above, s_yaw, tilt, s_curl),
                 p.steps_pad_align)
    scenes = run(scenes, gated2(touch, s_yaw, tilt, s_curl), p.steps_descend)
    cap2 = prim._suction_capture_mask(scenes, pad_id) & en2[:, None]
    s_succ = cap2.any(dim=1).to(torch.float32)
    scenes = scenes.replace(objects=stepper.attach(
        scenes.objects, scenes.gripper, cap2, ATTACHED_SUCTION))
    scenes = run(scenes, gated2(s_above, s_yaw, zero_tilt, s_curl),
                 p.steps_lift)
    scenes = prim._teleport_out_lifted(scenes, en2)

    # ---- Finish: detach, resurrect, open ----
    scenes = scenes.replace(
        objects=stepper.resurrect_fallen(stepper.detach_all(scenes.objects)))
    open_tgt = scenes.gripper.replace(curl=torch.zeros_like(scenes.gripper.curl))
    scenes = run(scenes, open_tgt, p.steps_finish)

    gs_reward = torch.where(
        (g_succ > 0) & (s_succ > 0), 2.5,
        torch.where((g_succ > 0) | (s_succ > 0), 0.5, 0.0))
    expect = torch.where(is_g[:, None], above, s_above)
    zero = torch.zeros_like(g_succ)
    outcome = StepOutcome(
        suction_success=torch.where(is_s, s_succ, zero),
        grasp_success=torch.where(is_g, g_succ, zero),
        gs_success=torch.where(is_e, gs_reward, zero),
        tip_divergence=torch.linalg.norm(scenes.gripper.pos - expect, dim=-1),
    )
    return scenes, outcome
