"""The batched SMG environment: reset, observe, geometry, predicates.

Port of smg_tpu/envs/smg_env.py for B scenes at once: EnvConfig,
resolve_catalogs (procedural catalogs or an --obj_mesh_dir of .obj
meshes), reset, observe (exact segmentation, or a learned front-end
through `seg_fn`), masked_scene_depth, compute_geometry, execute, ik_ok and episode_done.
Primitive execution has two executors of one program: `execute`, the
per-scene path (primitives on stepper.run_steps, dense contacts), and
envs/batched.py::execute_batched on the K1 stepper.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import torch

from smg_tpu_torch.envs import primitives as prim
from smg_tpu_torch.perception import segment as seg_mod
from smg_tpu_torch.physics import scene as scene_mod
from smg_tpu_torch.physics import stepper
from smg_tpu_torch.physics.state import Scene, _Batched
from smg_tpu_torch.policy import action_geom as ag
from smg_tpu_torch.policy.arbitrate import (
    ACTION_ETS,
    ACTION_GRASP,
    ACTION_SUCTION,
    ActionChoice,
)
from smg_tpu_torch.render import ortho
from smg_tpu_torch.utils import profiling


@dataclass(frozen=True)
class EnvConfig:
    """Setup + algorithm flags (smg_env.py:44-68)."""

    is_cluttered: bool = False
    is_testing: bool = False
    is_ets: bool = False
    is_pe: bool = False
    is_oo: bool = False
    method: str = "reinforcement"
    step_limit: int = 20
    max_episode_success: int = 10
    no_change_limit: int = 3
    settle_steps: int = 250
    # "exact": the renderer's id buffers; "learned": the SlotSegmenter on
    # the color + depth heightmaps (LoopConfig.segmenter).
    segmentation: str = "exact"
    obj_mesh_dir: str = ""


@functools.lru_cache(maxsize=8)
def resolve_catalogs(cfg: EnvConfig):
    """--obj_mesh_dir -> object catalogs (smg_env.py:71-90), cached per
    config so a mesh directory is fitted once: a directory with
    enveloping/ + sucking/ .obj meshes goes through utils/meshes.py; the
    datasets/{training,testing} sentinels select the procedural catalog of
    that name, and "" is_testing's."""
    d = cfg.obj_mesh_dir
    if d and os.path.isdir(os.path.join(d, "enveloping")):
        from smg_tpu_torch.utils import meshes

        return meshes.load_object_sets(d)
    base = os.path.basename(os.path.normpath(d)) if d else ""
    if d and base not in ("training", "testing"):
        raise FileNotFoundError(
            f"--obj_mesh_dir {d!r}: no enveloping/ + sucking/ .obj dirs, "
            "and not a datasets/{training,testing} sentinel")
    testing = base == "testing" if d else cfg.is_testing
    return scene_mod.default_catalogs(testing)


@dataclass
class Observation(_Batched):
    depth_hm: torch.Tensor   # (B, 224, 224)
    color_hm: torch.Tensor   # (B, 224, 224, 3)
    seg: seg_mod.Segmentation


@dataclass
class Geometry(_Batched):
    grasp_position: torch.Tensor    # (B, 3)
    grasp_angle: torch.Tensor       # (B,)
    open_distance: torch.Tensor     # (B,)
    suction_position: torch.Tensor  # (B, 3)
    suction_angle: torch.Tensor     # (B,)


@dataclass
class StepOutcome(_Batched):
    suction_success: torch.Tensor   # (B,) {0, 1}
    grasp_success: torch.Tensor     # (B,) {0, 1}
    gs_success: torch.Tensor        # (B,) {0, 0.5, 2.5}
    tip_divergence: torch.Tensor    # (B,) meters

    @property
    def any_success(self) -> torch.Tensor:
        return ((self.suction_success > 0) | (self.grasp_success > 0)
                | (self.gs_success > 0))


def reset(gen: torch.Generator, B: int, cfg: EnvConfig, device, scene_slice=None,
          run=stepper.run_steps_batched) -> Scene:
    """B fresh episode scenes (smg_env.py:130-135), settled with `run`; a
    scene_slice's of them when given (scene.reset_scene)."""
    return scene_mod.reset_scene(
        gen, B, device, cfg.is_cluttered, cfg.is_testing, cfg.settle_steps,
        catalogs=resolve_catalogs(cfg), scene_slice=scene_slice, run=run,
    )


def observe(scenes: Scene, seg_fn=None) -> Observation:
    """Render + segment (smg_env.py:138-151). `seg_fn(color_hm (B, H, W,
    3), depth_hm (B, H, W)) -> Segmentation` replaces the exact id-buffer
    path with a learned front-end (the Mask-R-CNN analog, reference
    main.py:139); None keeps the exact path."""
    depth, ids, color = ortho.render_heightmap(scenes.objects)
    if seg_fn is None:
        seg = seg_mod.segment(scenes.objects, ids)
    else:
        seg = seg_fn(color, depth)
    return Observation(depth_hm=depth, color_hm=color, seg=seg)


def masked_scene_depth(obs: Observation) -> torch.Tensor:
    """Scene depth zeroed off the object union (smg_env.py:154-158)."""
    union = obs.seg.masks.any(dim=1)
    return torch.where(union, obs.depth_hm, torch.zeros_like(obs.depth_hm))


def compute_geometry(choice: ActionChoice, obs: Observation,
                     cfg: EnvConfig) -> Geometry:
    """PE + OO for the selected targets (smg_env.py:161-193)."""
    with profiling.span("compute_geometry"):
        seg = obs.seg
        depth = obs.depth_hm
        B, n = seg.valid.shape
        bidx = torch.arange(B, device=depth.device)
        g_pos, g_angle, open_d = ag.pe_grasp_geometry(
            seg.box_corners[bidx, choice.grasp_obj.long()], depth, is_pe=cfg.is_pe)
        num = seg.number
        is_ets_act = choice.action == ACTION_ETS
        slots = torch.arange(n, device=depth.device)
        oo_valid = seg.valid & ~(
            (is_ets_act & (num > 2))[:, None]
            & (slots[None] == choice.grasp_obj[:, None])
        )
        s_pos, s_angle = ag.oo_suction_angle(
            choice.suction_obj, seg.centers, seg.box_corners, oo_valid, depth,
            is_oo=cfg.is_oo)
        s_angle = torch.where(is_ets_act & (num == 2), torch.zeros_like(s_angle),
                              s_angle)
        return Geometry(grasp_position=g_pos, grasp_angle=g_angle,
                        open_distance=open_d, suction_position=s_pos,
                        suction_angle=s_angle)


def execute(scenes: Scene, choice: ActionChoice, geom: Geometry,
            p: prim.PrimitiveParams = prim.DEFAULT):
    """The unified primitive executor on the per-scene stepper
    (smg_env.py:196-248, main.py:384-396): the envelop stage runs for grasp
    and ETS scenes, the suction stage for suction and ETS scenes, each
    gated per scene (a disabled stage holds the gripper where it is).
    Returns (scenes, StepOutcome)."""
    is_g = choice.action == ACTION_GRASP
    is_s = choice.action == ACTION_SUCTION
    is_e = choice.action == ACTION_ETS
    scenes, g_succ, reached_curl = prim.grasp(
        scenes, geom.open_distance, geom.grasp_position, geom.grasp_angle, p,
        enabled=is_g | is_e)
    # Suction posture: full close for plain suction; for ETS keep holding
    # on success, else the reached angle (robot.py:424-428,517).
    finger_angle = torch.where(is_s, torch.ones_like(reached_curl),
                               torch.where(g_succ > 0, torch.zeros_like(reached_curl),
                                           reached_curl))
    scenes, s_succ = prim.suction(scenes, geom.suction_position, geom.suction_angle,
                                  finger_angle, p, enabled=is_s | is_e)
    scenes = prim._teleport_out_lifted(scenes, is_s | is_e)
    scenes = prim._finish(scenes, p)
    gs_reward = torch.where((g_succ > 0) & (s_succ > 0), 2.5,
                            torch.where((g_succ > 0) | (s_succ > 0), 0.5, 0.0))
    # The final phase's target: the grasp hover point for grasp-only
    # scenes, else the suction hover point (the JAX executor computes it
    # from the gripper's curl after the finish).
    _, _, _, g_above, _ = prim.grasp_stage_params(
        geom.open_distance, geom.grasp_position, geom.grasp_angle)
    *_, s_above = prim.suction_stage_params(
        scenes.gripper.curl, geom.suction_position, geom.suction_angle, finger_angle)
    expect = torch.where(is_g[:, None], g_above, s_above)
    zero = torch.zeros_like(g_succ)
    return scenes, StepOutcome(
        suction_success=torch.where(is_s, s_succ, zero),
        grasp_success=torch.where(is_g, g_succ, zero),
        gs_success=torch.where(is_e, gs_reward, zero),
        tip_divergence=torch.linalg.norm(scenes.gripper.pos - expect, dim=-1),
    )


def ik_ok(scenes: Scene) -> torch.Tensor:
    """Workspace-stability half of the episode health check (smg_env.py:251-258)."""
    return stepper.sim_stable(scenes.gripper)


def episode_done(objects_number, no_change_count, sim_ok, episode_succ,
                 episode_iter, cfg: EnvConfig) -> torch.Tensor:
    """Episode termination (smg_env.py:261-281); no_change_count (B, 2)."""
    return (
        (objects_number == 0)
        | (no_change_count.sum(dim=1) > cfg.no_change_limit)
        | ~sim_ok
        | (episode_succ >= cfg.max_episode_success)
        | (episode_iter >= cfg.step_limit)
    )
