"""The batched multistage loop — main.py's per-step spine (port of smg_tpu/train/loop.py).

One train_step: observe -> segment -> score with the online net ->
arbitrate (epsilon-greedy out of testing) -> [training: labels for the
previous step (double-DQN through the target net, or reactive classes)
and one update on the previous step's experience, loop.py:232-257] ->
PE/OO geometry -> batched primitive execution -> counters -> auto-reset
with a settle. In testing (env.is_testing=True, the serving path) the step
makes no label and no update.

The port has only the batched executor (no LoopConfig.executor) and the
exact segmentation; its initial reset settles through the batched stepper
too (the JAX package's per-scene settle, loop.py:172-174, is pinned equal
to it).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from smg_tpu_torch.envs import batched as batched_env
from smg_tpu_torch.envs import primitives as prim
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.physics import scene as scene_mod
from smg_tpu_torch.physics import stepper
from smg_tpu_torch.physics.state import Scene, _Batched
from smg_tpu_torch.policy import arbitrate as arb
from smg_tpu_torch.policy.arbitrate import (
    ACTION_GRASP,
    ACTION_SUCTION,
    ActionChoice,
)
from smg_tpu_torch.train.trainer import Experience, Trainer, TrainerState


@dataclass(frozen=True)
class LoopConfig:
    env: env.EnvConfig = field(default_factory=env.EnvConfig)
    batch_size: int = 8
    explore_rate_decay: bool = False  # main.py:443
    reset_settle_steps: int = 100
    primitive: prim.PrimitiveParams = field(default_factory=prim.PrimitiveParams)


@dataclass
class EpisodeCounters(_Batched):
    no_change: torch.Tensor     # (B, 2) int32
    episode_iter: torch.Tensor  # (B,) int32
    episode_succ: torch.Tensor  # (B,) int32
    episode_idx: torch.Tensor   # (B,) int32

    @staticmethod
    def zeros(B: int, device) -> "EpisodeCounters":
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)  # noqa: E731
        return EpisodeCounters(no_change=z(B, 2), episode_iter=z(B),
                               episode_succ=z(B), episode_idx=z(B))


@dataclass
class PrevStep(_Batched):
    exp: Experience
    choice: ActionChoice
    outcome: env.StepOutcome
    objects_number: torch.Tensor  # (B,)


@dataclass
class LoopState:
    scenes: Scene
    trainer: TrainerState
    counters: EpisodeCounters
    prev: PrevStep
    generator: torch.Generator


@dataclass
class StepMetrics(_Batched):
    loss: torch.Tensor
    reward: torch.Tensor
    label_value: torch.Tensor
    predicted_value: torch.Tensor
    action: torch.Tensor
    explored: torch.Tensor
    best_pix: torch.Tensor
    objects_number: torch.Tensor
    episodes_done: torch.Tensor
    episode_iter: torch.Tensor
    episode_succ: torch.Tensor
    grasp_success: torch.Tensor
    suction_success: torch.Tensor
    gs_success: torch.Tensor
    color_hm0: torch.Tensor
    depth_hm0: torch.Tensor
    exec_mask0: torch.Tensor
    seg_masks0: torch.Tensor
    seg_boxes0: torch.Tensor
    seg_valid0: torch.Tensor


def blank_prev(B: int, device) -> PrevStep:
    """The prev_* carry before the first step (loop.py:127-152)."""
    zi = torch.zeros(B, dtype=torch.int32, device=device)
    zf = torch.zeros(B, device=device)
    z2 = torch.zeros(B, 2, dtype=torch.int32, device=device)
    zb = torch.zeros(B, dtype=torch.bool, device=device)
    exp = Experience(
        scene_depth=torch.zeros(B, 224, 224, device=device),
        exec_mask=torch.zeros(B, 224, 224, dtype=torch.bool, device=device),
        style=zi, valid=zb)
    choice = ActionChoice(
        action=zi, grasp_obj=zi, grasp_rot=zi, suction_obj=zi, suction_rot=zi,
        predicted_value=zf, explored=zb,
        best_pix=torch.zeros(B, 6, dtype=torch.int32, device=device),
        bestg_id=z2, bests_id=z2, bestgs_g_id=z2, bestgs_s_id=z2,
        bestgs_pair=z2, bestg_conf=zf, bests_conf=zf, bestgs_conf=zf,
        exploit_action=zi)
    outcome = env.StepOutcome(suction_success=zf, grasp_success=zf,
                              gs_success=zf, tip_divergence=zf)
    return PrevStep(exp=exp, choice=choice, outcome=outcome,
                    objects_number=zi)


def init_loop(seed: int, trainer: Trainer, cfg: LoopConfig) -> LoopState:
    """Fresh scenes, a seeded He-initialized online net, its target copy
    and a fresh optimizer (loop.py:166-181)."""
    device = trainer.device
    gen = torch.Generator(device=device).manual_seed(seed)
    scenes = env.reset(gen, cfg.batch_size, cfg.env, device)
    model_gen = torch.Generator(device=device).manual_seed(seed + 1)
    return LoopState(
        scenes=scenes, trainer=trainer.init_state(model_gen),
        counters=EpisodeCounters.zeros(cfg.batch_size, device),
        prev=blank_prev(cfg.batch_size, device), generator=gen,
    )


def train_step(trainer: Trainer, cfg: LoopConfig, state: LoopState,
               timer=None):
    """One step for the batch (loop.py:184-388): the act step, and out of
    testing the delayed labels and update on the previous step.

    `timer`, when given, is a callable timer(phase_name) that the step
    calls at the end of each phase (observe, score, [label, update,]
    geometry, execute, reset) — chip_smoke.py uses it for the per-phase
    times.
    """
    mark = timer or (lambda name: None)
    B = cfg.batch_size
    ecfg = cfg.env
    dev = state.scenes.device

    # --- Observe (main.py:108-117) ---
    obs = env.observe(state.scenes)
    scene_depths = env.masked_scene_depth(obs)
    masks = obs.seg.masks
    valid = obs.seg.valid
    mark("observe")

    # --- Score with the online net, arbitrate + explore (main.py:158-243) ---
    scores = trainer.score_scene_batch(state.trainer, scene_depths, masks, valid)
    explore_prob = arb.explore_probability(
        state.trainer.iteration, cfg.explore_rate_decay, ecfg.is_testing)
    choice = arb.select_action(
        scores.gra_conf, scores.suc_conf, scores.gs_conf, valid,
        obs.seg.centers, method=ecfg.method, is_ets=ecfg.is_ets,
        is_testing=ecfg.is_testing, explore_prob=explore_prob,
        generator=state.generator)
    mark("score")

    # --- Delayed training on the previous step (main.py:302-343) ---
    last = state.prev
    new_trainer = state.trainer
    if ecfg.is_testing:
        label_values = torch.zeros(B, device=dev)
        reward_values = trainer.current_reward(last.choice, last.outcome)
        loss = torch.zeros((), device=dev)
    else:
        if trainer.cfg.method == "reactive":
            label_values = trainer.reactive_labels(last.choice, last.outcome).float()
            reward_values = trainer.current_reward(last.choice, last.outcome)
        else:
            label_values, reward_values = trainer.dqn_labels(
                state.trainer, last.choice, last.outcome, last.objects_number,
                scene_depths, masks, choice)
        mark("label")
        new_trainer, loss = trainer.update(state.trainer, last.exp, label_values)
        mark("update")

    # --- Geometry + execute (main.py:245-294, 384-396) ---
    geom = env.compute_geometry(choice, obs, ecfg)
    mark("geometry")
    new_scenes, outcome = batched_env.execute_batched(
        state.scenes, choice, geom, cfg.primitive)
    mark("execute")

    # --- Counters (main.py:304-313, 420-422) ---
    succ_any = outcome.any_success
    is_suction = choice.action == ACTION_SUCTION
    nc = state.counters.no_change
    zero = torch.zeros_like(nc[:, 0])
    nc_suction = torch.where(is_suction, torch.where(succ_any, zero, nc[:, 1] + 1),
                             nc[:, 1])
    nc_grasp = torch.where(~is_suction, torch.where(succ_any, zero, nc[:, 0] + 1),
                           nc[:, 0])
    no_change = torch.stack([nc_grasp, nc_suction], dim=1)
    episode_iter = state.counters.episode_iter + 1
    episode_succ = state.counters.episode_succ + succ_any.to(torch.int32)

    # --- Episode termination + auto-reset (main.py:92-104,121) ---
    next_number = new_scenes.objects.on_table.sum(dim=1)
    sim_ok = env.ik_ok(new_scenes) & (outcome.tip_divergence < 0.1)
    done = env.episode_done(next_number, no_change, sim_ok, episode_succ,
                            episode_iter, ecfg)
    fresh = scene_mod.reset_scene(
        state.generator, B, dev, ecfg.is_cluttered, ecfg.is_testing, 0,
        catalogs=env.resolve_catalogs(ecfg))
    fresh = stepper.run_steps_batched(fresh, fresh.gripper,
                                      cfg.reset_settle_steps,
                                      cfg.primitive.stepper)
    scenes_next = new_scenes.where(done, fresh)
    zi = torch.zeros_like(episode_iter)
    counters_next = EpisodeCounters(
        no_change=torch.where(done[:, None], torch.zeros_like(no_change),
                              no_change),
        episode_iter=torch.where(done, zi, episode_iter),
        episode_succ=torch.where(done, zi, episode_succ),
        episode_idx=state.counters.episode_idx + done.to(torch.int32),
    )
    mark("reset")

    # --- This step's experience (the next update's sample) ---
    bidx = torch.arange(B, device=dev)
    mask_g = masks[bidx, choice.grasp_obj.long()]
    mask_s = masks[bidx, choice.suction_obj.long()]
    act = choice.action[:, None, None]
    exec_mask = torch.where(act == ACTION_GRASP, mask_g,
                            torch.where(act == ACTION_SUCTION, mask_s,
                                        mask_g | mask_s))
    style = torch.where(choice.action == ACTION_GRASP, 0,
                        torch.where(choice.action == ACTION_SUCTION, 1, 2))
    exp = Experience(scene_depth=scene_depths, exec_mask=exec_mask,
                     style=style.to(torch.int32), valid=valid.any(dim=1))
    prev = PrevStep(exp=exp, choice=choice, outcome=outcome,
                    objects_number=obs.seg.number)
    metrics = StepMetrics(
        loss=loss, reward=reward_values, label_value=label_values,
        predicted_value=choice.predicted_value, action=choice.action,
        explored=choice.explored, best_pix=choice.best_pix,
        objects_number=obs.seg.number, episodes_done=done,
        episode_iter=episode_iter, episode_succ=episode_succ,
        grasp_success=outcome.grasp_success,
        suction_success=outcome.suction_success,
        gs_success=outcome.gs_success,
        color_hm0=obs.color_hm[0], depth_hm0=obs.depth_hm[0],
        exec_mask0=exec_mask[0], seg_masks0=masks[0],
        seg_boxes0=obs.seg.boxes[0], seg_valid0=valid[0],
    )
    new_state = LoopState(scenes=scenes_next, trainer=new_trainer,
                          counters=counters_next, prev=prev,
                          generator=state.generator)
    return new_state, metrics
