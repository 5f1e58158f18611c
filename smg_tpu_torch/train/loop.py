"""The batched multistage loop — main.py's per-step spine (port of smg_tpu/train/loop.py).

One train_step: observe -> segment -> score with the online net ->
arbitrate (epsilon-greedy out of testing) -> [training: labels for the
previous step (double-DQN through the target net, or reactive classes)
and one update on the previous step's experience, loop.py:232-257] ->
PE/OO geometry -> batched primitive execution -> counters -> auto-reset
with a settle. In testing (env.is_testing=True, the serving path) the step
makes no label and no update.

Segmentation is the renderer's exact id buffers, or with
env.segmentation="learned" the SlotSegmenter of LoopConfig.segmenter,
one batched forward per step (loop.py:193-209).

LoopConfig.executor picks the physics of execution and of the settles
(loop.py:47-50,263-275,305-318): "batched" runs envs/batched.py on the K1
stepper; "vmap" runs the per-scene path, smg_env.execute with the dense
contacts of physics/contact.py, and settles the initial and the
auto-reset scenes through stepper.run_steps. "auto" is "batched" on every
device: the JAX package picks "vmap" off the TPU only because its batched
path needs a Pallas kernel there, while the port's batched path runs K1 on
the card and K1's plain version on the CPU.

Under data parallelism (parallel/sharded.py) LoopState.scene_slice says
which scenes of cfg.batch_size this process holds: the state carries
only those, and every random draw shaped by the batch (the spawn, the
epsilon-greedy draws) is made for the whole batch and cut to them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch

from smg_tpu_torch.envs import batched as batched_env
from smg_tpu_torch.envs import primitives as prim
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.perception import learned
from smg_tpu_torch.physics import scene as scene_mod
from smg_tpu_torch.physics import stepper
from smg_tpu_torch.physics.state import Scene, SceneSlice, _Batched
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
    # "auto" | "batched" | "vmap" (see the module docstring).
    executor: str = "auto"
    # The learned front end (a SlotSegmenter) read when env.segmentation
    # == "learned"; frozen during grasp training (it trains separately,
    # cli/train_segmenter.py). Left out of eq and hash.
    segmenter: learned.SlotSegmenter | None = field(default=None, compare=False,
                                                   hash=False)


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
    scene_slice: SceneSlice | None = None   # None: all cfg.batch_size scenes


EXECUTORS = ("auto", "batched", "vmap")


def resolve_executor(cfg: LoopConfig) -> str:
    """"batched" or "vmap" ("auto" is "batched", see the module docstring)."""
    if cfg.executor not in EXECUTORS:
        raise ValueError(f"LoopConfig.executor {cfg.executor!r}: one of {EXECUTORS}")
    return "vmap" if cfg.executor == "vmap" else "batched"


def _run_steps(cfg: LoopConfig):
    """The stepper of the settles: per scene under "vmap", else K1's."""
    if resolve_executor(cfg) == "vmap":
        return stepper.run_steps
    return stepper.run_steps_batched


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


def init_loop(seed: int, trainer: Trainer, cfg: LoopConfig,
              scene_slice: SceneSlice | None = None) -> LoopState:
    """Fresh scenes, a seeded online net (Flax's default init), its target copy
    and a fresh optimizer (loop.py:166-181); with scene_slice, that slice
    of the batch's scenes."""
    device = trainer.device
    gen = torch.Generator(device=device).manual_seed(seed)
    scenes = env.reset(gen, cfg.batch_size, cfg.env, device, scene_slice,
                       run=_run_steps(cfg))
    model_gen = torch.Generator(device=device).manual_seed(seed + 1)
    B = scenes.batch_size
    return LoopState(
        scenes=scenes, trainer=trainer.init_state(model_gen),
        counters=EpisodeCounters.zeros(B, device),
        prev=blank_prev(B, device), generator=gen, scene_slice=scene_slice,
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
    B = state.scenes.batch_size
    ecfg = cfg.env
    executor = resolve_executor(cfg)
    dev = state.scenes.device

    # --- Observe (main.py:108-117) ---
    seg_fn = None
    if ecfg.segmentation == "learned":
        if cfg.segmenter is None:
            raise ValueError("env.segmentation == 'learned' requires "
                             "LoopConfig.segmenter = a SlotSegmenter")
        seg_fn = functools.partial(learned.predict_segmentation, cfg.segmenter)
    obs = env.observe(state.scenes, seg_fn)
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
        generator=state.generator, scene_slice=state.scene_slice)
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
    execute = env.execute if executor == "vmap" else batched_env.execute_batched
    new_scenes, outcome = execute(state.scenes, choice, geom, cfg.primitive)
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
        state.generator, cfg.batch_size, dev, ecfg.is_cluttered, ecfg.is_testing,
        cfg.reset_settle_steps, cfg.primitive.stepper,
        catalogs=env.resolve_catalogs(ecfg), scene_slice=state.scene_slice,
        run=_run_steps(cfg))
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
                          generator=state.generator, scene_slice=state.scene_slice)
    return new_state, metrics
