"""Experiment runner: the reference main.py, batched, on the card (port of
smg_tpu/cli/main.py).

Usage follows the reference (reference README.md:40-113), e.g.:

    python -m smg_tpu_torch.cli.main --is_sim --method reactive --is_pe \
        --is_oo --explore_rate_decay
    python -m smg_tpu_torch.cli.main --is_sim --method reinforcement \
        --is_ets --is_pe --is_oo --batch_size 32 --imagery_every 0
    python -m smg_tpu_torch.cli.main ... --continue_logging \
        --logging_directory logs/<ts>
    python -m smg_tpu_torch.cli.main ... --is_testing --load_snapshot \
        --snapshot_file logs/<ts>/models/snapshot

plus the batched-run knobs --batch_size N, --input_size 224|640 and
--trunk densenet121|tiny, --obj_mesh_dir <dir of enveloping/ + sucking/
.obj meshes>, --segmentation learned --segmenter_checkpoint P (a
cli.train_segmenter checkpoint), --pretrained_trunks P (a
cli.pretrain_trunks checkpoint: the trunks of both nets start from it,
after a resume as in the JAX package),
and --cpu to run on the CPU. Data parallelism over N cards:

    torchrun --nproc_per_node N -m smg_tpu_torch.cli.main ... \
        --batch_size B --data_parallel N

each rank on cuda:LOCAL_RANK with B / N of the scenes
(parallel/sharded.py); rank 0 alone writes the run tree, so it is the
tree of a one-process run. A run
writes the reference's run tree (utils/logger.py): info/config.json, the
ten transitions logs, scene-0 imagery every --imagery_every iterations,
checkpoints under models/ckpt every 50 training iterations and at the
end, and models/snapshot.

`main(argv)` parses the flags; `run(cfg)` takes an ExperimentConfig, so a
caller can change what no flag reaches (depth, phase lengths).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from smg_tpu_torch.core import camera as cam
from smg_tpu_torch.parallel import mesh, sharded
from smg_tpu_torch.perception import learned
from smg_tpu_torch.render import persp
from smg_tpu_torch.train import checkpoints
from smg_tpu_torch.train.loop import StepMetrics, init_loop, train_step
from smg_tpu_torch.train.trainer import Trainer
from smg_tpu_torch.utils import config as cfg_mod
from smg_tpu_torch.utils import vis as vis_mod
from smg_tpu_torch.utils.logger import Logger
from smg_tpu_torch.utils.profiling import PhaseTimer

# The per-scene fields of StepMetrics that the logs and the progress line
# read; with best_pix (6 columns), the loss and the episode count they are
# the 19 numbers a scene that one copy brings to the host each step.
_SCENE_FIELDS = ("reward", "label_value", "predicted_value", "action",
                 "explored", "episodes_done", "episode_iter", "episode_succ",
                 "grasp_success", "suction_success", "gs_success")


@dataclasses.dataclass
class HostMetrics:
    """One step's small metrics on the host, as float64 arrays (B,), with
    best_pix (B, 6), the loss and the completed episodes of all scenes."""

    reward: np.ndarray
    label_value: np.ndarray
    predicted_value: np.ndarray
    action: np.ndarray
    explored: np.ndarray
    episodes_done: np.ndarray
    episode_iter: np.ndarray
    episode_succ: np.ndarray
    grasp_success: np.ndarray
    suction_success: np.ndarray
    gs_success: np.ndarray
    best_pix: np.ndarray
    loss: float
    episodes: int


def fetch_metrics(m: StepMetrics, episode_idx: torch.Tensor) -> HostMetrics:
    """The small fields of a step's metrics in one device-to-host copy.
    float32 and integer values are exact in float64."""
    B = m.action.shape[0]
    cols = [getattr(m, name).to(torch.float64)[:, None] for name in _SCENE_FIELDS]
    cols += [m.best_pix.to(torch.float64),
             m.loss.to(torch.float64).expand(B)[:, None],
             episode_idx.to(torch.float64)[:, None]]
    a = torch.cat(cols, dim=1).cpu().numpy()
    n = len(_SCENE_FIELDS)
    return HostMetrics(**{name: a[:, i] for i, name in enumerate(_SCENE_FIELDS)},
                       best_pix=a[:, n:n + 6], loss=float(a[0, n + 6]),
                       episodes=int(a[:, n + 7].sum()))


def log_step_metrics(logger: Logger, m, iteration: int,
                     episode_base: int = 0) -> int:
    """Write the reference's ten transitions arrays for every scene in the
    batch (executed-action layout from main.py:368-377, etc.). `m` holds
    numpy arrays (HostMetrics, or any object with StepMetrics' fields).

    `episode_base` = globally completed episodes before this step (resume
    reads it from the episode_success log); returns the number of
    episodes that ended this step so the caller can advance it."""
    B = m.action.shape[0]
    act_rows = np.concatenate(
        [m.action[:, None].astype(np.float64), m.best_pix.astype(np.float64)],
        axis=1,
    )
    logger.write_to_log("executed-action", act_rows)
    logger.write_to_log("label-value", m.label_value[:, None])
    logger.write_to_log("reward-value", m.reward[:, None])
    logger.write_to_log("predicted-value", m.predicted_value[:, None])
    logger.write_to_log("use-heuristic", np.zeros((B, 1)))
    # Testing mode logs exploit=1 (the reference's explore_actions is
    # unbound in testing, main.py:242).
    logger.write_to_log(
        "is-exploit", (1 - m.explored.astype(np.float64))[:, None]
    )
    logger.write_to_log("grasping_type", m.action[:, None].astype(np.float64))
    logger.write_to_log("training_loss",
                        np.asarray([[iteration, float(m.loss)]]))
    done = np.nonzero(m.episodes_done)[0]
    if done.size:
        logger.write_to_log("clearance", np.full((done.size, 1), iteration))
        # [episode, episode_iter, episode_succ] (main.py:125-126); episodes
        # ending in the same batched step get sequential global numbers.
        logger.write_to_log(
            "episode_success",
            np.stack(
                [episode_base + np.arange(done.size, dtype=np.float64),
                 m.episode_iter[done].astype(np.float64),
                 m.episode_succ[done].astype(np.float64)], axis=1,
            ),
        )
    return int(done.size)


def save_step_imagery(logger: Logger, metrics: StepMetrics, iteration: int) -> None:
    """Scene-0 heightmaps + segmentation/action overlays (the reference
    saves these every iteration: logger.py:94-115, main.py:252-294)."""
    np_ = lambda t: t.detach().cpu().numpy()  # noqa: E731
    color = np_(metrics.color_hm0)
    logger.save_heightmaps(iteration, color, np_(metrics.depth_hm0))
    overlay = vis_mod.overlay_masks(color, np_(metrics.seg_masks0),
                                    np_(metrics.seg_boxes0), np_(metrics.seg_valid0))
    # Tint the executed object(s) red over the instance overlay (the
    # reference's action visualization).
    exec_mask = np_(metrics.exec_mask0)
    overlay[exec_mask] = 0.5 * overlay[exec_mask] + np.array(
        [0.5, 0.0, 0.0], np.float32
    )
    logger.save_visualizations(iteration, overlay, "action")


def save_step_rgbd(logger: Logger, state, iteration: int) -> None:
    """Scene-0 camera RGB-D frame, 480 x 640 (the reference saves the
    sensor's images every iteration, logger.py:87-92 called at
    main.py:136-138)."""
    obj0 = state.scenes.objects.map(lambda x: x[0])
    color, depth = persp.render_rgbd(obj0, cam.Camera.overhead())
    logger.save_images(iteration, color.cpu().numpy(), depth.cpu().numpy())


def resolve_device(name: str) -> torch.device:
    """The run's device; a cuda run without a card stops here."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (--cpu runs on the CPU)")
    return dev


def _completed_episodes(logger: Logger) -> int:
    """Rows of the reused run's episode_success log: the global episode
    numbering continues from there (the reference restarted it)."""
    return logger.read_log("episode_success").shape[0]


def run(cfg: cfg_mod.ExperimentConfig) -> dict:
    """Train or test until the episode target (or max_iterations); returns
    the run directory (None on ranks other than 0), the iterations and
    episodes done and the phase times."""
    parallel = cfg.data_parallel > 1 or "WORLD_SIZE" in os.environ
    if parallel:
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"--data_parallel {cfg.data_parallel}: launch with torchrun "
                             f"--nproc_per_node {cfg.data_parallel} -m smg_tpu_torch.cli.main")
        dev = mesh.init_data_parallel(cfg.data_parallel, torch.device(cfg.device).type)
    else:
        dev = resolve_device(cfg.device)
    lead = mesh.rank() == 0
    if lead:
        print(f"device: {dev}"
              + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
              + (f", data-parallel world {mesh.world()}" if parallel else ""))
    if cfg.env.segmentation == "learned" and cfg.loop.segmenter is None:
        # The trained SlotSegmenter becomes the observation front end (the
        # Mask-R-CNN-parity path, reference main.py:139).
        if not cfg.segmenter_checkpoint:
            raise SystemExit("--segmentation learned requires --segmenter_checkpoint")
        seg = learned.load_segmenter(cfg.segmenter_checkpoint, dev)
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, segmenter=seg))
        if lead:
            print(f"segmenter loaded from: {cfg.segmenter_checkpoint}")
    trainer = Trainer(cfg.train, device=dev)
    logger = Logger(cfg.continue_logging, cfg.logging_directory) if lead else None
    try:
        return _run(cfg, trainer, logger, parallel)
    finally:
        if logger is not None:
            logger.close()
        mesh.shutdown()


def _run(cfg, trainer: Trainer, logger: Logger | None, parallel: bool) -> dict:
    """The run; `logger` is None on the ranks other than 0, which write
    nothing (their print is silenced too) and read the checkpoints of the
    reused run directory on resume."""
    lead = logger is not None
    say = print if lead else (lambda *a, **k: None)
    if lead:
        logger.save_camera_info(cam.DEFAULT_INTRINSICS, np.eye(4), 1.0)
        logger.save_heightmap_info(cam.WORKSPACE_LIMITS, cam.HEIGHTMAP_RESOLUTION)
        logger.save_config(cfg.to_dict())
        ckpt = checkpoints.CheckpointManager(os.path.join(logger.models_directory, "ckpt"))
    elif cfg.continue_logging:
        ckpt = checkpoints.CheckpointManager(os.path.join(
            os.path.abspath(cfg.logging_directory), "models", "ckpt"))

    say("initializing scenes + model...")
    scene_slice = mesh.scene_slice(cfg.loop.batch_size) if parallel else None
    state = init_loop(cfg.seed, trainer, cfg.loop, scene_slice)
    iteration = 0
    episode_base = 0
    if cfg.continue_logging:
        episode_base = _completed_episodes(logger) if lead else 0
        # Restore the latest checkpoint of the reused run, optimizer
        # included, and number on from its iteration, so later saves stay
        # monotone (the reference re-parsed its logs, trainer.py:118-158).
        latest = ckpt.latest_step()
        if latest is not None:
            state.trainer = ckpt.restore(trainer)
            iteration = state.trainer.iteration
            say(f"Resumed trainer state from checkpoint step {latest}"
                f" (iteration {iteration})")

    if cfg.pretrained_trunks:
        # The self-supervised warm start where the reference loaded
        # ImageNet weights (models.py:22-24,308-310), in the JAX package's
        # order (smg_tpu/cli/main.py:174-228): after a resume, whose Adam
        # moments and iteration stay, the trunks of the online net become
        # the pretrained one and the target net its copy; a snapshot
        # loaded next wins.
        checkpoints.load_pretrained(trainer, cfg.pretrained_trunks)
        say(f"pretrained trunks loaded from: {cfg.pretrained_trunks}")

    if cfg.load_snapshot and cfg.snapshot_file:
        # Params + BatchNorm running statistics into both nets (the
        # reference's state_dict includes BN buffers, logger.py:121-123).
        checkpoints.load_snapshot(trainer, cfg.snapshot_file)
        say(f"Pre-trained model snapshot loaded from: {cfg.snapshot_file}")
    step_fn = (sharded.make_sharded_step(trainer, cfg.loop) if parallel else
               (lambda s: train_step(trainer, cfg.loop, s)))

    testing = cfg.env.is_testing
    episode_target = cfg.testing_episode if testing else cfg.training_episode
    dev = trainer.device
    episodes = 0
    t_start = time.time()
    timer = PhaseTimer()
    while True:
        with timer.phase("step", block_on=dev):
            state, metrics = step_fn(state)
        with timer.phase("device_get"):
            episode_idx = state.counters.episode_idx
            if parallel:
                episode_idx = sharded.gather_scenes(episode_idx)
            host = fetch_metrics(metrics, episode_idx)
        iteration += 1
        episodes = host.episodes
        if lead:
            with timer.phase("log"):
                episode_base += log_step_metrics(logger, host, iteration, episode_base)
                if cfg.imagery_every and iteration % cfg.imagery_every == 0:
                    save_step_imagery(logger, metrics, iteration)
                    save_step_rgbd(logger, state, iteration)
        succ_rate = float(((host.grasp_success > 0) | (host.suction_success > 0)
                           | (host.gs_success > 0)).mean())
        say(f"{'Testing' if testing else 'Training'} iteration: {iteration}"
            f" | episodes: {episodes} | loss: {host.loss:.4f} | success-rate:"
            f" {succ_rate:.3f} | {time.time() - t_start:.1f}s", flush=True)
        if lead and not testing:
            ckpt.maybe_save(iteration, trainer, state.trainer)
        if episodes >= episode_target:
            break
        if 0 < cfg.max_iterations <= iteration:
            break

    if not lead:
        return {"run_dir": None, "iterations": iteration, "episodes": episodes,
                "phases": timer.summary()}
    if not testing:
        ckpt.save(iteration, trainer, state.trainer)
        # The snapshot for --is_testing --load_snapshot: params + BN
        # running statistics (reference logger.save_model, logger.py:121-123).
        snap = os.path.join(logger.models_directory, "snapshot")
        checkpoints.save_params(snap, trainer.model)
        print(f"snapshot: {snap}")
    logger.flush()
    print(timer.report())
    print(f"done: {iteration} iterations, {episodes} episodes")
    return {"run_dir": logger.base_directory, "iterations": iteration,
            "episodes": episodes, "phases": timer.summary()}


def main(argv=None) -> None:
    run(cfg_mod.parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
