"""Rank bodies for tests/test_torch_parallel.py; it holds no tests.

Each function runs in a spawned gloo CPU process (parallel/dryrun.py::
spawn_ranks) and imports neither JAX nor the test modules; rank 0 writes
what the test compares to a file with torch.save.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _flat_params(trainer) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()])


def _flat_stats(trainer) -> torch.Tensor:
    return torch.cat([b.reshape(-1) for name, b in trainer.model.named_buffers()
                      if "running" in name])


# Adam's epsilon in these tests (optax's default 1e-8 in production). At
# 1e-8 Adam's first step moves each weight by lr * sign(gradient), so a
# gradient that is zero but for rounding (a BatchNorm bias below a ReLU and
# another per-image BatchNorm) moves its weight by +-lr on the sign of its
# rounding noise, which any other summation order flips; at 1e-3 the step
# is linear in gradients below 1e-3, so the parameters after it measure
# how far the two runs' gradients agree.
ADAM_EPS = 1e-3


def loop_cfgs(n_scenes: int):
    """The parallel tests' training step: the dryrun's config (tiny trunk,
    float32, shortened phases and settles) at n_scenes, Adam eps ADAM_EPS."""
    from smg_tpu_torch.parallel.dryrun import dryrun_config

    train_cfg, loop_cfg = dryrun_config(n_scenes)
    return (dataclasses.replace(train_cfg, adam_eps=ADAM_EPS),
            dataclasses.replace(loop_cfg, batch_size=n_scenes))


def run_steps(trainer, loop_cfg, steps: int, scene_slice=None):
    """init_loop(0) and `steps` training steps, sharded when scene_slice
    is given: (losses, actions, rewards, params, stats)."""
    from smg_tpu_torch.parallel import sharded
    from smg_tpu_torch.train import loop

    state = loop.init_loop(0, trainer, loop_cfg, scene_slice)
    step = (sharded.make_sharded_step(trainer, loop_cfg) if scene_slice is not None
            else lambda s: loop.train_step(trainer, loop_cfg, s))
    losses, actions, rewards = [], [], []
    for _ in range(steps):
        state, m = step(state)
        losses.append(float(m.loss))
        actions.append(m.action.clone())
        rewards.append(m.reward.clone())
    return {"losses": losses, "actions": torch.stack(actions),
            "rewards": torch.stack(rewards), "params": _flat_params(trainer),
            "stats": _flat_stats(trainer)}


def steps_worker(r: int, n: int, out: str, n_scenes: int, steps: int) -> None:
    from smg_tpu_torch.parallel import mesh, sharded
    from smg_tpu_torch.train import loop
    from smg_tpu_torch.train.trainer import Trainer

    train_cfg, loop_cfg = loop_cfgs(n_scenes)
    res = run_steps(Trainer(train_cfg, device="cpu"), loop_cfg, steps,
                    mesh.scene_slice(n_scenes))
    # place_loop_state: the whole batch initialized, then cut, against
    # init_loop settling this rank's scenes only.
    trainer = Trainer(train_cfg, device="cpu")
    own = loop.init_loop(0, trainer, loop_cfg, mesh.scene_slice(n_scenes))
    placed = sharded.place_loop_state(loop.init_loop(0, trainer, loop_cfg))
    assert placed.scene_slice == own.scene_slice
    res["placed_err"] = max(
        float((getattr(placed.scenes.objects, f) - getattr(own.scenes.objects, f))
              .abs().max()) for f in ("pos", "quat", "vel", "omega"))
    if r == 0:
        torch.save(res, out)


def update_case(seed: int, styles, valid):
    """A tiny-trunk float32 Trainer with seeded weights and one Experience
    of len(styles) scenes, random depth and rectangle masks, and labels."""
    from smg_tpu_torch.models.affordance import ModelConfig
    from smg_tpu_torch.train.trainer import Experience, TrainConfig, Trainer

    trainer = Trainer(TrainConfig(model=ModelConfig(trunk="tiny", input_size=224,
                                                    dtype="float32"),
                                  adam_eps=ADAM_EPS), device="cpu")
    trainer.init_state(torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    B = len(styles)
    depth = (rng.rand(B, 224, 224) * 0.06).astype(np.float32)
    mask = np.zeros((B, 224, 224), bool)
    for b in range(B):
        y, x = rng.randint(20, 150, 2)
        mask[b, y:y + 50, x:x + 40] = True
    exp = Experience(scene_depth=torch.as_tensor(depth), exec_mask=torch.as_tensor(mask),
                     style=torch.as_tensor(np.asarray(styles, np.int32)),
                     valid=torch.as_tensor(np.asarray(valid, bool)))
    labels = torch.as_tensor(rng.uniform(-0.5, 2.5, B).astype(np.float32))
    return trainer, exp, labels


def update_results(trainer, loss) -> dict:
    return {"loss": float(loss), "params": _flat_params(trainer),
            "stats": _flat_stats(trainer)}


def update_worker(r: int, n: int, out: str, seed: int, styles, valid) -> None:
    """One Trainer.update on this rank's block of the experience, with the
    sharded step's Reducer."""
    from smg_tpu_torch.parallel import mesh, sharded
    from smg_tpu_torch.train.trainer import TrainerState

    trainer, exp, labels = update_case(seed, styles, valid)
    sl = mesh.scene_slice(len(styles))
    trainer.reducer = sharded.Reducer(len(styles))
    _, loss = trainer.update(TrainerState(0), exp.map(sl.cut), sl.cut(labels))
    if r == 0:
        torch.save(update_results(trainer, loss), out)


def small_cli_config(argv):
    """The CLI's ExperimentConfig for argv, cut as tests/test_torch_cli.py
    cuts it: one-layer dense blocks, 5- and 3-step settles, 3-step phases."""
    from smg_tpu_torch.envs.primitives import PrimitiveParams
    from smg_tpu_torch.utils import config as cfg_mod

    cfg = cfg_mod.parse_args(argv)
    short = PrimitiveParams(steps_move_above=3, steps_preclose=3, steps_descend=3,
                            steps_squeeze=3, steps_lift=3, steps_pad_align=3,
                            steps_finish=3)
    model = dataclasses.replace(cfg.train.model, block_config=(1, 1, 1, 1))
    env = dataclasses.replace(cfg.env, settle_steps=5)
    loop = dataclasses.replace(cfg.loop, env=env, reset_settle_steps=3, primitive=short)
    return dataclasses.replace(cfg, env=env, loop=loop,
                               train=dataclasses.replace(cfg.train, model=model))


def cli_worker(r: int, n: int, argv) -> None:
    """cli.main's run() on this rank, as under torchrun."""
    import os

    from smg_tpu_torch.cli import main as cli

    os.environ["WORLD_SIZE"] = str(n)
    cli.run(small_cli_config(argv))
