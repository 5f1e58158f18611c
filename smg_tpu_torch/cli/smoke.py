"""Smoke test: one sense -> score -> act cycle, printed (port of
smg_tpu/cli/smoke.py).

The counterpart of the reference's connectivity check
(code/simulation/simpleTest.py: connect, count scene objects, stream a
value): there is no server to connect to, so the smoke test builds scenes
on the device, renders and segments them, picks each scene's action with
a freshly initialised network with the tiny trunk at input 224 (as the
JAX smoke test does, smg_tpu/cli/smoke.py:37), executes the primitives
and reports the outcomes.

    python -m smg_tpu_torch.cli.smoke [--batch 4] [--seed 0] [--cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from smg_tpu_torch.envs import batched as batched_env
from smg_tpu_torch.envs import primitives as prim
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.policy import arbitrate as arb
from smg_tpu_torch.train.trainer import TrainConfig, Trainer

ACTION_NAMES = {arb.ACTION_SUCTION: "suction", arb.ACTION_GRASP: "grasp",
                arb.ACTION_ETS: "grasp_then_suction"}


def smoke(trainer: Trainer, batch: int, seed: int,
          cfg: env.EnvConfig = env.EnvConfig(is_pe=True, is_oo=True),
          primitive: prim.PrimitiveParams = prim.DEFAULT) -> list[tuple[str, float]]:
    """Reset, observe, score, select (greedy), execute: (action name,
    reward) per scene, each printed."""
    dev = trainer.device
    trainer.init_state(torch.Generator(device=dev).manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    scenes = env.reset(gen, batch, cfg, dev)
    obs = env.observe(scenes)
    print(f"scene objects in view: {obs.seg.number.tolist()}  "
          f"(simpleTest.py:38 'number of objects in scene' parity)")
    with torch.no_grad():
        scores = trainer.score_scene_batch(
            None, env.masked_scene_depth(obs), obs.seg.masks, obs.seg.valid)
    choice = arb.select_action(
        scores.gra_conf, scores.suc_conf, scores.gs_conf, obs.seg.valid,
        obs.seg.centers, method=cfg.method, is_ets=cfg.is_ets, is_testing=True,
        explore_prob=0.0, generator=gen)
    geom = env.compute_geometry(choice, obs, cfg)
    _, outcome = batched_env.execute_batched(scenes, choice, geom, primitive)
    reward = (outcome.grasp_success + outcome.suction_success
              + outcome.gs_success).tolist()
    out = []
    for i, (a, r) in enumerate(zip(choice.action.tolist(), reward)):
        print(f"scene {i}: action={ACTION_NAMES[a]:<18} reward={r}")
        out.append((ACTION_NAMES[a], r))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    from smg_tpu_torch.cli.main import resolve_device

    t0 = time.time()
    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {dev}")
    trainer = Trainer(TrainConfig(model=ModelConfig(method="reinforcement", trunk="tiny",
                                                    input_size=224)), device=dev)
    smoke(trainer, args.batch, args.seed)
    print(f"smoke ok in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
