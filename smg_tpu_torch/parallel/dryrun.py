"""Two sharded training steps over n CPU processes (gloo): the port's
counterpart of `__graft_entry__.dryrun_multichip`.

    python -m smg_tpu_torch.parallel.dryrun 2

Each of the n ranks holds one scene of an n-scene batch and runs the
whole training step on it (tiny trunk, shortened primitive phases and
settles, as the JAX dryrun) through parallel/sharded.py; the update's
count, gradients and running statistics are summed over the ranks. Two
steps, because the first trains on the blank previous step (no valid
experience: loss exactly 0) and the second on real experience. Each rank
checks: iteration 2, finite losses, valid experience in step 2, and the
same weights as rank 0.
"""

from __future__ import annotations

import os
import socket
import sys

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    """A free localhost TCP port (a socket bound to port 0)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_config(n: int):
    """(TrainConfig, LoopConfig) of the dryrun: the JAX dryrun's (tiny
    trunk, no ETS, 6/4-step phases, settles of 20 and 10 steps), float32."""
    from smg_tpu_torch.envs.primitives import PrimitiveParams
    from smg_tpu_torch.envs.smg_env import EnvConfig
    from smg_tpu_torch.models.affordance import ModelConfig
    from smg_tpu_torch.train.loop import LoopConfig
    from smg_tpu_torch.train.trainer import TrainConfig

    env_cfg = EnvConfig(is_pe=True, is_oo=True, is_ets=False, method="reinforcement",
                        settle_steps=20)
    train_cfg = TrainConfig(model=ModelConfig(method="reinforcement", trunk="tiny",
                                              input_size=224, dtype="float32"),
                            method="reinforcement", is_ets=False, scene_chunk=n)
    loop_cfg = LoopConfig(env=env_cfg, batch_size=n, reset_settle_steps=10,
                          primitive=PrimitiveParams(
                              steps_move_above=6, steps_preclose=6, steps_descend=4,
                              steps_squeeze=4, steps_lift=4, steps_pad_align=4,
                              steps_finish=4))
    return train_cfg, loop_cfg


def _entry(r: int, fn, n: int, init_method: str, args) -> None:
    from smg_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_data_parallel(n, device="cpu", rank_=r, init_method=init_method)
    try:
        fn(r, n, *args)
    finally:
        mesh.shutdown()


def spawn_ranks(fn, n: int, *args, init_method: str | None = None) -> None:
    """Run fn(rank, n, *args) in n spawned CPU processes joined in a gloo
    group (a free localhost port unless init_method is given, e.g. a
    file:// store); raises if any rank fails. fn must be importable."""
    init_method = init_method or f"tcp://localhost:{free_port()}"
    mp.start_processes(_entry, args=(fn, n, init_method, args), nprocs=n, join=True,
                       start_method="spawn")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_rank(r: int, n: int) -> None:
    from smg_tpu_torch.parallel import mesh, sharded
    from smg_tpu_torch.train.loop import init_loop
    from smg_tpu_torch.train.trainer import Trainer

    train_cfg, loop_cfg = dryrun_config(n)
    trainer = Trainer(train_cfg, device="cpu")
    state = init_loop(0, trainer, loop_cfg, mesh.scene_slice(loop_cfg.batch_size))
    step = sharded.make_sharded_step(trainer, loop_cfg)
    state, m1 = step(state)
    state, m2 = step(state)
    _check(state.trainer.iteration == 2, f"iteration {state.trainer.iteration}")
    _check(bool(torch.isfinite(m1.loss)) and bool(torch.isfinite(m2.loss)), "losses")
    _check(m2.action.shape == (n,), f"metrics of {tuple(m2.action.shape)} scenes")
    valid = sharded.gather_scenes(state.prev.exp.valid)
    _check(bool(valid.any()), "step 2 should carry real experience")
    flat = torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()])
    ref = flat.clone()
    torch.distributed.broadcast(ref, src=0)
    _check(torch.equal(flat, ref), "the replicas' weights differ")
    if r == 0:
        print(f"dryrun_multichip ok: world={n} batch={loop_cfg.batch_size} "
              f"loss1={float(m1.loss):.4f} loss2={float(m2.loss):.4f}", flush=True)


def dryrun_multichip(n: int) -> None:
    """Two sharded training steps over n gloo CPU processes; raises if any
    rank fails."""
    spawn_ranks(_dryrun_rank, n)


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
