"""Data parallelism over processes: the scene batch split across ranks
(port of smg_tpu/parallel/mesh.py, as torch.distributed).

The JAX package shards the scene axis of one program over a device
mesh's `data` axis and replicates the model; XLA inserts the collectives.
Here each rank is a process on one device (a card, or the CPU) that holds
a contiguous block of the scenes (`scene_slice`) and a replica of the
nets and Adam; parallel/sharded.py adds the collectives the training step
needs.

- `init_data_parallel(world)`: the process group, NCCL on CUDA and gloo
  on the CPU, from the RANK / WORLD_SIZE / LOCAL_RANK (and MASTER_ADDR /
  MASTER_PORT) that torchrun sets, or an explicit rank and init_method;
- `rank()`, `world()`: 0 / 1 when no group is up;
- `device_for_rank(kind)`: cuda:LOCAL_RANK (made current), or the CPU;
- `scene_slice(B)`: this rank's SceneSlice of B scenes (B % world == 0,
  as the JAX CLI requires, smg_tpu/cli/main.py:264-267).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from smg_tpu_torch.physics.state import SceneSlice


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def device_for_rank(kind: str = "cuda") -> torch.device:
    """This rank's device: cuda:LOCAL_RANK (set as the current card), or
    the CPU. A cuda rank without its card raises."""
    if kind == "cpu":
        return torch.device("cpu")
    i = local_rank()
    if not torch.cuda.is_available() or i >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank()}: no CUDA device {i}")
    torch.cuda.set_device(i)
    return torch.device("cuda", i)


def init_data_parallel(world_size: int, device: str = "cuda", rank_: int | None = None,
                       init_method: str = "env://") -> torch.device:
    """Join a process group of world_size ranks; returns this rank's
    device. The rank comes from RANK (torchrun) unless given; a
    WORLD_SIZE in the environment must equal world_size."""
    env_world = os.environ.get("WORLD_SIZE")
    if env_world is not None and int(env_world) != world_size:
        raise SystemExit(f"WORLD_SIZE={env_world} but --data_parallel {world_size}")
    r = int(os.environ.get("RANK", 0)) if rank_ is None else rank_
    dev = device_for_rank(device) if device != "cpu" else torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, world_size=world_size, rank=r,
                                **({"device_id": dev} if dev.type == "cuda" else {}))
    return dev


def scene_slice(B: int) -> SceneSlice:
    """The contiguous block of B scenes this rank holds."""
    n = world()
    if B % n:
        raise ValueError(f"batch {B} is not divisible by the world size {n}")
    per = B // n
    return SceneSlice(rank() * per, (rank() + 1) * per, B)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
