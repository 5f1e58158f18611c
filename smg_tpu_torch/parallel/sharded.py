"""The sharded training step: the loop over ranks (port of
smg_tpu/parallel/sharded.py, as torch.distributed).

Each rank holds its SceneSlice of the batch (scenes, counters, the
previous step's experience) and a replica of both nets and Adam; its
generator is the one-process run's, so every draw of the batch is the
same on every rank and each keeps its scenes' part (train/loop.py). The
step is the one-process `train_step` with the collectives that make it
the same function, as XLA's partitioned program is
(tests/test_parallel.py:119-147):

- the update's normaliser is the global count of valid scenes, summed
  before `backward`; the gradients are summed over ranks before
  `opt.step()`, so every rank takes the same Adam step;
- the running statistics take the mean over all B scenes: the per-rank
  sums, summed (`Reducer.mean_stats`);
- the metrics come back whole: per-scene fields gathered in rank order,
  the loss summed, scene-0 imagery broadcast from rank 0.

`Reducer` is Trainer.update's hook; `make_sharded_step` installs it when
the world has more than one rank (with one, the update is the plain one).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from smg_tpu_torch.parallel import mesh
from smg_tpu_torch.train import loop as train_loop
from smg_tpu_torch.train.trainer import Trainer

# StepMetrics fields that carry no scene axis: the loss (summed by the
# update) and scene-0 imagery (rank 0's, which holds scene 0).
_IMAGERY = ("color_hm0", "depth_hm0", "exec_mask0", "seg_masks0", "seg_boxes0",
            "seg_valid0")


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor the backends reduce and move: bool as uint8."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t


class Reducer:
    """The update's collectives over the group (see the module docstring)."""

    def __init__(self, total: int):
        self.total = total   # scenes of the whole batch

    @staticmethod
    def all_sum(t: torch.Tensor) -> torch.Tensor:
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def sum_grads(params) -> None:
        """Sum every parameter's gradient over the ranks, in one flat buffer."""
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def mean_stats(self, model, per_scene: dict, B: int) -> dict:
        """The batch mean of the running statistics over all ranks' scenes:
        per_scene maps each BatchNorm this rank's update touched to its
        (mean, var) per scene, (B, C) each, untouched scenes holding the old
        value. A BatchNorm no rank touched keeps its statistics; one that
        another rank touched takes this rank's old value for its scenes."""
        bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        dev = bns[0].running_mean.device
        parts = [torch.tensor([float(bn in per_scene) for bn in bns], device=dev)]
        for bn in bns:
            for k, old in enumerate((bn.running_mean, bn.running_var)):
                ps = per_scene[bn][k] if bn in per_scene else old.expand(B, -1)
                parts.append(ps.sum(dim=0))
        flat = torch.cat(parts)
        dist.all_reduce(flat)
        touched, off, out = flat[:len(bns)], len(bns), {}
        for i, bn in enumerate(bns):
            c = bn.running_mean.numel()
            if touched[i] > 0:
                out[bn] = (flat[off:off + c] / self.total,
                           flat[off + c:off + 2 * c] / self.total)
            off += 2 * c
        return out


def gather_scenes(t: torch.Tensor) -> torch.Tensor:
    """Each rank's (b, ...) block -> the whole (world * b, ...) in rank order."""
    w = _wire(t.contiguous())
    parts = [torch.empty_like(w) for _ in range(mesh.world())]
    dist.all_gather(parts, w)
    return torch.cat(parts).to(t.dtype)


def _broadcast0(t: torch.Tensor) -> torch.Tensor:
    w = _wire(t.contiguous()).clone()
    dist.broadcast(w, src=0)
    return w.to(t.dtype)


def gather_metrics(m: train_loop.StepMetrics) -> train_loop.StepMetrics:
    """This rank's StepMetrics -> the whole batch's, the same on every rank."""
    out = {}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if f.name == "loss":
            out[f.name] = v
        elif f.name in _IMAGERY:
            out[f.name] = _broadcast0(v)
        else:
            out[f.name] = gather_scenes(v)
    return train_loop.StepMetrics(**out)


def place_loop_state(state: train_loop.LoopState) -> train_loop.LoopState:
    """A whole-batch LoopState (init_loop without a slice) cut to this
    rank's scenes. init_loop(..., scene_slice=mesh.scene_slice(B)) makes
    the same state and settles only the rank's scenes."""
    sl = mesh.scene_slice(state.scenes.batch_size)
    return dataclasses.replace(
        state, scenes=state.scenes.map(sl.cut), counters=state.counters.map(sl.cut),
        prev=state.prev.map(sl.cut), scene_slice=sl)


def make_sharded_step(trainer: Trainer, cfg: train_loop.LoopConfig):
    """step(state) -> (state, whole-batch metrics), for a state that holds
    this rank's scene slice. Installs the update's Reducer on the trainer
    when the world has more than one rank."""
    if mesh.world() > 1:
        trainer.reducer = Reducer(cfg.batch_size)

    def step(state: train_loop.LoopState, timer=None):
        if state.scene_slice is None or state.scene_slice.total != cfg.batch_size:
            raise ValueError("the sharded step takes a state with this rank's "
                             "scene_slice of cfg.batch_size (place_loop_state)")
        state, metrics = train_loop.train_step(trainer, cfg, state, timer)
        return state, gather_metrics(metrics)

    return step
