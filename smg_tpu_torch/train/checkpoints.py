"""Checkpoint / resume on torch.save (port of smg_tpu/train/checkpoints.py).

The reference checkpoints only the model state_dict (every 50 iterations,
reference logger.py:121-125, main.py:347-362) and loses the optimizer
state across restarts. Here a checkpoint carries the whole trainer: the
online and target nets' state_dicts (BatchNorm buffers included), the
Adam state_dict and the iteration, so a resumed run continues learning
where it stopped. Scenes, episode counters and the loop's generator start
anew on resume: episodes are i.i.d. draws, so this changes nothing
statistically, but resume is not a bit-identical replay.

Every file is written under a temporary name and then renamed, so a
half-written checkpoint is never the latest. A checkpoint is read onto the
CPU and copied into the trainer's own tensors, so it loads onto the
trainer's device whichever device saved it (Adam's step counts stay on
the CPU, where torch.optim.Adam keeps them).

- `CheckpointManager(directory, save_every=50, max_to_keep=5)`: the
  checkpoints `<directory>/<step>.pt`, with `maybe_save`, `save`,
  `latest_step` and `restore`;
- `save_params` / `load_params`: one state_dict, the `models/snapshot` of
  a training run (the online net's params and BatchNorm running
  statistics, smg_tpu/cli/main.py:329-340); `load_snapshot` puts one into
  a trainer's online and target nets, as `--load_snapshot --snapshot_file`
  does (main.py:222-246);
- `load_pretrained`: a cli.pretrain_trunks checkpoint (a
  ReconstructionModel's save_params file) into the three trunks of the
  online net and then the whole online net into the target, as
  `--pretrained_trunks` does (main.py:204-228). It copies into the
  parameters in place, so the optimizer's state (keyed by parameter, as
  restored by a resume before it) stays.
"""

from __future__ import annotations

import os
import re

import torch

from smg_tpu_torch.train.trainer import Trainer, TrainerState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _atomic_save(obj, path: str) -> None:
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Numbered trainer checkpoints with the reference's cadence knobs."""

    def __init__(self, directory: str, save_every: int = 50,
                 max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_every = save_every
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def steps(self) -> list[int]:
        """The saved steps, ascending."""
        found = (_STEP_FILE.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def maybe_save(self, step: int, trainer: Trainer, state: TrainerState) -> bool:
        """Save every `save_every` steps (main.py:354-360 cadence)."""
        if step % self.save_every != 0:
            return False
        self.save(step, trainer, state)
        return True

    def save(self, step: int, trainer: Trainer, state: TrainerState) -> None:
        _atomic_save({"model": trainer.model.state_dict(),
                      "target": trainer.target.state_dict(),
                      "optimizer": trainer.opt.state_dict(),
                      "iteration": state.iteration}, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, trainer: Trainer, step: int | None = None) -> TrainerState:
        """Load a checkpoint (the latest by default) into `trainer`'s nets
        and a fresh Adam; returns its TrainerState."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        ckpt = torch.load(self._path(step), map_location="cpu", weights_only=True)
        trainer.model.load_state_dict(ckpt["model"])
        trainer.target.load_state_dict(ckpt["target"])
        trainer.opt = trainer.new_optimizer()
        trainer.opt.load_state_dict(ckpt["optimizer"])
        return TrainerState(iteration=int(ckpt["iteration"]))


def save_params(path: str, module: torch.nn.Module) -> None:
    """One net's state_dict (params and BatchNorm buffers) to `path`."""
    _atomic_save(module.state_dict(), os.path.abspath(path))


def load_params(path: str) -> dict:
    """A save_params file as a state_dict on the CPU (load_state_dict
    copies it onto the module's device)."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def load_snapshot(trainer: Trainer, path: str) -> None:
    """A snapshot into both the online and the target net."""
    state = load_params(path)
    trainer.model.load_state_dict(state)
    trainer.target.load_state_dict(state)


def load_pretrained(trainer: Trainer, path: str) -> None:
    """A pretrained trunk into all three trunks of both nets, in place
    (load_state_dict copies into the existing tensors)."""
    from smg_tpu_torch.train.pretrain import load_pretrained_trunks

    load_pretrained_trunks(trainer.model, load_params(path))
    trainer.target.load_state_dict(trainer.model.state_dict())
