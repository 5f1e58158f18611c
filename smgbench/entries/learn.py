"""The learn entry: one learner update on a batch of executed experiences.

A call is `Trainer.update` on B experiences (the executed style's trunk
in train mode on each scene and its executed mask, the head, the Huber
loss against the labels, backward, Adam, the BatchNorm running
statistics), ending with the loss read back to the host as the CLI logs
it. Experiences come from a pool made at set-up and are used in turn; the
weights and Adam's state evolve across the window as in training.

Set-up builds the one Trainer, loads the benchmark's weights, and drives
it through `warmup_calls` updates, one on each pool batch, through the
window's own call: every shape the window uses. The first `check_steps`
of them are what is judged, once the window has closed, against the
plain float32 update (`smgbench/reference/train.py`) from the same weights
on the same batches:

- `grad_median`: over the parameter leaves, the gap between the norm of
  the first gradient as Adam got it (its first moment after one step over
  1 - beta1) and the reference's, over the larger of the reference's norm
  of that leaf and of the median leaf; the median leaf's gap.
- `change_gap`: the same of the norm of each leaf's change after the
  checked steps; the worst leaf's gap.
- `stats_gap`, `stats_median`: the same of the norm of each BatchNorm
  running mean's and running variance's change after the checked steps;
  the worst buffer's gap, and the median buffer's.

Leaves whose reference gradient stays under a thousandth of the median
leaf's in every checked step (the heads and trunks no experience used;
the ETS style's own head while it is tied to suction's) move by rounding
alone and are left out; so are the buffers whose reference change is
under a thousandth of the median buffer's.

`smgbench.readings` also reports, not compared, the worst leaf's
gradient gap and the checked steps' loss gaps.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from smgbench import bounds, traffic, weights
from smgbench.entries.decide import build_program
from smgbench.reference import train as ref_train

HERE = Path(__file__).resolve().parents[1]
KEEP = 1e-3


@dataclass
class State:
    config: dict
    cell: dict
    trainer: object
    tstate: object
    pool: list
    weights: dict
    flops: float           # useful FLOPs of one update
    losses: list           # the checked steps' losses
    first_grad: dict       # name -> norm of the first gradient Adam got
    change: dict           # name -> norm of the change after the checked steps
    stats: dict            # buffer name -> norm of its change after the checked steps


def experience_pool(spec: dict, cell: dict, seed: int, device) -> list:
    scene_spec = spec.get("scene_spec") or traffic_spec(spec["scene_traffic"])
    labels = torch.tensor([float(x) for x in (HERE / "traffic" / spec["labels_file"])
                           .read_text().split()], dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    return [traffic.make_experiences(spec, scene_spec, labels, cell["batch"], gen, device)
            for _ in range(cell["pool_batches"])]


def traffic_spec(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def call(st: State, i: int, span) -> float:
    from smg_tpu_torch.train.trainer import Experience

    ex = st.pool[i % len(st.pool)]
    with span("update"):
        exp = Experience(scene_depth=ex.scene_depth, exec_mask=ex.exec_mask, style=ex.style,
                         valid=torch.ones_like(ex.style, dtype=torch.bool))
        st.tstate, loss = st.trainer.update(st.tstate, exp, ex.labels)
    with span("fetch"):
        return float(loss)


def setup(config: dict, cell: dict, spec: dict, seed: int, device) -> State:
    from smg_tpu_torch.train.trainer import TrainerState

    t0 = time.perf_counter()
    trainer, _ = build_program(config, device)
    w = weights.make(config, seed + 1, device)
    trainer.model.load_state_dict(w, strict=True)
    trainer.target.load_state_dict(w, strict=True)
    t1 = time.perf_counter()
    pool = experience_pool(spec, cell, seed, device)
    arch, size = config["architecture"], config["model"]["input_size"]
    per = 3 * (2 * bounds.trunk_flops(arch, size)
               + bounds.head_flops(arch, size, weights.trunk_channels(arch)))
    st = State(config=config, cell=cell, trainer=trainer, tstate=TrainerState(), pool=pool,
               weights=w, flops=per * cell["batch"], losses=[], first_grad={}, change={},
               stats={})
    print(f"set-up seconds: program {t1 - t0:.3f}, traffic {time.perf_counter() - t1:.3f}",
          file=sys.stderr)
    return st


def warm(st: State, span) -> None:
    """The first updates, one on each pool batch; the checked ones' loss,
    first gradient, change and running statistics' change kept."""
    named = dict(st.trainer.model.named_parameters())
    b1 = st.config["train"]["adam_b1"]
    for i in range(st.cell["warmup_calls"]):
        loss = call(st, i, span)
        if i < st.cell["check_steps"]:
            st.losses.append(loss)
        if i == 0:
            opt = st.trainer.opt
            st.first_grad = {k: float(opt.state[p]["exp_avg"].norm()) / (1 - b1)
                             for k, p in named.items()}
        if i == st.cell["check_steps"] - 1:
            with torch.no_grad():
                st.change = {k: float((p - st.weights[k]).norm()) for k, p in named.items()}
                st.stats = {k: float((b - st.weights[k]).norm())
                            for k, b in st.trainer.model.named_buffers()
                            if k.endswith(("running_mean", "running_var"))}


def scenes_of(st: State, loss) -> int:
    return st.cell["batch"]


def flops_of(st: State, loss) -> float:
    return st.flops


def release(st: State, answers: list, seed: int) -> list:
    """The checked steps were read at set-up; the program's state freed."""
    st.trainer = None
    answers.clear()
    return []


def _gap(prog: dict, ref: dict, keep, worst: bool = True) -> float:
    """The gap of the norms prog against ref, each over the larger of the
    leaf's and the median leaf's reference norm, over `keep`: the worst
    leaf's, or the median leaf's."""
    med = ref_train.median([ref[k] for k in keep])
    gaps = sorted(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)
    if not gaps:
        return 0.0
    return gaps[-1] if worst else gaps[len(gaps) // 2]


def reference(st: State, rnd=None):
    """The reference's (losses, first gradient norms, kept leaves, change
    norms, running statistics' change norms) over the checked steps."""
    upd = ref_train.Update(st.weights, st.config, rnd)
    losses, grads = [], []
    for i in range(st.cell["check_steps"]):
        ex = st.pool[i]
        loss, g = upd.step(ex.scene_depth, ex.exec_mask, ex.style, ex.labels)
        losses.append(loss)
        grads.append(ref_train.norms(g))
    first = grads[0]
    med = ref_train.median(first.values())
    keep = [k for k in upd.names if max(g[k] for g in grads) >= KEEP * med]
    return losses, first, keep, upd.change(st.weights), upd.stats_change(st.weights)


def judge_against(st: State, first_grad, change, stats, ref) -> dict:
    """The compared numbers of (first gradient, change, statistics' change)
    norms against the reference's."""
    _, r_first, keep, r_change, r_stats = ref
    grad_keep = [k for k in keep if r_first[k] >= KEEP * ref_train.median(r_first.values())]
    stats_med = ref_train.median(r_stats.values())
    stats_keep = [k for k, v in r_stats.items() if v >= KEEP * stats_med]
    return {"grad_median": _gap(first_grad, r_first, grad_keep, worst=False),
            "change_gap": _gap(change, r_change, keep),
            "stats_gap": _gap(stats, r_stats, stats_keep),
            "stats_median": _gap(stats, r_stats, stats_keep, worst=False)}


def _reported(losses, first_grad, ref) -> dict:
    """Readings reported beside the compared ones and not compared: the
    worst leaf's gradient gap and the checked steps' loss gaps."""
    r_losses, r_first, keep = ref[:3]
    grad_keep = [k for k in keep if r_first[k] >= KEEP * ref_train.median(r_first.values())]
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
    return {"grad_gap": _gap(first_grad, r_first, grad_keep), "loss_gaps": loss_gaps}


def judge(st: State, outs: list) -> dict:
    return judge_against(st, st.first_grad, st.change, st.stats, reference(st))


def control_reading(st: State, seed: int, span) -> dict:
    """The control in the program's place (readings.py): the reference
    update with every conv's operands and output rounded to fp8 e4m3 in the
    forward pass."""
    from smgbench.reference import densenet as dn

    release(st, [], seed)
    ref, ctl = reference(st), reference(st, dn.fp8_rounding)
    return {**judge_against(st, ctl[1], ctl[3], ctl[4], ref),
            **_reported(ctl[0], ctl[1], ref)}


def program_reading(st: State, seed: int, span) -> dict:
    """The comparison of a run with this seed (readings.py)."""
    warm(st, span)
    release(st, [], seed)
    ref = reference(st)
    return {**judge_against(st, st.first_grad, st.change, st.stats, ref),
            **_reported(st.losses, st.first_grad, ref)}


def half_batch_reading(st: State, seed: int, span) -> dict:
    """A planted fault, in the reference put in the program's place: each
    checked step takes the first half of its batch, the mean over those."""
    release(st, [], seed)
    h = st.cell["batch"] // 2
    full = reference(st)
    pool = st.pool
    st.pool = [traffic.Experiences(e.scene_depth[:h], e.exec_mask[:h], e.style[:h],
                                   e.labels[:h]) for e in pool]
    half = reference(st)
    st.pool = pool
    return {**judge_against(st, half[1], half[3], half[4], full),
            **_reported(half[0], half[1], full)}
