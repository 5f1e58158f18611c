"""A whole run of a decide cell at a size a CPU test holds, the control and
the planted faults that `correct` must catch, and the command's refusals.
The card-only case runs the real cell for a few seconds."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from smgbench import readings
from smgbench import run as bench_run
from smgbench.tests.helpers import tiny

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
DECIDE = [c for c in CELLS if c.startswith("decide.")]
LEARN = [c for c in CELLS if c.startswith("learn.")]
SEED = 2**31 + 2**30 + 5


def _run(cell, seed=SEED, trace=False, override=tiny):
    return bench_run.run_cell(cell, seed, 1.0, trace, BENCH, device="cpu",
                              cell_override=override)


def tiny_f32(cell, config, spec):
    """The tiny cell computing in float32: the program then meets the
    float32 reference to rounding, so only a fault can fail it."""
    cell, config, spec = tiny(cell, config, spec)
    config["model"]["dtype"] = "float32"
    return cell, config, spec


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell):
    result, checks = _run(cell, override=tiny_f32 if cell in LEARN else tiny)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    e2e = {m["name"] for m in bench_run.metrics_of(BENCH, cell, False)}
    assert set(result["metrics"]) == e2e
    assert all(v["value"] > 0 for v in result["metrics"].values())
    limits = json.loads((ROOT / "smgbench" / "workloads" / f"{cell}.json").read_text())["limits"]
    assert set(checks) == set(limits)


@pytest.mark.parametrize("cell", DECIDE[:1] + LEARN[:1])
def test_control_is_not_correct(cell):
    """The reference at fp8 (with its geometry in bf16), in the program's
    place, fails the cell's limits."""
    override = tiny_f32 if cell in LEARN else tiny
    _, ctl, _ = readings.readings(cell, [], [11, 12], device="cpu", cell_override=override)
    limits = json.loads((ROOT / "smgbench" / "workloads" / f"{cell}.json").read_text())["limits"]
    for row in ctl:
        assert any(row[k] > v for k, v in limits.items()), row


def _answer_altered(monkeypatch):
    from smg_tpu_torch.policy import arbitrate as arb

    inner = arb.select_action

    def altered(*args, **kw):
        choice = inner(*args, **kw)
        choice.action[0] = (choice.action[0] + 1) % 3
        return choice

    monkeypatch.setattr(arb, "select_action", altered)


def _half_batch_left_out(monkeypatch):
    """Only the first half of the scenes is scored; the rest repeat it."""
    from smg_tpu_torch.train.trainer import SceneScores, Trainer

    inner = Trainer.score_scene_batch

    def half(self, state, depth, masks, valid):
        h = (depth.shape[0] + 1) // 2
        s = inner(self, state, depth[:h], masks[:h], valid[:h])
        rep = lambda t: t.repeat((2,) + (1,) * (t.dim() - 1))[:depth.shape[0]]  # noqa: E731
        return SceneScores(gra_conf=rep(s.gra_conf), suc_conf=rep(s.suc_conf),
                           gs_conf=rep(s.gs_conf))

    monkeypatch.setattr(Trainer, "score_scene_batch", half)


def _pose_altered(monkeypatch):
    from smg_tpu_torch.envs import smg_env

    inner = smg_env.compute_geometry

    def moved(*args, **kw):
        g = inner(*args, **kw)
        return g.replace(grasp_position=g.grasp_position + 0.01)

    monkeypatch.setattr(smg_env, "compute_geometry", moved)


@pytest.mark.parametrize("fault", [_answer_altered, _half_batch_left_out, _pose_altered])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = _run(DECIDE[0], seed=SEED + 1)
    assert result["correct"] is False, checks


def _state_unchanged(monkeypatch):
    """The update computes its loss and returns, stepping nothing."""
    from smg_tpu_torch.train.trainer import Trainer

    inner = Trainer.update

    def frozen(self, state, exp, labels):
        saved = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        out = inner(self, state, exp, labels)
        self.model.load_state_dict(saved)
        return out

    monkeypatch.setattr(Trainer, "update", frozen)


def _update_half_batch(monkeypatch):
    """The update takes the first half of its batch, the mean over those."""
    from smg_tpu_torch.train.trainer import Trainer

    inner = Trainer.update

    def half(self, state, exp, labels):
        h = exp.style.shape[0] // 2
        return inner(self, state, exp.map(lambda t: t[:h]), labels[:h])

    monkeypatch.setattr(Trainer, "update", half)


def _running_stats_frozen(monkeypatch):
    """The update steps the parameters and leaves the BatchNorm running
    statistics as they were."""
    from smg_tpu_torch.train.trainer import Trainer

    inner = Trainer.update

    def frozen(self, state, exp, labels):
        saved = {k: b.clone() for k, b in self.model.named_buffers()}
        out = inner(self, state, exp, labels)
        with torch.no_grad():
            for k, b in self.model.named_buffers():
                b.copy_(saved[k])
        return out

    monkeypatch.setattr(Trainer, "update", frozen)


@pytest.mark.parametrize("fault", [_state_unchanged, _update_half_batch, _running_stats_frozen])
def test_planted_training_fault_is_not_correct(fault, monkeypatch):
    if not LEARN:
        pytest.skip("no learn cell")
    fault(monkeypatch)
    result, checks = _run(LEARN[0], seed=SEED + 2, override=tiny_f32)
    assert result["correct"] is False, checks


def test_refuses_without_a_card(tmp_path):
    """No CUDA device (this CPU run): exit 2 and no result line; the same
    in a directory holding only BENCHMARK.json and the benchmark's files."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "smgbench", bare / "smgbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    for cwd in (ROOT, bare):
        res = subprocess.run([sys.executable, "-m", "smgbench", "--workload", CELLS[0],
                              "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=cwd, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    """On the card: one short traced run of the first cell prints a correct
    result line with its per-layer metrics and the device's times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, "-m", "smgbench", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "8", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert "k2_roofline" in line["metrics"] and line["metrics"]["k2_roofline"]["value"] <= 100
