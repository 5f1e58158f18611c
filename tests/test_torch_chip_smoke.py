"""chip_smoke.py's plan, read without a card: main runs PHASES in order,
so no cut of the script's run time may drop a kernel phase or a path, or
move a check's shape or tolerance, without failing here. Imports
chip_smoke and launches nothing."""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

# Each kernel against its plain version (K1-K7), K6 composed over whole
# blocks, and K3 and K6 at the largest batch their wrappers take.
KERNEL_PHASES = ("phase_contact", "phase_dense_layer", "phase_transition", "phase_stem",
                 "phase_conv2", "phase_dense_layer_train", "phase_dense_block",
                 "phase_dense_block_train", "phase_index_limits")
PATHS = ("act", "train", "parity", "cli", "perception", "pretrain", "vmap", "sharded",
         "rotations")


def _names():
    return [name for name, _ in cs.PHASES]


@pytest.mark.parametrize("name", KERNEL_PHASES)
def test_kernel_phase_runs(name):
    """The kernel phase is in PHASES, once, and its step calls the module's
    own phase function."""
    steps = [step for n, step in cs.PHASES if n == name]
    assert len(steps) == 1, _names()
    assert steps[0].phase is getattr(cs, name)


def test_kernel_phases_in_order():
    names = _names()
    assert [n for n in names if n in KERNEL_PHASES] == list(KERNEL_PHASES)
    assert names[:len(KERNEL_PHASES)] == list(KERNEL_PHASES)


@pytest.mark.parametrize("path", PATHS)
def test_path_runs(path):
    """The path is driven once, and the kernel table reports its launches."""
    assert _names().count(path) == 1, _names()
    assert path in cs.PATHS


def test_paths_are_the_nine():
    assert tuple(cs.PATHS) == PATHS
    assert len(set(_names())) == len(cs.PHASES)


def test_shapes_and_tolerances():
    """The kernel checks' shapes and the bounds of every check that has a
    name: all 58 layers at 224 and 640, 104 eval and 64 train images, K6's
    6 x 6 block, the decision-parity scenes, the rotations path's R."""
    assert cs.SIZES == (224, 640)
    assert cs.STREAMS == 104 and cs.TRAIN_IMAGES == 64 and cs.DP_SCENES == 8
    assert cs.B_MAIN == 32 and cs.ROT_R == 16
    for size in cs.SIZES:
        blocks = cs.densenet_blocks(size)
        assert [L for _, _, L in blocks] == [6, 12, 24, 16]
        assert [H for H, _, _ in blocks] == [size // 4, size // 8, size // 16, size // 32]
    assert len(cs.densenet_layers()) == 58
    assert [C for _, C in cs.transitions(640)] == [256, 512, 1024]
    assert cs.SMALL_BLOCK == (6, 512, 16)
    assert (cs.TOL_BF16, cs.TOL_GRAD, cs.TRUTH_RATIO) == (2.0 ** -6, 1e-2, 1.5)
    assert (cs.FORCE_TOL, cs.ROT0_BOUND, cs.SCORE_BOUND) == (1e-5, 1e-3, 0.05)


def test_snapshot_stem_case():
    """The decision-parity path's case under a trained snapshot's stem
    statistic: at 224, style 0 (the style whose parity failed on cold
    seed 1's snapshot), all three backends, bound the strict rule and 2 x
    the bf16 module forward's ratio (decision parity's witness factor); the
    construction is decision_parity.snapshot_stem_, as
    tests/test_torch_eval_stages.py builds it."""
    import inspect

    from smg_tpu_torch.cli import decision_parity as dp

    assert cs.SNAPSHOT_CASE == (224, 0) and cs.SNAPSHOT_FACTOR == dp.WITNESS_FACTOR == 2.0
    src = inspect.getsource(cs.drive_decision_parity)
    assert "snapshot_stem_case(" in src
    case = inspect.getsource(cs.snapshot_stem_case)
    assert "dp.snapshot_stem_(m, x, SEED, gray_tap=False)" in case
    assert "styles=(style,)" in case
    assert dp.SNAPSHOT_VARS == {"norm0": (2.6e-3, 6.7e-2), "norm1": (1.1e-2, 1.0)}


def test_trunk_calls_passes_every_argument():
    """TrunkCalls (the rotations path's count of trunk images) wraps
    fast_trunk.trunk_features_eval with its whole signature: score_eval
    hands it a stage tap as well."""
    from smg_tpu_torch.cli import decision_parity as dp
    from smg_tpu_torch.models import fast_trunk

    m = dp.make_model(224, 0, "cpu", (1, 1, 1, 1), dtype="float32")
    x = torch.randn(3, 224, 224, 3, generator=torch.Generator().manual_seed(0))
    seen = []
    with cs.TrunkCalls() as calls:
        fast_trunk.score_eval(m.grasp_trunk, m.grasp_head, x[:1], x[1:][None], 1,
                              tap=lambda k, t: seen.append(k))
    assert calls.images == [3] and "stem" in seen and "scores" not in seen
    assert fast_trunk.trunk_features_eval is calls.orig


def test_paths_reach_their_point():
    """The depths each path needs: a training step with delayed labels
    after the blank one, the CLI's resume after 2 iterations, 2 training
    steps at R = 16 for one with ETS."""
    assert cs.TRAIN_STEPS >= 2 and cs.CLI_TRAIN_ITERS >= 2 and cs.ROT_TRAIN_STEPS >= 2
    assert cs.PRETRAIN_STEPS >= 10 and cs.SEG_STEPS >= 2


def test_side_by_side_paths_run_together(monkeypatch):
    """run_phases runs SIDE_BY_SIDE's paths at once, each under its own
    phase name, and every other phase alone, in PHASES' order."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(cs, "SECONDS", {})
    group = threading.Barrier(len(cs.SIDE_BY_SIDE), timeout=10)
    order = []

    def fake(name):
        def step(ctx):
            order.append(name)
            if name in cs.SIDE_BY_SIDE:
                group.wait()       # times out unless all of them run at once
            with cs.wall_clock("part"):
                time.sleep(0.01)
        return step

    monkeypatch.setattr(cs, "PHASES", tuple((n, fake(n)) for n, _ in cs.PHASES))
    cs.run_phases({})
    alone = [n for n in _names() if n not in cs.SIDE_BY_SIDE]
    assert [n for n in order if n not in cs.SIDE_BY_SIDE] == alone
    assert sorted(n for n in order if n in cs.SIDE_BY_SIDE) == sorted(cs.SIDE_BY_SIDE)
    assert set(cs.SIDE_BY_SIDE) <= set(PATHS)
    for n in _names():
        assert cs.SECONDS[n] >= 0.01 and cs.SECONDS[f"{n}/part"] >= 0.01
    assert "+".join(cs.SIDE_BY_SIDE) in cs.SECONDS


def test_timed_loses_no_update(monkeypatch):
    """Threads of side_by_side adding to one SECONDS key, on a clock that
    gives every timed block one second: the key holds them all."""
    class Clock:
        def __init__(self):
            self.local = threading.local()

        def perf_counter(self):
            now = getattr(self.local, "now", 0.0)
            self.local.now = now + 1.0
            return now

    monkeypatch.setattr(cs, "SECONDS", {})
    monkeypatch.setattr(cs, "time", Clock())
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(300):
            with cs.wall_clock("x"):
                pass

    try:
        cs._PHASE.name = "p"
        cs.side_by_side({i: work for i in range(16)})
    finally:
        cs._PHASE.name = ""
        sys.setswitchinterval(switch)
    assert cs.SECONDS == {"p/x": 16 * 300.0}
