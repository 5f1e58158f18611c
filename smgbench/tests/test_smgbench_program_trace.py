"""The readers of the program's own spans and counters
(smgbench/program_trace.py and the metrics that use it): host times over
the calls after the profiled part, device idle inside a span on the
trace's clock with the origin taken from the `call` marks, counts over the
window's calls, and the useful-image count against smgbench/bounds.py."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from smgbench import bounds, program_trace, traffic
from smgbench import run as bench_run
from smgbench import trace as tr
from smgbench.entries import decide
from smgbench.tests.helpers import tiny_traffic
from smgbench.tests.test_smgbench_trace import T0, _prof
from smg_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("score_eval_ms", "score_eval_idle_ms", "useful_image_share", "oo_ms",
       "update_forward_ms", "update_backward_ms", "update_adam_ms", "update_bn_stats_ms")
P0 = 5_000_000_000   # the perf_counter origin of the synthetic runs, ns


def _reader(name):
    return bench_run.load_module(ROOT / "smgbench" / "metrics" / f"{name}.py",
                                 "test_metric_" + name)


def _span(name, a_us, b_us, parent=None, **counts):
    """A finished span from a_us to b_us on both clocks (us after the
    trace's origin on the realtime clock, after P0 on perf_counter)."""
    s = profiling.Span(0, parent, name, {})
    s.start_ns, s.end_ns = P0 + int(a_us * 1e3), P0 + int(b_us * 1e3)
    s.start_wall_ns, s.end_wall_ns = T0 + int(a_us * 1e3), T0 + int(b_us * 1e3)
    s.counts = dict(counts)
    return s


def _call(a_us, b_us, profiled):
    return bench_run.Call((P0 + a_us * 1e3) / 1e9, (P0 + b_us * 1e3) / 1e9, 32, 1.0, profiled)


@pytest.fixture
def program(monkeypatch):
    """The recorder that program_trace reads, holding the spans given."""
    held = []
    fake = SimpleNamespace(spans=lambda: list(held), enable=lambda on=True: None)
    monkeypatch.setattr(program_trace, "recorder", lambda: fake)
    return held


def _run(calls, marks=(), kernels=()):
    trace = tr.Trace(_prof(list(kernels)), list(marks), "call") if marks else None
    return SimpleNamespace(calls=calls, spans=SimpleNamespace(marks=list(marks)), trace=trace)


def _us(t):
    return T0 + int(t * 1000)


def test_idle_inside_spans_per_profiled_call(program):
    """Idle 0-10, 50-70, 80-150, 190-200 us; score_eval spans catch 5 + 20
    (a gap over each edge of 45-75) + 20 + 4 us of it over two profiled
    calls; a warm-up span before the window catches none."""
    kernels = [(10, 40, "gemm_bnrelu_kernel"), (30, 50, "conv3x3_kernel"),
               (70, 80, "transition_kernel"), (150, 190, "elementwise_kernel")]
    # The benchmark closes a call's inner spans first: its first mark is
    # `score`, so the origin has to come from a `call` mark.
    marks = [(_us(0), _us(60), "score"), (_us(0), _us(100), "call"),
             (_us(120), _us(200), "score"), (_us(120), _us(200), "call")]
    program += [_span("score_eval", -50, -10), _span("score_eval", 5, 20),
                _span("score_eval", 45, 75), _span("oo", 80, 100),
                _span("score_eval", 130, 160), _span("score_eval", 195, 199)]
    run = _run([_call(0, 100, True), _call(120, 200, True)], marks, kernels)
    assert program_trace.origin_ns(run) == T0
    assert program_trace.idle_ms_per_call(run, "score_eval") == pytest.approx(49e-3 / 2)
    assert _reader("score_eval_idle_ms").read(run) == pytest.approx(49e-3 / 2)
    assert program_trace.idle_ms_per_call(run, "oo") == pytest.approx(20e-3 / 2)


def test_origin_from_call_marks_off_the_trace_start(program):
    """A trace that starts 1 ms before the first call: the spans land on
    the trace's clock through the call marks alone."""
    shift = 1000   # us
    kernels = [(shift + 10, shift + 90, "gemm_bnrelu_kernel")]
    marks = [(_us(shift), _us(shift + 100), "call")]
    program += [_span("score_eval", shift + 0, shift + 20)]
    run = _run([_call(shift, shift + 100, True)], marks, kernels)
    assert program_trace.origin_ns(run) == T0
    assert program_trace.idle_ms_per_call(run, "score_eval") == pytest.approx(10e-3)


def test_host_means_over_the_calls_after_the_profiled_part(program):
    program += [
        _span("score_eval", -900, -100),                     # warm-up: no call
        _span("score_eval", 10, 90), _span("oo", 90, 99),    # profiled call
        _span("score_eval", 1000, 3000), _span("score_eval", 3000, 7000),
        _span("oo", 7000, 17000),
        _span("score_eval", 20000, 26000), _span("oo", 26000, 46000),
        _span("update.backward", 20000, 21000),
    ]
    calls = [_call(0, 100, True), _call(500, 18000, False), _call(19000, 50000, False)]
    run = _run(calls)
    assert _reader("score_eval_ms").read(run) == pytest.approx((2 + 4 + 6) / 3)
    assert _reader("oo_ms").read(run) == pytest.approx((10 + 20) / 2)
    assert _reader("update_backward_ms").read(run) == pytest.approx(1 / 2)
    assert _reader("update_adam_ms").read(run) is None
    # Every call profiled: the means take them all.
    run = _run([_call(0, 100, True), _call(500, 18000, True)])
    assert _reader("score_eval_ms").read(run) == pytest.approx((0.08 + 2 + 4) / 3)


def test_counts_over_the_window_calls(program):
    program += [
        _span("score_scene", -900, -100, trunk_images=93, trunk_images_useful=93),
        _span("score_scene", 10, 50, trunk_images=186, trunk_images_useful=torch.tensor(40)),
        _span("score_scene", 50, 90, trunk_images=93, trunk_images_useful=torch.tensor(20)),
        _span("score_scene", 600, 700, trunk_images=93, trunk_images_useful=3),
    ]
    run = _run([_call(0, 100, True), _call(500, 800, False)])
    assert program_trace.counted(run, "trunk_images") == 372
    assert program_trace.counted(run, "trunk_images_useful") == 63
    assert _reader("useful_image_share").read(run) == pytest.approx(100 * 63 / 372)


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    marks = [(_us(0), _us(100), "call")]
    run = _run([_call(0, 100, True), _call(200, 300, False)], marks,
               [(10, 40, "gemm_bnrelu_kernel")])
    for name in NEW:
        r = _reader(name)
        r.install(run)
        assert r.read(run) is None, name


def test_every_new_metric_is_declared_and_reads_the_program():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["moves"] == "scenes_per_s"
        assert m["source"] in ("program_span", "program_counter")
        assert hasattr(_reader(name), "install")


def test_useful_share_is_the_benchmarks_own_count(monkeypatch):
    """The program's counters over two pool batches of the observations
    traffic (cut to 64-pixel heightmaps, helpers.tiny_traffic; the tiny
    trunk) equal smgbench/bounds.py's useful images (its decision_flops
    with one FLOP a trunk image and none a head) and 93 images a scene,
    exactly."""
    spec = tiny_traffic(json.loads((ROOT / "smgbench" / "traffic" / "observations.json")
                                   .read_text()))
    config = json.loads((ROOT / "smgbench" / "configs" / "densenet121-224.json").read_text())
    config["model"].update(trunk="tiny", input_size=64, dtype="float32")
    trainer, _ = decide.build_program(config, "cpu")
    pool = traffic.make_pool(spec, 2, 8, 2**31 + 2**29 + 7, "cpu")
    profiling.reset()
    profiling.enable()
    try:
        with torch.no_grad():
            for sc in pool:
                trainer.score_scene_batch(None, sc.depth * sc.masks.any(1), sc.masks, sc.valid)
        got = profiling.counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    monkeypatch.setattr(bounds, "trunk_flops", lambda arch, size: 1.0)
    monkeypatch.setattr(bounds, "head_flops", lambda *a, **k: 0.0)
    useful = sum(bounds.decision_flops(config["architecture"], 64, 1024, sc.number.tolist())
                 for sc in pool)
    assert got == {"trunk_images": 93 * 16, "trunk_images_useful": int(useful)}
    assert 0 < useful < 93 * 16
