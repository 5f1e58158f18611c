"""Tracing, per-phase timing, and the program's own spans and counters
(port of smg_tpu/utils/profiling.py, which has all but the recorder).

- `trace(log_dir)`: a context manager around torch.profiler.profile that
  writes a Chrome trace under log_dir when it closes (open it in
  TensorBoard's profiler plugin or chrome://tracing); the card's kernels
  are traced when CUDA is available, the host's ops always.
- `annotate(name)`: torch.profiler.record_function, a named region in
  that trace.
- `PhaseTimer.phase(name, block_on=x)` synchronises the card of x (a
  tensor or a device) before it stops the clock, so a phase's time is its
  execution, not its enqueue (the JAX version calls block_until_ready
  there).
- The recorder: `span(name, **attrs)` and `count(name, n)`, placed at the
  program's layer boundaries (Trainer.score_scene_batch and its trunk
  calls, _score_rows and _score_eval; Trainer.update's forward per style, backward, Adam and
  BatchNorm statistics; select_action; compute_geometry with PE and OO).
  It is off until code calls `enable()`; no environment variable or flag
  turns it on. Off, `span` returns one shared no-op context and `count`
  returns at once: no clock read, no allocation, no device work. On, each
  span keeps a `Span`: its id, its parent's id (the enclosing open span),
  its root's id (the id that a call's whole tree shares), its name, its
  attributes and both ends on two clocks, perf_counter_ns and time_ns (the
  realtime clock that the profiler's trace_start_ns counts from), each
  read at each edge. A span opens no `annotate` region: nothing reads
  one, and under an active profiler each costs host time. A count is
  kept on the innermost open span (outside any span it is dropped); a
  tensor count is summed on the device and read only by `counters()` or
  by whoever reads the span. The recorder never
  synchronizes: a span's length is the host's time, and the callers guard
  the work that makes a count with `enabled()`. One host thread records.

Who reads what: `trace` and `annotate`, the tests
(tests/test_torch_core_helpers.py); `PhaseTimer`, the CLI's phase report
(cli/main.py) and `train_step(timer=)` (chip_smoke.py); the `launches`
counters of ops/*.py, chip_smoke.py, compare_parent.py and the GPU
tests; the recorder's spans and counters, the benchmark's per-layer
readers (smgbench/metrics/).

The JAX module's `readback` has no counterpart: torch.cuda.synchronize
waits for the card.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: `with profiling.trace("logs/trace"): ...`."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Label a region in the trace."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulates wall time per named phase."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                dev = (block_on.device if isinstance(block_on, torch.Tensor)
                       else torch.device(block_on))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(
                    1e3 * self.totals[name] / max(self.counts[name], 1), 3
                ),
            }
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        lines = ["phase timings:"]
        for name, s in self.summary().items():
            lines.append(
                f"  {name:<12} {s['mean_ms']:>9.2f} ms/call"
                f" x{s['count']:<6} = {s['total_s']:.2f} s"
            )
        return "\n".join(lines)


class Span:
    """One recorded span. Times are ns: `start_ns`, `end_ns` on
    time.perf_counter_ns, `start_wall_ns`, `end_wall_ns` on time.time_ns
    (`end_*` None while it is open); `counts` maps a counter's name to
    what was counted inside it (an int or a device tensor)."""

    __slots__ = ("id", "parent", "root", "name", "attrs", "start_ns", "end_ns",
                 "start_wall_ns", "end_wall_ns", "counts")

    def __init__(self, id: int, parent: "Span | None", name: str, attrs: dict):
        self.id = id
        self.parent = None if parent is None else parent.id
        self.root = id if parent is None else parent.root
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = self.start_wall_ns = self.end_wall_ns = None
        self.counts: dict = {}

    @property
    def seconds(self) -> float:
        """Host seconds from start to end."""
        return (self.end_ns - self.start_ns) / 1e9


class _Open:
    """The context of one span while the recorder is on."""

    __slots__ = ("rec", "name", "attrs")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> Span:
        rec = self.rec
        s = Span(next(rec._ids), rec._open[-1] if rec._open else None, self.name, self.attrs)
        s.start_ns, s.start_wall_ns = time.perf_counter_ns(), time.time_ns()
        rec._spans.append(s)
        rec._open.append(s)
        return s

    def __exit__(self, *exc):
        s = self.rec._open.pop()
        s.end_ns, s.end_wall_ns = time.perf_counter_ns(), time.time_ns()
        return False


_OFF = contextlib.nullcontext()


class Recorder:
    """Spans and counters of one process (the module's functions use the
    one instance)."""

    def __init__(self):
        self.on = False
        self._ids = itertools.count()
        self._spans: list[Span] = []
        self._open: list[Span] = []

    def span(self, name: str, **attrs):
        """`with span("name", style=s):`; off, the shared no-op context."""
        if not self.on:
            return _OFF
        return _Open(self, name, attrs)

    def count(self, name: str, n) -> None:
        """Add n (an int, or a device tensor that the caller leaves as it
        is) to the counter `name` of the innermost open span; outside any
        span, or off, it does nothing."""
        if not self.on or not self._open:
            return
        into = self._open[-1].counts
        old = into.get(name)
        if isinstance(n, torch.Tensor):
            n = n.detach()
        into[name] = n if old is None else old + n

    def enable(self, on: bool = True) -> None:
        self.on = on

    def enabled(self) -> bool:
        return self.on

    def spans(self) -> list[Span]:
        """The spans recorded, in the order they opened."""
        return list(self._spans)

    def counters(self) -> dict:
        """Each counter's total over every span, as ints (reading a tensor
        count waits for the card)."""
        totals: dict = {}
        for s in self._spans:
            for k, v in s.counts.items():
                totals[k] = totals.get(k, 0) + v
        return {k: int(v) for k, v in totals.items()}

    def reset(self) -> None:
        """Forget every span and count (open spans stay open)."""
        self._spans.clear()


_RECORDER = Recorder()
span = _RECORDER.span
count = _RECORDER.count
enable = _RECORDER.enable
enabled = _RECORDER.enabled
spans = _RECORDER.spans
counters = _RECORDER.counters
reset = _RECORDER.reset
