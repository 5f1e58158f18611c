"""The program's own spans and counters, as the per-layer readers read them.

The program records them with the recorder of
smg_tpu_torch/utils/profiling.py, which is off until code turns it on:
a reader's `install` does, so only a `--trace 1` run records. A program
without the recorder (a checkout older than it, run with these readers)
leaves every reading None.

- Host times read the spans of the window's calls after the profiled part
  (of every call where all were profiled), a span belonging to the call
  whose interval holds it on the perf_counter clock that `Call` uses.
- Idle times read the profiled part on the realtime clock: the trace
  counts from its origin in us, the program's spans keep time_ns, and the
  origin is where the benchmark's `call` marks (realtime ns) and the
  trace's copies of them (us from the origin) meet.
- Counts sum what each span inside the window's calls counted.
"""

from __future__ import annotations

import bisect

from smg_tpu_torch.utils import profiling
from smgbench.trace import _union


def recorder():
    """The program's recorder, or None where its profiling module has none
    (a program older than the recorder, run with these readers)."""
    return profiling if hasattr(profiling, "enable") else None


def install(run) -> None:
    rec = recorder()
    if rec is not None:
        rec.enable()


def after_profiled(run) -> list:
    """The window's calls after the profiled part, or all of them."""
    return [c for c in run.calls if not c.profiled] or run.calls


def spans_by_call(run, calls) -> list | None:
    """For each call, the program's finished spans that lie inside it."""
    rec = recorder()
    if rec is None:
        return None
    spans = sorted((s for s in rec.spans() if s.end_ns is not None),
                   key=lambda s: s.start_ns)
    starts = [s.start_ns for s in spans]
    out = []
    for c in calls:
        lo, hi = c.start * 1e9, c.end * 1e9
        i, j = bisect.bisect_left(starts, lo), bisect.bisect_right(starts, hi)
        out.append([s for s in spans[i:j] if s.end_ns <= hi])
    return out


def ms_per_call(run, name: str) -> float | None:
    """Mean host ms per call of all `name` spans in it."""
    calls = after_profiled(run)
    per = spans_by_call(run, calls)
    if not per or not any(s.name == name for ss in per for s in ss):
        return None
    return sum(s.seconds for ss in per for s in ss if s.name == name) / len(per) * 1e3


def ms_per_span(run, name: str) -> float | None:
    """Mean host ms of one `name` span."""
    per = spans_by_call(run, after_profiled(run))
    got = [s.seconds for ss in per or [] for s in ss if s.name == name]
    return sum(got) / len(got) * 1e3 if got else None


def counted(run, name: str):
    """What the spans of the window's calls counted under `name` (an int),
    or None where nothing was counted."""
    per = spans_by_call(run, run.calls)
    got = [s.counts[name] for ss in per or [] for s in ss if name in s.counts]
    return int(sum(got)) if got else None


def origin_ns(run) -> int | None:
    """The trace's origin on the realtime clock, from the first `call` mark."""
    if run.trace is None or run.spans is None:
        return None
    for (a, _, n), (ta, _, _) in zip(run.spans.marks, run.trace.spans):
        if n == run.trace.call_span:
            return a - round(ta * 1e3)
    return None


def idle_gaps(trace) -> list:
    """The profiled window's idle intervals (us from the origin)."""
    edges = [trace.start] + [x for iv in trace.busy for x in iv] + [trace.end]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def overlap_us(a: list, b: list) -> float:
    """Length of the overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_call(run, name: str) -> float | None:
    """Device idle in the profiled part while the host is inside a `name`
    span, in ms per profiled call."""
    rec, t0 = recorder(), origin_ns(run)
    n_calls = sum(c.profiled for c in run.calls)
    if rec is None or t0 is None or not n_calls:
        return None
    inside = _union(((s.start_wall_ns - t0) / 1e3, (s.end_wall_ns - t0) / 1e3)
                    for s in rec.spans() if s.name == name and s.end_ns is not None)
    if not inside:
        return None
    return overlap_us(idle_gaps(run.trace), inside) / n_calls / 1e3
