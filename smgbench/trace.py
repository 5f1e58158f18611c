"""Spans around the benchmark's calls into the program, and the reduction
of a torch.profiler trace to device time, idle gaps and kernel time.

Spans are the benchmark's own: in a traced run each ends in a
synchronize, so its host time covers its device work, and while the
profiler runs each is also kept on the realtime clock that the profiler's
timestamps count from, so the trace can say what the host was doing while
the device sat idle. The profiler records the device's activity alone:
recording every host operator as well slows the host that paces the
calls (the idle share read 52% against 27% at 224 on an H100). In an
untraced run the spans cost nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict

import torch


class Spans:
    """Named host-clock spans; `active` makes them synchronize, and while
    `profiled` each is also kept on the profiler's clock (realtime ns)."""

    def __init__(self, active: bool):
        self.active = active
        self.profiled = False      # set while the profiler runs
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self.profiled_seconds: dict[str, list[float]] = defaultdict(list)
        self.marks: list[tuple[int, int, str]] = []   # (start ns, end ns, name)

    def read(self, name: str) -> list[float]:
        """Seconds of each `name` span outside the profiled part, or of all
        of them where every call was profiled."""
        return self.seconds.get(name) or self.profiled_seconds.get(name, [])

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.active:
            yield
            return
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if self.profiled:
            self.profiled_seconds[name].append(dt)
            self.marks.append((w0, time.time_ns(), name))
        else:
            self.seconds[name].append(dt)


def kernel_name(raw: str) -> str:
    """A kernel's bare name: no return type, namespace, template arguments
    or parameters."""
    s = raw.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    s = s.split("(")[0].split("<")[0]
    return s.split("::")[-1].strip() or raw[:60]


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """What a torch.profiler window held: kernel intervals (us) by bare
    name, the benchmark's spans, and the window on the same clock."""

    def __init__(self, prof, marks, call_span: str):
        """prof: a finished torch.profiler.profile of the device's activity;
        marks: the spans (start ns, end ns, name) on the realtime clock that
        the profiler's timestamps count from."""
        from torch.autograd import DeviceType

        self.call_span = call_span
        self.kernels = []          # (start us, end us, name)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                self.kernels.append((e.time_range.start, e.time_range.end,
                                     kernel_name(e.name)))
        t0 = prof.profiler.kineto_results.trace_start_ns()
        self.spans = [((a - t0) / 1e3, (b - t0) / 1e3, n) for a, b, n in marks]
        calls = [(a, b) for a, b, n in self.spans if n == call_span] or \
            [(a, b) for a, b, _ in self.kernels]
        self.start = min((a for a, _ in calls), default=0.0)
        self.end = max((b for _, b in calls), default=0.0)
        inside = [(max(a, self.start), min(b, self.end)) for a, b, _ in self.kernels
                  if b > self.start and a < self.end]
        self.busy = _union(inside)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def device_s(self, names) -> float:
        """Device seconds of the kernels whose bare name is in `names`."""
        return sum(b - a for a, b, n in self.kernels if n in names) / 1e6

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for a, b, n in self.kernels:
            by[n] += (b - a) / 1e6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]

    def _segments(self):
        """The window cut at every span's ends, each piece named by the
        innermost span over it: a call's own spans, else "call", else
        "between_calls"."""
        cuts = sorted({self.start, self.end} | {x for a, b, _ in self.spans
                                                 for x in (a, b)
                                                 if self.start < x < self.end})
        inner = sorted(s for s in self.spans if s[2] != self.call_span)
        outer = sorted(s for s in self.spans if s[2] == self.call_span)
        keys = ([s[0] for s in inner], [s[0] for s in outer])
        out = []
        for a, b in zip(cuts, cuts[1:]):
            mid, name = (a + b) / 2, "between_calls"
            for lv, st in zip((inner, outer), keys):
                i = bisect.bisect_right(st, mid) - 1
                if i >= 0 and mid < lv[i][1]:
                    name = lv[i][2]
                    break
            out.append((a, b, name))
        return out

    def idle_gaps(self, k: int = 10):
        """Idle device time inside the window, split by what the host was
        doing over it: the innermost span ("between_calls" outside any)."""
        edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        by = defaultdict(float)
        segs = self._segments()
        j = 0
        for a, b in gaps:
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            i = j
            while i < len(segs) and segs[i][0] < b:
                lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
                by[segs[i][2]] += max(0.0, hi - lo) / 1e6
                i += 1
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]
