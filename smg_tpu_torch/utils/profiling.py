"""Tracing and per-phase timing (port of smg_tpu/utils/profiling.py).

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

The JAX module's `readback` has no counterpart: torch.cuda.synchronize
waits for the card.
"""

from __future__ import annotations

import contextlib
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
