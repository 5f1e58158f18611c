"""Per-phase wall-clock timing of the host loop (port of
smg_tpu/utils/profiling.py::PhaseTimer).

`PhaseTimer.phase(name, block_on=x)` synchronises the card of x (a
tensor or a device) before it stops the clock, so a phase's time is its
execution, not its enqueue (the JAX version calls block_until_ready
there).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
