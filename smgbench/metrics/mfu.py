"""Useful FLOPs of the window's calls (only the images and head passes the
inputs need, smgbench/bounds.py) over their time, as a share of the
card's dense bf16 peak (peaks.json), in %. In a traced run it reads the
calls after the profiled part, when there are any."""

from smgbench.bounds import PEAKS


def read(run):
    calls = [c for c in run.calls if not c.profiled] or run.calls
    if not calls:
        return None
    seconds = calls[-1].end - calls[0].start
    if seconds <= 0:
        return None
    return 100.0 * sum(c.flops for c in calls) / seconds / PEAKS["bf16_flops"]
