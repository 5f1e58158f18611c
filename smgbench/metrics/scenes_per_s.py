"""Scenes decided (or experiences learned) in the calls of the window, over
the window's whole time, by the host clock."""


def read(run):
    if run.window_s <= 0 or not run.calls:
        return None
    return sum(c.scenes for c in run.calls) / run.window_s
