"""The share of the profiled window in which no kernel or copy ran on the
device (1 - the union of their intervals over the window), in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
