"""K3's share of its roofline: the least time its launches in the profiled
window could take (smgbench/bounds.py::k3_work, shapes recorded at each
launch of ops/transition.py::transition) over its kernel's device time by
name in the trace, in %."""

from smgbench.bounds import bound_s, k3_work

KERNELS = ("transition_kernel",)


def install(run):
    from smg_tpu_torch.ops import transition

    shapes = run.counters.setdefault("k3", [])
    inner = transition.transition

    def counted(x, a, b, wt, *args, **kw):
        if run.counting and x.device.type == "cuda":
            N, H, W, C = x.shape
            shapes.append((N, H, W, C, wt.shape[1]))
        return inner(x, a, b, wt, *args, **kw)

    transition.transition = counted


def read(run):
    shapes = run.counters.get("k3")
    if run.trace is None or not shapes:
        return None
    device_s = run.trace.device_s(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(bound_s(*k3_work(*s)) for s in shapes) / device_s
