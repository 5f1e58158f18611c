"""K2's share of its roofline: the least time its launches in the profiled
window could take (smgbench/bounds.py::k2_work, shapes recorded at each
launch of ops/dense_layer.py::dense_layer) over its kernels' device time
by name in the trace, in %."""

from smgbench.bounds import bound_s, k2_work

KERNELS = ("gemm_bnrelu_kernel", "conv3x3_kernel")


def install(run):
    from smg_tpu_torch.ops import dense_layer

    shapes = run.counters.setdefault("k2", [])
    inner = dense_layer.dense_layer

    def counted(buf, c_in, *args, **kw):
        if run.counting and buf.device.type == "cuda":
            N, H, W, _ = buf.shape
            shapes.append((N, H, W, c_in))
        return inner(buf, c_in, *args, **kw)

    dense_layer.dense_layer = counted


def read(run):
    shapes = run.counters.get("k2")
    if run.trace is None or not shapes:
        return None
    device_s = run.trace.device_s(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(bound_s(*k2_work(*s)) for s in shapes) / device_s
