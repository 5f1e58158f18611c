"""The reduction of a device trace: busy time as the union of kernel
intervals, idle gaps named by the host span they began in, kernel names."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from smgbench import trace as tr

T0 = 1_000_000_000_000


def _prof(kernels):
    events = [SimpleNamespace(device_type=DeviceType.CUDA, name=n,
                              time_range=SimpleNamespace(start=a, end=b))
              for a, b, n in kernels]
    events.append(SimpleNamespace(device_type=DeviceType.CPU, name="aten::mm",
                                  time_range=SimpleNamespace(start=0, end=1e9)))
    results = SimpleNamespace(trace_start_ns=lambda: T0)
    return SimpleNamespace(events=lambda: events,
                           profiler=SimpleNamespace(kineto_results=results))


def test_busy_idle_and_gap_names():
    kernels = [(10, 40, "void smg::gemm_bnrelu_kernel<64, 2>(bf16 const*, int)"),
               (30, 50, "conv3x3_kernel<Src>"), (70, 80, "transition_kernel"),
               (150, 190, "at::native::elementwise_kernel<128, 4>")]
    us = lambda t: T0 + int(t * 1000)  # noqa: E731
    marks = [(us(0), us(100), "call"), (us(0), us(60), "score"), (us(60), us(100), "policy"),
             (us(120), us(200), "call"), (us(120), us(200), "score")]
    t = tr.Trace(_prof(kernels), marks, "call")
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx((40 + 10 + 40) * 1e-6)
    gaps = dict(t.idle_gaps())
    # Idle: 0-10, 50-70, 80-150, 190-200.
    assert gaps["score"] == pytest.approx((10 + 10 + 30 + 10) * 1e-6)
    assert gaps["policy"] == pytest.approx((10 + 20) * 1e-6)       # 60-70, 80-100
    assert gaps["between_calls"] == pytest.approx(20e-6)           # 100-120
    assert gaps["score"] + gaps["policy"] + gaps["between_calls"] + t.busy_s == \
        pytest.approx(t.window_s)
    assert t.device_s(("gemm_bnrelu_kernel", "conv3x3_kernel")) == pytest.approx(50e-6)
    assert t.top_ops()[0][0] in ("gemm_bnrelu_kernel", "elementwise_kernel")


def test_kernel_names():
    assert tr.kernel_name("void smg::(anonymous namespace)::k2<1>(int)") == "k2"
    assert tr.kernel_name("nchwToNhwcKernel") == "nchwToNhwcKernel"
