"""K5: eval BN2, ReLU and the 3x3 conv 128 -> 32 on a bf16 h1 (csrc/conv2.cu).

Port of smg_tpu/ops/conv2_pallas.py::conv2_bn_relu and
::conv2_bn_relu_merge, the conv2 of the `xla_pk` eval backend
(fast_trunk.py:106-115, :204-236). For a bottleneck output h1 (N, H, W, 128):

  h2  = bf16( relu(h1 * a + b) )                       f32 affine
  out = bf16( sum_tap bf16( sum_c h2[pixel + tap, c] * w2[tap, c] ) )

The zero padding of the 3x3 applies to h2 after the BN and ReLU at every
image edge: out-of-image taps contribute exactly 0. Each tap's partial is
rounded to the working dtype before the f32 tap sum, as the TPU kernel's
packed-taps product is (conv2_pallas.py:109-117).

One kernel serves both TPU variants: it writes its 32 channels into an
`out` that may be a channel slice of an NHWC buffer. The port's dense
block keeps one buffer and writes each layer at its channel offset, which
is the merge variant (a 128-lane group buffer whose other lanes are kept);
`conv2_bn_relu_merge` reproduces the TPU function's own output for tests.
w2 is (9, 128, 32) with tap = 3 * dy + dx (the TPU's packed (128, 288)
holds tap t at columns [32 t, 32 t + 32)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smg_tpu_torch.ops import _build

launches = 0

BOTTLENECK = 128
GROWTH = 32
N_TAPS = 9


def conv3x3_plain(h2, w2, dt, round_taps: bool = True):
    """The 3x3 / pad-1 conv 128 -> 32 of the f32 values h2 (N, H, W, 128)
    with w2 (9, 128, 32): f32 (N, H, W, 32). Each tap's partial is rounded
    to dt before the sum when round_taps."""
    N, H, W, _ = h2.shape
    hp = F.pad(h2, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((N * H * W, GROWTH), dtype=torch.float32, device=h2.device)
    for tap in range(N_TAPS):
        dy, dx = divmod(tap, 3)
        part = hp[:, dy:dy + H, dx:dx + W].reshape(-1, BOTTLENECK) @ w2[tap].float()
        acc = acc + (part.to(dt).float() if round_taps else part)
    return acc.reshape(N, H, W, GROWTH)


def conv2_bn_relu_plain(h1, a, b, w2):
    """Plain version: h1 (N, H, W, 128) -> (N, H, W, 32) in h1's dtype."""
    dt = h1.dtype
    h2 = torch.relu(h1.float() * a + b).to(dt).float()
    return conv3x3_plain(h2, w2, dt).to(dt)


def conv2_bn_relu(h1, a, b, w2, out=None):
    """h1 (N, H, W, 128) bf16; a, b (128,) f32; w2 (9, 128, 32) bf16.

    Returns (N, H, W, 32). `out` may be a channel slice [..., c:c + 32] of
    a wider NHWC buffer (the dense block's), which the kernel writes in
    place; the buffer's other channels are not touched.
    """
    global launches
    if h1.device.type == "cpu":
        res = conv2_bn_relu_plain(h1, a, b, w2)
        if out is None:
            return res
        out.copy_(res)
        return out
    N, H, W = h1.shape[:3]
    _build.check_cuda(h1, "h1", torch.bfloat16, (N, H, W, BOTTLENECK))
    _build.check_cuda(a, "a", torch.float32, (BOTTLENECK,))
    _build.check_cuda(b, "b", torch.float32, (BOTTLENECK,))
    _build.check_cuda(w2, "w2", torch.bfloat16, (N_TAPS, BOTTLENECK, GROWTH))
    if out is None:
        out = torch.empty((N, H, W, GROWTH), dtype=torch.bfloat16, device=h1.device)
    ld = _build.check_nhwc_view(out, "out", torch.bfloat16, (N, H, W, GROWTH))
    _build.launch("smg_conv2_bn_relu", h1.data_ptr(), a.data_ptr(), b.data_ptr(),
                  w2.data_ptr(), out.data_ptr(), N, H, W, ld)
    launches += 1
    return out


def conv2_bn_relu_merge(h1, pend, a, b, w2, pend_n: int):
    """The TPU merge variant's output: a new (N, H, W, 128) group buffer
    holding this layer's 32 channels at [pend_n, pend_n + 32) and, in its
    other channels, those of `pend` (zeros when pend is None)."""
    if pend_n % GROWTH or not 0 <= pend_n <= BOTTLENECK - GROWTH:
        raise ValueError(f"pend_n must be 0, 32, 64 or 96, got {pend_n}")
    if pend is None:
        group = torch.zeros(h1.shape, dtype=h1.dtype, device=h1.device)
    else:
        group = pend.clone()
    conv2_bn_relu(h1, a, b, w2, out=group[..., pend_n:pend_n + GROWTH])
    return group
