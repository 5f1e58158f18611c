"""K2: one eval-mode DenseNet dense layer, in place in the block buffer (csrc/dense_layer.cu).

Port of smg_tpu/ops/dense_layer_pallas.py::dense_layer_fused and
::dense_layers_fused (the K-layer grouping there is a TPU VMEM choice;
the math is the same). For a block buffer of N x H x W pixels and `ld`
channels, the layer reads the prefix channels [0, C_in) and writes its 32
new channels at [C_in, C_in + 32):

  h1  = bf16( sum_c bf16(relu(x_c * a1_c + b1_c)) * w1[c] )   f32 accumulation
  h2  = bf16( relu(h1 * a2 + b2) )
  out = bf16( sum_tap bf16( sum_c h2[pixel + tap, c] * w2[tap, c] ) )

The 3x3 conv's zero padding applies to h2 (dense_layer_pallas.py:105-106):
out-of-image taps contribute exactly 0. Each tap's 128-channel partial is
rounded to the working dtype before the f32 tap sum, as the TPU kernel's
packed-taps product does (dense_layer_pallas.py:147-155).

The port keeps one preallocated NHWC feature buffer per dense block and
updates it in place, so the TPU path's grouped 128-channel segments,
validity-padded affines, width padding and lane placement have no
counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smg_tpu_torch.ops import _build

launches = 0

BOTTLENECK = 128
GROWTH = 32
N_TAPS = 9


def dense_layer_plain(buf, c_in, a1, b1, w1, a2, b2, w2):
    """Plain version, in place: buf (N, H, W, ld); w1 (C_in, 128);
    w2 (9, 128, 32) with tap = 3 * dy + dx. Rounds to buf's dtype."""
    dt = buf.dtype
    N, H, W, _ = buf.shape
    x = buf[..., :c_in].float()
    h = torch.relu(x * a1 + b1).to(dt).float().reshape(-1, c_in)
    h1 = (h @ w1.float()).to(dt).float()
    h2 = torch.relu(h1 * a2 + b2).to(dt).float().reshape(N, H, W, BOTTLENECK)
    hp = F.pad(h2, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((N * H * W, GROWTH), dtype=torch.float32,
                      device=buf.device)
    for tap in range(N_TAPS):
        dy, dx = divmod(tap, 3)
        part = hp[:, dy:dy + H, dx:dx + W].reshape(-1, BOTTLENECK) @ w2[tap].float()
        acc = acc + part.to(dt).float()
    buf[..., c_in:c_in + GROWTH] = acc.reshape(N, H, W, GROWTH).to(dt)
    return buf


def dense_layer(buf, c_in: int, a1, b1, w1, a2, b2, w2):
    """One dense layer, in place in the block buffer buf (N, H, W, ld).

    a1, b1 (C_in,) f32; w1 (C_in, 128); a2, b2 (128,) f32; w2 (9, 128, 32).
    On the card buf, w1 and w2 are bf16 and C_in is a multiple of 32.
    """
    global launches
    if buf.device.type == "cpu":
        return dense_layer_plain(buf, c_in, a1, b1, w1, a2, b2, w2)
    N, H, W, ld = buf.shape
    _build.check_cuda(buf, "buf", torch.bfloat16)
    _build.check_cuda(a1, "a1", torch.float32, (c_in,))
    _build.check_cuda(b1, "b1", torch.float32, (c_in,))
    _build.check_cuda(w1, "w1", torch.bfloat16, (c_in, BOTTLENECK))
    _build.check_cuda(a2, "a2", torch.float32, (BOTTLENECK,))
    _build.check_cuda(b2, "b2", torch.float32, (BOTTLENECK,))
    _build.check_cuda(w2, "w2", torch.bfloat16, (N_TAPS, BOTTLENECK, GROWTH))
    if c_in % 32 or c_in + GROWTH > ld or ld % 8:
        raise ValueError(f"unsupported layer: C_in {c_in}, buffer {ld}")
    h2 = torch.empty((N * H * W, BOTTLENECK), dtype=torch.bfloat16,
                     device=buf.device)
    _build.launch("smg_dense_layer", buf.data_ptr(), a1.data_ptr(),
                  b1.data_ptr(), w1.data_ptr(), a2.data_ptr(), b2.data_ptr(),
                  w2.data_ptr(), h2.data_ptr(), N, H, W, ld, c_in)
    launches += 1
    return buf
