"""K4: the stem tail — eval BN affine, ReLU, 3x3 stride-2 max pool (csrc/stem_pool.cu).

Port of smg_tpu/ops/stem_pool_pallas.py::bn_relu_maxpool. conv0 itself
stays a convolution outside the kernel, as it was an XLA convolution in
the JAX package (fast_trunk.py:50-54); the quad-phase 9x9/s4 repacking
existed only for TPU lanes and is not ported. Padding: the pool pads with
0 after the ReLU (stem_pool_pallas.py:15-16), which equals -inf padding
since every window holds at least one in-image value >= 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smg_tpu_torch.ops import _build

launches = 0


def out_hw(h: int) -> int:
    """Pooled extent of a 3x3 / stride-2 / pad-1 window."""
    return (h - 1) // 2 + 1


def bn_relu_maxpool_plain(y, a, b):
    """Plain version: y (N, H, W, C) -> (N, H', W', C) in y's dtype."""
    h = torch.relu(y.float() * a + b)
    m = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, padding=1)
    return m.permute(0, 2, 3, 1).to(y.dtype)


def bn_relu_maxpool(y, a, b, out=None):
    """y (N, H, W, C) conv0 output; a, b (C,) f32 folded eval BN.

    Returns (N, H', W', C). `out` may be given as a channel slice of a
    wider NHWC buffer (the first dense block's), which the kernel then
    writes in place.
    """
    global launches
    if y.device.type == "cpu":
        res = bn_relu_maxpool_plain(y, a, b)
        if out is None:
            return res
        out.copy_(res)
        return out
    N, H, W, C = y.shape
    Ho, Wo = out_hw(H), out_hw(W)
    _build.check_cuda(y, "y", torch.bfloat16)
    _build.check_cuda(a, "a", torch.float32, (C,))
    _build.check_cuda(b, "b", torch.float32, (C,))
    if C % 8:
        raise ValueError("channels must be a multiple of 8")
    if out is None:
        out = torch.empty((N, Ho, Wo, C), dtype=torch.bfloat16, device=y.device)
    ld = _build.check_nhwc_view(out, "out", torch.bfloat16, (N, Ho, Wo, C))
    _build.launch("smg_stem_pool", y.data_ptr(), a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), N, H, W, C, ld)
    launches += 1
    return out
