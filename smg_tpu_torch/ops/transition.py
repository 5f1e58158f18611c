"""K3: the DenseNet transition — BN affine, ReLU, 2x2 mean, 1x1 conv (csrc/transition.cu).

Port of smg_tpu/ops/transition_pallas.py::transition. The pool is commuted
ahead of the 1x1 (exact for a linear map); the pooled value is
((h00 + h10) + (h01 + h11)) * 0.25 in f32, rounded to the working dtype
(transition_pallas.py:46-51), then contracted with f32 accumulation.
"""

from __future__ import annotations

import torch

from smg_tpu_torch.ops import _build

launches = 0


def transition_plain(x, a, b, wt):
    """Plain version: x (N, H, W, C), wt (C, C_out) -> (N, H/2, W/2, C_out)."""
    dt = x.dtype
    N, H, W, C = x.shape
    h = torch.relu(x.float() * a + b)
    pooled = ((h[:, 0::2, 0::2] + h[:, 1::2, 0::2])
              + (h[:, 0::2, 1::2] + h[:, 1::2, 1::2])) * 0.25
    pooled = pooled.to(dt).float().reshape(-1, C)
    out = pooled @ wt.float()
    return out.reshape(N, H // 2, W // 2, wt.shape[1]).to(dt)


def transition(x, a, b, wt, out=None):
    """x (N, H, W, C) bf16 (H, W even); a, b (C,) f32; wt (C, C_out) bf16.

    `out` may be a channel slice of the next dense block's NHWC buffer.
    """
    global launches
    if x.device.type == "cpu":
        res = transition_plain(x, a, b, wt)
        if out is None:
            return res
        out.copy_(res)
        return out
    N, H, W, C = x.shape
    C_out = wt.shape[1]
    _build.check_cuda(x, "x", torch.bfloat16)
    _build.check_cuda(a, "a", torch.float32, (C,))
    _build.check_cuda(b, "b", torch.float32, (C,))
    _build.check_cuda(wt, "wt", torch.bfloat16, (C, C_out))
    if H % 2 or W % 2 or C % 32 or C_out % 128:
        raise ValueError(f"unsupported transition shape {tuple(x.shape)} -> "
                         f"{C_out}")
    if out is None:
        out = torch.empty((N, H // 2, W // 2, C_out), dtype=torch.bfloat16,
                          device=x.device)
    ld = _build.check_nhwc_view(out, "out", torch.bfloat16,
                                (N, H // 2, W // 2, C_out))
    _build.launch("smg_transition", x.data_ptr(), a.data_ptr(), b.data_ptr(),
                  wt.data_ptr(), out.data_ptr(), N, H, W, C, C, C_out, ld)
    launches += 1
    return out
