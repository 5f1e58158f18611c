"""K3: the DenseNet transition — BN affine, ReLU, 2x2 mean, 1x1 conv (csrc/transition.cu).

Port of smg_tpu/ops/transition_pallas.py::transition. The pool is commuted
ahead of the 1x1 (exact for a linear map); the pooled value is
((h00 + h10) + (h01 + h11)) * 0.25 in f32, rounded to the working dtype
(transition_pallas.py:46-51), then contracted with f32 accumulation.

The kernel is common.cuh's transition_kernel, which K7's transition
epilogue runs too (with K7's bf16-arithmetic pool). transition_plan below
picks its tile: the pooled pixels a block pools once for all C channels
into shared memory, and the output columns of one pass of its product.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from smg_tpu_torch.ops import _build
from smg_tpu_torch.ops.conv2 import C3_SMEM_LIMIT, H100_SMS

launches = 0

# transition_kernel's instantiations: (pooled pixels per block, output
# columns per pass), 8 warps of 32 x 64 each.
TR_TILES = ((128, 128), (64, 256), (32, 512))
TR_RING_BYTES = 3 * 16384      # the cp.async ring: pool stages, then weight k-slices
SM_SMEM = 233472               # an H100 SM's shared memory, 1 KB of it reserved per block
BLOCK_RESERVED = 1024
POOL_STAGE_VALUES = 2048       # pooled values (pixels x channels) per 16 KB pool stage


class TransitionPlan(NamedTuple):
    rows: int         # pooled pixels per block
    cols: int         # output columns per pass of the product
    kc: int           # channels per pool stage (divides C)
    grid: int         # blocks: cdiv(Q, rows)
    smem_bytes: int   # the resident pooled tile (C rounded up to 64) and the ring

    def args(self):
        """The ints the C entry points take."""
        return self.rows, self.cols, self.kc, self.grid, self.smem_bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def transition_smem(rows: int, C: int) -> int:
    """The block's shared memory: a rows x round_up(C, 64) bf16 pooled tile
    and the ring."""
    return rows * _cdiv(C, 64) * 64 * 2 + TR_RING_BYTES


@functools.lru_cache(maxsize=None)
def transition_plan(Q: int, C: int, C_out: int, sms: int = H100_SMS) -> TransitionPlan:
    """The tile of Q pooled pixels, C -> C_out channels (C a multiple of 32,
    C_out of 128): among the instantiations whose shared memory fits, the
    one with the most blocks up to one per SM, then no idle columns (C_out a
    multiple of its pass), then two blocks per SM (one pools while the
    other multiplies), then the most rows (fewer re-reads of the weight).
    At the DenseNet shapes, pooled tiles of 128 x 256, 64 x 512 and
    32 x 1024 (64 KB each), one pass over all of C_out. Memoized per shape."""
    if C % 32 or C_out % 128 or C <= 0:
        raise ValueError(f"unsupported transition: C {C} -> {C_out}")
    kc = next(k for k in (256, 128, 64, 32) if C % k == 0)
    best = None
    for rows, cols in TR_TILES:
        smem = transition_smem(rows, C)
        if smem > C3_SMEM_LIMIT:
            continue
        blocks = _cdiv(Q, rows)
        key = (min(blocks, sms), C_out % cols == 0,
               2 * (smem + BLOCK_RESERVED) <= SM_SMEM, rows)
        if best is None or key > best[0]:
            best = (key, TransitionPlan(rows, cols, kc, blocks, smem))
    if best is None:
        raise ValueError(f"unsupported transition: C {C} does not fit shared memory")
    return best[1]


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
    On the card C is a multiple of 32, C_out of 128, and x holds fewer than
    2^31 elements.
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
    _build.check_int32("x", x.numel())
    _build.check_aligned(x=x, a=a, b=b, wt=wt)
    if out is None:
        out = torch.empty((N, H // 2, W // 2, C_out), dtype=torch.bfloat16,
                          device=x.device)
    ld = _build.check_nhwc_view(out, "out", torch.bfloat16,
                                (N, H // 2, W // 2, C_out))
    plan = transition_plan(N * (H // 2) * (W // 2), C, C_out, _build.sm_count(x.device))
    _build.launch("smg_transition", x.data_ptr(), a.data_ptr(), b.data_ptr(),
                  wt.data_ptr(), out.data_ptr(), N, H, W, C, C, C_out, ld, *plan.args())
    launches += 1
    return out
