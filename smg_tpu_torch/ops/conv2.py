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

The kernel is common.cuh's conv3x3_kernel, the 3x3 of every dense-layer
kernel (K2, K5, K6a, K7). conv3x3_plan below cuts its output into tiles
whose halo patches fit in shared memory beside the resident tap weights;
each wrapper passes the plan to its kernel as ints.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from smg_tpu_torch.ops import _build

launches = 0

BOTTLENECK = 128
GROWTH = 32
N_TAPS = 9

# The 3x3 kernel's shared memory: the tap weights, resident, and two halo
# patches (one computed on, one being loaded) of 128 bf16 per pixel.
C3_SMEM_LIMIT = 232448                       # 227 KB: a block's most on the H100
C3_WEIGHT_BYTES = N_TAPS * BOTTLENECK * GROWTH * 2
C3_PIXEL_BYTES = BOTTLENECK * 2
C3_PATCH_PIXELS = (C3_SMEM_LIMIT - C3_WEIGHT_BYTES) // (2 * C3_PIXEL_BYTES)   # 310
H100_SMS = 132


C3_SUBPARTITIONS = 4          # of an SM: warp w of a block issues on w % 4
# The plan's cost model, in units of one warp's 32-pixel task (the time of
# its 9 x 8 x 8 mma.sync): staging a patch pixel, and a tile's fixed cost
# (barriers, the stores' address math), fitted to a chip run of the kernel.
C3_STAGE_COST = 0.003
C3_TILE_COST = 0.5


class Conv3x3Plan(NamedTuple):
    images: int       # a tile is `images` whole images (rows == H, cols == W),
    rows: int         # or `rows` x `cols` of one image
    cols: int
    tiles: int
    grid: int         # persistent blocks: min(tiles, SMs)
    smem_bytes: int   # weights + two (rows + 2) x (cols + 2) patches per image

    def args(self):
        """The ints the C entry points take."""
        return self.images, self.rows, self.cols, self.grid, self.smem_bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_count(N, H, W, images, rows, cols):
    return _cdiv(N, images) * _cdiv(H, rows) * _cdiv(W, cols)


def _tile_cost(N, H, W, images, rows, cols, sms):
    """Estimated time of the whole 3x3: the rounds of tiles the persistent
    grid walks, each as long as the tile's busiest SM sub-partition (warp
    task u runs on sub-partition u % 4) plus its staging and fixed cost."""
    tiles = _tile_count(N, H, W, images, rows, cols)
    tasks = _cdiv(images * rows * cols, 32)
    per_tile = (_cdiv(tasks, C3_SUBPARTITIONS) + C3_TILE_COST
                + C3_STAGE_COST * images * (rows + 2) * (cols + 2))
    return max(1.0, tiles / sms) * per_tile


@functools.lru_cache(maxsize=None)
def conv3x3_plan(N: int, H: int, W: int, sms: int = H100_SMS) -> Conv3x3Plan:
    """Tiles of the 3x3 over N images of H x W whose halo patch (tile + 1
    pixel all round) holds at most C3_PATCH_PIXELS pixels: whole images, or
    `rows` x `cols` of one image (the widest even column bands that fit
    each row count). Of these, the cheapest by _tile_cost among those that
    give at least `sms` tiles, when any does; else the cheapest. Memoized:
    a layer's wrapper asks for the same plan on every call."""
    cap = C3_PATCH_PIXELS
    cands = []
    for images in range(1, min(N, cap // ((H + 2) * (W + 2))) + 1):
        cands.append((_cdiv(N, _cdiv(N, images)), H, W))
    for rows in range(1, min(H, cap // 3 - 2) + 1):
        cols = _cdiv(W, _cdiv(W, cap // (rows + 2) - 2))
        cands.append((1, _cdiv(H, _cdiv(H, rows)), cols))
    full = [c for c in cands if _tile_count(N, H, W, *c) >= sms]
    images, rows, cols = min(full or cands, key=lambda c: (
        _tile_cost(N, H, W, *c, sms), _tile_count(N, H, W, *c)))
    tiles = _tile_count(N, H, W, images, rows, cols)
    patch = images * (rows + 2) * (cols + 2)
    return Conv3x3Plan(images, rows, cols, tiles, min(tiles, sms),
                       C3_WEIGHT_BYTES + 2 * patch * C3_PIXEL_BYTES)


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
    _build.check_aligned(h1=h1, w2=w2)
    _build.launch("smg_conv2_bn_relu", h1.data_ptr(), a.data_ptr(), b.data_ptr(),
                  w2.data_ptr(), out.data_ptr(), N, H, W, ld,
                  *conv3x3_plan(N, H, W, _build.sm_count(h1.device)).args())
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
