"""K6: the train-mode dense layer, forward and backward (csrc/dense_layer_train.cu).

Port of smg_tpu/ops/dense_layer_train_pallas.py::layer_train_fwd (K6a) and
::layer_train_bwd (K6b), the kernels of the JAX update under
fast_train_conv2='pk'. There each scene ran its layer as a batch-1 call;
here one call covers N images of a dense block's NHWC buffer, each with
its own BatchNorm moments over (H, W), which is what vmap over batch-1
calls computed. For the prefix x = buf[..., :C_in]:

  forward   m1, v1 = E[x], E[x^2] - E[x]^2 per image;  a1 = s1 rsqrt(v1 + eps)
            h1 = bf16( sum_c bf16(relu(x a1 + b1)) w1 )          (the residual)
            m2, v2 of h1;  y2 = bf16(relu(h1 a2 + b2)), zero off the image
            out = bf16( sum_tap bf16(y2[pixel + tap] w2[tap]) )   -> buf[C_in:+32]
  backward  from dout = bf16(dbuf[..., C_in:C_in+32]) (an f32 cotangent
            buffer): dw1, dw2 and the BN scale/bias gradients, summed over
            images, and dbuf[..., :C_in] += bf16(dx).

The rounding points are the TPU kernel's; in float32 (the CPU tests) they
vanish and the layer is _layer_vjp's. The plain versions below repeat the
arithmetic in PyTorch; the wrappers take them only for CPU tensors.

`dense_block_train` wraps a whole dense block in one autograd Function:
the eval path's in-place block buffer breaks a per-layer autograd graph.
Its forward runs K6a layer by layer into the buffer and saves the final
buffer (layer l's input is its first C_in(l) channels), each h1 and the
moments; its backward walks the layers in reverse through K6b, summing
each prefix's cotangent in an f32 block buffer. The JAX package summed
those cotangents in bf16 (autodiff of its segment list); the port sums in
f32, so in bf16 its input gradients carry less rounding than JAX's, and
the two agree only to bf16 tolerance. In float32 they agree to rounding.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from smg_tpu_torch.ops import _build
from smg_tpu_torch.ops.conv2 import (C3_SMEM_LIMIT, C3_STAGE_COST, C3_SUBPARTITIONS,
                                     C3_TILE_COST, H100_SMS, conv3x3_plan)
from smg_tpu_torch.ops.dense_layer import gemm_rows

fwd_launches = 0
bwd_launches = 0

BOTTLENECK = 128
GROWTH = 32
N_TAPS = 9
BN_EPS = 1e-5


def _img(t: torch.Tensor) -> torch.Tensor:
    """(N, C) per-image values -> broadcastable over (N, H, W, C)."""
    return t[:, None, None, :]


def _moments(x: torch.Tensor):
    """Per-image mean and E[x^2] - E[x]^2 over (H, W) of f32 (N, H, W, C)."""
    m = x.mean(dim=(1, 2))
    return m, (x * x).mean(dim=(1, 2)) - m * m


def _affine(mean, var, scale, bias):
    a = scale * torch.rsqrt(var + BN_EPS)
    return a, bias - mean * a


def _shifted(d: torch.Tensor, tap: int) -> torch.Tensor:
    """d[pixel + (1 - dy, 1 - dx)] with zeros off the image, tap = 3 dy + dx."""
    dy, dx = divmod(tap, 3)
    H, W = d.shape[1:3]
    dp = F.pad(d, (0, 0, 1, 1, 1, 1))
    return dp[:, 2 - dy:2 - dy + H, 2 - dx:2 - dx + W]


def layer_fwd_plain(buf, c_in, w1, s1, bi1, w2, s2, bi2):
    """Plain K6a. buf (N, H, W, ld) in the compute dtype; writes the 32 new
    channels at [c_in, c_in + 32). Returns (h1, mean1, var1, mean2, var2)."""
    dt = buf.dtype
    N, H, W, _ = buf.shape
    x = buf[..., :c_in].float()
    m1, v1 = _moments(x)
    a1, b1 = _affine(m1, v1, s1, bi1)
    y1 = torch.relu(x * _img(a1) + _img(b1)).to(dt).float()
    h1 = (y1.reshape(-1, c_in) @ w1.float()).to(dt).reshape(N, H, W, BOTTLENECK)
    h1f = h1.float()
    m2, v2 = _moments(h1f)
    a2, b2 = _affine(m2, v2, s2, bi2)
    y2 = torch.relu(h1f * _img(a2) + _img(b2)).to(dt).float()
    yp = F.pad(y2, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((N, H, W, GROWTH), dtype=torch.float32, device=buf.device)
    for tap in range(N_TAPS):
        dy, dx = divmod(tap, 3)
        acc = acc + (yp[:, dy:dy + H, dx:dx + W] @ w2[tap].float()).to(dt).float()
    buf[..., c_in:c_in + GROWTH] = acc.to(dt)
    return h1, m1, v1, m2, v2


def layer_bwd_plain(buf, dbuf, c_in, h1, w1, w2, s1, bi1, s2, bi2, m1, v1, m2, v2):
    """Plain K6b. dbuf (N, H, W, ld) f32: reads the layer's cotangent at
    [c_in, c_in + 32), adds bf16(dx) to [0, c_in). Returns
    (dw1 (C_in, 128), dw2 (9, 128, 32), dscale1, dbias1, dscale2, dbias2)."""
    dt = buf.dtype
    N, H, W, _ = buf.shape
    n = float(H * W)
    dout = dbuf[..., c_in:c_in + GROWTH].to(dt).float()
    shifted = [_shifted(dout, tap) for tap in range(N_TAPS)]
    h1f = h1.float()
    r2 = torch.rsqrt(v2 + BN_EPS)
    a2, b2 = _affine(m2, v2, s2, bi2)
    u2 = h1f * _img(a2) + _img(b2)
    dy2 = sum(shifted[t] @ w2[t].float().t() for t in range(N_TAPS))
    du2 = torch.where(u2 > 0, dy2, torch.zeros_like(dy2))
    xh2 = (h1f - _img(m2)) * _img(r2)
    sdu2, sduh2 = du2.sum(dim=(1, 2)), (du2 * xh2).sum(dim=(1, 2))
    dh1 = (_img(a2) * (du2 - _img(sdu2 / n) - xh2 * _img(sduh2 / n))).to(dt).float()
    y2 = torch.relu(u2).to(dt).float().reshape(-1, BOTTLENECK)
    dw2 = torch.stack([y2.t() @ shifted[t].reshape(-1, GROWTH)
                       for t in range(N_TAPS)])
    x = buf[..., :c_in].float()
    r1 = torch.rsqrt(v1 + BN_EPS)
    a1, b1 = _affine(m1, v1, s1, bi1)
    u1 = x * _img(a1) + _img(b1)
    y1 = torch.relu(u1).to(dt).float().reshape(-1, c_in)
    dh1_2d = dh1.reshape(-1, BOTTLENECK)
    dw1 = y1.t() @ dh1_2d
    dy1 = (dh1_2d @ w1.float().t()).reshape(u1.shape)
    du1 = torch.where(u1 > 0, dy1, torch.zeros_like(dy1))
    xh1 = (x - _img(m1)) * _img(r1)
    sdu1, sduh1 = du1.sum(dim=(1, 2)), (du1 * xh1).sum(dim=(1, 2))
    dx = _img(a1) * (du1 - _img(sdu1 / n) - xh1 * _img(sduh1 / n))
    dbuf[..., :c_in] += dx.to(dt).float()
    return (dw1, dw2, sduh1.sum(0), sdu1.sum(0), sduh2.sum(0), sdu2.sum(0))


# The kernels' tile geometry (csrc/dense_layer_train.cu).
SLOT_COUNTS = (4, 16, 64)     # image slots a tile's per-image table may have (instantiated)
DY1_ROWS = 128                # dy1_kernel's tile: up to 128 pixels x 128 channels
GEMM_BK = 64                  # K6a's GEMM (common.cuh gemm_bnrelu_kernel): k-slice,
GEMM_STAGES = 3               # ring stages
DY1_TAB = 6                   # dy1_kernel's per-(slot, channel) values
W2_BYTES = N_TAPS * BOTTLENECK * GROWTH * 2   # the resident tap weights
DOUT_PX_BYTES = GROWTH * 2    # a pixel of the compact bf16 dout
DW1_STAGE_PIXELS = 64         # dw1_kernel's staged pixels


class TilePlan(NamedTuple):
    """Tiles of `rows` x `cols` pixels of one image, walked by a persistent
    grid of `grid` blocks with `smem_bytes` of dynamic shared memory."""
    rows: int
    cols: int
    tiles: int
    grid: int
    smem_bytes: int

    def args(self):
        """The ints the C entry point takes."""
        return self.rows, self.cols, self.grid, self.smem_bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dgrad_smem(rows: int, cols: int) -> int:
    """dy2_kernel's shared memory: the tap weights, two dout halo patches,
    the image's a2, b2, m2, r2 and two sums per channel per 32-pixel group."""
    patch = (rows + 2) * (cols + 2)
    return (W2_BYTES + 2 * patch * DOUT_PX_BYTES + 4 * BOTTLENECK * 4
            + _cdiv(rows * cols, 32) * 2 * BOTTLENECK * 4)


def dw2_smem(rows: int, cols: int) -> int:
    """dw2_kernel's shared memory: two buffers of (dout halo patch, the
    tile's y2 rows, its patch-pixel table), a zero row and a2, b2."""
    patch, m = (rows + 2) * (cols + 2), rows * cols
    return 2 * (patch * DOUT_PX_BYTES + m * 256 + _cdiv(m * 4, 16) * 16) + 256 + 2 * BOTTLENECK * 4


def _image_tiles(N, H, W, sms, smem, cost, fill=True):
    """The cheapest tiling of N images of H x W into rows x cols tiles of one
    image (the widest column band that fits each row count) whose shared
    memory fits, by cost(rows, cols, tiles); with `fill`, among those that
    give at least `sms` tiles when any does."""
    cands = []
    for rows in range(1, H + 1):
        cols = next((c for c in range(W, 0, -1) if smem(rows, c) <= C3_SMEM_LIMIT), 0)
        if cols == 0:
            break
        cols = _cdiv(W, _cdiv(W, cols))
        cands.append((_cdiv(H, _cdiv(H, rows)), cols))
    cands = sorted(set(cands))
    tiles = {c: N * _cdiv(H, c[0]) * _cdiv(W, c[1]) for c in cands}
    full = [c for c in cands if fill and tiles[c] >= sms]
    rows, cols = min(full or cands, key=lambda c: (cost(*c, tiles[c]), tiles[c]))
    t = tiles[(rows, cols)]
    return rows, cols, t


@functools.lru_cache(maxsize=None)
def dgrad_plan(N: int, H: int, W: int, sms: int = H100_SMS) -> TilePlan:
    """The transposed 3x3's tiles (dy2_kernel), by the 3x3's cost model
    (ops/conv2.py) in its unit: a task of 32 pixels x 64 channels is half a
    3x3 task, four sub-partitions per SM, a patch pixel a quarter of the
    3x3's to stage. Memoized per shape."""
    def cost(rows, cols, tiles):
        tasks = 2 * _cdiv(rows * cols, 32)
        per_tile = (0.5 * _cdiv(tasks, C3_SUBPARTITIONS) + C3_TILE_COST
                    + C3_STAGE_COST / 4 * (rows + 2) * (cols + 2))
        return max(1.0, tiles / sms) * per_tile

    rows, cols, tiles = _image_tiles(N, H, W, sms, dgrad_smem, cost)
    return TilePlan(rows, cols, tiles, min(tiles, sms), dgrad_smem(rows, cols))


@functools.lru_cache(maxsize=None)
def dw2_plan(N: int, H: int, W: int, sms: int = H100_SMS) -> TilePlan:
    """dw2_kernel's tiles: every warp walks every pixel of a tile in steps of
    16, so a tile costs its 16-pixel steps plus a fixed cost (a staging
    round and three barriers, about 8 steps); rounds of `sms` tiles. Each
    block writes a 147 KB partial, so fewer tiles than SMs are not
    penalised (a plan that bounded the grid by the pixels per block to cut
    the partials measured slower). Memoized per shape."""
    def cost(rows, cols, tiles):
        return _cdiv(tiles, sms) * (_cdiv(rows * cols, 16) + 8)

    rows, cols, tiles = _image_tiles(N, H, W, sms, dw2_smem, cost, fill=False)
    return TilePlan(rows, cols, tiles, min(tiles, sms), dw2_smem(rows, cols))


@functools.lru_cache(maxsize=None)
def h1_chunks(N: int, HW: int, sms: int = H100_SMS):
    """(splits, chunk) of each image's pixels for h1's moments: about two
    blocks per SM over the N images, chunks of at least 64 pixels."""
    splits = max(1, min(_cdiv(HW, 64), _cdiv(2 * sms, N)))
    chunk = _cdiv(HW, splits)
    return _cdiv(HW, chunk), chunk


@functools.lru_cache(maxsize=None)
def dw1_split(P: int, c_in: int, sms: int = H100_SMS):
    """(splits, chunk) of the pixel axis for dw1_kernel: about two blocks
    per SM over the cdiv(C_in, 128) channel tiles, chunks a multiple of the
    64-pixel stage."""
    target = max(1, _cdiv(2 * sms, _cdiv(c_in, 128)))
    chunk = _cdiv(P, target)
    chunk = _cdiv(chunk, DW1_STAGE_PIXELS) * DW1_STAGE_PIXELS
    return _cdiv(P, chunk), chunk


def span(rows: int, HW: int) -> int:
    """The most images that a run of `rows` consecutive pixels of images of
    HW pixels each can touch."""
    return min(rows, _cdiv(rows - 1, HW) + 1)


def gemm_smem(bm: int, slots: int) -> int:
    """K6a's GEMM's shared memory (common.cuh::gemmn_smem_bytes): per ring
    stage the x and w1 tiles of a 64-deep k-slice and that slice's (a, b)
    for each image slot."""
    return GEMM_STAGES * (bm * GEMM_BK * 2 + GEMM_BK * BOTTLENECK * 2 + slots * 2 * GEMM_BK * 4)


def dy1_smem(slots: int) -> int:
    """dy1_kernel's shared memory: its dh1, w1 and x tiles (128 x 128 bf16
    each) and six values per slot and channel."""
    return 3 * DY1_ROWS * BOTTLENECK * 2 + DY1_TAB * slots * BOTTLENECK * 4


def _slots(images, smem):
    """The fewest instantiated slots that hold `images` and fit, or None."""
    return next((s for s in SLOT_COUNTS if s >= images and smem(s) <= C3_SMEM_LIMIT), None)


class ImagePlan(NamedTuple):
    """The pixel tiles that may span several images, each with a table of
    per-image values, one slot per image: K6a's GEMM (tiles of `gemm_rows`
    pixels, `gemm_slots` slots) and dy1 (`dy1_rows` pixels of its 128-row
    tile, `dy1_slots` slots)."""
    gemm_rows: int
    gemm_slots: int
    dy1_rows: int
    dy1_slots: int


@functools.lru_cache(maxsize=None)
def image_plan(N: int, HW: int, sms: int = H100_SMS) -> ImagePlan:
    """Tile rows and slot counts for N images of HW pixels. A run of r pixels
    spans up to cdiv(r - 1, HW) + 1 images: 4 for 128 rows where HW >= 43
    (the training path at 224), up to 128 for 1-pixel images. The GEMM
    keeps K2's tile rows (gemm_rows) where their slots fit its shared
    memory, else takes 64-row tiles (64 slots at most); dy1 takes the
    longest power-of-two run up to 128 rows whose slots fit (16 rows of
    1-pixel images). Memoized per shape."""
    bm = gemm_rows(N * HW, sms)
    slots = _slots(span(bm, HW), lambda s: gemm_smem(bm, s))
    if slots is None:
        bm = 64
        slots = _slots(span(bm, HW), lambda s: gemm_smem(bm, s))
    rows = DY1_ROWS
    while _slots(span(rows, HW), dy1_smem) is None:
        rows //= 2
    return ImagePlan(bm, slots, rows, _slots(span(rows, HW), dy1_smem))


def _check_layer(buf, c_in, w1, s1, bi1, w2, s2, bi2):
    ld = buf.shape[-1]
    _build.check_cuda(buf, "buf", torch.bfloat16)
    _build.check_cuda(w1, "w1", torch.bfloat16, (c_in, BOTTLENECK))
    _build.check_cuda(s1, "s1", torch.float32, (c_in,))
    _build.check_cuda(bi1, "bi1", torch.float32, (c_in,))
    _build.check_cuda(w2, "w2", torch.bfloat16, (N_TAPS, BOTTLENECK, GROWTH))
    _build.check_cuda(s2, "s2", torch.float32, (BOTTLENECK,))
    _build.check_cuda(bi2, "bi2", torch.float32, (BOTTLENECK,))
    if c_in % 32 or c_in + GROWTH > ld or ld % 8 or buf.dim() != 4:
        raise ValueError(f"unsupported layer: C_in {c_in}, buffer {tuple(buf.shape)}")
    _build.check_int32("buf", buf.shape[0] * buf.shape[1] * buf.shape[2] * max(ld, BOTTLENECK))
    _build.check_aligned(buf=buf, w1=w1, w2=w2)


def _check_moments(mean, var, name, n, c):
    """(N, C) f32 moments whose rows may be a channel prefix of a wider
    per-block buffer: returns their row stride."""
    for t, nm in ((mean, "mean" + name), (var, "var" + name)):
        _build.check_cuda(t, nm, torch.float32, (n, c), contiguous=False)
        if t.stride(1) != 1 or t.stride(0) != mean.stride(0):
            raise ValueError(f"{nm}: expected rows of unit stride, got {t.stride()}")
    return mean.stride(0)


def layer_fwd(buf, c_in: int, w1, s1, bi1, w2, s2, bi2, moments=None, known: int = 0):
    """K6a, in place in the block buffer buf (N, H, W, ld).

    w1 (C_in, 128), w2 (9, 128, 32) in buf's dtype (tap = 3 dy + dx);
    s1, bi1 (C_in,), s2, bi2 (128,) f32: norm1's and norm2's scale and bias.
    Returns h1 (N, H, W, 128) in buf's dtype and the per-image moments
    mean1, var1 (N, C_in), mean2, var2 (N, 128) f32.
    `moments`: on the card, the dense block's (2, N, C_block) f32 buffer of
    per-image means and variances, whose channels [0, known) hold the
    prefix's already (the moments of a channel do not change once it is
    written); the layer adds [known, C_in) and returns views of it. Without
    it the layer computes all C_in. The CPU takes the plain version.
    On the card buf and the weights are bf16, C_in is a multiple of 32 and
    N H W max(ld, 128) is below 2^31 (the kernels' 32-bit indices).
    """
    global fwd_launches
    if buf.device.type == "cpu":
        return layer_fwd_plain(buf, c_in, w1, s1, bi1, w2, s2, bi2)
    _check_layer(buf, c_in, w1, s1, bi1, w2, s2, bi2)
    N, H, W, ld = buf.shape
    dev = buf.device
    if moments is None:
        moments, known = torch.empty((2, N, c_in), dtype=torch.float32, device=dev), 0
    _build.check_cuda(moments, "moments", torch.float32)
    if moments.dim() != 3 or moments.shape[:2] != (2, N) or not 0 <= known <= c_in \
            or known % 32 or moments.shape[2] < c_in:
        raise ValueError(f"moments: expected (2, {N}, >= {c_in}), known <= C_in a multiple "
                         f"of 32; got {tuple(moments.shape)}, known {known}")
    h1 = torch.empty((N, H, W, BOTTLENECK), dtype=torch.bfloat16, device=dev)
    st2 = torch.empty((4, N, BOTTLENECK), dtype=torch.float32, device=dev)
    sms = _build.sm_count(dev)
    ip = image_plan(N, H * W, sms)
    splits, chunk = h1_chunks(N, H * W, sms)
    h1_part = torch.empty((N, splits, 2, BOTTLENECK), dtype=torch.float32, device=dev)
    _build.launch("smg_dense_layer_train_fwd", buf.data_ptr(), w1.data_ptr(),
                  s1.data_ptr(), bi1.data_ptr(), w2.data_ptr(), s2.data_ptr(),
                  bi2.data_ptr(), h1.data_ptr(), moments.data_ptr(), st2.data_ptr(),
                  h1_part.data_ptr(), N, H, W, ld, c_in, moments.shape[2], known,
                  ip.gemm_rows, ip.gemm_slots, splits, chunk,
                  *conv3x3_plan(N, H, W, sms).args())
    fwd_launches += 1
    return h1, moments[0, :, :c_in], moments[1, :, :c_in], st2[0], st2[1]


class Scratch:
    """K6b's scratch, flat buffers reused by the layers of one dense block's
    backward: allocated at the first (widest) layer, views after."""

    def __init__(self, device):
        self.device = device
        self.bufs = {}

    def get(self, name, shape, dtype=torch.float32):
        n = math.prod(shape)
        b = self.bufs.get(name)
        if b is None or b.numel() < n:
            b = self.bufs[name] = torch.empty(n, dtype=dtype, device=self.device)
        return b[:n].view(shape)


def layer_bwd(buf, dbuf, c_in: int, h1, w1, w2, s1, bi1, s2, bi2, m1, v1, m2, v2,
              scratch=None):
    """K6b: the backward of layer_fwd, accumulating into dbuf.

    dbuf (N, H, W, ld) f32 holds the block's cotangent: the layer reads its
    32 channels' cotangent at [c_in, c_in + 32) and adds bf16(dx) to
    [0, c_in). The other operands are layer_fwd's inputs and outputs.
    `scratch`: a Scratch shared by the layers of one block (else made here).
    Returns (dw1 (C_in, 128), dw2 (9, 128, 32), dscale1, dbias1 (C_in,),
    dscale2, dbias2 (128,)), all f32 and summed over the N images; every
    reduction runs in a fixed order (deterministic).
    """
    global bwd_launches
    if buf.device.type == "cpu":
        return layer_bwd_plain(buf, dbuf, c_in, h1, w1, w2, s1, bi1, s2, bi2,
                               m1, v1, m2, v2)
    _check_layer(buf, c_in, w1, s1, bi1, w2, s2, bi2)
    N, H, W, ld = buf.shape
    _build.check_cuda(dbuf, "dbuf", torch.float32, (N, H, W, ld))
    _build.check_cuda(h1, "h1", torch.bfloat16, (N, H, W, BOTTLENECK))
    ldm1 = _check_moments(m1, v1, "1", N, c_in)
    _check_moments(m2, v2, "2", N, BOTTLENECK)
    if m2.stride(0) != BOTTLENECK:
        raise ValueError("mean2, var2: expected contiguous (N, 128) rows")
    dev, P = buf.device, N * H * W
    sms = _build.sm_count(dev)
    dg, dw = dgrad_plan(N, H, W, sms), dw2_plan(N, H, W, sms)
    ip = image_plan(N, H * W, sms)
    splits, chunk = dw1_split(P, c_in, sms)
    sc = scratch if scratch is not None else Scratch(dev)
    bf = torch.bfloat16
    aff1 = sc.get("aff1", (3, N, c_in))
    aff2 = sc.get("aff2", (3, N, BOTTLENECK))
    dc = sc.get("dc", (P, GROWTH), bf)
    du2 = sc.get("du2", (P, BOTTLENECK))
    dh1 = sc.get("dh1", (P, BOTTLENECK), bf)
    part_dy2 = sc.get("part_dy2", (dg.tiles, 2, BOTTLENECK))
    part_dy1 = sc.get("part_dy1", (_cdiv(P, ip.dy1_rows), ip.dy1_slots, 2, c_in))
    sums1 = sc.get("sums1", (2, N, c_in))
    sums2 = sc.get("sums2", (2, N, BOTTLENECK))
    part_w1 = sc.get("part_w1", (splits, c_in, BOTTLENECK))
    part_w2 = sc.get("part_w2", (dw.grid, N_TAPS, BOTTLENECK, GROWTH))
    n1, n2 = c_in * BOTTLENECK, N_TAPS * BOTTLENECK * GROWTH
    grads = torch.empty(n1 + n2 + 2 * c_in + 2 * BOTTLENECK, dtype=torch.float32, device=dev)
    _build.launch("smg_dense_layer_train_bwd", buf.data_ptr(), dbuf.data_ptr(),
                  h1.data_ptr(), w1.data_ptr(), w2.data_ptr(), s1.data_ptr(),
                  bi1.data_ptr(), m1.data_ptr(), v1.data_ptr(), ldm1, s2.data_ptr(),
                  bi2.data_ptr(), m2.data_ptr(), v2.data_ptr(), aff1.data_ptr(),
                  aff2.data_ptr(), dc.data_ptr(), du2.data_ptr(), dh1.data_ptr(),
                  part_dy2.data_ptr(), part_dy1.data_ptr(), sums1.data_ptr(),
                  sums2.data_ptr(), part_w1.data_ptr(), part_w2.data_ptr(),
                  grads.data_ptr(), N, H, W, ld, c_in, *dg.args(), *dw.args(), splits,
                  chunk, ip.dy1_rows, ip.dy1_slots)
    bwd_launches += 1
    dw1, dw2, bn1, bn2 = grads.split((n1, n2, 2 * c_in, 2 * BOTTLENECK))
    return (dw1.view(c_in, BOTTLENECK), dw2.view(N_TAPS, BOTTLENECK, GROWTH),
            bn1[:c_in], bn1[c_in:], bn2[:BOTTLENECK], bn2[BOTTLENECK:])


class _DenseBlockTrain(torch.autograd.Function):
    """A dense block through K6: see the module docstring."""

    @staticmethod
    def forward(ctx, x0, *flat):
        L = len(flat) // 6
        N, H, W, C0 = x0.shape
        dt = x0.dtype
        buf = torch.empty((N, H, W, C0 + GROWTH * L), dtype=dt, device=x0.device)
        buf[..., :C0] = x0
        # The block's per-image moments: each channel's once, when written.
        block_moments = torch.empty((2, N, C0 + GROWTH * (L - 1)), dtype=torch.float32,
                                    device=x0.device)
        saved, moments = [], []
        for l in range(L):
            w1f, s1, bi1, w2f, s2, bi2 = flat[6 * l:6 * l + 6]
            c_in = C0 + GROWTH * l
            out = layer_fwd(buf, c_in, w1f.to(dt).contiguous(), s1,
                            bi1, w2f.to(dt).contiguous(), s2, bi2,
                            moments=block_moments, known=c_in - GROWTH if l else 0)
            saved += out
            moments += out[1:]
        ctx.save_for_backward(buf, *flat, *saved)
        ctx.layers, ctx.c0 = L, C0
        ctx.mark_non_differentiable(*moments)
        return (buf, *moments)

    @staticmethod
    def backward(ctx, dout, *_):
        buf, *rest = ctx.saved_tensors
        L, C0 = ctx.layers, ctx.c0
        flat, saved = rest[:6 * L], rest[6 * L:]
        dt = buf.dtype
        dbuf = torch.empty(buf.shape, dtype=torch.float32, device=buf.device)
        dbuf.copy_(dout)
        grads = [None] * (6 * L)
        scratch = Scratch(buf.device)
        for l in reversed(range(L)):
            w1f, s1, bi1, w2f, s2, bi2 = flat[6 * l:6 * l + 6]
            h1, m1, v1, m2, v2 = saved[5 * l:5 * l + 5]
            dw1, dw2, ds1, db1, ds2, db2 = layer_bwd(
                buf, dbuf, C0 + GROWTH * l, h1, w1f.to(dt).contiguous(),
                w2f.to(dt).contiguous(), s1, bi1, s2, bi2, m1, v1, m2, v2,
                scratch=scratch)
            grads[6 * l:6 * l + 6] = [dw1, ds1, db1, dw2, ds2, db2]
        return (dbuf[..., :C0].to(dt), *grads)


def dense_block_train(x0: torch.Tensor, layers) -> tuple:
    """A train-mode dense block through K6 with autograd.

    x0 (N, H, W, C0) in the compute dtype; `layers` a sequence of
    (w1 (C_in, 128), s1, bi1, w2 (9, 128, 32), s2, bi2) f32 tensors (views
    of the module's parameters, so that the gradients reach them).
    Returns (buf (N, H, W, C0 + 32 L), [(mean1, var1, mean2, var2)] * L)
    with per-image moments (N, C) that carry no gradient.
    """
    flat = [t for layer in layers for t in layer]
    out = _DenseBlockTrain.apply(x0, *flat)
    buf, moments = out[0], out[1:]
    return buf, [tuple(moments[4 * l:4 * l + 4]) for l in range(len(layers))]
