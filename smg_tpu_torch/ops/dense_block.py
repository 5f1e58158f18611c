"""K7: a whole eval dense block and its fused epilogue (csrc/dense_block.cu).

Port of smg_tpu/ops/dense_block_pallas.py::dense_block_apply (with
pack_dense_block, pack_transition, pack_final_bn), the `pallas` eval
backend (fast_trunk.py:382-401). The block's NHWC buffer holds the block
input in channels [0, C0); layer l (C = C0 + 32 l) computes

  y1  = bf16( relu(x[..., :C] * a1 + b1) )
  t   = y1 @ w1                            one f32 accumulation, not rounded
  h2  = bf16( relu(t * a2 + b2) ), zero outside the image
  new = bf16( sum_tap p_tap )              p_tap = bf16(tap product) when
                                           taps_packed, else the f32 product

and writes `new` at channels [C, C + 32) in place. The epilogue then reads
the whole buffer (dense_block_pallas.py:374-403):

  transition  hs = bf16(relu(feat * at + bt)); a 2x2 pool in bf16
              arithmetic (row-pair sum, column-pair sum, x 0.25); out =
              bf16(pooled @ wt), f32 accumulation -> (N, H/2, W/2, C_out)
  final_bn    out = bf16(feat * at + bt), no ReLU  -> (N, H, W, Cf)

One wrapper call runs the whole block and its epilogue and counts one
launch. Each layer is one launch of a fused kernel (csrc/dense_block.cu)
that keeps the layer's h2 in shared memory: per tile of output pixels it
runs the bottleneck GEMM on every in-image pixel of the tile's patch (the
tile and one pixel all round: a band's halo rows are recomputed), writes h2
into the patch, then runs the wgmma 3x3 from there. dense_plan below
chooses the tiles. The TPU's BlockGeom (B_tile, row bands with an L-row
halo, width and channel padding, the selection-matrix append) existed for
16 MB of VMEM and has no counterpart: any N, H, W.
"""

from __future__ import annotations

import functools

import torch

from smg_tpu_torch.ops import _build
from smg_tpu_torch.ops.conv2 import (BOTTLENECK, C2_TASK, C2_WARPGROUPS, C3_PIXEL_BYTES,
                                     C3_SMEM_LIMIT, GROWTH, H100_SMS, N_TAPS, Conv3x3Plan,
                                     _cdiv, _tile_count, conv3x3_plain, tile_candidates)
from smg_tpu_torch.ops.transition import transition_plan

launches = 0

# The fused layer kernel's shared memory: the tap weights and the GEMM's
# ring (4 stages of a 32-channel slice of 128 pixel rows, w1's 32 rows and
# their norm1), then the h2 patch and 8 mbarriers.
DL_STAGES = 4
DL_BK = 32                    # channels of a GEMM k-slice
DL_ROWS = 128                 # GEMM rows per pass: two warpgroups of 64
DL_H2_OFFSET = N_TAPS * BOTTLENECK * GROWTH * 2 + DL_STAGES * (
    DL_BK * BOTTLENECK * 2 + DL_ROWS * DL_BK * 2 + 2 * DL_BK * 4)             # 140,288
DL_BARRIER_BYTES = 2 * DL_STAGES * 8
DL_PATCH_PIXELS = (C3_SMEM_LIMIT - DL_H2_OFFSET - DL_BARRIER_BYTES) // C3_PIXEL_BYTES  # 359
# The cost model, in units of one 3x3 warpgroup task (as conv2's): a
# 32-channel k-slice of one GEMM pass (128 rows, both warpgroups). Fitted to
# the card by k5k7_plans.py (40 tilings of each of the 8 trunk blocks; rms
# log error 0.118; H100 80GB HBM3), where a per-tile fixed cost fit as 0.
DL_SLICE_COST = 0.06

EPILOGUES = ("transition", "final_bn")


def pack_dense_block(layers) -> dict:
    """Kernel operands of one block from its layers' (c_in, a1, b1, w1
    (c_in, 128), a2, b2, w2 (9, 128, 32)) tuples, as
    models/fast_trunk.py::trunk_operands builds them: a1, b1 concatenated
    over the layers, w1 stacked row-wise (sum of C_l, 128); a2, b2 (L, 128);
    w2 (L, 9, 128, 32)."""
    return {"c0": layers[0][0], "L": len(layers),
            "a1": torch.cat([l[1] for l in layers]).contiguous(),
            "b1": torch.cat([l[2] for l in layers]).contiguous(),
            "w1": torch.cat([l[3] for l in layers]).contiguous(),
            "a2": torch.stack([l[4] for l in layers]).contiguous(),
            "b2": torch.stack([l[5] for l in layers]).contiguous(),
            "w2": torch.stack([l[6] for l in layers]).contiguous()}


def pack_transition(a, b, wt) -> dict:
    """The transition epilogue: folded BN (Cf,) f32 and the 1x1 (Cf, C_out)."""
    return {"at": a, "bt": b, "wt": wt}


def pack_final_bn(a, b) -> dict:
    """The final_bn epilogue: norm5 folded to (Cf,) f32."""
    return {"at": a, "bt": b, "wt": None}


def _layers(packed):
    off = 0
    for l in range(packed["L"]):
        c = packed["c0"] + GROWTH * l
        yield (c, packed["a1"][off:off + c], packed["b1"][off:off + c],
               packed["w1"][off:off + c], packed["a2"][l], packed["b2"][l],
               packed["w2"][l])
        off += c


def _region(N, H, W, images, rows, cols):
    """The GEMM rows of each tile of a tiling: the in-image pixels of its
    patch (the tile and one pixel all round, clipped to the image), as
    (tile count, rows) pairs for the tile sizes that occur."""
    def bands(n, size):
        # (count, clipped extent + halo) of the bands of `size` over n.
        out = {}
        for b0 in range(0, n, size):
            ext = min(b0 + size + 1, n) - max(b0 - 1, 0)
            out[ext] = out.get(ext, 0) + 1
        return out

    imgs = {}
    for n0 in range(0, N, images):
        g = min(images, N - n0)
        imgs[g] = imgs.get(g, 0) + 1
    return [(ci * cy * cx, g * ey * ex) for g, ci in imgs.items()
            for ey, cy in bands(H, rows).items() for ex, cx in bands(W, cols).items()]


def _dl_cost(N, H, W, C0, L, images, rows, cols, sms):
    """The fused layers' estimated time over the block's L layers: the rounds
    of tiles the persistent grid walks, each tile its GEMM passes over all
    of its patch's in-image pixels (k-slices of 32 channels) and its 3x3
    tasks (the two warpgroups in turn)."""
    tiles = _tile_count(N, H, W, images, rows, cols)
    passes = sum(n * _cdiv(r, DL_ROWS) for n, r in _region(N, H, W, images, rows, cols)) / tiles
    tasks = _cdiv(_cdiv(images * rows * cols, C2_TASK), C2_WARPGROUPS)
    slices = sum((C0 + GROWTH * l) // DL_BK for l in range(L))
    return _cdiv(tiles, sms) * (passes * slices * DL_SLICE_COST + L * tasks)


@functools.lru_cache(maxsize=None)
def dense_plan(N: int, H: int, W: int, C0: int, L: int, sms: int = H100_SMS) -> Conv3x3Plan:
    """The fused layer kernel's tiles for a block of L layers over N images
    of H x W: the cheapest by _dl_cost of conv2.tile_candidates whose patch
    fits DL_PATCH_PIXELS (ties: the one that keeps more SMs busy, then
    fewer tiles); one plan for all the block's layers. Memoized."""
    def key(c):
        tiles = _tile_count(N, H, W, *c)
        return _dl_cost(N, H, W, C0, L, *c, sms), -min(tiles, sms), tiles

    images, rows, cols = min(tile_candidates(N, H, W, DL_PATCH_PIXELS), key=key)
    tiles = _tile_count(N, H, W, images, rows, cols)
    patch = images * (rows + 2) * (cols + 2)
    return Conv3x3Plan(images, rows, cols, tiles, min(tiles, sms),
                       DL_H2_OFFSET + patch * C3_PIXEL_BYTES + DL_BARRIER_BYTES)


def dense_block_apply_plain(buf, packed, ep, epilogue: str, taps_packed: bool = True):
    """Plain version, in place in buf (N, H, W, Cf); returns the epilogue's
    output in buf's dtype."""
    dt = buf.dtype
    N, H, W, Cf = buf.shape
    for c, a1, b1, w1, a2, b2, w2 in _layers(packed):
        y1 = torch.relu(buf[..., :c].float() * a1 + b1).to(dt).float()
        t = y1.reshape(-1, c) @ w1.float()
        h2 = torch.relu(t * a2 + b2).to(dt).float().reshape(N, H, W, BOTTLENECK)
        buf[..., c:c + GROWTH] = conv3x3_plain(h2, w2, dt, taps_packed).to(dt)
    if epilogue == "final_bn":
        return (buf.float() * ep["at"] + ep["bt"]).to(dt)
    hs = torch.relu(buf.float() * ep["at"] + ep["bt"]).to(dt)
    rows = hs[:, 0::2] + hs[:, 1::2]                      # in dt arithmetic
    pooled = (rows[:, :, 0::2] + rows[:, :, 1::2]) * 0.25
    out = pooled.float().reshape(-1, Cf) @ ep["wt"].float()
    return out.reshape(N, H // 2, W // 2, -1).to(dt)


def dense_block_apply(buf, packed, ep, epilogue: str, *, taps_packed: bool = True,
                      out=None):
    """Run one dense block in place in buf (N, H, W, Cf) bf16, whose
    channels [0, C0) hold the block input, then its epilogue.

    Returns the epilogue's output: (N, H/2, W/2, C_out) for "transition",
    (N, H, W, Cf) for "final_bn". `out` may be a channel slice of a wider
    NHWC buffer (the next dense block's), which the epilogue writes in place.
    """
    global launches
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if buf.device.type == "cpu":
        res = dense_block_apply_plain(buf, packed, ep, epilogue, taps_packed)
        if out is None:
            return res
        out.copy_(res)
        return out
    N, H, W, Cf = buf.shape
    c0, L = packed["c0"], packed["L"]
    n1 = L * c0 + GROWTH * L * (L - 1) // 2
    _build.check_cuda(buf, "buf", torch.bfloat16)
    if Cf != c0 + GROWTH * L or c0 % 32:
        raise ValueError(f"unsupported block: C0 {c0}, {L} layers, buffer {Cf}")
    for name, dtype, shape in (("a1", torch.float32, (n1,)), ("b1", torch.float32, (n1,)),
                               ("w1", torch.bfloat16, (n1, BOTTLENECK)),
                               ("a2", torch.float32, (L, BOTTLENECK)),
                               ("b2", torch.float32, (L, BOTTLENECK)),
                               ("w2", torch.bfloat16, (L, N_TAPS, BOTTLENECK, GROWTH))):
        _build.check_cuda(packed[name], name, dtype, shape)
    _build.check_cuda(ep["at"], "at", torch.float32, (Cf,))
    _build.check_cuda(ep["bt"], "bt", torch.float32, (Cf,))
    if epilogue == "transition":
        C_out = ep["wt"].shape[1]
        _build.check_cuda(ep["wt"], "wt", torch.bfloat16, (Cf, C_out))
        if H % 2 or W % 2 or C_out % 128:
            raise ValueError(f"unsupported transition {tuple(buf.shape)} -> {C_out}")
        out_shape, wt_ptr, code = (N, H // 2, W // 2, C_out), ep["wt"].data_ptr(), 0
        tr = transition_plan(N * (H // 2) * (W // 2), Cf, C_out,
                             _build.sm_count(buf.device)).args()
    else:
        C_out = Cf
        out_shape, wt_ptr, code, tr = (N, H, W, Cf), 0, 1, (0,) * 5
    if out is None:
        out = torch.empty(out_shape, dtype=torch.bfloat16, device=buf.device)
    out_ld = _build.check_nhwc_view(out, "out", torch.bfloat16, out_shape)
    _build.check_aligned(buf=buf, at=ep["at"], bt=ep["bt"],
                         **{k: packed[k] for k in ("a1", "b1", "w1", "w2")})
    _build.launch("smg_dense_block", buf.data_ptr(), packed["a1"].data_ptr(),
                  packed["b1"].data_ptr(), packed["w1"].data_ptr(),
                  packed["a2"].data_ptr(), packed["b2"].data_ptr(),
                  packed["w2"].data_ptr(), ep["at"].data_ptr(), ep["bt"].data_ptr(),
                  wt_ptr, out.data_ptr(), N, H, W, c0, L, C_out,
                  out_ld, code, int(taps_packed),
                  *dense_plan(N, H, W, c0, L, _build.sm_count(buf.device)).args(), *tr)
    launches += 1
    return out
