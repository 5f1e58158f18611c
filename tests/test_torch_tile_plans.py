"""The CUDA kernels' tile plans, which the wrappers compute in Python and
pass to the kernels as ints: K1's (ops/contact.py::contact_plan), the
mma.sync 3x3's (ops/conv2.py::conv3x3_plan, used by K2 and K6a), K5's
(ops/conv2.py::conv2_plan) and K7's fused layer's
(ops/dense_block.py::dense_plan), K2's
GEMM tile rows, K3's (ops/transition.py::transition_plan, also K7's
transition epilogue), and K6's (ops/dense_layer_train.py: dgrad_plan,
dw2_plan, dw1_split, and image_plan: the pixel tiles of dy1 and K6a's GEMM
with their image slots). Checked on the CPU at every shape the port's paths
and its card tests give them. No JAX.
"""

import numpy as np
import pytest
import torch

from smg_tpu_torch.ops import contact, conv2, dense_layer
from smg_tpu_torch.ops import dense_block as k7
from smg_tpu_torch.ops import dense_layer_train as k6
from smg_tpu_torch.ops import transition as k3

torch.set_num_threads(1)  # as test_torch_parity_helpers.py: one thread per xdist worker

SMS = conv2.H100_SMS
SMEM_227KB = 232448


def _trunk_shapes(images, sizes):
    """(N, H, W) of DenseNet-121's four dense blocks at each input size."""
    return [(images, s // (4 << i), s // (4 << i)) for s in sizes for i in range(4)]


# The main paths: K2, K5 and K7 on one 104-image trunk pass at 224 and 640;
# K6a on one 64-image style group of the b32 update at 224.
PATH_SHAPES = _trunk_shapes(104, (224, 640)) + _trunk_shapes(64, (224,))
# tests/test_torch_gpu.py's shapes (W = 5, 6, 7, 8, 9, 12, 160 among them).
CARD_TEST_SHAPES = [
    (3, 7, 8), (3, 8, 9), (3, 5, 6),                        # test_dense_layer
    (3, 7, 7), (3, 8, 12), (3, 5, 9),                       # test_conv2
    (2, 8, 6), (2, 7, 7), (2, 7, 5),                        # test_dense_block
    (1, 7, 7), (5, 7, 7), (5, 14, 14), (1, 14, 14),         # test_dense_layer_train
    (13, 7, 7), (8, 56, 56), (300, 7, 7), (2, 5, 160),      # the tiling tests
    (48, 26, 26), (300, 8, 6), (2, 4, 160)]


def _tiles(plan, N, H, W):
    """The tiles as conv3x3_kernel decodes them: (n0, y0, x0) and extents."""
    tiles_x = -(-W // plan.cols)
    tiles_y = -(-H // plan.rows)
    for t in range(plan.tiles):
        n0 = t // (tiles_x * tiles_y) * plan.images
        y0 = (t // tiles_x) % tiles_y * plan.rows
        x0 = t % tiles_x * plan.cols
        yield (n0, y0, x0, min(plan.images, N - n0), min(plan.rows, H - y0),
               min(plan.cols, W - x0))


@pytest.mark.parametrize("shape", PATH_SHAPES + CARD_TEST_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_plan(shape):
    N, H, W = shape
    plan = conv2.conv3x3_plan(N, H, W, SMS)
    # Every output pixel lies in exactly one tile, and the persistent grid
    # (block b takes tiles b, b + grid, ...) takes every tile once.
    cover = np.zeros(shape, np.int32)
    for n0, y0, x0, gn, th, tw in _tiles(plan, N, H, W):
        assert gn > 0 and th > 0 and tw > 0
        cover[n0:n0 + gn, y0:y0 + th, x0:x0 + tw] += 1
    assert (cover == 1).all()
    taken = sorted(t for b in range(plan.grid) for t in range(b, plan.tiles, plan.grid))
    assert taken == list(range(plan.tiles))
    # A tile is whole images, or rows of one image.
    assert plan.images == 1 or (plan.rows, plan.cols) == (H, W)
    # The halo patch, the resident weights and the second patch buffer fit.
    patch = plan.images * (plan.rows + 2) * (plan.cols + 2)
    assert patch <= conv2.C3_PATCH_PIXELS
    assert plan.smem_bytes == conv2.C3_WEIGHT_BYTES + 2 * patch * conv2.C3_PIXEL_BYTES
    assert plan.smem_bytes <= SMEM_227KB
    # At least one block per SM wherever the shape allows: fewer only where
    # even one-row tiles of the widest column band that fits are fewer.
    assert plan.grid == min(plan.tiles, SMS)
    if plan.tiles < SMS:
        assert N * H * -(-W // (conv2.C3_PATCH_PIXELS // 3 - 2)) < SMS


@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_plan_fills_the_card_on_the_paths(shape):
    assert conv2.conv3x3_plan(*shape, SMS).grid == SMS


@pytest.mark.parametrize("shape,tile", [
    ((104, 56, 56), (1, 8, 28)), ((104, 28, 28), (1, 14, 14)), ((104, 14, 14), (1, 7, 14)),
    ((104, 7, 7), (1, 4, 7)), ((104, 160, 160), (1, 15, 16)), ((300, 7, 7), (2, 7, 7))])
def test_conv3x3_plan_tiles(shape, tile):
    """The cost model's choices on the paths: at block 1 of 224 (56 x 56)
    8 x 28 tiles, 7 warp tasks of 32 pixels in a 10 x 30-pixel patch (75 KB
    a buffer), rather than full-width bands of 3 rows (6 tasks, two on each
    of two sub-partitions, and a wider halo per pixel); whole images where
    more than 132 tiles of them remain."""
    plan = conv2.conv3x3_plan(*shape, SMS)
    assert (plan.images, plan.rows, plan.cols) == tile


# K5 and K7 on one 104-image trunk pass at 224 and 640: (N, H, W, C0, L)
# of each dense block; and tests/test_torch_gpu.py's K5 / K7 shapes.
K5K7_PATH = [(104, s // (4 << i), s // (4 << i), c0, L) for s in (224, 640)
             for i, (c0, L) in enumerate(((64, 6), (128, 12), (256, 24), (512, 16)))]
K5_CARD = [(3, 7, 7), (3, 8, 12), (3, 5, 9), (48, 26, 26), (300, 7, 7), (2, 5, 160),
           (8, 56, 56), (5, 1, 1), (4, 2, 3), (3, 3, 3), (7, 4, 4), (2, 5, 5), (3, 6, 6),
           (2, 7, 7), (13, 14, 14), (600, 4, 4), (401, 7, 7), (1, 40, 40), (2, 30, 17)]
K7_CARD = [(2, 8, 6, 64, 2), (2, 7, 7, 128, 3), (2, 7, 5, 96, 2), (48, 26, 26, 64, 2),
           (300, 8, 6, 64, 2), (2, 4, 160, 64, 2), (5, 10, 10, 192, 2), (5, 10, 6, 448, 2),
           (3, 6, 6, 960, 2), (44, 28, 28, 448, 2), (3, 1, 1, 64, 2), (5, 2, 2, 64, 2),
           (4, 3, 3, 96, 2), (2, 5, 5, 64, 3), (3, 6, 6, 128, 2), (2, 7, 7, 512, 2),
           (3, 14, 14, 256, 2), (2, 30, 30, 64, 2), (1, 37, 23, 64, 2)]


def _check_sm90_plan(plan, N, H, W, cap):
    """What K5's and K7's kernels assume of a plan: every output pixel in
    exactly one tile, every tile taken once by the persistent grid, the
    patch within `cap` pixels, whole-image tiles wherever one image's patch
    fits (and then only those), bands of one image otherwise."""
    cover = np.zeros((N, H, W), np.int32)
    for n0, y0, x0, gn, th, tw in _tiles(plan, N, H, W):
        assert gn > 0 and th > 0 and tw > 0
        cover[n0:n0 + gn, y0:y0 + th, x0:x0 + tw] += 1
    assert (cover == 1).all()
    taken = sorted(t for b in range(plan.grid) for t in range(b, plan.tiles, plan.grid))
    assert taken == list(range(plan.tiles)) and plan.grid == min(plan.tiles, SMS)
    patch = plan.images * (plan.rows + 2) * (plan.cols + 2)
    assert patch <= cap
    if (H + 2) * (W + 2) <= cap:
        assert (plan.rows, plan.cols) == (H, W)
    else:
        assert plan.images == 1
    return patch


@pytest.mark.parametrize("shape", [s[:3] for s in K5K7_PATH] + K5_CARD,
                         ids=lambda s: "x".join(map(str, s)))
def test_conv2_plan(shape):
    """K5's plan: the tap weights, two h2 patches and the barriers fit
    227 KB."""
    N, H, W = shape
    plan = conv2.conv2_plan(N, H, W, SMS)
    patch = _check_sm90_plan(plan, N, H, W, conv2.C2_PATCH_PIXELS)
    assert plan.smem_bytes == (conv2.C3_WEIGHT_BYTES + 2 * patch * conv2.C3_PIXEL_BYTES
                               + conv2.C2_BARRIER_BYTES)
    assert plan.smem_bytes <= SMEM_227KB


@pytest.mark.parametrize("shape", K5K7_PATH + K7_CARD, ids=lambda s: "x".join(map(str, s)))
def test_dense_plan(shape):
    """K7's fused layer plan: the tap weights, the GEMM's ring, the h2 patch
    and the barriers fit 227 KB; each tile's GEMM rows (the in-image pixels
    of its patch, halo included) number at least its own pixels and at most
    its patch's."""
    N, H, W, C0, L = shape
    plan = k7.dense_plan(N, H, W, C0, L, SMS)
    patch = _check_sm90_plan(plan, N, H, W, k7.DL_PATCH_PIXELS)
    assert plan.smem_bytes == k7.DL_H2_OFFSET + patch * conv2.C3_PIXEL_BYTES + k7.DL_BARRIER_BYTES
    assert plan.smem_bytes <= SMEM_227KB
    regions = k7._region(N, H, W, plan.images, plan.rows, plan.cols)
    assert sum(n for n, _ in regions) == plan.tiles
    assert max(r for _, r in regions) <= patch
    assert sum(n * r for n, r in regions) >= N * H * W
    if (plan.rows, plan.cols) == (H, W):
        assert sum(n * r for n, r in regions) == N * H * W   # no halo: zero padding


@pytest.mark.parametrize("B", [1, 5, 32, 130, 1024])
def test_contact_plan(B):
    S, T = 108, 145
    plan = contact.contact_plan(S, T, B)
    # The kernel's chunks [c T // chunks, (c + 1) T // chunks) partition the
    # sources 0..T-1 in order, contiguous, even.
    bounds = [(c * T // plan.chunks, (c + 1) * T // plan.chunks) for c in range(plan.chunks)]
    assert [j for lo, hi in bounds for j in range(lo, hi)] == list(range(T))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1
    # Enough slabs for the longest chunk; the staged slab and the partials
    # fit the block's static shared memory.
    assert plan.slab * -(-max(sizes) // plan.slab) >= max(sizes)
    staged = 9 * plan.chunks * plan.slab * plan.scenes * 4
    partials = 3 * plan.chunks * plan.rows * plan.scenes * 4
    assert plan.smem_bytes >= staged and plan.smem_bytes <= contact.SMEM_LIMIT
    assert plan.chunks == 1 or plan.smem_bytes >= partials
    assert plan.scenes * plan.rows * plan.chunks <= 1024
    # The grid covers every (row, scene) pair.
    assert plan.grid[0] * plan.scenes >= B and plan.grid[1] * plan.rows >= S
    if B == 32:
        assert plan.grid[0] * plan.grid[1] >= SMS


def test_gemm_rows():
    """K2's GEMM takes 64-row tiles where 128-row tiles would not fill one
    wave: block 4 at 224 with 104 images; 128 elsewhere on the path."""
    rows = {H: dense_layer.gemm_rows(104 * H * H, SMS) for _, H, _ in _trunk_shapes(104, (224,))}
    assert rows == {56: 128, 28: 128, 14: 128, 7: 64}
    assert dense_layer.gemm_rows(10, SMS) == 64


@pytest.mark.parametrize("plan, args", [
    (conv2.conv3x3_plan, (104, 56, 56, SMS)),
    (conv2.conv2_plan, (104, 56, 56, SMS)),
    (k7.dense_plan, (104, 56, 56, 64, 6, SMS)),
    (contact.contact_plan, (108, 145, 32)),
    (dense_layer.gemm_rows, (104 * 7 * 7, SMS)),
    (k6.dgrad_plan, (64, 56, 56, SMS)),
    (k6.dw2_plan, (64, 7, 7, SMS)),
    (k6.dw1_split, (64 * 14 * 14, 512, SMS)),
    (k6.h1_chunks, (64, 56 * 56, SMS)),
    (k6.image_plan, (64, 6 * 6, SMS)),
    (k3.transition_plan, (104 * 28 * 28, 256, 128, SMS)),
])
def test_plans_are_memoized(plan, args):
    """A wrapper asks for its plan on every launch: the search runs once
    per shape, later calls are cache hits with the same plan."""
    first = plan(*args)
    hits = plan.cache_info().hits
    assert plan(*args) == first
    assert plan.cache_info().hits == hits + 1


# K6 on the training path: one 64-image style group of the b32 update at
# 224, the 58 layers' (N, H, W) and C_in; and tests/test_torch_gpu.py's K6
# shapes (N, H, C_in).
K6_PATH = [(64, H, H, C0 + 32 * l) for H, C0, L in ((56, 64, 6), (28, 128, 12),
                                                   (14, 256, 24), (7, 512, 16))
           for l in range(L)]
K6_CARD = [(n, H, H, c) for n, H, c in (
    (1, 7, 64), (5, 7, 224), (5, 14, 64), (1, 14, 224),          # test_dense_layer_train
    (5, 7, 64), (5, 7, 96), (5, 7, 992),                          # the tile edges
    (1, 7, 96), (64, 7, 96), (1, 14, 96), (64, 14, 96), (1, 56, 96), (5, 56, 96),
    (64, 56, 96), (5, 14, 96),                                    # repeatability
    (5, 6, 64), (64, 6, 224), (5, 3, 96), (64, 3, 64), (5, 2, 96), (5, 1, 64),
    (64, 1, 224), (40, 6, 128), (40, 3, 128), (40, 1, 128),       # images under 43 pixels
    (1, 6, 64))]                                                  # the wrappers' test
# K6 at 640 (chip_smoke.py): one 64-image style group, the four blocks'
# first and last layers; and a 6 x 6 block 4 (input 192).
K6_640 = [(64, H, H, c) for H, C0, L in ((160, 64, 6), (80, 128, 12), (40, 256, 24),
                                         (20, 512, 16), (6, 512, 16))
          for c in (C0, C0 + 32 * (L - 1))]
K6_SHAPES = K6_PATH + K6_CARD + K6_640
K6_IMAGES = sorted({s[:3] for s in K6_SHAPES})


def _image_tile_cover(plan, N, H, W):
    """Decode the tiles as dy2_kernel / dw2_kernel do (TileGeom): tile ->
    image, row and column origin; count how often each pixel is covered."""
    tx, ty = -(-W // plan.cols), -(-H // plan.rows)
    cover = np.zeros((N, H, W), np.int32)
    for t in range(plan.tiles):
        n, r = divmod(t, tx * ty)
        y0, x0 = r // tx * plan.rows, r % tx * plan.cols
        th, tw = min(plan.rows, H - y0), min(plan.cols, W - x0)
        assert n < N and th > 0 and tw > 0
        cover[n, y0:y0 + th, x0:x0 + tw] += 1
    return cover


@pytest.mark.parametrize("plan_fn, smem_fn", [(k6.dgrad_plan, k6.dgrad_smem),
                                              (k6.dw2_plan, k6.dw2_smem)],
                         ids=["dgrad", "dw2"])
@pytest.mark.parametrize("shape", K6_IMAGES, ids=lambda s: "x".join(map(str, s)))
def test_k6b_image_tiles(plan_fn, smem_fn, shape):
    """dy2's and dw2's tiles lie within one image and cover every pixel
    once; the persistent grid takes every tile once; shared memory fits."""
    N, H, W = shape
    plan = plan_fn(N, H, W, SMS)
    assert plan.tiles == N * -(-H // plan.rows) * -(-W // plan.cols)
    assert (_image_tile_cover(plan, N, H, W) == 1).all()
    taken = sorted(t for b in range(plan.grid) for t in range(b, plan.tiles, plan.grid))
    assert taken == list(range(plan.tiles))
    assert plan.grid == min(plan.tiles, SMS)
    assert plan.smem_bytes == smem_fn(plan.rows, plan.cols) <= SMEM_227KB
    if plan_fn is k6.dgrad_plan and N * H >= SMS:
        assert plan.tiles >= SMS                  # the card is filled on the path


@pytest.mark.parametrize("shape", K6_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k6_pixel_tiles(shape):
    """h1's moment chunks and dw1's splits cover every pixel once (dw1's
    in 64-pixel stages); a tile of K6a's GEMM and of dy1 (image_plan's rows)
    spans at most its image slots, which fit shared memory; the reduction
    of dy1's partials reads, for each image, exactly the (tile, slot) pairs
    the tiles write; the buffer stays inside 32-bit indices."""
    N, H, W, C = shape
    HW, P = H * W, N * H * W
    h1_splits, h1_chunk = k6.h1_chunks(N, HW, SMS)
    assert (h1_splits - 1) * h1_chunk < HW <= h1_splits * h1_chunk
    splits, chunk = k6.dw1_split(P, C, SMS)
    assert chunk % k6.DW1_STAGE_PIXELS == 0 and (splits - 1) * chunk < P <= splits * chunk
    if P >= 2 * SMS * k6.DW1_STAGE_PIXELS:
        assert -(-C // 128) * splits >= SMS
    plan = k6.image_plan(N, HW, SMS)
    assert plan.gemm_slots in k6.SLOT_COUNTS and plan.dy1_slots in k6.SLOT_COUNTS
    assert k6.gemm_smem(plan.gemm_rows, plan.gemm_slots) <= SMEM_227KB
    assert k6.dy1_smem(plan.dy1_slots) <= SMEM_227KB
    assert plan.gemm_rows in (128, 64) and 1 <= plan.dy1_rows <= k6.DY1_ROWS
    if HW >= 43:   # the training path at 224: K2's tile rows, 4 slots, 128-pixel dy1 tiles
        assert plan == (dense_layer.gemm_rows(P, SMS), 4, 128, 4)
    for bm, slots in ((plan.gemm_rows, plan.gemm_slots), (plan.dy1_rows, plan.dy1_slots)):
        for m0 in range(0, P, bm):
            rows = min(bm, P - m0)
            assert (m0 + rows - 1) // HW - m0 // HW < slots
    tr = plan.dy1_rows
    tiles = -(-P // tr)
    written = {(t, n - t * tr // HW)
               for t in range(tiles)
               for n in range(t * tr // HW, (min(P, (t + 1) * tr) - 1) // HW + 1)}
    read = {(t, n - t * tr // HW) for n in range(N)
            for t in range(n * HW // tr, ((n + 1) * HW - 1) // tr + 1)}
    assert read == written
    assert all(0 <= j < plan.dy1_slots for _, j in written)
    assert P * max(C + 32, 128) < 2 ** 31


@pytest.mark.parametrize("HW,plan", [(36, (64, 4, 128, 16)), (9, (64, 16, 128, 16)),
                                     (4, (64, 64, 32, 16)), (1, (64, 64, 16, 16))])
def test_k6_image_plan_small_images(HW, plan):
    """The choice for images under 43 pixels at 64 images (6 x 6, 3 x 3,
    2 x 2, 1 x 1): 64-row GEMM tiles with 4, 16 or 64 slots; dy1 on 128-,
    32- or 16-pixel tiles with 16 slots (its 3 x 32 KB tiles leave room for
    no more)."""
    assert tuple(k6.image_plan(64, HW, SMS)) == plan


# K3 on the paths: the three transitions of one 104-image trunk pass at 224
# and 640 (and K7's transition epilogue at the same shapes); the card tests'
# shapes (test_transition, test_dense_block_transition, the K7 tests).
K3_PATH = [(104 * (s // (8 << i)) ** 2, 256 << i, 128 << i) for s in (224, 640)
           for i in range(3)]
K3_CARD = [(N * H * W // 4, C, max(128, C // 2)) for N, H, W, C in (
    (3, 4, 4, 256), (3, 6, 6, 512), (3, 2, 2, 1024), (22, 56, 56, 256), (44, 28, 28, 512),
    (5, 10, 10, 1024), (5, 10, 6, 96), (5, 10, 6, 512), (3, 6, 6, 1024), (2, 8, 6, 128),
    (48, 26, 26, 128))]


@pytest.mark.parametrize("shape", K3_PATH + K3_CARD, ids=lambda s: "x".join(map(str, s)))
def test_transition_plan(shape):
    """K3's blocks cover every pooled pixel once (block b: pixels
    [b rows, (b + 1) rows)); the pooled tile and the ring fit shared memory;
    at least one block per SM wherever the smallest tile gives as many; the
    pool stage's channels divide C and its 16 KB hold whole pooled pixels."""
    Q, C, C_out = shape
    plan = k3.transition_plan(Q, C, C_out, SMS)
    assert (plan.rows, plan.cols) in k3.TR_TILES
    assert (plan.grid - 1) * plan.rows < Q <= plan.grid * plan.rows
    assert plan.smem_bytes == k3.transition_smem(plan.rows, C) <= SMEM_227KB
    if -(-Q // 32) >= SMS:
        assert plan.grid >= SMS
    assert C % plan.kc == 0 and k3.POOL_STAGE_VALUES % plan.kc == 0


@pytest.mark.parametrize("shape,tile", [
    (K3_PATH[0], (128, 128)), (K3_PATH[1], (64, 256)), (K3_PATH[2], (32, 512)),
    (K3_PATH[3], (128, 128)), (K3_PATH[4], (64, 256)), (K3_PATH[5], (32, 512))])
def test_transition_plan_on_the_paths(shape, tile):
    """At 224 and 640 with 104 images each transition pools a 64 KB tile
    (128 x 256, 64 x 512, 32 x 1024) and multiplies all of C_out in one
    pass, two blocks per SM (112 KB each), at least 132 blocks."""
    plan = k3.transition_plan(*shape, SMS)
    assert (plan.rows, plan.cols) == tile
    assert plan.cols == shape[2] and plan.grid >= SMS
    assert 2 * (plan.smem_bytes + k3.BLOCK_RESERVED) <= k3.SM_SMEM
    assert plan.rows * shape[1] * 2 == 65536


def test_block_moments_keep_their_bits():
    """K6a's moments once per channel per block, when the channel is
    written, equal a per-layer recompute of the whole prefix bit for bit:
    the moments of a channel depend on that channel alone (plain torch, the
    port's _moments, f32 sums of bf16 values)."""
    rng = np.random.RandomState(0)
    N, H, C0, L = 3, 7, 64, 4
    buf = torch.tensor(rng.randn(N, H, H, C0 + 32 * L).astype(np.float32)).to(torch.bfloat16)
    block = [k6._moments(buf[..., :C0].float())]
    for l in range(1, L):
        c = C0 + 32 * l
        block.append(k6._moments(buf[..., c - 32:c].float()))
    for l in range(L):
        c = C0 + 32 * l
        m, v = k6._moments(buf[..., :c].float())
        bm = torch.cat([b[0] for b in block[:l + 1]], dim=1)
        bv = torch.cat([b[1] for b in block[:l + 1]], dim=1)
        assert torch.equal(m, bm) and torch.equal(v, bv)
