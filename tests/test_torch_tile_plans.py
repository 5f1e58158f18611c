"""The CUDA kernels' tile plans, which the wrappers compute in Python and
pass to the kernels as ints: K1's (ops/contact.py::contact_plan) and the
shared 3x3's (ops/conv2.py::conv3x3_plan, used by K2, K5, K6a and K7), plus
K2's GEMM tile rows. Checked on the CPU at every shape the port's paths and
its card tests give them. No JAX.
"""

import numpy as np
import pytest

from smg_tpu_torch.ops import contact, conv2, dense_layer

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
    (contact.contact_plan, (108, 145, 32)),
    (dense_layer.gemm_rows, (104 * 7 * 7, SMS)),
])
def test_plans_are_memoized(plan, args):
    """A wrapper asks for its plan on every launch: the search runs once
    per shape, later calls are cache hits with the same plan."""
    first = plan(*args)
    hits = plan.cache_info().hits
    assert plan(*args) == first
    assert plan.cache_info().hits == hits + 1
