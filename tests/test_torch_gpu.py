"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip without a CUDA device (a CUDA kernel has no
interpret mode). Small shapes; chip_smoke.py checks the act and training
steps' full shapes. This file imports neither jax nor smg_tpu, so it also runs where
JAX is absent — without the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

TOL_BF16 = 2.0 ** -6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _affine(g, dev, c):
    return (torch.rand(c, generator=g, device=dev) + 0.5,
            torch.rand(c, generator=g, device=dev) * 0.6 - 0.2)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-6))


@pytest.mark.parametrize("B", [1, 5, 130])
def test_contact(dev, B):
    from smg_tpu_torch.ops import contact

    g = _gen(dev, B)
    S, T = 108, 145
    rows = torch.rand((9, S, B), generator=g, device=dev) * 0.06
    cols = torch.rand((9, T, B), generator=g, device=dev) * 0.06
    for st in (rows, cols):
        st[3:6] = st[3:6] * 10 - 0.3        # velocities
        st[6] = 0.006 + st[6] * 0.2         # radii
        st[7] = 0.02 + st[7]                # masses
        st[8] = (st[8] > 0.01).float()      # live
    gains = dict(kn=800.0, zeta=0.6, share=4.0, mu=0.8, mu_grip=0.6,
                 v_eps=0.01, max_pen=0.006, max_vn=0.5)
    before = contact.launches
    got = torch.stack(contact.pairwise_forces(tuple(rows), tuple(cols), 9, **gains))
    assert contact.launches == before + 1
    want = torch.stack(contact.pairwise_forces_plain(tuple(rows), tuple(cols), 9,
                                                     **gains))
    fmax = float(want.abs().max())
    assert fmax > 0
    assert float(((got - want).abs() - 1e-5 * want.abs()).max()) <= 1e-5 * fmax


@pytest.mark.parametrize("B", [1, 5, 130, 1024])
def test_contact_repeatable(dev, B):
    """K1 sums each (row, scene) in a fixed order (chunks in order, no
    atomics): two runs on the same input give the same bits."""
    from smg_tpu_torch.ops import contact

    g = _gen(dev, B + 1)
    S, T = 108, 145
    rows = torch.rand((9, S, B), generator=g, device=dev) * 0.06
    cols = torch.rand((9, T, B), generator=g, device=dev) * 0.06
    for st in (rows, cols):
        st[3:6] = st[3:6] * 10 - 0.3
        st[6] = 0.006 + st[6] * 0.2
        st[7] = 0.02 + st[7]
        st[8] = (st[8] > 0.01).float()
    gains = dict(kn=800.0, zeta=0.6, share=4.0, mu=0.8, mu_grip=0.6,
                 v_eps=0.01, max_pen=0.006, max_vn=0.5)
    first = torch.stack(contact.pairwise_forces_stacked(rows, cols, 9, **gains))
    second = torch.stack(contact.pairwise_forces_stacked(rows, cols, 9, **gains))
    assert float(first.abs().max()) > 0
    assert torch.equal(first, second)


@pytest.mark.parametrize("H,C_in,ld", [(7, 64, 128), (8, 224, 256),
                                       (5, 992, 1024)])
def test_dense_layer(dev, H, C_in, ld):
    from smg_tpu_torch.ops import dense_layer as k2

    g = _gen(dev, C_in)
    buf = torch.randn((3, H, H + 1, ld), generator=g, device=dev).to(torch.bfloat16)
    ops = (torch.rand(C_in, generator=g, device=dev) + 0.5,
           torch.rand(C_in, generator=g, device=dev) * 0.6 - 0.2,
           (torch.randn((C_in, 128), generator=g, device=dev) * C_in ** -0.5)
           .to(torch.bfloat16),
           torch.rand(128, generator=g, device=dev) + 0.5,
           torch.rand(128, generator=g, device=dev) * 0.6 - 0.2,
           (torch.randn((9, 128, 32), generator=g, device=dev) * 0.03)
           .to(torch.bfloat16))
    ref = buf.clone()
    k2.dense_layer(buf, C_in, *ops)
    k2.dense_layer_plain(ref, C_in, *ops)
    assert torch.equal(buf[..., :C_in], ref[..., :C_in])
    assert torch.equal(buf[..., C_in + 32:], ref[..., C_in + 32:])
    assert _rel(buf[..., C_in:C_in + 32], ref[..., C_in:C_in + 32]) <= TOL_BF16


# The 3x3's tilings (ops/conv2.py::conv3x3_plan): one row of 7 (13 images,
# tile boundaries inside every image), bands of 9 rows whose last has 8 (26
# rows), two whole images per tile, and 3 x 40 tiles whose last row band has
# 2 (5 x 160).
TILINGS = [((13, 7, 7), (1, 1, 7)), ((48, 26, 26), (1, 9, 26)), ((300, 7, 7), (2, 7, 7)),
           ((2, 5, 160), (1, 3, 40))]


@pytest.mark.parametrize("shape,tile", TILINGS)
def test_dense_layer_tilings(dev, shape, tile):
    """K2 at block-4-like and block-1-like shapes under each tiling."""
    from smg_tpu_torch.ops import _build, conv2
    from smg_tpu_torch.ops import dense_layer as k2

    plan = conv2.conv3x3_plan(*shape, _build.sm_count(dev))
    assert (plan.images, plan.rows, plan.cols) == tile
    C_in = 992 if shape[1] == 7 else 64
    g = _gen(dev, sum(shape))
    buf = torch.randn(shape + (C_in + 32,), generator=g, device=dev).to(torch.bfloat16)
    ops = _affine(g, dev, C_in) + (
        (torch.randn((C_in, 128), generator=g, device=dev) * C_in ** -0.5).to(torch.bfloat16),
    ) + _affine(g, dev, 128) + (
        (torch.randn((9, 128, 32), generator=g, device=dev) * 0.03).to(torch.bfloat16),)
    ref = buf.clone()
    k2.dense_layer(buf, C_in, *ops)
    k2.dense_layer_plain(ref, C_in, *ops)
    assert torch.equal(buf[..., :C_in], ref[..., :C_in])
    assert _rel(buf[..., C_in:], ref[..., C_in:]) <= TOL_BF16


@pytest.mark.parametrize("shape,tile", TILINGS[1:] + [((8, 56, 56), (1, 4, 28))])
def test_conv2_tilings(dev, shape, tile):
    """K5 under each tiling, 4 x 28 tiles of 56 x 56 images too, written at
    a channel offset."""
    from smg_tpu_torch.ops import _build, conv2
    from smg_tpu_torch.ops import conv2 as k5

    plan = conv2.conv3x3_plan(*shape, _build.sm_count(dev))
    assert (plan.images, plan.rows, plan.cols) == tile
    g = _gen(dev, sum(shape) + 1)
    bf = torch.bfloat16
    h1 = torch.randn(shape + (128,), generator=g, device=dev).to(bf)
    a, b = _affine(g, dev, 128)
    w2 = (torch.randn((9, 128, 32), generator=g, device=dev) * 0.03).to(bf)
    buf = torch.zeros(shape + (96,), dtype=bf, device=dev)
    k5.conv2_bn_relu(h1, a, b, w2, out=buf[..., 32:64])
    assert _rel(buf[..., 32:64], k5.conv2_bn_relu_plain(h1, a, b, w2)) <= TOL_BF16
    assert not buf[..., :32].any() and not buf[..., 64:].any()


@pytest.mark.parametrize("N,H,W,epilogue,taps_packed", [
    (48, 26, 26, "transition", True), (300, 8, 6, "final_bn", False),
    (2, 4, 160, "final_bn", True)])
def test_dense_block_tilings(dev, N, H, W, epilogue, taps_packed):
    """K7 with row bands ending inside an image, two-image tiles and column
    bands (2 x 54 of 4 x 160, the last band 52 wide)."""
    from smg_tpu_torch.ops import dense_block as k7

    g = _gen(dev, N + H + W)
    bf, C0, L = torch.bfloat16, 64, 2
    layers = [(c,) + _affine(g, dev, c)
              + ((torch.randn((c, 128), generator=g, device=dev) * c ** -0.5).to(bf),)
              + _affine(g, dev, 128)
              + ((torch.randn((9, 128, 32), generator=g, device=dev) * 0.03).to(bf),)
              for c in (C0 + 32 * l for l in range(L))]
    Cf = C0 + 32 * L
    at, bt = _affine(g, dev, Cf)
    if epilogue == "transition":
        wt = (torch.randn((Cf, 128), generator=g, device=dev) * Cf ** -0.5).to(bf)
        ep = k7.pack_transition(at, bt, wt)
    else:
        ep = k7.pack_final_bn(at, bt)
    packed = k7.pack_dense_block(layers)
    buf = torch.randn((N, H, W, Cf), generator=g, device=dev).to(bf)
    ref = buf.clone()
    got = k7.dense_block_apply(buf, packed, ep, epilogue, taps_packed=taps_packed)
    want = k7.dense_block_apply_plain(ref, packed, ep, epilogue, taps_packed)
    assert _rel(buf[..., C0:], ref[..., C0:]) <= TOL_BF16
    assert _rel(got, want) <= TOL_BF16


# K3's shapes: (N, H, W, C) with Q = N H W / 4 pooled pixels a multiple of
# no tile (128, 64, 32 rows), one block and many, each of the kernel's three
# tiles (ops/transition.py::transition_plan): 128 x 128 at 22 x 56 x 56 x
# 256, 64 x 256 at 44 x 28 x 28 x 512, 32 x 512 elsewhere; C = 96 pads the
# pooled tile to 128 columns.
K3_SHAPES = [(3, 4, 4, 256), (3, 6, 6, 512), (3, 2, 2, 1024), (22, 56, 56, 256),
             (44, 28, 28, 512), (5, 10, 10, 1024), (5, 10, 6, 96)]


def _k3_operands(g, dev, N, H, W, C, C_out):
    x = torch.randn((N, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    a, b = _affine(g, dev, C)
    wt = (torch.randn((C, C_out), generator=g, device=dev) * C ** -0.5).to(torch.bfloat16)
    return x, a, b, wt


@pytest.mark.parametrize("N,H,W,C", K3_SHAPES)
def test_transition(dev, N, H, W, C):
    """K3 against its plain version, written into a channel slice of a wider
    buffer whose other channels stay untouched."""
    from smg_tpu_torch.ops import _build
    from smg_tpu_torch.ops import transition as k3

    C_out = max(128, C // 2)
    g = _gen(dev, N * C + H)
    x, a, b, wt = _k3_operands(g, dev, N, H, W, C, C_out)
    plan = k3.transition_plan(N * H * W // 4, C, C_out, _build.sm_count(dev))
    assert plan.grid == -(-N * H * W // 4 // plan.rows)
    out = torch.zeros((N, H // 2, W // 2, C_out + 64), dtype=torch.bfloat16, device=dev)
    before = k3.launches
    k3.transition(x, a, b, wt, out=out[..., :C_out])
    assert k3.launches == before + 1
    assert _rel(out[..., :C_out], k3.transition_plain(x, a, b, wt)) <= TOL_BF16
    assert not out[..., C_out:].any()      # the view's other channels untouched


@pytest.mark.parametrize("N,H,W,C", K3_SHAPES[3:])
def test_transition_repeatable(dev, N, H, W, C):
    """K3 twice on the same input gives the same bits (each output's k-sum
    in one fixed order)."""
    from smg_tpu_torch.ops import transition as k3

    x, a, b, wt = _k3_operands(_gen(dev, C + 1), dev, N, H, W, C, max(128, C // 2))
    first = k3.transition(x, a, b, wt)
    assert torch.equal(first, k3.transition(x, a, b, wt))


@pytest.mark.parametrize("H", [9, 16])
def test_stem_pool(dev, H):
    from smg_tpu_torch.ops import stem_pool as k4

    g = _gen(dev, H)
    y = torch.randn((2, H, H, 64), generator=g, device=dev).to(torch.bfloat16)
    a = torch.rand(64, generator=g, device=dev) + 0.5
    b = torch.rand(64, generator=g, device=dev) - 0.5
    got = k4.bn_relu_maxpool(y, a, b)
    assert torch.equal(got, k4.bn_relu_maxpool_plain(y, a, b))




@pytest.mark.parametrize("H,W,ld,c_off", [(7, 7, 160, 96), (8, 12, 128, 64),
                                          (5, 9, 32, 0)])
def test_conv2(dev, H, W, ld, c_off):
    """K5 writes 32 channels at a channel offset of a wider NHWC buffer
    (the block buffer) and leaves the others; the merge wrapper too."""
    from smg_tpu_torch.ops import conv2 as k5

    g = _gen(dev, H * W + ld)
    bf = torch.bfloat16
    h1 = torch.randn((3, H, W, 128), generator=g, device=dev).to(bf)
    a, b = _affine(g, dev, 128)
    w2 = (torch.randn((9, 128, 32), generator=g, device=dev) * 0.03).to(bf)
    buf = torch.randn((3, H, W, ld), generator=g, device=dev).to(bf)
    ref = buf.clone()
    before = k5.launches
    k5.conv2_bn_relu(h1, a, b, w2, out=buf[..., c_off:c_off + 32])
    assert k5.launches == before + 1
    want = k5.conv2_bn_relu_plain(h1, a, b, w2)
    assert _rel(buf[..., c_off:c_off + 32], want) <= TOL_BF16
    assert torch.equal(buf[..., :c_off], ref[..., :c_off])
    assert torch.equal(buf[..., c_off + 32:], ref[..., c_off + 32:])
    pend = torch.randn((3, H, W, 128), generator=g, device=dev).to(bf)
    merged = k5.conv2_bn_relu_merge(h1, pend, a, b, w2, 64)
    assert k5.launches == before + 2
    assert _rel(merged[..., 64:96], want) <= TOL_BF16
    assert torch.equal(merged[..., :64], pend[..., :64])
    assert torch.equal(merged[..., 96:], pend[..., 96:])


@pytest.mark.parametrize("H,W,C0,L,epilogue,taps_packed", [
    (8, 6, 64, 2, "transition", True), (8, 6, 64, 2, "transition", False),
    (7, 7, 128, 3, "final_bn", True), (7, 5, 96, 2, "final_bn", False)])
def test_dense_block(dev, H, W, C0, L, epilogue, taps_packed):
    """K7 against its plain version: the appended channels in the block
    buffer and the epilogue's output, written into a channel slice."""
    from smg_tpu_torch.ops import dense_block as k7

    g = _gen(dev, H * W + C0 + L)
    bf = torch.bfloat16
    layers = [(c,) + _affine(g, dev, c)
              + ((torch.randn((c, 128), generator=g, device=dev) * c ** -0.5).to(bf),)
              + _affine(g, dev, 128)
              + ((torch.randn((9, 128, 32), generator=g, device=dev) * 0.03).to(bf),)
              for c in (C0 + 32 * l for l in range(L))]
    Cf = C0 + 32 * L
    at, bt = _affine(g, dev, Cf)
    if epilogue == "transition":
        wt = (torch.randn((Cf, 128), generator=g, device=dev) * Cf ** -0.5).to(bf)
        ep, out_shape = k7.pack_transition(at, bt, wt), (2, H // 2, W // 2, 128)
    else:
        ep, out_shape = k7.pack_final_bn(at, bt), (2, H, W, Cf)
    packed = k7.pack_dense_block(layers)
    buf = torch.randn((2, H, W, Cf), generator=g, device=dev).to(bf)
    ref = buf.clone()
    nxt = torch.zeros(out_shape[:3] + (out_shape[3] + 32,), dtype=bf, device=dev)
    before = k7.launches
    got = k7.dense_block_apply(buf, packed, ep, epilogue, taps_packed=taps_packed,
                               out=nxt[..., :out_shape[3]])
    assert k7.launches == before + 1
    want = k7.dense_block_apply_plain(ref, packed, ep, epilogue, taps_packed)
    assert torch.equal(buf[..., :C0], ref[..., :C0])
    assert _rel(buf[..., C0:], ref[..., C0:]) <= TOL_BF16
    assert _rel(got, want) <= TOL_BF16
    assert not nxt[..., out_shape[3]:].any()


@pytest.mark.parametrize("N,H,W,C0,L", [(5, 10, 10, 192, 2), (5, 10, 6, 448, 2),
                                        (3, 6, 6, 960, 2), (44, 28, 28, 448, 2)])
def test_dense_block_transition(dev, N, H, W, C0, L):
    """K7's transition epilogue (K3's kernel with the bf16-arithmetic pool)
    at 256, 512 and 1024 channels, Q a multiple of no tile, written into a
    channel slice whose other channels stay untouched."""
    from smg_tpu_torch.ops import dense_block as k7

    g = _gen(dev, N + H + C0)
    bf = torch.bfloat16
    layers = [(c,) + _affine(g, dev, c)
              + ((torch.randn((c, 128), generator=g, device=dev) * c ** -0.5).to(bf),)
              + _affine(g, dev, 128)
              + ((torch.randn((9, 128, 32), generator=g, device=dev) * 0.03).to(bf),)
              for c in (C0 + 32 * l for l in range(L))]
    Cf = C0 + 32 * L
    at, bt = _affine(g, dev, Cf)
    wt = (torch.randn((Cf, Cf // 2), generator=g, device=dev) * Cf ** -0.5).to(bf)
    ep = k7.pack_transition(at, bt, wt)
    packed = k7.pack_dense_block(layers)
    buf = torch.randn((N, H, W, Cf), generator=g, device=dev).to(bf)
    ref = buf.clone()
    nxt = torch.zeros((N, H // 2, W // 2, Cf // 2 + 32), dtype=bf, device=dev)
    got = k7.dense_block_apply(buf, packed, ep, "transition", out=nxt[..., :Cf // 2])
    want = k7.dense_block_apply_plain(ref, packed, ep, "transition")
    assert _rel(buf[..., C0:], ref[..., C0:]) <= TOL_BF16
    assert _rel(got, want) <= TOL_BF16
    assert not nxt[..., Cf // 2:].any()


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-12))


def _k6_operands(dev, g, c_in):
    bf = torch.bfloat16
    return ((torch.randn((c_in, 128), generator=g, device=dev) * c_in ** -0.5).to(bf),
            torch.rand(c_in, generator=g, device=dev) + 0.5,
            torch.rand(c_in, generator=g, device=dev) * 0.6 - 0.2,
            (torch.randn((9, 128, 32), generator=g, device=dev) * 0.03).to(bf),
            torch.rand(128, generator=g, device=dev) + 0.5,
            torch.rand(128, generator=g, device=dev) * 0.6 - 0.2)


def _check_dense_layer_train(dev, H, C_in, n):
    """K6a and K6b against their plain versions; K6b twice gives the same bits."""
    from smg_tpu_torch.ops import dense_layer_train as k6

    g = _gen(dev, C_in + n)
    ld = C_in + 64                         # channels past the layer's stay put
    buf = torch.randn((n, H, H, ld), generator=g, device=dev).to(torch.bfloat16)
    w1, s1, b1, w2, s2, b2 = _k6_operands(dev, g, C_in)
    ref = buf.clone()
    before = k6.fwd_launches
    h1, *moms = k6.layer_fwd(buf, C_in, w1, s1, b1, w2, s2, b2)
    assert k6.fwd_launches == before + 1
    rh1, *rmoms = k6.layer_fwd_plain(ref, C_in, w1, s1, b1, w2, s2, b2)
    assert torch.equal(buf[..., :C_in], ref[..., :C_in])
    assert torch.equal(buf[..., C_in + 32:], ref[..., C_in + 32:])
    assert _rel(buf[..., C_in:C_in + 32], ref[..., C_in:C_in + 32]) <= TOL_BF16
    assert _rel(h1, rh1) <= TOL_BF16
    for got, want in zip(moms, rmoms):
        assert got.shape == (n, want.shape[-1])
    # norm1's moments against the plain version's; norm2's against those of
    # the kernel's own h1 (h1 itself is held to TOL_BF16 above).
    for got, want in zip(moms, (*rmoms[:2], *k6._moments(h1.float()))):
        assert _rel(got, want) <= 1e-4

    dbuf = torch.randn((n, H, H, ld), generator=g, device=dev)
    runs = []
    for _ in range(2):
        d = dbuf.clone()
        grads = k6.layer_bwd(buf, d, C_in, rh1, w1, w2, s1, b1, s2, b2, *rmoms)
        torch.cuda.synchronize()
        runs.append((d, grads))
    d_plain = dbuf.clone()
    want = k6.layer_bwd_plain(buf, d_plain, C_in, rh1, w1, w2, s1, b1, s2, b2, *rmoms)
    (d, grads), (d2, grads2) = runs
    assert torch.equal(d, d2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert torch.equal(d[..., C_in:], dbuf[..., C_in:])
    assert _rel_l2(d[..., :C_in] - dbuf[..., :C_in],
                   d_plain[..., :C_in] - dbuf[..., :C_in]) < 1e-2
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        assert _rel_l2(got, w) < 1e-2
    return moms, rmoms


@pytest.mark.parametrize("H,C_in,n", [(7, 64, 1), (7, 224, 5), (14, 64, 5),
                                      (14, 224, 1)])
def test_dense_layer_train(dev, H, C_in, n):
    """K6a and K6b against their plain versions; K6b twice gives the same bits."""
    moms, rmoms = _check_dense_layer_train(dev, H, C_in, n)
    for got, want in zip(moms, rmoms):
        assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("H,C_in,n", [(6, 64, 5), (6, 224, 64), (3, 96, 5), (3, 64, 64),
                                      (2, 96, 5), (1, 64, 5), (1, 224, 64)])
def test_dense_layer_train_small_images(dev, H, C_in, n):
    """K6 at images under 43 pixels, where a 128-pixel tile spans 5 (6 x 6)
    up to 128 (1 x 1) images: the GEMM's and dy1's image slots (16, 64) and
    dy1's shorter tiles (ops/dense_layer_train.py::image_plan)."""
    moms, rmoms = _check_dense_layer_train(dev, H, C_in, n)
    for got, want in zip(moms[:2], rmoms[:2]):
        assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("H", [6, 3, 1])
def test_dense_block_train_small_images(dev, H):
    """A whole dense block through K6 (autograd Function: K6a layer by
    layer, K6b in reverse) at 6 x 6, 3 x 3 and 1 x 1 images against the same
    walk through K6b's plain version from the same forward."""
    from smg_tpu_torch.ops import dense_layer_train as k6

    g = _gen(dev, 100 + H)
    bf, N, C0, L = torch.bfloat16, 40, 64, 3
    x0 = torch.randn((N, H, H, C0), generator=g, device=dev).to(bf).requires_grad_(True)
    layers = [[t.float().requires_grad_(True) for t in _k6_operands(dev, g, C0 + 32 * l)]
              for l in range(L)]
    buf, _ = k6.dense_block_train(x0, layers)
    dout = torch.randn(buf.shape, generator=g, device=dev).to(bf)
    buf.backward(dout)
    with torch.no_grad():
        # K6a layer by layer again (the same bits), then K6b's plain version.
        ref = torch.empty_like(buf)
        ref[..., :C0] = x0
        saved = [k6.layer_fwd(ref, C0 + 32 * l, w1.to(bf), s1, b1, w2.to(bf), s2, b2)
                 for l, (w1, s1, b1, w2, s2, b2) in enumerate(layers)]
        assert torch.equal(ref, buf)
        dbuf = dout.float()
        for l in reversed(range(L)):
            w1, s1, b1, w2, s2, b2 = layers[l]
            dw1, dw2, ds1, db1, ds2, db2 = k6.layer_bwd_plain(
                ref, dbuf, C0 + 32 * l, saved[l][0], w1.to(bf), w2.to(bf), s1, b1, s2, b2,
                *saved[l][1:])
            for p, w in zip((w1, s1, b1, w2, s2, b2), (dw1, ds1, db1, dw2, ds2, db2)):
                assert _rel_l2(p.grad, w) < 1e-2
        assert _rel_l2(x0.grad, dbuf[..., :C0]) < 1e-2


@pytest.mark.parametrize("C_in", [64, 96, 992])
def test_dense_layer_train_tile_edges(dev, C_in):
    """At 5 images of 7 x 7, 128-pixel tiles span up to four images and
    straddle image edges; C_in 96 and 992 leave a part-filled 128-channel
    tile (dw1, dy1)."""
    _check_dense_layer_train(dev, 7, C_in, 5)


@pytest.mark.parametrize("n", [1, 5, 64])
@pytest.mark.parametrize("H", [7, 14, 56])
def test_dense_layer_train_bwd_repeatable(dev, H, n):
    """K6b twice on the same operands gives the same bits: dx, dw1, dw2 and
    the BN gradients (fixed-order partials, no float atomics)."""
    from smg_tpu_torch.ops import dense_layer_train as k6

    C_in = 96
    g = _gen(dev, 7 * H + n)
    buf = torch.randn((n, H, H, C_in + 32), generator=g, device=dev).to(torch.bfloat16)
    ops = _k6_operands(dev, g, C_in)
    w1, s1, b1, w2, s2, b2 = ops
    h1, *moms = k6.layer_fwd(buf, C_in, *ops)
    dbuf = torch.randn(buf.shape, generator=g, device=dev)
    runs = []
    for _ in range(2):
        d = dbuf.clone()
        grads = k6.layer_bwd(buf, d, C_in, h1, w1, w2, s1, b1, s2, b2, *moms)
        torch.cuda.synchronize()
        runs.append((d, grads))
    (d, grads), (d2, grads2) = runs
    assert torch.equal(d, d2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert all(bool(torch.isfinite(t).all()) for t in (d, *grads))


def test_block_moments_keep_their_bits(dev):
    """K6a through a whole dense block, each channel's moments computed
    once into the block's buffer, gives the same mean1 and var1 bits as the
    per-layer recompute of the whole prefix (the parent design)."""
    from smg_tpu_torch.ops import dense_layer_train as k6

    g = _gen(dev, 11)
    N, H, C0, L = 5, 7, 64, 4
    x0 = torch.randn((N, H, H, C0), generator=g, device=dev).to(torch.bfloat16)
    layers = [tuple(t.float() for t in _k6_operands(dev, g, C0 + 32 * l)) for l in range(L)]
    buf, moments = k6.dense_block_train(x0, layers)
    for l, (w1, s1, b1, w2, s2, b2) in enumerate(layers):
        c_in = C0 + 32 * l
        ref = buf.clone()
        _, m1, v1, _, _ = k6.layer_fwd(ref, c_in, w1.to(torch.bfloat16), s1, b1,
                                       w2.to(torch.bfloat16), s2, b2)
        assert torch.equal(moments[l][0], m1) and torch.equal(moments[l][1], v1)


def test_wrappers_reject_bad_operands(dev):
    from smg_tpu_torch.ops import dense_layer_train as k6
    from smg_tpu_torch.ops import stem_pool as k4

    y = torch.zeros((1, 8, 8, 64), device=dev)        # float32, not bf16
    with pytest.raises(TypeError):
        k4.bn_relu_maxpool(y, torch.zeros(64, device=dev),
                           torch.zeros(64, device=dev))
    ops = _k6_operands(dev, _gen(dev, 1), 64)
    with pytest.raises(TypeError):
        k6.layer_fwd(torch.zeros((1, 7, 7, 128), device=dev), 64, *ops)
    with pytest.raises(ValueError):                   # no room for the 32 channels
        k6.layer_fwd(torch.zeros((1, 7, 7, 64), device=dev, dtype=torch.bfloat16),
                     64, *ops)
    # Images under 43 pixels (a 128-pixel tile spans 5 or more) run and
    # match the plain version.
    buf = torch.randn((1, 6, 6, 96), generator=_gen(dev, 2), device=dev).to(torch.bfloat16)
    ref = buf.clone()
    k6.layer_fwd(buf, 64, *ops)
    k6.layer_fwd_plain(ref, 64, *ops)
    assert _rel(buf[..., 64:], ref[..., 64:]) <= TOL_BF16
    from smg_tpu_torch.ops import transition as k3

    a, b = _affine(_gen(dev, 3), dev, 1024)
    wt = torch.zeros((1024, 512), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                   # 2^31 elements: past 32-bit indices
        k3.transition(torch.empty((1, 2, 2 ** 20, 1024), device=dev, dtype=torch.bfloat16),
                      a, b, wt)
