"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip without a CUDA device (a CUDA kernel has no
interpret mode). Small shapes; chip_smoke.py checks the act step's full
shapes. This file imports neither jax nor smg_tpu, so it also runs where
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


@pytest.mark.parametrize("H,C", [(4, 256), (6, 512), (2, 1024)])
def test_transition(dev, H, C):
    from smg_tpu_torch.ops import transition as k3

    g = _gen(dev, C)
    x = torch.randn((3, H, H, C), generator=g, device=dev).to(torch.bfloat16)
    a = torch.rand(C, generator=g, device=dev) + 0.5
    b = torch.rand(C, generator=g, device=dev) * 0.6 - 0.2
    wt = (torch.randn((C, C // 2), generator=g, device=dev) * C ** -0.5).to(
        torch.bfloat16)
    out = torch.zeros((3, H // 2, H // 2, C), dtype=torch.bfloat16, device=dev)
    k3.transition(x, a, b, wt, out=out[..., :C // 2])
    assert _rel(out[..., :C // 2], k3.transition_plain(x, a, b, wt)) <= TOL_BF16
    assert not out[..., C // 2:].any()      # the view's other channels untouched


@pytest.mark.parametrize("H", [9, 16])
def test_stem_pool(dev, H):
    from smg_tpu_torch.ops import stem_pool as k4

    g = _gen(dev, H)
    y = torch.randn((2, H, H, 64), generator=g, device=dev).to(torch.bfloat16)
    a = torch.rand(64, generator=g, device=dev) + 0.5
    b = torch.rand(64, generator=g, device=dev) - 0.5
    got = k4.bn_relu_maxpool(y, a, b)
    assert torch.equal(got, k4.bn_relu_maxpool_plain(y, a, b))


def test_wrappers_reject_bad_operands(dev):
    from smg_tpu_torch.ops import stem_pool as k4

    y = torch.zeros((1, 8, 8, 64), device=dev)        # float32, not bf16
    with pytest.raises(TypeError):
        k4.bn_relu_maxpool(y, torch.zeros(64, device=dev),
                           torch.zeros(64, device=dev))
