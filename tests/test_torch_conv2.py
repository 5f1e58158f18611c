"""Parity: K5 (the eval BN2/ReLU/3x3 on h1) and the `xla_pk` dense block
against the JAX package, on the CPU.

- K5's plain version against conv2_pallas.conv2_bn_relu(interpret=True) at
  8x8, at 7x7 (the TPU pads the width to 8 and masks it) and at 16x16 cut
  into two row bands (force_ty=2: the halo side input); the merge variant
  against conv2_bn_relu_merge at every pend_n, with and without `pend`.
- The `xla_pk` dense block walk (plain bottleneck + K5 per layer, in place
  in one buffer) against fast_trunk._dense_block_xla_segs(conv2="pk",
  interpret=True) at DenseNet's channel counts: a merge-variant block
  (8x8, 64 -> 256) and a plain-variant one (7x7, 512 -> 640).
Bound: KERNEL_TOL (2^-6 of the largest |value|; test_torch_parity_helpers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.models import fast_trunk as jft
from smg_tpu.ops import conv2_pallas as c2p
from smg_tpu_torch.models import fast_trunk as tft
from smg_tpu_torch.ops import conv2 as k5

from test_torch_parity_helpers import (
    assert_kernel_close,
    bf16_np,
    block_layers,
    bn_np,
    flax_block,
    fold_np,
)


def _operands(seed, H, W, B=2):
    """h1 (B, H, W, 128) bf16 values, the folded BN2 and a conv2 kernel."""
    rng = np.random.RandomState(seed)
    h1 = bf16_np(rng.randn(B, H, W, 128))
    a, b = fold_np(*bn_np(rng, 128))
    k = (rng.randn(3, 3, 128, 32) * (2 / 1152) ** 0.5).astype(np.float32)
    return h1, a, b, k


def _jax(h1, a, b, k):
    return (jnp.asarray(h1, jnp.bfloat16), jnp.asarray(a.numpy()),
            jnp.asarray(b.numpy()), c2p.pack_w2(jnp.asarray(k)))


def _port(h1, k):
    return (torch.tensor(h1).to(torch.bfloat16),
            torch.tensor(k.reshape(9, 128, 32)).to(torch.bfloat16))


@pytest.mark.parametrize("H,W,force_ty", [(8, 8, None), (7, 7, None), (16, 16, 2)])
def test_conv2_matches_pallas(H, W, force_ty):
    h1, a, b, k = _operands(H * 100 + W, H, W)
    want = c2p.conv2_bn_relu(*_jax(h1, a, b, k), interpret=True, force_ty=force_ty)
    th1, w2 = _port(h1, k)
    got = k5.conv2_bn_relu(th1, a, b, w2)
    assert got.dtype == torch.bfloat16
    assert_kernel_close(got.float(), want, f"conv2 {H}x{W} ty={force_ty}")


@pytest.mark.parametrize("with_pend", [False, True])
@pytest.mark.parametrize("pend_n", [0, 32, 64, 96])
def test_conv2_merge_matches_pallas(pend_n, with_pend):
    h1, a, b, k = _operands(pend_n + int(with_pend), 8, 8)
    pend = None
    if with_pend:
        pend = bf16_np(np.random.RandomState(pend_n).randn(*h1.shape))
        pend[..., pend_n:] = 0.0                       # lanes [pend_n, 128) unused
    jh1, ja, jb, jw = _jax(h1, a, b, k)
    want = c2p.conv2_bn_relu_merge(
        jh1, None if pend is None else jnp.asarray(pend, jnp.bfloat16), ja, jb, jw,
        pend_n, interpret=True)
    th1, w2 = _port(h1, k)
    got = k5.conv2_bn_relu_merge(
        th1, None if pend is None else torch.tensor(pend).to(torch.bfloat16), a, b, w2,
        pend_n)
    new = slice(pend_n, pend_n + 32)
    assert_kernel_close(got[..., new].float(), np.asarray(want, np.float32)[..., new],
                        f"merge pend_n={pend_n}")
    kept = np.ones(128, bool)
    kept[new] = False
    np.testing.assert_array_equal(got[..., kept].float().numpy(),
                                  np.asarray(want, np.float32)[..., kept])


@pytest.mark.parametrize("HW,C0,L", [(8, 64, 6), (7, 512, 4)])
def test_pk_dense_block_matches_jax(HW, C0, L):
    rng = np.random.RandomState(HW * 1000 + C0)
    bp, bs = flax_block(rng, C0, L)
    x0 = bf16_np(rng.randn(1, HW, HW, C0))
    segs = [jnp.asarray(x0[..., g:g + 128], jnp.bfloat16) for g in range(0, C0, 128)]
    assert c2p.merge_supported(HW, HW) == (HW % 8 == 0)
    want = np.concatenate([np.asarray(s, np.float32) for s in jft._dense_block_xla_segs(
        jax.tree_util.tree_map(jnp.asarray, bp), jax.tree_util.tree_map(jnp.asarray, bs),
        segs, conv2="pk", interpret=True)], -1)

    buf = torch.zeros(1, HW, HW, C0 + 32 * L, dtype=torch.bfloat16)
    buf[..., :C0] = torch.tensor(x0).to(torch.bfloat16)
    tft._dense_block_pk(buf, block_layers(bp, bs))
    torch.testing.assert_close(buf[..., :C0].float(), torch.tensor(x0))
    for i in range(L):
        lo = C0 + 32 * i
        assert_kernel_close(buf[..., lo:lo + 32].float(), want[..., lo:lo + 32],
                            f"layer {i + 1}")
