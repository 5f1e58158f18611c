"""Parity: the port's eval trunk kernels (plain versions), trunk and head
against the JAX package.

- K4 (stem) against fast_trunk._stem(conv2='fl', interpret=True), K3
  against transition_pallas.transition(interpret=True), K2 against
  dense_layer_pallas.dense_block_fused(interpret=True): small spatial
  sizes (8x8, 7x7) at DenseNet-121's real channel counts. Both sides round
  to bf16 at the same points; their f32 sums run in different orders, so
  an element may land one bf16 step (2^-8 relative) apart, which a
  downstream bf16 rounding can double. Bound: max |err| <= 2^-6 of the
  largest |value| (4 bf16 steps).
- A shallow trunk (block_config (2, 2, 2, 2): every block ends 128-aligned)
  plus head against Flax AffordanceNet.score in eval: float32 to 1e-4 of
  the largest output; bf16 to 5% with equal argmax (PARITY devs 12, 15).
- The full DenseNet-121 at 224 against Flax in bf16, marked slow as
  tests/test_fast_trunk.py:150-195 is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.models import affordance as jaff
from smg_tpu.models import fast_trunk as jft
from smg_tpu.ops import dense_layer_pallas as dlp
from smg_tpu.ops import transition_pallas as trp
from smg_tpu_torch.models import densenet as tdn
from smg_tpu_torch.models import fast_trunk as tft
from smg_tpu_torch.ops import dense_layer as k2
from smg_tpu_torch.ops import stem_pool as k4
from smg_tpu_torch.ops import transition as k3

from test_torch_parity_helpers import (
    assert_kernel_close as _assert_kernel_close,
    bf16_np as _bf16_np,
    bn_np as _bn_np,
    flax_block as _flax_block,
    fold_np as _fold,
    models as _models,
    score_inputs as _inputs,
)

# ---------------------------------------------------------------------------
# Kernels (plain versions) against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def test_stem_pool_matches_pallas():
    rng = np.random.RandomState(0)
    x1 = rng.randn(2, 32, 32, 1).astype(np.float32)
    x = np.repeat(x1, 3, axis=-1)
    k0 = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    p, s = _bn_np(rng, 64)
    tp = {"conv0": {"kernel": jnp.asarray(k0)}, "norm0": p}
    ts = {"norm0": s}
    want = jft._stem(tp, ts, jnp.asarray(x), conv2="fl", interpret=True)
    assert want.shape == (2, 8, 8, 64)
    kg = torch.as_tensor(k0).permute(3, 2, 0, 1).sum(1, keepdim=True)
    y = tft._stem_conv(torch.as_tensor(x), kg.to(torch.bfloat16))
    got = k4.bn_relu_maxpool(y, *_fold(p, s))
    assert got.dtype == torch.bfloat16
    _assert_kernel_close(got.float(), want, "stem")


@pytest.mark.parametrize("C", [256, 512, 1024])
def test_transition_matches_pallas(C):
    rng = np.random.RandomState(C)
    x = _bf16_np(rng.randn(2, 8, 8, C))
    p, s = _bn_np(rng, C)
    wt = _bf16_np(rng.randn(C, C // 2) * C ** -0.5)
    a, b = _fold(p, s)
    segs = tuple(jnp.asarray(x[..., g:g + 128], jnp.bfloat16)
                 for g in range(0, C, 128))
    want = trp.transition(segs, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                          jnp.asarray(wt, jnp.bfloat16), interpret=True)
    got = k3.transition(torch.tensor(x).to(torch.bfloat16), a, b,
                        torch.tensor(wt).to(torch.bfloat16))
    _assert_kernel_close(got.float(), np.asarray(want, np.float32),
                         f"transition C={C}")


@pytest.mark.parametrize("HW,C0,L", [
    (8, 64, 6),      # block 1 of DenseNet-121: 64 -> 256
    (8, 128, 12),    # block 2: 128 -> 512
    (7, 896, 4),     # block 3's deepest layers: 896 -> 1024
    (7, 512, 16),    # block 4: 512 -> 1024, unaligned width on the TPU
    pytest.param(7, 256, 24, marks=pytest.mark.slow),  # all of block 3
])
def test_dense_block_matches_pallas(HW, C0, L):
    rng = np.random.RandomState(HW * 1000 + C0)
    bp, bs = _flax_block(rng, C0, L)
    x0 = _bf16_np(rng.randn(1, HW, HW, C0))
    segs = [jnp.asarray(x0[..., g:g + 128], jnp.bfloat16)
            for g in range(0, C0, 128)]
    names = [f"denselayer{i + 1}" for i in range(L)]
    jbp = jax.tree_util.tree_map(jnp.asarray, bp)
    jbs = jax.tree_util.tree_map(jnp.asarray, bs)
    want = np.concatenate([np.asarray(g, np.float32) for g in
                           dlp.dense_block_fused(jbp, jbs, segs, names,
                                                 interpret=True)], -1)

    C = C0 + 32 * L
    buf = torch.zeros(1, HW, HW, C, dtype=torch.bfloat16)
    buf[..., :C0] = torch.tensor(x0).to(torch.bfloat16)
    for i, n in enumerate(names):
        p, s = bp[n], bs[n]
        c_in = C0 + 32 * i
        a1, b1 = _fold(p["norm1"], s["norm1"])
        a2, b2 = _fold(p["norm2"], s["norm2"])
        w1 = torch.as_tensor(p["conv1"]["kernel"].reshape(c_in, 128))
        w2 = torch.as_tensor(p["conv2"]["kernel"].reshape(9, 128, 32))
        k2.dense_layer(buf, c_in, a1, b1, w1.to(torch.bfloat16), a2, b2,
                       w2.to(torch.bfloat16))
    # Each layer's 32 channels against the JAX block, layer by layer.
    for i in range(L):
        lo = C0 + 32 * i
        _assert_kernel_close(buf[..., lo:lo + 32].float(),
                             want[..., lo:lo + 32], f"layer {i + 1}")


# ---------------------------------------------------------------------------
# Trunk + head against Flax AffordanceNet.score (eval)
# ---------------------------------------------------------------------------


def _score_pair(monkeypatch, dtype, block_config, S, B, M, style):
    model, variables, port = _models(monkeypatch, dtype, block_config, S)
    scene, masks = _inputs(1, B, M, S)
    want = np.asarray(model.apply(
        variables, jnp.asarray(scene), jnp.asarray(masks), style, False,
        method=jaff.AffordanceNet.score), np.float32)
    got = port.score_eval(torch.as_tensor(scene), torch.as_tensor(masks),
                          style).numpy()
    assert got.shape == want.shape == (B, M, 1)
    assert float(want.std()) > 1e-3  # non-degenerate oracle
    return got, want


@pytest.mark.parametrize("style", [0, 1, 2])
def test_shallow_score_float32(monkeypatch, style):
    got, want = _score_pair(monkeypatch, "float32", (2, 2, 2, 2), 64, 2, 4,
                            style)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err < 1e-4, err


def test_shallow_score_bf16(monkeypatch):
    got, want = _score_pair(monkeypatch, "bfloat16", (2, 2, 2, 2), 64, 2, 6, 0)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err < 0.05, err
    np.testing.assert_array_equal(got[..., 0].argmax(1), want[..., 0].argmax(1))


@pytest.mark.slow
def test_densenet121_224_score_bf16(monkeypatch):
    got, want = _score_pair(monkeypatch, "bfloat16", tdn.BLOCK_CONFIG, 224,
                            1, 3, 1)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err < 0.05, err
    np.testing.assert_array_equal(got[..., 0].argmax(1), want[..., 0].argmax(1))
