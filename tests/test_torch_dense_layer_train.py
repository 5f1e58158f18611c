"""Parity: the port's K6 (plain versions, as the CPU takes them) against the
JAX package's train-mode dense layer.

- Forward: out, h1 and the four moment vectors against
  fast_trunk._layer_vjp_pk (the Pallas kernel in interpret mode); relative
  L2 1e-5 in float32 and 3e-2 in bf16, the JAX tests' own bounds
  (tests/test_dense_layer_train_pallas.py:68).
- Backward: every gradient of sum(out^2) (the prefix and all six
  parameters) through the port's autograd Function against jax.grad of
  _layer_vjp_pk and of the hand-written _layer_vjp, float32, relative L2
  1e-4.
- n = 3 images in one call with per-image statistics against the JAX layer
  vmapped over batch-1 calls (the trainer's structure).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.models import fast_trunk as jft
from smg_tpu_torch.ops import dense_layer_train as k6

torch.set_num_threads(1)  # as test_torch_parity_helpers.py: one thread per xdist worker


def _rel_l2(got, ref):
    g = np.asarray(got, np.float32).ravel()
    r = np.asarray(ref, np.float32).ravel()
    return float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-6))


def _params(rng, C):
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return {
        "norm1": {"scale": f(rng.uniform(0.5, 1.5, C)), "bias": f(rng.randn(C) * 0.1)},
        "conv1": {"kernel": f(rng.randn(1, 1, C, 128) * 0.05)},
        "norm2": {"scale": f(rng.uniform(0.5, 1.5, 128)), "bias": f(rng.randn(128) * 0.1)},
        "conv2": {"kernel": f(rng.randn(3, 3, 128, 32) * 0.05)},
    }


def _port_layer(p, C, requires_grad=False):
    """The layer's f32 operands in the port's layout."""
    t = lambda a: torch.tensor(np.asarray(a), requires_grad=requires_grad)  # noqa: E731
    return (t(p["conv1"]["kernel"].reshape(C, 128)), t(p["norm1"]["scale"]),
            t(p["norm1"]["bias"]), t(p["conv2"]["kernel"].reshape(9, 128, 32)),
            t(p["norm2"]["scale"]), t(p["norm2"]["bias"]))


def _bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _case(seed, n, HW, cs, dtype):
    rng = np.random.RandomState(seed)
    C = sum(cs)
    x = rng.randn(n, HW, HW, C).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_np(x)
    return x, _params(rng, C)


def _jax_segs(x, cs, jdt):
    offs = np.cumsum((0,) + cs)
    return tuple(jnp.asarray(x[..., offs[i]:offs[i + 1]], jdt) for i in range(len(cs)))


def _port_fwd(x, p, C, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    n, H, W, _ = x.shape
    buf = torch.zeros((n, H, W, C + 32), dtype=tdt)
    buf[..., :C] = torch.tensor(x).to(tdt)
    w1, s1, b1, w2, s2, b2 = _port_layer(p, C)
    h1, m1, v1, m2, v2 = k6.layer_fwd(buf, C, w1.to(tdt), s1, b1, w2.to(tdt), s2, b2)
    return buf, h1, (m1, v1, m2, v2)


def _check_fwd(cs, dtype, HW):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    C = sum(cs)
    x, p = _case(HW * 100 + C, 1, HW, cs, dtype)
    segs = _jax_segs(x, cs, jdt)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    out, h1, *moms = jft._pk_fwd_call(segs, jp, jdt)
    buf, ph1, pmoms = _port_fwd(x, p, C, dtype)
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert _rel_l2(buf[..., C:].float(), out.astype(jnp.float32)) < tol
    assert _rel_l2(ph1.float(), h1.astype(jnp.float32)) < tol
    for got, want in zip(pmoms, moms):
        assert got.shape == (1, want.shape[-1])
        assert _rel_l2(got[0], want) < tol
    # The prefix is left as it was.
    assert torch.equal(buf[..., :C].float(),
                       torch.tensor(x).to(buf.dtype).float())


@pytest.mark.parametrize("cs", [(64,), (128, 96), (128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("HW", [12, 7])
def test_fwd_matches_pallas(cs, dtype, HW):
    _check_fwd(cs, dtype, HW)


def _port_grads(x, p, C):
    ops = _port_layer(p, C, requires_grad=True)
    x0 = torch.tensor(x, requires_grad=True)
    buf, _ = k6.dense_block_train(x0, [ops])
    (buf[..., C:] ** 2).sum().backward()
    return x0.grad.numpy(), [t.grad.numpy() for t in ops]


def _jax_grads(fn, x, p, cs):
    def loss(args):
        segs_, p_ = args
        out, _ = fn(segs_, p_, jnp.float32)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    segs = _jax_segs(x, cs, jnp.float32)
    gs, gp = jax.grad(loss)((segs, jax.tree_util.tree_map(jnp.asarray, p)))
    C = sum(cs)
    return (np.concatenate([np.asarray(g) for g in gs], -1),
            [np.asarray(gp["conv1"]["kernel"]).reshape(C, 128),
             gp["norm1"]["scale"], gp["norm1"]["bias"],
             np.asarray(gp["conv2"]["kernel"]).reshape(9, 128, 32),
             gp["norm2"]["scale"], gp["norm2"]["bias"]])


def _check_bwd(cs, HW):
    C = sum(cs)
    x, p = _case(HW * 100 + C + 1, 1, HW, cs, "float32")
    gx, gps = _port_grads(x, p, C)
    for fn in (jft._layer_vjp_pk, jft._layer_vjp):
        wx, wps = _jax_grads(fn, x, p, cs)
        assert _rel_l2(gx, wx) < 1e-4, fn.__name__
        for i, (g, w) in enumerate(zip(gps, wps)):
            assert _rel_l2(g, w) < 1e-4, (fn.__name__, i, _rel_l2(g, w))


@pytest.mark.parametrize("cs", [(64,), (128, 96), (128, 128)])
@pytest.mark.parametrize("HW", [12, 7])
def test_bwd_matches_pallas_and_vjp(cs, HW):
    _check_bwd(cs, HW)


@pytest.mark.parametrize("cs", [(64,), (128, 96)])
@pytest.mark.parametrize("HW", [6, 2])
def test_small_images_match_pallas(cs, HW):
    """Images under 43 pixels (6 x 6: a 128-pixel tile of the card's K6
    spans 5 images; 2 x 2: 33), which the reference's 'pk' path runs too:
    forward in float32 and bf16, backward in float32, at the bounds above."""
    for dtype in ("float32", "bfloat16"):
        _check_fwd(cs, dtype, HW)
    _check_bwd(cs, HW)


def test_images_keep_their_own_statistics():
    """n = 3 images in one call == the JAX layer vmapped over batch-1 calls:
    forward (out, moments) and gradients."""
    cs, HW, C = (64,), 8, 64
    x, p = _case(7, 3, HW, cs, "float32")
    jp = jax.tree_util.tree_map(jnp.asarray, p)

    def one(xi, p_):
        out, moms = jft._layer_vjp_pk((xi[None],), p_, jnp.float32)
        return out[0], moms

    out, moms = jax.vmap(one, in_axes=(0, None))(jnp.asarray(x), jp)
    buf, _, pmoms = _port_fwd(x, p, C, "float32")
    assert _rel_l2(buf[..., C:], out) < 1e-5
    for got, want in zip(pmoms, moms):
        assert _rel_l2(got, want) < 1e-5

    def loss(args):
        x_, p_ = args
        return jnp.sum(jax.vmap(one, in_axes=(0, None))(x_, p_)[0] ** 2)

    wx, wp = jax.grad(loss)((jnp.asarray(x), jp))
    gx, gps = _port_grads(x, p, C)
    assert _rel_l2(gx, wx) < 1e-4
    want = [np.asarray(wp["conv1"]["kernel"]).reshape(C, 128), wp["norm1"]["scale"],
            wp["norm1"]["bias"], np.asarray(wp["conv2"]["kernel"]).reshape(9, 128, 32),
            wp["norm2"]["scale"], wp["norm2"]["bias"]]
    for g, w in zip(gps, want):
        assert _rel_l2(g, w) < 1e-4
