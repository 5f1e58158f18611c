"""Parity: the port's tiny trunk (models/densenet.py::TinyTrunk,
models/fast_trunk.py::tiny_features_train) and the tiny-trunk Trainer
against the JAX package's Flax TinyTrunk and Trainer(trunk="tiny"), in
float32 on the CPU; weights and random BatchNorm statistics go through
the bridge.

Tolerances (float32 convolutions summed in other orders):
- the trunk's eval and train forwards: 1e-4 of the largest |feature|; the
  running statistics after a train pass: STATS_TOL;
- score_scene_batch at B = 2: 1e-4 of the largest |score|, the invalid
  slots' -1e9 exact;
- one update at B = 2 (styles 1 and 2): the loss to 1e-5 relative and the
  new statistics to STATS_TOL. The gradients are held to the JAX Trainer's
  own gradient in float64 (its Flax modules built in float64 under
  jax.enable_x64): the port's float64 gradient to F64_TOL relative L2 per
  leaf (read: 3.6e-6; JAX's head returns its output in float32, and that
  rounding moves the Huber cotangent by ~1e-7 / |output - label|), the
  port's float32 gradient to 1e-3 (read: 1.9e-4, at the first conv). The
  port's float32 gradient is also held to JAX's float32 one at 2e-3
  (test_torch_parity_helpers.assert_grads), or WITNESS_FACTOR times JAX's
  float32 gap from its float64 gradient where that is larger: JAX's
  float32 features of a masked stream are ~5e-5 off its float64 ones (its
  BatchNorm moments of near-constant images), and the head's per-image
  BatchNorm over 7 x 7 cells amplifies that in the backward, so its trunk
  gradients read up to 6.7e-3 from float64.
And the DenseNet-only paths refuse the tiny trunk: the eval backends and
fast_train_conv2 "pk".
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smg_tpu.models import affordance as jaff
from smg_tpu.models import densenet as jdn
from smg_tpu.train import trainer as jtr
from smg_tpu_torch import bridge
from smg_tpu_torch.models import affordance as aff
from smg_tpu_torch.models import densenet, fast_trunk
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.physics.state import N_SLOTS
from smg_tpu_torch.train import losses
from smg_tpu_torch.train.trainer import Experience, TrainConfig, Trainer, TrainerState

from test_torch_parity_helpers import (
    STATS_TOL,
    assert_grads,
    assert_stats,
    flat_tree,
    init_flax_all,
    jax_trainer_state,
    leaf_gaps,
    port_grads,
    rand_stats,
    reset_port,
    to_numpy_tree,
    to_port as _t,
    train_images,
    witness_tol,
)

B = 2
F64_TOL = 1e-5
S = 224


@pytest.fixture(scope="module")
def trainers():
    """(JAX trainer, params, stats, port trainer), trunk "tiny", float32."""
    jm = jaff.ModelConfig(method="reinforcement", trunk="tiny", input_size=S, dtype="float32")
    jt = jtr.Trainer(jtr.TrainConfig(model=jm, method="reinforcement", scene_chunk=B,
                                     unroll_styles="off"))
    variables = init_flax_all(jt.model, densenet.TINY_FEATURES, jm.feature_hw, 0)
    params, stats = variables["params"], rand_stats(variables["batch_stats"], 0)
    pt = Trainer(TrainConfig(model=ModelConfig(method="reinforcement", trunk="tiny",
                                               input_size=S, dtype="float32"),
                             method="reinforcement", scene_chunk=B), device="cpu")
    reset_port(pt, params, stats)
    return jt, params, stats, pt


def _trunk_inputs(seed, n, size):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, size, size) * 0.06 - 0.02) / 0.03
    return np.repeat(x[..., None], 3, axis=-1).astype(np.float32)


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max err {err:.2e} of scale {scale:.3f}"


def test_trunk_eval_forward(trainers):
    _, params, stats, pt = trainers
    x = _trunk_inputs(0, 3, 64)
    flax = jdn.TinyTrunk(dtype=jnp.float32)
    want = flax.apply({"params": params["grasp_trunk"], "batch_stats": stats["grasp_trunk"]},
                      jnp.asarray(x), False)
    got = pt.model.grasp_trunk(torch.as_tensor(x))
    assert got.shape == (3, 2, 2, densenet.TINY_FEATURES)
    _close(got.detach().numpy(), want)


def test_trunk_train_forward(trainers):
    """Per-image BatchNorm: each image alone through Flax's train mode."""
    _, params, stats, pt = trainers
    x = _trunk_inputs(1, 3, 64)
    flax = jdn.TinyTrunk(dtype=jnp.float32)
    trunk = pt.model.grasp_trunk
    feats, moments = fast_trunk.tiny_features_train(trunk, torch.as_tensor(x))
    for i in range(3):
        want, mut = flax.apply(
            {"params": params["grasp_trunk"], "batch_stats": stats["grasp_trunk"]},
            jnp.asarray(x[i:i + 1]), True, mutable=["batch_stats"])
        _close(feats[i:i + 1].detach().numpy(), want)
        got_stats = {}
        for bn, m, v in moments:
            name = next(n for n, mod in trunk.named_children() if mod is bn)
            got_stats[(name, "mean")] = fast_trunk._running(bn.running_mean, m[i]).numpy()
            got_stats[(name, "var")] = fast_trunk._running(bn.running_var, v[i]).numpy()
        assert_stats(got_stats, flat_tree(to_numpy_tree(mut["batch_stats"])), STATS_TOL)


def _score_inputs(seed):
    rng = np.random.RandomState(seed)
    depth = (rng.rand(B, S, S) * 0.06).astype(np.float32)
    masks = np.zeros((B, N_SLOTS, S, S), bool)
    for b in range(B):
        for n in range(N_SLOTS):
            y, x = rng.randint(0, 180, 2)
            masks[b, n, y:y + 40, x:x + 40] = True
    valid = rng.rand(B, N_SLOTS) < 0.7
    return depth * masks.any(1), masks, valid


def test_scores_match_jax(trainers):
    jt, params, stats, pt = trainers
    depth, masks, valid = _score_inputs(2)
    jstate = jax_trainer_state(jt, params, stats)
    want = to_numpy_tree(jax.jit(jt.score_scene_batch)(
        jstate, jnp.asarray(depth), jnp.asarray(masks), jnp.asarray(valid)))
    with torch.no_grad():
        got = pt.score_scene_batch(None, _t(depth), _t(masks), _t(valid))
    for k in ("gra_conf", "suc_conf"):
        w, g = want[k], getattr(got, k).numpy()
        live = w > -1e8
        np.testing.assert_array_equal(g > -1e8, live)
        _close(g[live], w[live])
        np.testing.assert_array_equal(g[~live], w[~live])


def _grad_capture():
    """An optax transformation that keeps the gradient as its state."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def test_update_matches_jax(trainers, monkeypatch):
    jt, params, stats, pt = trainers
    depth, mask = train_images(3, B)
    style = np.array([1, 2], np.int32)
    valid = np.array([True, True])
    labels = np.array([0.5, 2.0], np.float32)
    jt = jtr.Trainer(dataclasses.replace(jt.cfg))
    jt.tx = _grad_capture()
    jexp = jtr.Experience(scene_depth=jnp.asarray(depth), exec_mask=jnp.asarray(mask),
                          style=jnp.asarray(style), valid=jnp.asarray(valid))
    jnew, jloss = jax.jit(jt.update)(jax_trainer_state(jt, params, stats), jexp,
                                     jnp.asarray(labels))
    reset_port(pt, params, stats)
    pstate, ploss = pt.update(TrainerState(0), Experience(
        scene_depth=_t(depth), exec_mask=_t(mask), style=_t(style), valid=_t(valid)),
        _t(labels))
    assert pstate.iteration == 1 and float(jloss) > 0
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    got, want = port_grads(pt.model), flat_tree(to_numpy_tree(jnew.opt_state))
    truth = _jax_f64_grads(jt, params, stats, jexp, labels, monkeypatch)
    port64 = _f64_grads(pt, params, stats, depth, mask, style, labels)
    gaps = {name: max(leaf_gaps(g, truth).values())
            for name, g in (("port f64", port64), ("port f32", got), ("JAX f32", want))}
    print("update gradients from JAX's float64:",
          ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    assert_grads(port64, truth, tol=F64_TOL)
    assert_grads(got, truth, tol=1e-3)
    assert_grads(got, want, tol=witness_tol(2e-3, gaps["JAX f32"]))
    reset_port(pt, params, stats)
    pt.update(TrainerState(0), Experience(
        scene_depth=_t(depth), exec_mask=_t(mask), style=_t(style), valid=_t(valid)),
        _t(labels))
    assert_stats(flat_tree(bridge.dump_affordance_params(pt.model)[1]),
                 flat_tree(to_numpy_tree(jnew.batch_stats)))


def _jax_f64_grads(jt, params, stats, jexp, labels, monkeypatch):
    """The JAX Trainer's update gradient in float64: the same Trainer with
    its Flax modules built in float64, under jax.enable_x64."""
    monkeypatch.setattr(jaff.ModelConfig, "jdtype", property(lambda self: jnp.float64))
    f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else jnp.asarray(np.asarray(a)), t)
    with jax.enable_x64(True):
        j64 = jtr.Trainer(dataclasses.replace(jt.cfg))
        j64.tx = _grad_capture()
        new, _ = jax.jit(j64.update)(jax_trainer_state(j64, f64(params), f64(stats)),
                                     f64(jexp), f64(jnp.asarray(labels)))
        return flat_tree(to_numpy_tree(new.opt_state))


def _f64_grads(pt, params, stats, depth, mask, style, labels):
    """The update's loss (mean Huber over the valid scenes) differentiated
    in float64 through the port's tiny trunk and head, per scene."""
    net = pt.model
    reset_port(pt, params, stats)
    net.double()
    net.zero_grad(set_to_none=True)
    prep = lambda d: aff.preprocess_depth(torch.as_tensor(d).double(), pt.cfg.model)  # noqa: E731
    for b, s in enumerate(style):
        trunk = net.trunk(int(s))
        trunk.dtype = torch.float64
        out, _ = fast_trunk.score_train(trunk, net.head(int(s)), prep(depth[b:b + 1]),
                                        prep(depth[b:b + 1] * mask[b:b + 1]), 1)
        (losses.huber_q(out[:, 0], torch.tensor(labels[b:b + 1]).double())
         / len(style)).sum().backward()
        trunk.dtype = torch.float32
    grads = port_grads(net)
    net.float()
    reset_port(pt, params, stats)
    return grads


def test_densenet_paths_refuse_tiny(trainers):
    *_, pt = trainers
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(TypeError, match="DenseNet-121"):
        fast_trunk.trunk_features_eval(pt.model.grasp_trunk, x)
    with pytest.raises(ValueError, match="tiny trunk"):
        fast_trunk.score_train(pt.model.grasp_trunk, pt.model.grasp_head, x, x, 1, "pk")
    with pytest.raises(ValueError, match="unknown trunk"):
        densenet.make_trunk("resnet")
