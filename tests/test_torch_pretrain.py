"""Parity: trunk pretraining (smg_tpu_torch/train/pretrain.py) against
smg_tpu/train/pretrain.py.

- The train-mode BatchNorm forward (batch-wide moments, running
  statistics updated with the biased variance), on a shallow DenseNet
  (block_config (2, 2, 2, 2)) and on the tiny trunk, float32 at a
  64-pixel input: the updated statistics to relative 1e-5 of each
  array's largest |value|; the features to relative 1e-5 of the same
  Flax forward run in float64 (jax.enable_x64), and to JAX's float32
  within 1e-5 plus JAX's own distance from that float64 forward (XLA's
  float32 reductions read ~2e-5 from it, the port ~5e-6).
- `pretrain_step` (the masked-reconstruction loss, then Adam against
  optax.adam) on the same two trunks: the loss, and every running
  statistic after the step, to relative 1e-5 (of each leaf's largest
  |value|); the gradients it hands Adam per leaf to relative L2 2e-3 with
  a 1e-3 * gmax floor (test_torch_parity_helpers.assert_grads); and the
  parameters after the port's Adam step on JAX's gradients to relative
  1e-5 of each leaf's largest |value| against optax's. The parameters of
  the two whole steps are not compared to 1e-5: several gradients are
  zero but for rounding (the BatchNorm bias below a ReLU whose inputs are
  all positive and a train-mode BatchNorm, which removes the constant),
  and Adam's first step moves a weight by lr * sign(gradient) whatever its
  size, so such leaves read the sign of rounding noise (test_torch_train.py
  says the same of the update).
- `load_pretrained_trunks` bit-equal to JAX's, through the bridge.
- `random_patch_mask` keeps its blocks and ratio (tests/test_pretrain.py:30-36);
  `make_batch_fn` hides what the mask says.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smg_tpu.models import densenet as jdn
from smg_tpu.models.affordance import ModelConfig as JModelConfig
from smg_tpu.train import pretrain as jpre
from smg_tpu_torch import bridge
from smg_tpu_torch.models import affordance as aff
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.train import pretrain

from test_torch_parity_helpers import assert_grads, flat_tree, to_numpy_tree

SIZE = 64
BATCH = 3
SHALLOW = (2, 2, 2, 2)
TOL = 1e-5
TRUNKS = ("densenet121", "tiny")


def _shallow(monkeypatch, trunk):
    """Make the Flax ReconstructionModel build a shallow DenseNet (a
    test-local patch; nothing in smg_tpu changes)."""
    if trunk == "densenet121":
        monkeypatch.setattr(jpre, "make_trunk", lambda kind, dt, name=None:
                            jdn.DenseNetTrunk(block_config=SHALLOW, dtype=dt, name=name))


def _configs(trunk):
    jcfg = jpre.PretrainConfig(model=JModelConfig(trunk=trunk, input_size=SIZE,
                                                  dtype="float32"), patch=16)
    pcfg = pretrain.PretrainConfig(model=ModelConfig(
        trunk=trunk, input_size=SIZE, dtype="float32", block_config=SHALLOW), patch=16)
    return jcfg, pcfg


def _inputs(seed):
    """Masked, normalised depth inputs, the target depth and the mask."""
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.0, 0.08, (BATCH, SIZE, SIZE)).astype(np.float32)
    hide = rng.rand(BATCH, SIZE // 16, SIZE // 16) < 0.5
    hidden = hide.repeat(16, axis=1).repeat(16, axis=2)
    x = (np.where(hidden, 0.0, depth) - aff.DEPTH_MEAN) / aff.DEPTH_STD
    return np.stack([x] * 3, axis=-1).astype(np.float32), depth, hidden


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_trees(got, want, what):
    for path, w in _leaves(want):
        err = _rel(_get(got, path), w)
        assert err <= TOL, f"{what} {'/'.join(path)}: rel err {err:.3e}"


def _grad_capture():
    """An optax transformation whose state is the gradient it saw (and
    whose updates are zero): JAX's pretrain_step hands it back."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _slots(model):
    """(Flax path, parameter, is_conv_kernel) of a ReconstructionModel."""
    yield from bridge.param_slots(model.trunk, ("trunk",))
    for name, child in model.named_children():
        if isinstance(child, torch.nn.Conv2d):
            yield (name, "kernel"), child.weight, True
            yield (name, "bias"), child.bias, False


def _port_grads(model) -> dict:
    return {path: bridge.to_flax(p.grad, conv) for path, p, conv in _slots(model)}


def _flax_model(monkeypatch, trunk, seed=0):
    _shallow(monkeypatch, trunk)
    jcfg, pcfg = _configs(trunk)
    jmodel = jpre.ReconstructionModel(jcfg)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, SIZE, SIZE, 3)), False))(
        jax.random.PRNGKey(seed))
    # Alive statistics, so the running-average update is not from 0 / 1.
    rng = np.random.RandomState(seed + 7)
    stats = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.uniform(0.5, 1.5, s.shape).astype(np.float32)),
        variables["batch_stats"])
    model = pretrain.ReconstructionModel(pcfg)
    bridge.load_reconstruction_params(model, jax.device_get(variables["params"]),
                                      jax.device_get(stats))
    return jmodel, variables["params"], stats, model


@pytest.mark.parametrize("trunk", TRUNKS)
def test_bn_train_forward(monkeypatch, trunk):
    """Train-mode trunk forward: features and the updated running statistics."""
    jmodel, params, stats, model = _flax_model(monkeypatch, trunk)
    inputs, _, _ = _inputs(1)
    jtrunk = (jdn.DenseNetTrunk(block_config=SHALLOW, dtype=jnp.float32)
              if trunk == "densenet121" else jdn.TinyTrunk(dtype=jnp.float32))
    want, mut = jax.jit(lambda v, x: jtrunk.apply(v, x, True, mutable=["batch_stats"]))(
        {"params": params["trunk"], "batch_stats": stats["trunk"]}, jnp.asarray(inputs))
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        jtrunk64 = (jdn.DenseNetTrunk(block_config=SHALLOW, dtype=jnp.float64)
                    if trunk == "densenet121" else jdn.TinyTrunk(dtype=jnp.float64))
        truth, _ = jax.jit(lambda v, x: jtrunk64.apply(v, x, True, mutable=["batch_stats"]))(
            {"params": f64(params["trunk"]), "batch_stats": f64(stats["trunk"])},
            jnp.asarray(inputs, jnp.float64))
        truth = np.asarray(truth)
    got = model.trunk(torch.as_tensor(inputs), train=True).detach().numpy()
    err_truth, jax_truth = _rel(got, truth), _rel(want, truth)
    assert err_truth <= TOL, f"features vs float64: rel err {err_truth:.3e}"
    err = _rel(got, want)
    assert err <= TOL + jax_truth, f"features vs JAX: {err:.3e} (JAX's own {jax_truth:.3e})"
    _, got_stats = bridge.dump_reconstruction_params(model)
    _assert_trees(got_stats["trunk"], jax.device_get(mut["batch_stats"]), "stats")
    # The running variance took the biased batch variance: a layer's
    # update read back from the port's own forward.
    bn = model.trunk.norm0
    x0 = torch.as_tensor(inputs).permute(0, 3, 1, 2)
    h = torch.nn.functional.conv2d(x0, model.trunk.conv0.weight, stride=2, padding=3) \
        if trunk == "densenet121" else \
        torch.nn.functional.conv2d(x0, model.trunk.conv0.weight, stride=2, padding=1)
    old = torch.as_tensor(np.array(stats["trunk"]["norm0"]["var"]))
    biased = h.detach().var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 * old + 0.1 * biased).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("trunk", TRUNKS)
def test_pretrain_step(monkeypatch, trunk):
    """One pretrain_step: the loss, the parameters after Adam, the stats."""
    jmodel, params, stats, model = _flax_model(monkeypatch, trunk)
    jcfg, _ = _configs(trunk)
    inputs, depth, hidden = _inputs(2)
    capture = _grad_capture()
    _, js, jgrads, jloss = jax.jit(
        lambda p, s, o, x, t, h: jpre.pretrain_step(jmodel, p, s, o, capture, x, t, h))(
            params, stats, capture.init(params), inputs, depth, hidden)
    # optax.adam's step on those gradients, as pretrain_step applies it.
    adam = optax.adam(jcfg.lr)
    updates, _ = adam.update(jgrads, adam.init(params), params)
    jp = optax.apply_updates(params, updates)
    fresh = copy.deepcopy(model)
    opt = pretrain.new_optimizer(model)
    loss = pretrain.pretrain_step(model, opt, torch.as_tensor(inputs),
                                  torch.as_tensor(depth), torch.as_tensor(hidden))
    err = _rel(float(loss), float(jloss))
    assert err <= TOL, f"loss {float(loss)} vs {float(jloss)}"
    _, got_s = bridge.dump_reconstruction_params(model)
    _assert_trees(got_s, jax.device_get(js), "stats")
    want_g = flat_tree(to_numpy_tree(jgrads))
    assert_grads(_port_grads(model), want_g)
    # Adam itself: the port's step on JAX's gradients against optax's.
    for path, p, conv in _slots(fresh):
        p.grad = bridge.from_flax(want_g[path], conv)
    pretrain.new_optimizer(fresh).step()
    got_p, _ = bridge.dump_reconstruction_params(fresh)
    _assert_trees(got_p, jax.device_get(jp), "params")


def test_load_pretrained_trunks_bitwise(monkeypatch):
    """The pretrained trunk lands in all three trunks, bit for bit as
    JAX's load_pretrained_trunks puts it; the heads stay."""
    from smg_tpu.train.trainer import TrainConfig, Trainer

    jmodel, params, stats, model = _flax_model(monkeypatch, "tiny", seed=3)
    mcfg = JModelConfig(method="reinforcement", trunk="tiny", input_size=SIZE)
    st = Trainer(TrainConfig(model=mcfg, method="reinforcement")).init_state(
        jax.random.PRNGKey(4))
    want_p, want_s = jpre.load_pretrained_trunks(
        st.params, st.batch_stats, {"params": params, "batch_stats": stats})

    net = aff.AffordanceNet(ModelConfig(method="reinforcement", trunk="tiny",
                                        input_size=SIZE))
    bridge.load_affordance_params(net, jax.device_get(st.params),
                                  jax.device_get(st.batch_stats))
    pretrain.load_pretrained_trunks(net, model.state_dict())
    got_p, got_s = bridge.dump_affordance_params(net)
    for tree_got, tree_want in ((got_p, want_p), (got_s, want_s)):
        for path, w in _leaves(jax.device_get(tree_want)):
            np.testing.assert_array_equal(_get(tree_got, path), w, err_msg="/".join(path))
    np.testing.assert_array_equal(got_p["grasp_trunk"]["conv0"]["kernel"],
                                  np.asarray(params["trunk"]["conv0"]["kernel"]))


def test_patch_mask():
    gen = torch.Generator().manual_seed(0)
    m = pretrain.random_patch_mask(gen, 224, 32, 0.5)
    assert m.shape == (224, 224) and m.dtype == torch.bool
    blocks = m.numpy().reshape(7, 32, 7, 32)
    assert (blocks.std(axis=(1, 3)) == 0).all()
    assert 0.2 < float(m.float().mean()) < 0.8
    mb = pretrain.random_patch_mask(gen, 224, 32, 0.5, batch=6)
    assert mb.shape == (6, 224, 224)
    assert (mb.numpy().reshape(6, 7, 32, 7, 32).std(axis=(2, 4)) == 0).all()
    assert 0.2 < float(mb.float().mean()) < 0.8


def test_make_batch_fn():
    """Spawned, settled, rendered scenes; the hidden pixels read as depth
    0 in the input, the visible ones as the target."""
    cfg = pretrain.PretrainConfig(model=ModelConfig(trunk="tiny", input_size=224))
    inp, depth, hidden = pretrain.make_batch_fn(cfg)(torch.Generator().manual_seed(1), 2)
    assert inp.shape == (2, 224, 224, 3) and depth.shape == hidden.shape == (2, 224, 224)
    assert bool(torch.isfinite(inp).all()) and float(depth.max()) > 0.005
    x = inp[..., 0] * aff.DEPTH_STD + aff.DEPTH_MEAN
    torch.testing.assert_close(x[hidden], torch.zeros_like(x[hidden]), atol=1e-6, rtol=0)
    torch.testing.assert_close(x[~hidden], depth[~hidden], atol=1e-6, rtol=0)
