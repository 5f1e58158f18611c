"""Parity of the port's bf16 update against the JAX package's: one
Trainer.update, B = 4 (styles 0, 1, 2 and an invalid scene), shallow
trunks (block_config (2, 2, 2, 2)) at SIZE = 128 pixels, in bf16 as both
packages train by default.

Three JAX computations on the same bridged weights and numpy-seeded
inputs, each compiled as written (test_torch_parity_helpers.AS_WRITTEN):
float32 with fast_train 'conv' (the anchor; the JAX package pins its f32
forms equal), bf16 'conv', and bf16 'vjp' (the jnp twin of 'pk' that the
JAX package pins equal to it in f32, and that compiles faster than 'pk' in
interpret mode). The port's bf16 'conv' is held to JAX's bf16 'conv', its
'pk' (the plain K6 version on the CPU) to JAX's 'vjp', by the bf16 rule
(test_torch_parity_helpers.assert_bf16_rule: each gradient leaf, JAX's
from grad_capture, and each updated running statistic no farther from
float32 than max(2e-3, 1.5 x) JAX bf16's distance) and the loss within 1%
of JAX bf16's.

128 pixels, not 64: the head's per-image BatchNorm over a 64-pixel
input's 2 x 2 feature maps takes moments of four values, whose backward
(E[x^2] - E[x]^2) amplifies f32 sum orders (the reason
test_torch_bf16_train.py's head stages use 4 x 4 and 7 x 7), and all six
trunks' gradients pass through it. At 64 pixels JAX's own bf16 'vjp' and
'conv' put 2-101 of 198 gradient leaves over 1.5 x each other's distance
from float32; at 128, none.

- cold: Flax's default init (the port's init_params) and alive running
  statistics.
- warm: the same after the trunks are loaded from the bf16 pretrain of
  test_torch_bf16_train.py (its JAX checkpoint): JAX through
  pretrain.load_pretrained_trunks, the port through
  bridge.load_reconstruction_params and its own load_pretrained_trunks,
  which must land the same weights bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.models.affordance import ModelConfig as JModelConfig
from smg_tpu.train import pretrain as jpre
from smg_tpu.train import trainer as jtr
from smg_tpu_torch import bridge
from smg_tpu_torch.models import affordance as aff
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.train import pretrain
from smg_tpu_torch.train.trainer import Experience, TrainConfig, Trainer, TrainerState

from test_torch_bf16_train import SHALLOW, jax_pretrain_runs, pretrain_configs
from test_torch_parity_helpers import (
    AS_WRITTEN,
    alive_stats,
    assert_bf16_loss,
    assert_bf16_rule,
    flat_tree,
    grad_capture,
    jax_trainer_state,
    port_grads,
    shallow_train_patch,
    shallow_train_patch_bf16,
    to_numpy_tree,
    to_port as _t,
)

torch.set_num_threads(1)

SIZE = 128
B = 4
JAX_BF16_FORMS = ("conv", "vjp")


def _jax_trainer(dtype, conv2):
    jt = jtr.Trainer(jtr.TrainConfig(
        model=JModelConfig(method="reinforcement", input_size=SIZE, dtype=dtype),
        method="reinforcement", scene_chunk=B, fast_train="on",
        fast_train_conv2=conv2, unroll_styles="off"))
    jt.tx = grad_capture()
    return jt


def _port_trainer(conv2):
    return Trainer(TrainConfig(
        model=ModelConfig(method="reinforcement", input_size=SIZE, dtype="bfloat16",
                          block_config=SHALLOW),
        method="reinforcement", scene_chunk=B, fast_train_conv2=conv2), device="cpu")


def _experience():
    rng = np.random.RandomState(3)
    depth = (rng.rand(B, SIZE, SIZE) * 0.06).astype(np.float32)
    mask = np.zeros((B, SIZE, SIZE), bool)
    for b in range(B):
        y, x = rng.randint(SIZE // 16, SIZE // 2, 2)
        mask[b, y:y + SIZE // 3, x:x + SIZE * 3 // 8] = True
    style = np.array([0, 1, 2, 1], np.int32)
    valid = np.array([True, True, True, False])
    labels = rng.uniform(-0.5, 2.5, B).astype(np.float32)
    return depth, mask, style, valid, labels


def _cold_start():
    """The port's init_params (Flax's default init) and alive running
    statistics, as Flax trees of numpy."""
    net = aff.AffordanceNet(ModelConfig(method="reinforcement", input_size=SIZE,
                                        dtype="bfloat16", block_config=SHALLOW))
    aff.init_params(net, torch.Generator().manual_seed(0))
    params, stats = bridge.dump_affordance_params(net)
    return params, to_numpy_tree(alive_stats(stats, 11))


@pytest.fixture(scope="module")
def updates():
    """{(dtype, conv2): (JAX trainer, its compiled update)}: float32
    'conv' and the bf16 forms. score_train reads its dtype at trace time,
    so the float32 program is traced under shallow_train_patch's pin and
    the bf16 ones without it."""
    depth, mask, style, valid, labels = _experience()
    exp = jtr.Experience(scene_depth=jnp.asarray(depth), exec_mask=jnp.asarray(mask),
                         style=jnp.asarray(style), valid=jnp.asarray(valid))
    labels = jnp.asarray(labels)
    params, stats = _cold_start()
    keys = [("float32", "conv")] + [("bfloat16", c) for c in JAX_BF16_FORMS]
    trainers, lowered = [], []
    for dtype, conv2 in keys:
        mp = pytest.MonkeyPatch()
        (shallow_train_patch if dtype == "float32" else shallow_train_patch_bf16)(mp)
        jt = _jax_trainer(dtype, conv2)
        lowered.append(jax.jit(lambda st, jt=jt: jt.update(st, exp, labels)).lower(
            jax_trainer_state(jt, params, stats)))
        mp.undo()
        trainers.append(jt)
    # XLA compiles outside the interpreter lock: the three side by side.
    with ThreadPoolExecutor(len(keys)) as pool:
        compiled = list(pool.map(lambda lo: lo.compile(compiler_options=AS_WRITTEN), lowered))
    return dict(zip(keys, zip(trainers, compiled)))


def _run_jax(updates, key, params, stats):
    jt, fn = updates[key]
    new, loss = fn(jax_trainer_state(jt, params, stats))
    return (float(loss), flat_tree(to_numpy_tree(new.opt_state)),
            flat_tree(to_numpy_tree(new.batch_stats)))


@pytest.fixture(scope="module")
def checkpoint():
    """The bf16 DenseNet pretrain's JAX result, as a Flax checkpoint."""
    _, _, runs = jax_pretrain_runs("densenet121", ("bfloat16",))
    ck_p, ck_s, _ = runs["bfloat16"]
    return {"params": ck_p, "batch_stats": ck_s}


def _start(warm: bool, ckpt):
    """(params, stats) as Flax trees: the cold start, and for warm its
    trunks replaced by the checkpoint's, as JAX loads them."""
    params, stats = _cold_start()
    if not warm:
        return params, stats
    jp, js = jpre.load_pretrained_trunks(params, stats, ckpt)
    return to_numpy_tree(jp), to_numpy_tree(js)


@pytest.mark.parametrize("conv2", ("conv", "pk"))
@pytest.mark.parametrize("warm", (False, True), ids=("cold", "warm"))
def test_update_bf16(checkpoint, updates, warm, conv2):
    params, stats = _start(warm, checkpoint)
    f32_l, f32_g, f32_s = _run_jax(updates, ("float32", "conv"), params, stats)
    forms = [_run_jax(updates, ("bfloat16", c), params, stats) for c in JAX_BF16_FORMS]

    pt = _port_trainer(conv2)
    if warm:
        # The port's own route for a checkpoint: the cold start, then the
        # reconstruction model's state_dict into the three trunks.
        cold_p, cold_s = _cold_start()
        for net in (pt.model, pt.target):
            bridge.load_affordance_params(net, cold_p, cold_s)
        rec = pretrain.ReconstructionModel(pretrain_configs("densenet121", "bfloat16")[1])
        bridge.load_reconstruction_params(rec, to_numpy_tree(checkpoint["params"]),
                                          to_numpy_tree(checkpoint["batch_stats"]))
        for net in (pt.model, pt.target):
            pretrain.load_pretrained_trunks(net, rec.state_dict())
        got_p = flat_tree(bridge.dump_affordance_params(pt.model)[0])
        for k, v in flat_tree(params).items():
            np.testing.assert_array_equal(got_p[k], v, err_msg="/".join(k))
    else:
        for net in (pt.model, pt.target):
            bridge.load_affordance_params(net, params, stats)
    pt.opt = pt.new_optimizer()
    depth, mask, style, valid, labels = _experience()
    _, loss = pt.update(TrainerState(0), Experience(
        scene_depth=_t(depth), exec_mask=_t(mask), style=_t(style), valid=_t(valid)),
        _t(labels))
    what = f"update {'warm' if warm else 'cold'} {conv2}"
    print(f"{what}: loss port bf16 {float(loss)}, JAX bf16 {[f[0] for f in forms]}, "
          f"JAX f32 {f32_l}")
    assert_bf16_loss(float(loss), [f[0] for f in forms], what)
    got_g = port_grads(pt.model)
    # Parts the update does not reach (a tied gs_head) have zero gradients
    # on every side.
    live = {k for k, v in f32_g.items() if np.abs(v).any()}
    sub = lambda d: {k: d[k] for k in live}  # noqa: E731
    assert_bf16_rule(sub(got_g), [sub(f[1]) for f in forms], sub(f32_g), f"{what} gradients")
    got_s = flat_tree(bridge.dump_affordance_params(pt.model)[1])
    assert_bf16_rule(got_s, [f[2] for f in forms], f32_s, f"{what} stats")
