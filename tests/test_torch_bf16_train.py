"""Parity of the port's training side in bf16 against the JAX package's:
the layers' rounding points, and the trunk pretrain
(tests/test_torch_bf16_update.py holds the update).

Both packages train in bf16 by default (ModelConfig.dtype). Each case runs
three computations on the same bridged weights and numpy-seeded inputs:
JAX in float32 (the anchor), JAX in bf16 and the port in bf16. JAX's
programs are compiled with xla_allow_excess_precision off
(test_torch_parity_helpers.AS_WRITTEN): by default XLA:CPU computes bf16
convolutions and dots in f32 and drops the rounding of their results to
bf16, so its bf16 result would skip roundings that the JAX program asks
for and the port performs (test_excess_precision_drops_roundings).

- Rounding points, one layer or one short path at a time: the pretrain's
  module DenseLayer and Transition (batch BN), a decoder layer, the
  DenseNet stem with norm5 and the whole tiny trunk; the update's dense
  layer under 'conv' and under 'pk' (whose plain K6 version the port's
  wrapper takes on the CPU), its stem with norm5, and its head at 4 x 4
  and 7 x 7. The forward output, the input gradient and every parameter
  gradient for a random cotangent. Rounding at the same points, the port
  and JAX's bf16 differ only by their f32 sums' orders: each item sits
  within ROUNDING_SHARE of JAX bf16's distance from float32 (relative L2).
  Misplaced roundings read 0.6-0.95 of it: BatchNorm moments rounded to
  bf16, an unrounded h2, a decoder bias added before the convolution's
  rounding (0.87), a transition's 2 x 2 pool summed in f32 (0.72).
- Five pretrain_steps on the same five batches (shallow DenseNet,
  block_config (2, 2, 2, 2), and the tiny trunk, at 64 pixels, Flax's
  init and alive running statistics), by the bf16 rule
  (test_torch_parity_helpers.assert_bf16_rule): every parameter and
  running statistic after the fifth step no farther from JAX float32 than
  max(2e-3, 1.5 x) JAX bf16's distance from it, and each step's loss
  within 1% of JAX bf16's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from smg_tpu.models import densenet as jdn
from smg_tpu.models import fast_trunk as jft
from smg_tpu.models.affordance import ModelConfig as JModelConfig
from smg_tpu.train import pretrain as jpre
from smg_tpu_torch import bridge
from smg_tpu_torch.models import affordance as aff
from smg_tpu_torch.models import densenet as tdn
from smg_tpu_torch.models import fast_trunk as pft
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.ops import dense_layer_train as k6
from smg_tpu_torch.train import pretrain

from test_torch_parity_helpers import (
    AS_WRITTEN,
    alive_stats,
    assert_bf16_loss,
    assert_bf16_rule,
    compile_as_written,
    flat_tree,
    bn_np,
    flax_block,
    rel_l2,
    to_numpy_tree,
)

torch.set_num_threads(1)

SIZE = 64
SHALLOW = (2, 2, 2, 2)
PRE_BATCH = 3
PRE_STEPS = 5
# Adam's epsilon in the pretrain comparison. At optax's 1e-8 the first
# step moves each parameter by lr x the sign of its gradient, and several
# leaves (the stem BatchNorm's scale, whose exact gradient is zero; decoder
# biases of near-dead channels) have gradients that are rounding noise:
# their signs, and so the parameters after five steps, are a coin toss in
# every bf16 computation. 1e-3, as tests/test_torch_parallel.py uses,
# scales such a step by its gradient's size.
PRE_ADAM_EPS = 1e-3
ROUNDING_SHARE = 0.25
DTYPES = ("float32", "bfloat16")


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def test_excess_precision_drops_roundings():
    """The reason for AS_WRITTEN: the gradient of a bf16 convolution keeps
    two more bf16 roundings (the convolution's result, the weight
    gradient) when XLA:CPU may not use excess precision."""
    def loss(x, w):
        y = jax.lax.conv_general_dilated(
            x.astype(jnp.bfloat16), w.astype(jnp.bfloat16), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return (y.astype(jnp.float32) ** 2).mean()

    lowered = jax.jit(jax.grad(loss, argnums=1)).lower(jnp.ones((1, 8, 8, 4)),
                                                      jnp.ones((3, 3, 4, 4)))

    def bf16_converts(options):
        text = lowered.compile(compiler_options=options).as_text()
        return sum(" = bf16[" in line and " convert(" in line for line in text.splitlines())

    assert bf16_converts(AS_WRITTEN) == bf16_converts(None) + 2


# ---------------------------------------------------------------------------
# Rounding points, layer by layer
# ---------------------------------------------------------------------------

def _jax_vjp(f, params, x, g):
    """{("out",): f(params, x), ("dx",): its input gradient, ("d", ...):
    its parameter gradients} for the cotangent g, as written."""
    def vj(p, x, g):
        y, back = jax.vjp(f, p, x)
        dp, dx = back(g.astype(y.dtype))
        return y, dp, dx

    y, dp, dx = compile_as_written(vj, params, x, g)(params, x, g)
    out = {("out",): y, ("dx",): dx}
    out.update({("d",) + k: v for k, v in flat_tree(to_numpy_tree(dp)).items()})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _port_vjp(module, fn, x, g):
    """The port's side of _jax_vjp: fn(module, x) on bf16 x, backward g."""
    xt = torch.as_tensor(x).to(torch.bfloat16).requires_grad_(True)
    y = fn(module, xt)
    y.backward(torch.as_tensor(g).to(y.dtype))
    out = {("out",): y.detach().float().numpy(), ("dx",): xt.grad.float().numpy()}
    for path, p, conv in bridge.param_slots(module, ("d",)):
        out[path] = bridge.to_flax(p.grad, conv)
    for name, child in module.named_children():
        if isinstance(child, torch.nn.Conv2d) and child.bias is not None:
            out[("d", name, "bias")] = child.bias.grad.numpy()
    return out


def _layer(rng, c):
    """Flax params / stats of one dense layer on c channels, alive."""
    bp, bs = flax_block(rng, c, 1)
    return bp["denselayer1"], bs["denselayer1"]


def _stage_dense_module(rng):
    """The pretrain's module forward (densenet.py's DenseLayer, batch BN)."""
    p, s = _layer(rng, 96)
    x = np.maximum(rng.randn(3, 16, 16, 96), 0).astype(np.float32)

    def jax_fn(dt):
        layer = jdn.DenseLayer(32, 4, _jdt(dt))
        return lambda p, x: layer.apply({"params": p, "batch_stats": s}, x.astype(_jdt(dt)),
                                        True, mutable=["batch_stats"])[0][..., 96:]

    module = tdn.DenseLayer(96)
    bridge.load_module(module, p, s)
    port_fn = lambda m, x: m(x.permute(0, 3, 1, 2), True)[:, 96:].permute(0, 2, 3, 1)  # noqa: E731
    return jax_fn, module, port_fn, p, x


def _stage_dense_fast(conv2):
    """The update's dense layer (fast_trunk, per-image BN) under conv2."""
    def stage(rng):
        p, s = _layer(rng, 96)
        x = np.maximum(rng.randn(3, 16, 16, 96), 0).astype(np.float32)

        def jax_fn(dt):
            mode = conv2 if dt == "bfloat16" else "conv"
            return lambda p, x: jax.vmap(lambda x1: jft._dense_layer_train(
                p, s, [x1[None].astype(_jdt(dt))], _jdt(dt), mode)[0][0])(x)

        module = tdn.DenseLayer(96)
        bridge.load_module(module, p, s)
        if conv2 == "conv":
            port_fn = lambda m, x: pft._dense_layer_conv(x, m, [])  # noqa: E731
        else:
            def port_fn(m, x):
                ops = [(m.conv1.weight.reshape(128, -1).t(), m.norm1.weight, m.norm1.bias,
                        m.conv2.weight.permute(2, 3, 1, 0).reshape(9, 128, -1),
                        m.norm2.weight, m.norm2.bias)]
                return k6.dense_block_train(x, ops)[0][..., 96:]
        return jax_fn, module, port_fn, p, x
    return stage


def _stage_head(fh):
    """The update's head (fast_trunk.head_train, per-image BN) on a shallow
    trunk's 256-channel pair features, fh x fh (4 at a 128-pixel input, 7
    at 224). Not 2 x 2, a 64-pixel input's: per-image moments of four
    values put some channels' variance within f32 cancellation of zero,
    and the two sides' sum orders then part in the input gradient."""
    def stage(rng):
        c = 256
        p, s = {}, {}
        p["norm0"], s["norm0"] = bn_np(rng, c)
        p["norm1"], s["norm1"] = bn_np(rng, 64)
        p["conv0"] = {"kernel": (rng.randn(1, 1, c, 64) * (2 / c) ** 0.5).astype(np.float32)}
        p["conv1"] = {"kernel": (rng.randn(fh, fh, 64, 1) * (2 / (64 * fh * fh)) ** 0.5)
                      .astype(np.float32)}
        # The trunks' features: norm5's affine output, no ReLU.
        x = rng.randn(3, fh, fh, c).astype(np.float32)

        def jax_fn(dt):
            return lambda p, x: jax.vmap(lambda x1: jft.head_train(
                p, s, x1[None].astype(_jdt(dt)), 1, _jdt(dt))[0][0])(x)

        module = aff.AffordanceHead(c, 1, fh)
        bridge.load_module(module, p, s)
        return jax_fn, module, lambda m, x: pft.head_train(m, x, 1)[0], p, x
    return stage


def _stage_decoder(rng):
    """One layer of the pretrain's decoder: x2 nearest, 3x3 conv with a
    bias, ReLU (pretrain.py's ReconstructionModel)."""
    c_in, c_out = 64, 32
    p = {"dec": {"kernel": (rng.randn(3, 3, c_in, c_out) / np.sqrt(9 * c_in)).astype(np.float32),
                 "bias": (rng.randn(c_out) * 0.1).astype(np.float32)}}
    x = rng.randn(3, 8, 8, c_in).astype(np.float32)

    def jax_fn(dt):
        conv = nn.Conv(c_out, (3, 3), padding=1, dtype=_jdt(dt))

        def f(p, x):
            h = x.astype(_jdt(dt))
            B, H, W, C = h.shape
            h = jax.image.resize(h, (B, H * 2, W * 2, C), "nearest")
            return nn.relu(conv.apply({"params": p["dec"]}, h))
        return f

    module = torch.nn.Module()
    module.dec = torch.nn.Conv2d(c_in, c_out, 3, padding=1)
    with torch.no_grad():
        module.dec.weight.copy_(bridge.from_flax(p["dec"]["kernel"], True))
        module.dec.bias.copy_(torch.as_tensor(p["dec"]["bias"]))

    def port_fn(m, x):
        h = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return torch.relu(pretrain.conv_bias(h, m.dec, x.dtype, padding=1)).permute(0, 2, 3, 1)
    return jax_fn, module, port_fn, p, x


def _stage_transition_module(rng):
    """The pretrain's module Transition (batch BN, ReLU, 1x1, 2x2 mean)."""
    c = 128
    np_, ns = bn_np(rng, c)
    p = {"norm": np_, "conv": {"kernel": (rng.randn(1, 1, c, c // 2) * (2 / c) ** 0.5)
                               .astype(np.float32)}}
    s = {"norm": ns}
    x = np.maximum(rng.randn(3, 16, 16, c), 0).astype(np.float32)

    def jax_fn(dt):
        tr = jdn.Transition(c // 2, _jdt(dt))
        return lambda p, x: tr.apply({"params": p, "batch_stats": s}, x.astype(_jdt(dt)),
                                     True, mutable=["batch_stats"])[0]

    module = tdn.Transition(c, c // 2)
    bridge.load_module(module, p, s)
    port_fn = lambda m, x: m(x.permute(0, 3, 1, 2), True).permute(0, 2, 3, 1)  # noqa: E731
    return jax_fn, module, port_fn, p, x


def _trunk_params(kind, seed):
    """Flax's init of a stem-only DenseNet (block_config ()) or the tiny
    trunk, with alive running statistics."""
    jt = (jdn.DenseNetTrunk(block_config=(), dtype=jnp.float32) if kind == "densenet121"
          else jdn.TinyTrunk(dtype=jnp.float32))
    v = jax.jit(lambda k: jt.init(k, jnp.zeros((1, SIZE, SIZE, 3)), False))(
        jax.random.PRNGKey(seed))
    return to_numpy_tree(v["params"]), to_numpy_tree(alive_stats(v["batch_stats"], seed + 1))


def _stage_trunk_module(kind):
    """A trunk's module forward with batch BN, as the pretrain runs it:
    the DenseNet's stem (conv0, norm0, ReLU, max pool) and norm5, or the
    whole tiny trunk."""
    def stage(rng):
        p, s = _trunk_params(kind, 2)
        x = rng.randn(3, SIZE, SIZE, 3).astype(np.float32)

        def jax_fn(dt):
            t = (jdn.DenseNetTrunk(block_config=(), dtype=_jdt(dt)) if kind == "densenet121"
                 else jdn.TinyTrunk(dtype=_jdt(dt)))
            return lambda p, x: t.apply({"params": p, "batch_stats": s}, x, True,
                                        mutable=["batch_stats"])[0]

        module = tdn.make_trunk(kind, torch.bfloat16, ())
        bridge.load_module(module, p, s)
        return jax_fn, module, lambda m, x: m(x.float(), True), p, x
    return stage


def _stage_stem_fast(rng):
    """The update's stem (fast_trunk.trunk_features_train: the gray-tap
    conv0, per-image BN, ReLU, max pool) and norm5, one image per call."""
    p, s = _trunk_params("densenet121", 4)
    x = np.repeat(rng.randn(3, SIZE, SIZE, 1), 3, axis=-1).astype(np.float32)

    def jax_fn(dt):
        def f(p, x):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jft, "BLOCK_CONFIG", ())
                return jax.vmap(lambda x1: jft.trunk_features_train(
                    p, s, x1[None], _jdt(dt), "conv")[0][0])(x)
        return f

    module = tdn.make_trunk("densenet121", torch.bfloat16, ())
    bridge.load_module(module, p, s)
    return jax_fn, module, lambda m, x: pft.trunk_features_train(m, x.float())[0], p, x


STAGES = {"dense_layer_module": _stage_dense_module,
          "dense_layer_conv": _stage_dense_fast("conv"),
          "dense_layer_pk": _stage_dense_fast("pk"),
          "head4": _stage_head(4),
          "head7": _stage_head(7),
          "decoder": _stage_decoder,
          "transition_module": _stage_transition_module,
          "stem_module": _stage_trunk_module("densenet121"),
          "stem_fast": _stage_stem_fast,
          "tiny_module": _stage_trunk_module("tiny")}

# Items whose exact value is a cancellation: the stem's norm0 gradients.
# Past the stem every consumer normalises its channels (norm5 here), so the
# loss is blind to norm0's scale (ReLU and max pool commute with it) and
# sees its bias only through the pooled windows that ReLU zeroes; each bf16
# computation's own rounding sets most of what is left. They are held to
# the whole steps' rule instead: the port no farther from JAX bf16 than
# WITNESS_SHARE x JAX bf16's distance from float32.
CANCELLING = {"stem_module": "norm0", "stem_fast": "norm0"}
WITNESS_SHARE = 1.5


def _bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16), np.float32)


def _bias_sum(y, g):
    """A conv bias's gradient at JAX's rounding points with its sum rounded
    once: the bf16 cotangent of y = relu(conv + bias) (JAX's relu passes
    it where y > 0), summed over batch and pixels in float64, rounded to
    bf16. XLA:CPU rounds every partial sum of that reduction to bf16
    instead (test_bias_gradient_reduction)."""
    dy = np.where(y > 0, _bf16(g), 0.0)
    return _bf16(dy.astype(np.float64).sum(axis=(0, 1, 2)))


@pytest.mark.parametrize("stage", STAGES)
def test_rounding_points(stage):
    """One layer's bf16 forward and backward, the port against JAX's bf16
    directly: rounding at the same points, they differ by their f32 sums'
    orders only, far less than bf16 differs from float32."""
    rng = np.random.RandomState(5)
    jax_fn, module, port_fn, p, x = STAGES[stage](rng)
    y32 = jax_fn("float32")(p, x)
    g = rng.randn(*y32.shape).astype(np.float32)
    f32, jbf = (_jax_vjp(jax_fn(dt), p, x, g) for dt in DTYPES)
    got = _port_vjp(module, port_fn, x, g)
    if stage == "decoder":
        k = ("d", "dec", "bias")
        ref = _bias_sum(jbf[("out",)], g)
        print(f"decoder: XLA:CPU's bias gradient {rel_l2(jbf[k], ref, 1e-30):.3e} from its "
              f"cotangent's sum rounded once, the port's {rel_l2(got[k], ref, 1e-30):.3e}")
        jbf[k] = ref
    for k in f32:
        share = rel_l2(got[k], jbf[k], 1e-30) / max(rel_l2(jbf[k], f32[k], 1e-30), 1e-6)
        bound = WITNESS_SHARE if CANCELLING.get(stage) in k else ROUNDING_SHARE
        print(f"{stage} {'/'.join(k)}: port-JAX bf16 at {share:.4f} of JAX bf16-float32")
        assert share <= bound, (stage, k, share)


def test_bias_gradient_reduction():
    """Why the decoder's bias gradient is held to _bias_sum: XLA:CPU rounds
    each partial sum of a bf16 reduction to bf16, with or without excess
    precision, so over 3072 terms JAX's bias gradient sits far from the
    exact sum of its own bf16 cotangent; the port's (PyTorch sums bf16 in
    f32) sits one rounding from it."""
    g = np.random.RandomState(0).randn(3, 32, 32, 8).astype(np.float32)
    exact = _bf16(g).astype(np.float64).sum(axis=(0, 1, 2))

    def jax_db(g):
        add = lambda b: jnp.zeros(g.shape, jnp.bfloat16) + b.astype(jnp.bfloat16)  # noqa: E731
        return jax.vjp(add, jnp.zeros(8))[1](g.astype(jnp.bfloat16))[0]

    b = torch.zeros(8, requires_grad=True)
    (torch.zeros(g.shape, dtype=torch.bfloat16) + b.to(torch.bfloat16)).backward(
        torch.as_tensor(g).to(torch.bfloat16))
    once = rel_l2(_bf16(exact), exact, 1e-30)
    for options in (None, AS_WRITTEN):
        db = jax.jit(jax_db).lower(g).compile(compiler_options=options)(g)
        assert rel_l2(db, exact, 1e-30) > 10 * once, options
    assert rel_l2(b.grad.numpy(), exact, 1e-30) <= once * (1 + 1e-6)


# ---------------------------------------------------------------------------
# Pretrain
# ---------------------------------------------------------------------------

def pretrain_configs(trunk, dtype):
    return (jpre.PretrainConfig(model=JModelConfig(trunk=trunk, input_size=SIZE, dtype=dtype),
                                patch=16),
            pretrain.PretrainConfig(model=ModelConfig(trunk=trunk, input_size=SIZE, dtype=dtype,
                                                      block_config=SHALLOW), patch=16))


def _pre_batch(seed):
    """Masked, normalised depth inputs, the target depth and the mask."""
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.0, 0.08, (PRE_BATCH, SIZE, SIZE)).astype(np.float32)
    hide = rng.rand(PRE_BATCH, SIZE // 16, SIZE // 16) < 0.5
    hidden = hide.repeat(16, axis=1).repeat(16, axis=2)
    x = (np.where(hidden, 0.0, depth) - aff.DEPTH_MEAN) / aff.DEPTH_STD
    return np.stack([x] * 3, axis=-1).astype(np.float32), depth, hidden


def _jax_pretrain(trunk, dtype, params, stats, batches):
    """PRE_STEPS JAX pretrain_steps on batches: (params, stats, losses)."""
    jcfg, _ = pretrain_configs(trunk, dtype)
    model = jpre.ReconstructionModel(jcfg)
    tx = optax.adam(jcfg.lr, eps=PRE_ADAM_EPS)
    opt, losses = tx.init(params), []
    step = compile_as_written(lambda p, s, o, x, t, h: jpre.pretrain_step(model, p, s, o, tx, x, t, h),
                    params, stats, opt, *batches[0])
    for x, t, h in batches:
        params, stats, opt, loss = step(params, stats, opt, x, t, h)
        losses.append(float(loss))
    return params, stats, losses


def pretrain_batches():
    return [_pre_batch(10 + i) for i in range(PRE_STEPS)]


def jax_pretrain_runs(trunk, dtypes=DTYPES):
    """(initial params, stats, {dtype: JAX result}) of PRE_STEPS JAX
    pretrain_steps on pretrain_batches(), from Flax's init and alive
    running statistics; a shallow DenseNet through a test-local patch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpre, "make_trunk", lambda kind, dt, name=None: (
            jdn.DenseNetTrunk(block_config=SHALLOW, dtype=dt, name=name)
            if kind == "densenet121" else jdn.make_trunk(kind, dt, name=name)))
        seed = ("densenet121", "tiny").index(trunk)
        jcfg, _ = pretrain_configs(trunk, "float32")
        variables = jax.jit(lambda k: jpre.ReconstructionModel(jcfg).init(
            k, jnp.zeros((1, SIZE, SIZE, 3)), False))(jax.random.PRNGKey(seed))
        params, stats = variables["params"], alive_stats(variables["batch_stats"], seed + 7)
        batches = pretrain_batches()
        return params, stats, {dt: _jax_pretrain(trunk, dt, params, stats, batches)
                               for dt in dtypes}


@pytest.mark.parametrize("trunk", ("densenet121", "tiny"))
def test_pretrain_bf16(trunk):
    params, stats, jax_runs = jax_pretrain_runs(trunk)
    batches = pretrain_batches()
    _, pcfg = pretrain_configs(trunk, "bfloat16")
    model = pretrain.ReconstructionModel(pcfg)
    bridge.load_reconstruction_params(model, jax.device_get(params), jax.device_get(stats))
    opt = torch.optim.Adam(model.parameters(), lr=pcfg.lr, eps=PRE_ADAM_EPS)
    losses = [float(pretrain.pretrain_step(model, opt, *map(torch.as_tensor, b)))
              for b in batches]
    f = lambda t: flat_tree(to_numpy_tree(t))  # noqa: E731
    f32_p, f32_s, f32_l = jax_runs["float32"]
    bf_p, bf_s, bf_l = jax_runs["bfloat16"]
    print(f"{trunk} losses: port bf16 {losses}, JAX bf16 {bf_l}, JAX f32 {f32_l}")
    for i, (got, want) in enumerate(zip(losses, bf_l)):
        assert_bf16_loss(got, [want], f"{trunk} step {i + 1}")
    got_p, got_s = bridge.dump_reconstruction_params(model)
    assert_bf16_rule(flat_tree(got_p), [f(bf_p)], f(f32_p), f"{trunk} params after {PRE_STEPS} steps")
    assert_bf16_rule(flat_tree(got_s), [f(bf_s)], f(f32_s), f"{trunk} stats after {PRE_STEPS} steps")
