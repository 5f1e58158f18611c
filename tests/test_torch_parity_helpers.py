"""Helpers for the port's parity tests (tests/test_torch_*.py); it holds
no tests of its own.

Inputs are made from a numpy seed and handed to both sides as numpy: the
JAX function on one side, its port in smg_tpu_torch on the other. JAX
pytrees (flax struct dataclasses) become nested dicts of numpy arrays,
which is what smg_tpu_torch.bridge takes.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch


def to_numpy_tree(x):
    """A JAX value / dataclass pytree / dict -> nested dicts of numpy."""
    x = jax.device_get(x)
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: to_numpy_tree(v) for k, v in x.items()}
    return np.asarray(x)


def torch_tree_to_numpy(x):
    """A port dataclass of tensors -> nested dicts of numpy."""
    if dataclasses.is_dataclass(x):
        return {f.name: torch_tree_to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_both(jax_fn, torch_fn, *inputs):
    """Run jax_fn and torch_fn on the same numpy inputs; both as numpy."""
    j = jax_fn(*[jax.numpy.asarray(a) for a in inputs])
    t = torch_fn(*[torch.as_tensor(np.asarray(a)) for a in inputs])
    return to_numpy_tree(j), torch_tree_to_numpy(t)


def jax_scenes(B: int, seed: int = 0, settle_steps: int = 20, **kw):
    """B settled JAX scenes (vmap of reset_scene) as a numpy tree."""
    from smg_tpu.physics import scene as sc

    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    batch = jax.jit(jax.vmap(
        lambda k: sc.reset_scene(k, settle_steps=settle_steps, **kw)))(keys)
    return batch, to_numpy_tree(batch)


def rand_stats(tree, seed):
    """BN statistics that keep the relu chain alive at depth
    (tests/test_fast_trunk.py:20-41), from a numpy seed."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)

    def rand(path, leaf):
        name = path[-1].key
        lo, hi = {"mean": (-0.1, 0.1), "var": (0.5, 1.5),
                  "scale": (0.5, 1.5)}.get(name, (0.05, 0.4))
        return jnp.asarray(rng.uniform(lo, hi, leaf.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(rand, tree)


def init_flax_all(model, c_final: int, fhw: int, seed: int):
    """Flax AffordanceNet variables for any trunk depth: init_all sizes
    the heads for 1024-channel trunks, so run every style's score (and
    the otherwise unused gs_head) on probe inputs instead."""
    import jax.numpy as jnp

    S = 32 * fhw
    probe = jnp.zeros((1, S, S, 3), jnp.float32)

    def all_styles(m):
        for s in range(3):
            m.score(probe, probe[:, None], s, False)
        m.gs_head(jnp.zeros((1, fhw, fhw, 2 * c_final), m.cfg.jdtype), False)

    return jax.jit(lambda k: model.init(k, method=all_styles))(
        jax.random.PRNGKey(seed))


def shallow_trunk_patch(monkeypatch, block_config, jdt):
    """Make the Flax AffordanceNet build DenseNet trunks of block_config
    (a test-local monkeypatch; nothing in smg_tpu changes)."""
    from smg_tpu.models import affordance as jaff
    from smg_tpu.models import densenet as jdn

    monkeypatch.setattr(
        jaff, "make_trunk",
        lambda kind, dt=jdt, name=None: jdn.DenseNetTrunk(
            block_config=block_config, dtype=dt, name=name))


# ---------------------------------------------------------------------------
# The eval kernels' parity tests (test_torch_{trunk,conv2,dense_block,
# trunk_backends}.py)
# ---------------------------------------------------------------------------

# A kernel's plain version against the Pallas kernel in interpret mode:
# max |err| <= 2^-6 of the largest |value|. Both sides round to bf16 at the
# same points; their f32 sums run in other orders, so an element may land
# one bf16 step (2^-8 relative) apart, which a downstream rounding can
# double; XLA on the CPU may also keep excess precision between fused bf16
# operations (xla_allow_excess_precision), e.g. across K7's bf16 pool adds.
KERNEL_TOL = 2.0 ** -6


def bn_np(rng, c):
    """Flax BatchNorm params and alive statistics of c channels."""
    p = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.uniform(0.05, 0.4, c)}
    s = {"mean": rng.uniform(-0.1, 0.1, c), "var": rng.uniform(0.5, 1.5, c)}
    f = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    return f(p), f(s)


def fold_np(p, s):
    """Eval BatchNorm folded to the f32 affine (a, b) the kernels take."""
    a = p["scale"] / np.sqrt(s["var"] + 1e-5)
    return (torch.as_tensor(a.astype(np.float32)),
            torch.as_tensor((p["bias"] - s["mean"] * a).astype(np.float32)))


def bf16_np(x):
    """x rounded to bf16, as float32 numpy."""
    import jax.numpy as jnp

    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def assert_kernel_close(got, want, name, tol=KERNEL_TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 1e-3, f"{name}: degenerate case"
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{name}: max err {err:.5f} of scale {scale:.3f}"


def flax_block(rng, C0, L):
    """Flax params / stats of a DenseBlock of L layers on C0 channels."""
    bp, bs = {}, {}
    for i in range(L):
        c = C0 + 32 * i
        n1p, n1s = bn_np(rng, c)
        n2p, n2s = bn_np(rng, 128)
        bp[f"denselayer{i + 1}"] = {
            "norm1": n1p, "norm2": n2p,
            "conv1": {"kernel": (rng.randn(1, 1, c, 128) * (2 / c) ** 0.5)
                      .astype(np.float32)},
            "conv2": {"kernel": (rng.randn(3, 3, 128, 32) * (2 / 1152) ** 0.5)
                      .astype(np.float32)},
        }
        bs[f"denselayer{i + 1}"] = {"norm1": n1s, "norm2": n2s}
    return bp, bs


def block_layers(bp, bs, dtype=torch.bfloat16):
    """The port's per-layer kernel operands (c_in, a1, b1, w1 (c_in, 128),
    a2, b2, w2 (9, 128, 32)) of a flax_block, weights in dtype."""
    layers = []
    for i in range(len(bp)):
        n = f"denselayer{i + 1}"
        p, s = bp[n], bs[n]
        c_in = p["conv1"]["kernel"].shape[2]
        a1, b1 = fold_np(p["norm1"], s["norm1"])
        a2, b2 = fold_np(p["norm2"], s["norm2"])
        w1 = torch.as_tensor(p["conv1"]["kernel"].reshape(c_in, 128)).to(dtype)
        w2 = torch.as_tensor(p["conv2"]["kernel"].reshape(9, 128, 32)).to(dtype)
        layers.append((c_in, a1, b1, w1, a2, b2, w2))
    return layers


def models(monkeypatch, dtype: str, block_config, input_size, seed=0):
    """(flax model, variables, port model) with the same weights and alive
    statistics; a shallow block_config patches the Flax trunks test-locally."""
    import jax.numpy as jnp
    from smg_tpu.models import affordance as jaff
    from smg_tpu_torch import bridge
    from smg_tpu_torch.models import affordance as aff
    from smg_tpu_torch.models import densenet as tdn

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    if tuple(block_config) != tdn.BLOCK_CONFIG:
        shallow_trunk_patch(monkeypatch, block_config, jdt)
    cfg = jaff.ModelConfig(method="reinforcement", input_size=input_size, dtype=dtype)
    model = jaff.AffordanceNet(cfg)
    port = aff.AffordanceNet(aff.ModelConfig(
        method="reinforcement", input_size=input_size, dtype=dtype,
        block_config=block_config))
    variables = init_flax_all(model, port.grasp_trunk.num_features, cfg.feature_hw, seed)
    stats = rand_stats(variables["batch_stats"], seed)
    bridge.load_affordance_params(port, to_numpy_tree(variables["params"]),
                                  to_numpy_tree(stats))
    return model, {"params": variables["params"], "batch_stats": stats}, port


def score_inputs(seed, B, M, S):
    """Preprocessed random depth maps: scenes (B, S, S, 3), masks (B, M, S, S, 3)."""
    from smg_tpu_torch.models import affordance as aff

    rng = np.random.RandomState(seed)
    depth = (rng.rand(B * (M + 1), S, S) * 0.06).astype(np.float32)
    x = aff.preprocess_depth(torch.as_tensor(depth), aff.ModelConfig(input_size=S)).numpy()
    return x[:B], x[B:].reshape(B, M, S, S, 3)


# ---------------------------------------------------------------------------
# The training step's parity tests (test_torch_train*.py)
# ---------------------------------------------------------------------------

TRAIN_SHALLOW = (2, 2, 2, 2)
TRAIN_S = 224

# Running statistics agree to 5e-5 of max(1, |value|). The variance is
# E[x^2] - E[x]^2 in f32 over up to 56 x 56 pixels, which cancels where
# the mean is large against the spread; the two frameworks sum in other
# orders, and the running average chains two passes. The tests measured
# gaps up to 2.3e-5 (ROADMAP.md §3).
STATS_TOL = 5e-5

def shallow_train_patch(monkeypatch):
    """Shallow float32 Flax trunks, and the JAX fast_train forward in
    float32: fast_trunk.score_train computes in bf16 unless told otherwise,
    whatever ModelConfig.dtype says (trainer.py:240-246). Test-local."""
    import functools

    import jax.numpy as jnp
    from smg_tpu.models import fast_trunk as jft

    shallow_trunk_patch(monkeypatch, TRAIN_SHALLOW, jnp.float32)
    monkeypatch.setattr(jft, "score_train",
                        functools.partial(jft.score_train, dtype=jnp.float32))


def make_trainers(method="reinforcement", conv2="pk", jax_conv2="vjp", B=4,
                  unroll="auto"):
    """(JAX trainer, params, stats, port trainer) with the same weights, at
    input 224 in float32 with shallow trunks (call shallow_train_patch
    first). The JAX trainer takes the fast_train forward with jax_conv2
    ('vjp' is pinned equal to 'pk' by the JAX package and compiles faster
    in interpret mode). unroll="off" takes the JAX trainer's style-grouped
    dispatch, which the JAX package pins equal to its CPU default of all
    three styles per scene (tests/test_train.py::TestChunkedDispatch): one
    styled trunk in the compiled program instead of three."""
    from smg_tpu.models import affordance as jaff
    from smg_tpu.train import trainer as jtr
    from smg_tpu_torch.models.affordance import ModelConfig
    from smg_tpu_torch.train.trainer import TrainConfig, Trainer

    jm = jaff.ModelConfig(method=method, input_size=TRAIN_S, dtype="float32")
    jt = jtr.Trainer(jtr.TrainConfig(model=jm, method=method, scene_chunk=B,
                                     fast_train="on", fast_train_conv2=jax_conv2,
                                     unroll_styles=unroll))
    variables = init_flax_all(jt.model, 128, jm.feature_hw, 0)
    params = variables["params"]
    stats = rand_stats(variables["batch_stats"], 0)
    pt = Trainer(TrainConfig(
        model=ModelConfig(method=method, input_size=TRAIN_S, dtype="float32",
                          block_config=TRAIN_SHALLOW),
        method=method, scene_chunk=B, fast_train_conv2=conv2), device="cpu")
    reset_port(pt, params, stats)
    return jt, params, stats, pt


def reset_port(pt, params, stats):
    """Both port nets back to the JAX weights, a fresh optimizer."""
    from smg_tpu_torch import bridge

    for net in (pt.model, pt.target):
        bridge.load_affordance_params(net, to_numpy_tree(params), to_numpy_tree(stats))
    pt.opt = pt.new_optimizer()


def jax_trainer_state(jt, params, stats):
    import jax.numpy as jnp
    from smg_tpu.train import trainer as jtr

    return jtr.TrainerState(params=params, batch_stats=stats, target_params=params,
                            target_stats=stats, opt_state=jt.tx.init(params),
                            iteration=jnp.asarray(0, jnp.int32))


def to_port(a):
    from smg_tpu_torch import bridge

    return bridge.to_tensor(np.asarray(a))


def flat_tree(tree, prefix=()):
    """Nested dicts -> {path tuple: f32 numpy leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def rel_l2(got, ref, floor):
    g = np.asarray(got, np.float32).ravel()
    r = np.asarray(ref, np.float32).ravel()
    return float(np.linalg.norm(g - r) / max(np.linalg.norm(r), floor))


def leaf_gaps(got: dict, want: dict) -> dict:
    """Relative L2 per leaf, floored at 1e-3 of the largest leaf norm
    (tests/test_dense_layer_train_pallas.py:157-178)."""
    assert got.keys() == want.keys()
    gmax = max(float(np.linalg.norm(v)) for v in want.values())
    assert gmax > 0
    return {k: rel_l2(got[k], want[k], 1e-3 * gmax) for k in want}


def assert_grads(got: dict, want: dict, tol: float = 2e-3):
    for k, err in leaf_gaps(got, want).items():
        assert err < tol, f"grad {'/'.join(k)}: rel L2 {err:.2e}"


# A ReLU network's gradient jumps where a pre-activation lies within f32
# rounding of zero: there are ~1e7 pre-activations in the shallow trunks
# at 224, so a few dozen sit within ~1e-6 of zero, and two computations
# that sum in other orders put some of them on other sides. One flipped
# element moves its BatchNorm bias gradient by ~1/sqrt(pixels) of a
# channel, and the change flows into every layer below. The JAX package's
# own two forms of the same function (its Flax autodiff and its fast_train
# path) part by as much on some cases. So a gradient bound is the
# tolerance asked for, or WITNESS_FACTOR times the gap that JAX's own two
# forms show on the same case, whichever is larger.
WITNESS_FACTOR = 3.0


def witness_tol(tol: float, jax_gap: float) -> float:
    return max(tol, WITNESS_FACTOR * jax_gap)


def stats_gaps(got: dict, want: dict) -> dict:
    """Largest |difference| per statistics leaf, over max(1, |value|)."""
    assert got.keys() == want.keys()
    return {k: float(np.abs(got[k] - want[k]).max()) / max(1.0, float(np.abs(want[k]).max()))
            for k in want}


def assert_stats(got: dict, want: dict, tol: float = STATS_TOL):
    for k, err in stats_gaps(got, want).items():
        assert err <= tol, f"stats {'/'.join(k)}: {err:.2e}"


def port_grads(model) -> dict:
    """The port model's .grad of every parameter, Flax paths and layouts."""
    from smg_tpu_torch import bridge

    out = {}
    for path, p, conv in bridge.param_slots(model):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[path] = bridge.to_flax(g, conv)
    return out


def train_images(seed, n, S=TRAIN_S):
    """n random depth maps (S, S) and one rectangular exec mask each."""
    rng = np.random.RandomState(seed)
    depth = (rng.rand(n, S, S) * 0.06).astype(np.float32)
    mask = np.zeros((n, S, S), bool)
    for b in range(n):
        y, x = rng.randint(30, 150, 2)
        mask[b, y:y + 45, x:x + 60] = True
    return depth, mask
