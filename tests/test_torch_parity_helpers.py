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
