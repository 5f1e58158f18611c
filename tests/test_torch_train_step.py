"""Parity of one whole training train_step (env.is_testing=False) against
the JAX package, float32.

B = 4, a shallow DenseNet at input 224 (test-local shallow_train_patch),
~5-step primitive phases, exploration pinned to 0 on both sides by a
test-local monkeypatch of explore_probability. The JAX side runs the
fast_train forward with "vjp" (pinned equal to "pk" by the JAX package;
see test_torch_train.py), its style-grouped dispatch (unroll_styles="off",
pinned equal to the default, which would compile three styled trunks) and
executor="vmap" (pinned equal to the batched executor); the port runs "pk" (K6, plain version). Step 1 runs on both
sides from the same bridged state (the blank prev: loss 0). Then JAX's
post-step-1 state (scenes, prev, counters, trainer with its Adam state) is
bridged into the port, since a scene whose episode ends is re-spawned from
each side's own RNG, and step 2 is compared: the action, reward and
explored flags exact, the labels to 1e-4 of the largest, the loss to 1e-4,
the new BatchNorm statistics to STEP_STATS_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from smg_tpu.envs import primitives as jprim
from smg_tpu.envs import smg_env as jenv
from smg_tpu.policy import arbitrate as jarb
from smg_tpu.train import loop as jloop
from smg_tpu_torch import bridge
from smg_tpu_torch.envs import primitives as prim
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.policy import arbitrate as arb
from smg_tpu_torch.train import loop
from smg_tpu_torch.train.trainer import Experience, TrainerState

from test_torch_parity_helpers import (
    assert_stats,
    flat_tree,
    jax_scenes,
    jax_trainer_state,
    make_trainers,
    shallow_train_patch,
    to_numpy_tree,
    to_port as _t,
    torch_tree_to_numpy,
)

B = 4
# Real masked heightmaps are mostly flat background, where f32's
# E[x^2] - E[x]^2 cancels harder than on the random images of
# test_torch_train.py: the sides part by up to 1.8e-4 (ROADMAP.md §3).
STEP_STATS_TOL = 5e-4
PHASES = dict(steps_move_above=5, steps_preclose=5, steps_descend=5,
              steps_squeeze=5, steps_lift=5, steps_pad_align=5,
              steps_finish=5)


def _prev_from_numpy(tree):
    return loop.PrevStep(
        exp=Experience(**{k: _t(v) for k, v in tree["exp"].items()}),
        choice=arb.ActionChoice(**{k: _t(v) for k, v in tree["choice"].items()}),
        outcome=env.StepOutcome(**{k: _t(v) for k, v in tree["outcome"].items()}),
        objects_number=_t(tree["objects_number"]))


def test_train_step_matches_jax(monkeypatch):
    shallow_train_patch(monkeypatch)
    no_explore = lambda iteration, decay, is_testing: 0.0  # noqa: E731
    monkeypatch.setattr(jarb, "explore_probability", no_explore)
    monkeypatch.setattr(arb, "explore_probability", no_explore)
    jt, params, stats, pt = make_trainers(unroll="off")
    ecfg = dict(is_pe=True, is_oo=True, method="reinforcement", is_testing=False)
    jcfg = jloop.LoopConfig(env=jenv.EnvConfig(**ecfg), batch_size=B,
                            reset_settle_steps=10,
                            primitive=jprim.PrimitiveParams(**PHASES), executor="vmap")
    pcfg = loop.LoopConfig(env=env.EnvConfig(**ecfg), batch_size=B,
                           reset_settle_steps=10, primitive=prim.PrimitiveParams(**PHASES))
    batch, tree = jax_scenes(B, seed=4, settle_steps=150, is_testing=False)
    j0 = jloop.LoopState(
        scenes=batch, counters=jloop.EpisodeCounters.zeros(B),
        trainer=jax_trainer_state(jt, params, stats),
        prev=jloop.blank_prev(B), key=jax.random.PRNGKey(0))
    step = jax.jit(lambda st: jloop.train_step(jt, jcfg, st))
    j1, jm1 = step(j0)
    j2, jm2 = step(j1)

    p0 = loop.LoopState(scenes=bridge.scene_from_numpy(tree), trainer=TrainerState(0),
                        counters=loop.EpisodeCounters.zeros(B, "cpu"),
                        prev=loop.blank_prev(B, "cpu"), generator=torch.Generator())
    p1, pm1 = loop.train_step(pt, pcfg, p0)
    assert float(pm1.loss) == 0.0 == float(jm1.loss)
    assert p1.trainer.iteration == 1

    # Step 2 from JAX's post-step-1 state (re-spawns draw from each side's
    # own RNG, so the sides would part at the first finished episode).
    jt1, adam = j1.trainer, j1.trainer.opt_state[0]
    ptrain = bridge.load_trainer_state(pt, to_numpy_tree({
        "params": jt1.params, "batch_stats": jt1.batch_stats,
        "target_params": jt1.target_params, "target_stats": jt1.target_stats,
        "adam": {"count": adam.count, "mu": adam.mu, "nu": adam.nu},
        "iteration": jt1.iteration}))
    counters = to_numpy_tree(j1.counters)
    p1b = loop.LoopState(
        scenes=bridge.scene_from_numpy(to_numpy_tree(j1.scenes)), trainer=ptrain,
        counters=loop.EpisodeCounters(**{k: _t(v) for k, v in counters.items()}),
        prev=_prev_from_numpy(to_numpy_tree(j1.prev)), generator=torch.Generator())
    assert bool(p1b.prev.exp.valid.any())
    p2, pm2 = loop.train_step(pt, pcfg, p1b)
    jm2, pm2 = to_numpy_tree(jm2), torch_tree_to_numpy(pm2)
    assert p2.trainer.iteration == 2
    for k in ("action", "reward", "explored"):
        np.testing.assert_array_equal(pm2[k], jm2[k], err_msg=k)
    scale = max(1.0, float(np.abs(jm2["label_value"]).max()))
    assert np.abs(pm2["label_value"] - jm2["label_value"]).max() <= 1e-4 * scale
    assert float(jm2["loss"]) > 0
    assert abs(float(pm2["loss"]) - float(jm2["loss"])) <= 1e-4 * float(jm2["loss"])
    assert_stats(flat_tree(bridge.dump_affordance_params(pt.model)[1]),
                 flat_tree(to_numpy_tree(j2.trainer.batch_stats)), tol=STEP_STATS_TOL)
