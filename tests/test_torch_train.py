"""Parity of the port's trainer against the JAX package, float32.

A shallow DenseNet (block_config (2, 2, 2, 2)) at input 224 on both sides
(test-local patches: shallow_train_patch); weights and random BatchNorm
statistics go through the bridge.

- Trainer.update against JAX's with fast_train="on": B = 4 with all three
  styles and one invalid scene. The JAX side runs its style-grouped
  dispatch (unroll_styles="off", see make_trainers) and
  fast_train_conv2="vjp", which the JAX package pins equal to "pk"
  (tests/test_dense_layer_train_pallas.py::test_bwd_matches_jnp_vjp) and
  which compiles faster in interpret mode; the port runs "pk" (K6, plain
  version). JAX's gradients come back through a test-local optax
  transformation that stores them as its state. Compared: the loss to
  1e-5; each network part's gradient (relative L2) and every leaf's (with
  a 1e-3 * gmax floor) to 2e-3, and the new batch_stats to 1e-5, or
  WITNESS_FACTOR times the gap between JAX's own two forms of the update
  where that is larger: its Flax autodiff (fast_train="off") against its
  fast_train path on the same case (test_torch_parity_helpers.witness_tol).
  On this case JAX's own forms part by more than 2e-3 on the trunks whose
  gradient comes from one or two scenes, and by more than 1e-5 on the
  statistics.
- Adam against optax.adam: a bridged, non-fresh optax state, then 3 steps
  on identical gradients: params to 1e-6, moments to 1e-5 of each leaf's
  largest value. (Comparing params after an update of the model would
  test the sign of rounding noise: an Adam step moves a weight by about
  lr whatever the gradient's size.)
- dqn_labels (labels to 1e-4 of the largest; the zero rules and rewards
  exact) and reactive_labels (exact).
- maybe_sync_target: syncs at iteration 10 only; the target's BatchNorm
  buffers stay frozen between syncs.
- epsilon-greedy: distributions over 4096 scenes (a torch Generator and a
  JAX key give different bits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smg_tpu.envs import smg_env as jenv
from smg_tpu.policy import arbitrate as jarb
from smg_tpu.train import trainer as jtr
from smg_tpu_torch import bridge
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.policy import arbitrate as arb
from smg_tpu_torch.train.trainer import Experience, TrainerState

from test_torch_parity_helpers import (
    TRAIN_S as S,
    assert_grads,
    assert_stats,
    flat_tree,
    jax_trainer_state,
    leaf_gaps,
    make_trainers,
    port_grads,
    rel_l2,
    reset_port,
    shallow_train_patch,
    stats_gaps,
    to_numpy_tree,
    to_port as _t,
    train_images,
    witness_tol,
)

B = 4


@pytest.fixture(scope="module")
def dqn():
    mp = pytest.MonkeyPatch()
    shallow_train_patch(mp)
    yield make_trainers(unroll="off")
    mp.undo()


def _grad_capture():
    """An optax transformation whose state is the last gradient it saw and
    whose updates are zero: JAX's update then hands its gradients back."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _jax_update(jt, params, stats, exp, labels, **cfg):
    """JAX's update with the trainer config changed by cfg: (loss, the
    gradients, the new batch_stats), flattened."""
    jt = jtr.Trainer(dataclasses.replace(jt.cfg, **cfg))
    jt.tx = _grad_capture()
    jnew, jloss = jax.jit(jt.update)(jax_trainer_state(jt, params, stats), exp, labels)
    return (float(jloss), flat_tree(to_numpy_tree(jnew.opt_state)),
            flat_tree(to_numpy_tree(jnew.batch_stats)))


def _part_gaps(got: dict, want: dict) -> dict:
    """Relative L2 of each network part's whole gradient (gs_head: none)."""
    out = {}
    for part in bridge.AFFORDANCE_PARTS[:5]:
        keys = sorted(k for k in want if k[0] == part)
        cat = lambda d: np.concatenate([d[k].ravel() for k in keys])  # noqa: E731
        out[part] = rel_l2(cat(got), cat(want), 1e-6)
    return out


def test_update_matches_jax(dqn):
    jt, params, stats, pt = dqn
    depth, mask = train_images(2, B)
    style = np.array([0, 1, 2, 1], np.int32)
    valid = np.array([True, True, True, False])
    labels = np.random.RandomState(3).uniform(-0.5, 2.5, B).astype(np.float32)

    jexp = jtr.Experience(scene_depth=jnp.asarray(depth), exec_mask=jnp.asarray(mask),
                          style=jnp.asarray(style), valid=jnp.asarray(valid))
    jloss, want, want_stats = _jax_update(jt, params, stats, jexp, jnp.asarray(labels))
    _, flax_g, flax_stats = _jax_update(jt, params, stats, jexp, jnp.asarray(labels),
                                        fast_train="off", fast_train_conv2="conv")

    reset_port(pt, params, stats)
    pstate, ploss = pt.update(
        TrainerState(0), Experience(scene_depth=_t(depth), exec_mask=_t(mask),
                                    style=_t(style), valid=_t(valid)), _t(labels))
    assert pstate.iteration == 1
    assert jloss > 0
    assert abs(float(ploss) - jloss) <= 1e-5 * abs(jloss)
    got = port_grads(pt.model)
    got_stats = flat_tree(bridge.dump_affordance_params(pt.model)[1])
    gaps = {name: (max(leaf_gaps(g, want).values()), _part_gaps(g, want),
                   max(stats_gaps(st, want_stats).values()))
            for name, g, st in (("port", got, got_stats), ("JAX Flax", flax_g, flax_stats))}
    for name, (leaf, parts, st) in gaps.items():
        print(f"update, {name} against JAX fast_train: worst leaf {leaf:.3e}, parts "
              + ", ".join(f"{k} {v:.3e}" for k, v in parts.items()) + f", stats {st:.3e}")
    leaf_w, parts_w, stats_w = gaps["JAX Flax"]
    assert_grads(got, want, tol=witness_tol(2e-3, leaf_w))
    part_tol = witness_tol(2e-3, max(parts_w.values()))
    for part, err in gaps["port"][1].items():
        assert err < part_tol, (part, err)
    assert_stats(got_stats, want_stats, tol=witness_tol(1e-5, stats_w))
    # The tied head: gs_head neither learns nor moves its statistics.
    assert not any(np.abs(v).any() for k, v in got.items() if k[0] == "gs_head")


def test_adam_matches_optax(dqn):
    _, params, stats, pt = dqn
    reset_port(pt, params, stats)
    rng = np.random.RandomState(5)
    tx = optax.adam(1e-4, b1=0.9, b2=0.999, eps=1e-8)
    p = jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(params))
    grads = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)
                              * 10.0 ** rng.uniform(-4, 0)), p)
    opt = tx.init(p)
    for _ in range(2):     # a non-fresh state to bridge
        upd, opt = tx.update(grads(), opt, p)
        p = optax.apply_updates(p, upd)
    np_stats = to_numpy_tree(stats)
    adam = to_numpy_tree({"count": opt[0].count, "mu": opt[0].mu, "nu": opt[0].nu})
    pstate = bridge.load_trainer_state(pt, {
        "params": to_numpy_tree(p), "batch_stats": np_stats,
        "target_params": to_numpy_tree(p), "target_stats": np_stats,
        "adam": adam, "iteration": np.int32(2)})
    assert pstate.iteration == 2
    slots = list(bridge.param_slots(pt.model))
    for _ in range(3):
        g = grads()
        upd, opt = tx.update(g, opt, p)
        p = optax.apply_updates(p, upd)
        flat_g = flat_tree(to_numpy_tree(g))
        for path, t, conv in slots:
            t.grad = bridge.from_flax(flat_g[path], conv)
        pt.opt.step()
    got = bridge.trainer_state_to_numpy(pt, pstate)
    assert int(got["adam"]["count"]) == int(opt[0].count) == 5
    want_p, got_p = flat_tree(to_numpy_tree(p)), flat_tree(got["params"])
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=1e-6,
                                   err_msg="/".join(k))
    for name, tree in (("mu", opt[0].mu), ("nu", opt[0].nu)):
        want_m, got_m = flat_tree(to_numpy_tree(tree)), flat_tree(got["adam"][name])
        for k in want_m:
            scale = float(np.abs(want_m[k]).max())
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{name} {'/'.join(k)}")


# ---------------------------------------------------------------------------
# Labels, target sync, exploration
# ---------------------------------------------------------------------------


_CHOICE_FIELDS = [f.name for f in dataclasses.fields(arb.ActionChoice)]


def _choice(action, exploit, rng, n_slots=12):
    n = len(action)
    ids = lambda: np.stack([rng.randint(0, 4, n), np.zeros(n, int)], 1)  # noqa: E731
    c = {k: np.zeros(n, np.int32) for k in _CHOICE_FIELDS}
    c.update(action=np.asarray(action, np.int32), exploit_action=np.asarray(exploit, np.int32),
             explored=np.zeros(n, bool), best_pix=np.zeros((n, 6), np.int32),
             bestg_id=ids(), bests_id=ids(), bestgs_g_id=ids(), bestgs_s_id=ids(),
             bestgs_pair=ids())
    for k in ("predicted_value", "bestg_conf", "bests_conf", "bestgs_conf"):
        c[k] = np.zeros(n, np.float32)
    for k in ("bestg_id", "bests_id", "bestgs_g_id", "bestgs_s_id", "bestgs_pair"):
        c[k] = c[k].astype(np.int32)
    return (jarb.ActionChoice(**{k: jnp.asarray(v) for k, v in c.items()}),
            arb.ActionChoice(**{k: _t(v) for k, v in c.items()}))


def _outcome(s, g, gs):
    arrs = dict(suction_success=np.float32(s), grasp_success=np.float32(g),
                gs_success=np.float32(gs), tip_divergence=np.zeros(len(s), np.float32))
    arrs = {k: np.asarray(v, np.float32) for k, v in arrs.items()}
    return (jenv.StepOutcome(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            env.StepOutcome(**{k: _t(v) for k, v in arrs.items()}))


def test_dqn_and_reactive_labels(dqn):
    jt, params, stats, pt = dqn
    rng = np.random.RandomState(6)
    n = 6
    # 0 fails; 1 and 2 clear the table; 3-5 succeed with a future term
    # (5: an ETS reward of 0.5 counts as a success).
    j_prev, p_prev = _choice([1, 1, 2, 0, 1, 2], [1, 1, 2, 0, 1, 2], rng)
    j_out, p_out = _outcome([0, 0, 0, 1, 0, 0], [0, 1, 0, 0, 1, 0],
                            [0, 0, 2.5, 0, 0, 0.5])
    num = np.array([3, 1, 2, 3, 4, 3], np.int32)
    j_next, p_next = _choice([0] * n, [1, 1, 2, 1, 0, 2], rng)
    depth, _ = train_images(7, n)
    masks = np.zeros((n, 12, S, S), bool)
    for b in range(n):
        for k in range(4):
            y, x = rng.randint(20, 160, 2)
            masks[b, k, y:y + 40, x:x + 40] = True
    jstate = jax_trainer_state(jt, params, stats)
    want, wr = jax.jit(jt.dqn_labels)(jstate, j_prev, j_out, jnp.asarray(num),
                                      jnp.asarray(depth), jnp.asarray(masks), j_next)
    reset_port(pt, params, stats)
    got, gr = pt.dqn_labels(TrainerState(0), p_prev, p_out, _t(num), _t(depth),
                            _t(masks), p_next)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(got[:3], [0.0, 1.0, 2.5])
    np.testing.assert_array_equal(want[:3], [0.0, 1.0, 2.5])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert (np.abs(got[3:] - np.asarray(wr)[3:]) > 1e-6).all()   # a live future term

    np.testing.assert_array_equal(pt.reactive_labels(p_prev, p_out).numpy(),
                                  np.asarray(jt.reactive_labels(j_prev, j_out)))
    np.testing.assert_array_equal(pt.reactive_labels(p_prev, p_out).numpy(),
                                  [1, 0, 0, 0, 0, 1])


def test_target_sync_cadence(dqn):
    _, params, stats, pt = dqn
    reset_port(pt, params, stats)
    pt.target.load_state_dict(pt.model.state_dict())
    frozen = {k: v.clone() for k, v in pt.target.state_dict().items()}
    bn = pt.model.grasp_trunk.norm0
    for it in range(1, 11):
        with torch.no_grad():
            pt.model.grasp_trunk.conv0.weight.add_(0.01)
            bn.running_mean.add_(0.1)
            bn.running_var.mul_(1.1)
        pt.maybe_sync_target(TrainerState(it))
        now = pt.target.state_dict()
        same = all(torch.equal(now[k], frozen[k]) for k in frozen)
        assert same == (it < 10), it
    for k, v in pt.model.state_dict().items():
        assert torch.equal(pt.target.state_dict()[k], v), k


def test_epsilon_greedy():
    n, N = 4096, 12
    rng = np.random.RandomState(8)
    gra = torch.tensor(rng.randn(n, N, 1).astype(np.float32))
    suc = torch.tensor(rng.randn(n, N, 1).astype(np.float32))
    gs = torch.tensor(rng.randn(n, N, N).astype(np.float32))
    valid = torch.zeros(n, N, dtype=torch.bool)
    valid[:, 0] = True
    valid[n // 2:, 1:5] = True                  # the second half: 5 objects
    centers = torch.tensor(rng.randint(0, 224, (n, N, 2)).astype(np.float32))
    for is_ets in (False, True):
        gen = torch.Generator().manual_seed(0)
        c = arb.select_action(gra, suc, gs, valid, centers, is_ets=is_ets,
                              is_testing=False, explore_prob=0.5, generator=gen)
        share = float(c.explored.float().mean())
        assert abs(share - 0.5) < 0.03, share
        assert bool(((c.action >= 0) & (c.action <= (2 if is_ets else 1))).all())
        assert torch.equal(c.action[~c.explored], c.exploit_action[~c.explored])
        single = valid.sum(1) == 1
        assert not bool((c.action[single & c.explored] == arb.ACTION_ETS).any())
        if is_ets:
            multi_ex = c.action[~single & c.explored]
            ets_share = float((multi_ex == arb.ACTION_ETS).float().mean())
            assert abs(ets_share - 1 / 3) < 0.05, ets_share
    greedy = arb.select_action(gra, suc, gs, valid, centers, is_ets=True)
    assert not bool(greedy.explored.any())
    for it in (0, 1, 100, 5000, 20000):
        for decay in (False, True):
            for testing in (False, True):
                want = float(jarb.explore_probability(jnp.asarray(it), decay, testing))
                # Both raise 0.9998 to the integer iteration in float32 by
                # square-and-multiply (the float64 power parts 2.2e-4
                # relative at iteration 5000); bound: float32 rounding.
                got = arb.explore_probability(it, decay, testing)
                assert abs(got - want) <= 1e-6 * want


