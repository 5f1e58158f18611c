"""Parity: arbitration, PE/OO geometry and the batched primitive executor
of the port against the JAX package.

- select_action on bridged scores (testing mode, with and without ETS,
  reactive and reinforcement): every ActionChoice field equal.
- compute_geometry on bridged observations and choices: to 1e-5.
- execute_batched against batched.execute_batched(interpret=True) with
  short phases, for grasp, suction and ETS scenes: rewards and outcomes
  equal, float states to 1e-5 of each field's scale (atol 1e-5 for the
  O(1) positions, quaternions and velocities; angular velocities of
  rolling objects reach the 30 rad/s clamp, where one f32 step is 2e-6
  and the tiny inertias amplify last-bit differences of the torques);
  integer and boolean states equal. The batch mixes the three actions and
  runs from the settled pose, and again from the gripper placed at its
  suction touch pose, where the pad captures, so the capture and reward
  paths give non-zero suction rewards (states there to 1e-4 of the scale:
  see STATE_TOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.envs import batched as jbatched
from smg_tpu.envs import primitives as jprim
from smg_tpu.envs import smg_env as jenv
from smg_tpu.policy import arbitrate as jarb
from smg_tpu_torch import bridge
from smg_tpu_torch.envs import batched, primitives as prim
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.perception.segment import Segmentation
from smg_tpu_torch.policy import arbitrate as arb

from test_torch_parity_helpers import jax_scenes, to_numpy_tree, torch_tree_to_numpy

N = 12


def _scores(seed, B=16, R=1):
    rng = np.random.RandomState(seed)
    valid = rng.rand(B, N) < 0.5
    valid[0] = False
    valid[1] = False
    valid[1, 3] = True            # one object
    valid[2] = False
    valid[2, [4, 9]] = True       # two objects
    gra = np.where(valid[..., None], rng.randn(B, N, R), -1e9)
    suc = np.where(valid[..., None], rng.randn(B, N, R), -1e9)
    gs = np.full((B, N, N), -100.0)
    iu = np.triu_indices(N, 1)
    gs[:, iu[0], iu[1]] = rng.randn(B, len(iu[0])) * 1.5
    centers = rng.randint(0, 224, (B, N, 2)).astype(np.float32)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return f(gra), f(suc), f(gs), valid, centers


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("is_ets,method", [(False, "reinforcement"),
                                           (True, "reinforcement"),
                                           (True, "reactive")])
def test_select_action(is_ets, method, R):
    gra, suc, gs, valid, centers = _scores(int(is_ets) + 2 * (method == "reactive"), R=R)
    B = gra.shape[0]
    want = to_numpy_tree(jax.vmap(lambda k, g, s, p, v, c: jarb.select_action(
        k, g, s, p, v, c, method=method, is_ets=is_ets, is_testing=True))(
            jax.random.split(jax.random.PRNGKey(0), B), gra, suc, gs, valid,
            centers))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    got = torch_tree_to_numpy(arb.select_action(
        t(gra), t(suc), t(gs), t(valid), t(centers), method=method,
        is_ets=is_ets))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if is_ets:
        assert (want["action"] == arb.ACTION_ETS).any()
    if R > 1:   # the rotation ids reach best_pix
        assert (want["best_pix"][:, [0, 3]] > 0).any()
        assert (want["best_pix"][:, [0, 3]] < R).all()


@pytest.fixture(scope="module")
def scenes_obs():
    batch, tree = jax_scenes(6, seed=11, settle_steps=150)
    obs = jax.jit(jax.vmap(jenv.observe))(batch)
    return batch, tree, obs, to_numpy_tree(obs)


def _choices(obs_np, actions, seed=0):
    """Per-scene ActionChoice trees: the given actions on valid slots."""
    rng = np.random.RandomState(seed)
    valid = obs_np["seg"]["valid"]
    B = valid.shape[0]
    g_obj = np.zeros(B, np.int32)
    s_obj = np.zeros(B, np.int32)
    for b in range(B):
        ids = np.flatnonzero(valid[b])
        pick = rng.permutation(ids)
        g_obj[b] = pick[0]
        s_obj[b] = pick[1] if len(pick) > 1 else pick[0]
    z = np.zeros(B, np.int32)
    zf = np.zeros(B, np.float32)
    z2 = np.zeros((B, 2), np.int32)
    return dict(
        action=np.asarray(actions, np.int32), grasp_obj=g_obj, grasp_rot=z,
        suction_obj=s_obj, suction_rot=z, predicted_value=zf,
        explored=np.zeros(B, bool), best_pix=np.zeros((B, 6), np.int32),
        bestg_id=z2, bests_id=z2, bestgs_g_id=z2, bestgs_s_id=z2,
        bestgs_pair=z2, bestg_conf=zf, bests_conf=zf, bestgs_conf=zf,
        exploit_action=np.asarray(actions, np.int32))


def _port_obs(obs_np):
    tt = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return env.Observation(
        depth_hm=tt(obs_np["depth_hm"]), color_hm=tt(obs_np["color_hm"]),
        seg=Segmentation(**{k: tt(v) for k, v in obs_np["seg"].items()}))


def _jax_geometry(obs, choice_np, cfg):
    choice = jarb.ActionChoice(**{k: jnp.asarray(v) for k, v in choice_np.items()})
    geom = jax.jit(jax.vmap(lambda c, o: jenv.compute_geometry(c, o, cfg)))(
        choice, obs)
    return choice, geom


@pytest.mark.parametrize("pe_oo", [True, False])
def test_compute_geometry(scenes_obs, pe_oo):
    _, _, obs, obs_np = scenes_obs
    actions = [1, 0, 2, 2, 0, 1]
    choice_np = _choices(obs_np, actions)
    jcfg = jenv.EnvConfig(is_pe=pe_oo, is_oo=pe_oo, is_ets=True)
    _, geom = _jax_geometry(obs, choice_np, jcfg)
    want = to_numpy_tree(geom)
    pcfg = env.EnvConfig(is_pe=pe_oo, is_oo=pe_oo, is_ets=True)
    choice = arb.ActionChoice(**{k: torch.as_tensor(v)
                                 for k, v in choice_np.items()})
    got = torch_tree_to_numpy(env.compute_geometry(choice, _port_obs(obs_np),
                                                   pcfg))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    if pe_oo:
        assert (np.abs(want["suction_angle"]) > 0).any()


# ~5-step phases; no travel phases (move-above, pad-align), so that a
# gripper placed at its suction touch pose captures within them.
PHASES = dict(steps_move_above=0, steps_preclose=5, steps_descend=5,
              steps_squeeze=5, steps_lift=5, steps_pad_align=0,
              steps_finish=5)
_JAX_EXECUTE = {}


def _jax_execute():
    """One compiled JAX executor for every case (actions and poses are
    data, the phase lengths static)."""
    if "fn" not in _JAX_EXECUTE:
        jp = jprim.PrimitiveParams(**PHASES)
        _JAX_EXECUTE["fn"] = jax.jit(lambda s, c, g: jbatched.execute_batched(
            s, c, g, jp, interpret=True))
    return _JAX_EXECUTE["fn"]


def _at_suction_touch(g, geom):
    def one(gp, pos, ang):
        _, yaw, tilt, curl, touch, _ = jprim.suction_stage_params(
            gp.curl, pos, ang, jnp.asarray(1.0))
        return gp.replace(pos=touch, yaw=yaw, tilt=tilt, curl=curl)
    return jax.vmap(one)(g, geom.suction_position, geom.suction_angle)


# Settled pose: float states to 1e-5 of each field's scale. Touch pose: the
# pad starts pressed into its target at the penetration clamp, the stiffest
# contact of the model, where last-bit differences grow about ten times
# faster over the 35 steps; there 1e-4 of the scale.
STATE_TOL = {"home": 1e-5, "touch": 1e-4}


@pytest.mark.parametrize("start", ["home", "touch"])
def test_execute_batched(scenes_obs, start):
    """Grasp, suction and ETS scenes in one batch (slots 0..5)."""
    from smg_tpu.train.loop import _strong

    batch, tree, obs, obs_np = scenes_obs
    actions = [arb.ACTION_GRASP, arb.ACTION_SUCTION, arb.ACTION_ETS,
               arb.ACTION_ETS, arb.ACTION_SUCTION, arb.ACTION_GRASP]
    choice_np = _choices(obs_np, actions, seed=1)
    jcfg = jenv.EnvConfig(is_pe=True, is_oo=True, is_ets=True)
    choice, geom = _jax_geometry(obs, choice_np, jcfg)
    if start == "touch":
        batch = batch.replace(gripper=_at_suction_touch(batch.gripper, geom))
        tree = to_numpy_tree(batch)
    scenes, outcome = _jax_execute()(_strong(batch), choice, geom)
    want_s, want_o = to_numpy_tree(scenes), to_numpy_tree(outcome)

    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    pchoice = arb.ActionChoice(**{k: t(v) for k, v in choice_np.items()})
    pgeom = env.Geometry(**{k: t(v) for k, v in to_numpy_tree(geom).items()})
    pscenes, pout = batched.execute_batched(
        bridge.scene_from_numpy(tree), pchoice, pgeom,
        prim.PrimitiveParams(**PHASES))
    got_s, got_o = bridge.scene_to_numpy(pscenes), torch_tree_to_numpy(pout)
    for k in ("suction_success", "grasp_success", "gs_success"):
        np.testing.assert_array_equal(got_o[k], want_o[k], err_msg=k)
    np.testing.assert_allclose(got_o["tip_divergence"],
                               want_o["tip_divergence"], atol=1e-5)
    for part in ("objects", "gripper"):
        for k, w in want_s[part].items():
            g = got_s[part][k]
            if w.dtype.kind == "f":
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, w, atol=STATE_TOL[start] * scale,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
    if start == "touch":
        assert want_o["suction_success"].sum() > 0, "no suction capture"
