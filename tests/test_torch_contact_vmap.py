"""Parity: the per-scene physics path (physics/contact.py,
stepper.physics_step / run_steps, the per-scene primitives,
smg_env.execute, LoopConfig.executor="vmap") against the JAX package, and
against the port's own batched (K1) path.

- Contacts on 16 JAX-spawned scenes with the gripper pressed into each
  scene's first object and the second object pushed into the first: fused_contact_forces and the class-by-class
  table_forces, object_object_forces and gripper_object_forces against
  JAX's vmapped functions, to relative 1e-5 with a floor of 1e-5 of the
  largest force (as K1's test: sums over 145 sources, in other orders).
- physics_step over 3 steps from that state against JAX's vmapped
  run_steps: positions, quaternions and velocities to 1e-5 of each
  field's scale (the execute tests' bound).
- run_steps against the port's run_steps_batched on the CPU, as the JAX
  package holds its two paths (tests/test_physics.py:243-284): bit-equal
  at rest; with an attached object under a moving gripper, and with the
  gripper in contact, the plain K1 adds its pair terms in another order
  (ROADMAP section 3), so object and gripper positions there are held to
  JAX's attached-case bound, atol 1e-6, and the other states to 1e-5 of
  their scale.
- smg_env.execute against JAX's vmapped execute with short phases, from
  the settled pose and from the suction touch pose: rewards and outcomes
  equal, tip divergence to 1e-5, states to the bounds of
  tests/test_torch_policy_env.py::test_execute_batched.
- grasp_first, suction_first and grasp_then_suction against JAX's on the
  same scenes and short phases: rewards equal, states to 1e-4 of each
  field's scale (the touch-pose bound of test_execute_batched: the ETS
  sequence runs both stages and the finish, and an angular velocity near
  the 30 rad/s clamp reads 1.1e-5 of the scale apart, ROADMAP section 3's
  physics drift).
- The loop: one testing act step with executor="vmap" against "batched"
  on the same state (tiny trunk, B = 2): the same actions and rewards,
  scenes to atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.envs import primitives as jprim
from smg_tpu.envs import smg_env as jenv
from smg_tpu.physics import contact as jct
from smg_tpu.physics import gripper as jgr
from smg_tpu.physics import stepper as jstepper
from smg_tpu.train.loop import _strong
from smg_tpu_torch import bridge
from smg_tpu_torch.envs import primitives as prim
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.physics import contact as ct
from smg_tpu_torch.physics import gripper as gr
from smg_tpu_torch.physics import stepper
from smg_tpu_torch.physics.state import ATTACHED_GRASP, Gripper
from smg_tpu_torch.policy import arbitrate as arb

from test_torch_parity_helpers import jax_scenes, to_numpy_tree, torch_tree_to_numpy
from test_torch_policy_env import (
    PHASES,
    STATE_TOL,
    _at_suction_touch,
    _choices,
    _jax_geometry,
)

B = 16


def _pressed(batch):
    """The gripper 6 cm above each scene's first object, moving down 3 cm."""
    def one(g, o):
        pos = jnp.concatenate([o.pos[0, :2], jnp.array([0.06])])
        here = g.replace(pos=pos, yaw=jnp.asarray(0.3))
        return here, here.replace(pos=pos - jnp.array([0.0, 0.0, 0.03]))
    return jax.vmap(one)(batch.gripper, batch.objects)


@pytest.fixture(scope="module")
def pressed():
    batch, _ = jax_scenes(B, seed=5)
    pos = batch.objects.pos
    batch = batch.replace(objects=batch.objects.replace(
        pos=pos.at[:, 1].set(pos[:, 0] + jnp.array([0.025, 0.0, 0.01]))))
    g, tgt = _pressed(batch)
    batch = jax.jit(jax.vmap(lambda s, t: jstepper.run_steps(s, t, 3)))(
        batch.replace(gripper=g), tgt)
    return batch, tgt


def _port(batch):
    return bridge.scene_from_numpy(to_numpy_tree(batch))


def _port_gripper(g) -> Gripper:
    return Gripper(**{k: torch.as_tensor(np.array(v)) for k, v in to_numpy_tree(g).items()})


def _assert_forces(got, want):
    fmax = max(float(np.abs(w).max()) for w in want)
    assert fmax > 1.0, "the case has real contacts"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * fmax)


def _grip_state(batch, g_old):
    """JAX's collider spheres of the servoed gripper, and their velocities."""
    def one(s, t):
        g_new = jstepper._servo_gripper(s.gripper, t, jstepper.DEFAULT)
        c1, r = jgr.collider_spheres(g_new)
        c0, _ = jgr.collider_spheres(s.gripper)
        return c1, r, (c1 - c0) / jstepper.DEFAULT.dt
    return jax.vmap(one)(batch, g_old)


@pytest.mark.parametrize("fn", ["fused", "table", "objects", "gripper"])
def test_contact_forces(pressed, fn):
    batch, tgt = pressed
    c, r, v = jax.jit(_grip_state)(batch, tgt)
    jfns = {"fused": lambda o, c, r, v: jct.fused_contact_forces(o, c, r, v),
            "table": lambda o, c, r, v: jct.table_forces(o),
            "objects": lambda o, c, r, v: jct.object_object_forces(o),
            "gripper": lambda o, c, r, v: jct.gripper_object_forces(o, c, r, v)}
    want = [np.asarray(w) for w in jax.jit(jax.vmap(jfns[fn]))(batch.objects, c, r, v)]
    obj = _port(batch).objects
    pc, pv = torch.as_tensor(np.array(c)), torch.as_tensor(np.array(v))
    pr = torch.as_tensor(np.array(r[0]))
    pfns = {"fused": lambda: ct.fused_contact_forces(obj, pc, pr, pv),
            "table": lambda: ct.table_forces(obj),
            "objects": lambda: ct.object_object_forces(obj),
            "gripper": lambda: ct.gripper_object_forces(obj, pc, pr, pv)}
    got = [t.numpy() for t in pfns[fn]()]
    assert len(got) == len(want)
    _assert_forces(got, want)


def test_collider_spheres(pressed):
    batch, _ = pressed
    want = jax.vmap(jgr.collider_spheres)(batch.gripper)
    got = gr.collider_spheres(_port(batch).gripper)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1][0]))


def _assert_states(got, want, tol=1e-5):
    for k in ("pos", "quat", "vel", "omega"):
        w, g = want["objects"][k], got["objects"][k]
        np.testing.assert_allclose(g, w, atol=tol * max(1.0, float(np.abs(w).max())),
                                   err_msg=k)
    np.testing.assert_allclose(got["gripper"]["pos"], want["gripper"]["pos"], atol=1e-6)


def test_physics_step(pressed):
    batch, tgt = pressed
    want = to_numpy_tree(jax.jit(jax.vmap(lambda s, t: jstepper.run_steps(s, t, 3)))(
        batch, tgt))
    got = bridge.scene_to_numpy(stepper.run_steps(_port(batch), _port_gripper(tgt), 3))
    _assert_states(got, want)
    np.testing.assert_array_equal(got["t"], want["t"])


def _attached_case(scenes):
    obj = stepper.attach(scenes.objects, scenes.gripper,
                         (torch.arange(12) == 0).expand(scenes.batch_size, 12),
                         ATTACHED_GRASP)
    g = scenes.gripper
    tgt = Gripper(pos=g.pos + torch.tensor([0.05, -0.03, 0.02]), yaw=g.yaw + 0.4,
                  tilt=g.tilt, curl=g.curl + 0.3)
    return scenes.replace(objects=obj), tgt


@pytest.mark.parametrize("case", ["rest", "attached", "contact"])
def test_run_steps_vs_batched(pressed, case):
    """The per-scene path against the port's batched K1 path (plain on
    the CPU), as tests/test_physics.py:243-284 holds JAX's."""
    if case == "contact":
        scenes, tgt = _port(pressed[0]), _port_gripper(pressed[1])
    else:
        batch, _ = jax_scenes(8, seed=2)
        scenes = _port(batch)
        scenes, tgt = (_attached_case(scenes) if case == "attached"
                       else (scenes, scenes.gripper))
    n = 8
    a = bridge.scene_to_numpy(stepper.run_steps(scenes, tgt, n))
    b = bridge.scene_to_numpy(stepper.run_steps_batched(scenes, tgt, n))
    if case != "rest":
        np.testing.assert_allclose(a["objects"]["pos"], b["objects"]["pos"], atol=1e-6)
        _assert_states(a, b)
        return
    for part in ("objects", "gripper"):
        for k, v in b[part].items():
            np.testing.assert_array_equal(a[part][k], v, err_msg=k)


def test_lift_success_mask(pressed):
    batch, _ = pressed
    jobj = batch.objects.replace(pos=batch.objects.pos.at[:, 1, 2].set(0.2))
    want = np.asarray(jax.vmap(jstepper.lift_success_mask)(jobj))
    obj = _port(batch).objects
    obj = obj.replace(pos=obj.pos.clone().index_put_(
        (torch.arange(B), torch.ones(B, dtype=torch.long), torch.full((B,), 2)),
        torch.tensor(0.2)))
    got = stepper.lift_success_mask(obj).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[:, 1].any()


@pytest.fixture(scope="module")
def scenes_obs():
    batch, tree = jax_scenes(6, seed=11, settle_steps=150)
    obs = jax.jit(jax.vmap(jenv.observe))(batch)
    return batch, tree, obs, to_numpy_tree(obs)


def _compare_execute(got_s, got_o, want_s, want_o, tol):
    for k in ("suction_success", "grasp_success", "gs_success"):
        np.testing.assert_array_equal(got_o[k], want_o[k], err_msg=k)
    np.testing.assert_allclose(got_o["tip_divergence"], want_o["tip_divergence"],
                               atol=1e-5)
    for part in ("objects", "gripper"):
        for k, w in want_s[part].items():
            g = got_s[part][k]
            if w.dtype.kind == "f":
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, w, atol=tol * scale, err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)


_JAX_EXECUTE = {}


def _jax_execute():
    """One compiled JAX executor for both starts."""
    if "fn" not in _JAX_EXECUTE:
        jp = jprim.PrimitiveParams(**PHASES)
        _JAX_EXECUTE["fn"] = jax.jit(jax.vmap(lambda s, c, g: jenv.execute(s, c, g, jp)))
    return _JAX_EXECUTE["fn"]


@pytest.mark.parametrize("start", ["home", "touch"])
def test_execute(scenes_obs, start):
    """smg_env.execute: grasp, suction and ETS scenes in one batch."""
    batch, tree, obs, obs_np = scenes_obs
    actions = [arb.ACTION_GRASP, arb.ACTION_SUCTION, arb.ACTION_ETS,
               arb.ACTION_ETS, arb.ACTION_SUCTION, arb.ACTION_GRASP]
    choice_np = _choices(obs_np, actions, seed=1)
    choice, geom = _jax_geometry(obs, choice_np,
                                 jenv.EnvConfig(is_pe=True, is_oo=True, is_ets=True))
    if start == "touch":
        batch = batch.replace(gripper=_at_suction_touch(batch.gripper, geom))
        tree = to_numpy_tree(batch)
    scenes, outcome = _jax_execute()(_strong(batch), choice, geom)
    want_s, want_o = to_numpy_tree(scenes), to_numpy_tree(outcome)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    pchoice = arb.ActionChoice(**{k: t(v) for k, v in choice_np.items()})
    pgeom = env.Geometry(**{k: t(v) for k, v in to_numpy_tree(geom).items()})
    pscenes, pout = env.execute(bridge.scene_from_numpy(tree), pchoice, pgeom,
                                prim.PrimitiveParams(**PHASES))
    _compare_execute(bridge.scene_to_numpy(pscenes), torch_tree_to_numpy(pout),
                     want_s, want_o, STATE_TOL[start])
    if start == "touch":
        assert want_o["suction_success"].sum() > 0, "no suction capture"


@pytest.mark.parametrize("primitive", ["grasp_first", "suction_first",
                                       "grasp_then_suction"])
def test_primitive_wrappers(scenes_obs, primitive):
    """The reference's three primitive entry points on the settled scenes."""
    batch, tree, obs, obs_np = scenes_obs
    choice_np = _choices(obs_np, [arb.ACTION_ETS] * 6, seed=2)
    _, geom = _jax_geometry(obs, choice_np,
                            jenv.EnvConfig(is_pe=True, is_oo=True, is_ets=True))
    gn = to_numpy_tree(geom)
    jp, pp = jprim.PrimitiveParams(**PHASES), prim.PrimitiveParams(**PHASES)
    jargs = {"grasp_first": ("open_distance", "grasp_position", "grasp_angle"),
             "suction_first": ("suction_position", "suction_angle"),
             "grasp_then_suction": ("open_distance", "grasp_position", "grasp_angle",
                                    "suction_position", "suction_angle")}[primitive]
    jfn = getattr(jprim, primitive)
    scenes, reward = jax.jit(jax.vmap(lambda s, *a: jfn(s, *a, jp)))(
        batch, *(getattr(geom, k) for k in jargs))
    pscenes, preward = getattr(prim, primitive)(
        bridge.scene_from_numpy(tree), *(torch.as_tensor(np.array(gn[k])) for k in jargs),
        pp)
    np.testing.assert_array_equal(preward.numpy(), np.asarray(reward))
    _assert_states(bridge.scene_to_numpy(pscenes), to_numpy_tree(scenes), tol=1e-4)


def test_loop_executor_vmap_vs_batched():
    """One testing act step per executor from the same state: the same
    choices and outcomes, the scenes to atol 1e-6."""
    from smg_tpu_torch.models.affordance import ModelConfig
    from smg_tpu_torch.train import loop
    from smg_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(model=ModelConfig(trunk="tiny", input_size=224)),
                      device="cpu")
    cfg = loop.LoopConfig(env=env.EnvConfig(is_pe=True, is_oo=True, is_testing=True,
                                            settle_steps=20),
                          batch_size=2, reset_settle_steps=5,
                          primitive=prim.PrimitiveParams(**PHASES))
    with pytest.raises(ValueError, match="executor"):
        loop.resolve_executor(dataclasses.replace(cfg, executor="scan"))
    assert loop.resolve_executor(cfg) == "batched"
    out = {}
    for ex in ("vmap", "batched"):
        c = dataclasses.replace(cfg, executor=ex)
        state = loop.init_loop(3, trainer, c)
        state, m = loop.train_step(trainer, c, state)
        out[ex] = (bridge.scene_to_numpy(state.scenes), torch_tree_to_numpy(m))
    (sv, mv), (sb, mb) = out["vmap"], out["batched"]
    for k in ("action", "reward", "grasp_success", "suction_success", "gs_success",
              "episodes_done"):
        np.testing.assert_array_equal(mv[k], mb[k], err_msg=k)
    for k in ("pos", "quat"):
        np.testing.assert_allclose(sv["objects"][k], sb["objects"][k], atol=1e-6, err_msg=k)
