"""Parity: the port's K1 contact sweep and batched stepper against JAX.

- K1's plain version against contact_pallas.pairwise_forces in interpret
  mode on seeded SoA state (S = 108, T = 145, B = 5: no 128-lane padding
  rule in the port). Tolerance: rtol 1e-5, with an absolute floor of 1e-5
  of the largest force (sums over 145 sources cancel to near zero in some
  rows, and the two sides add in different orders).
- run_steps_batched over 5 and 8 steps on bridged scenes with an attached
  object and a moving gripper (tests/test_physics.py:259-285): states to
  atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.ops import contact_pallas
from smg_tpu.physics import stepper as jstepper
from smg_tpu.physics.state import ATTACHED_GRASP, Gripper as JGripper
from smg_tpu_torch import bridge
from smg_tpu_torch.ops import contact
from smg_tpu_torch.physics import stepper
from smg_tpu_torch.physics.state import Gripper

from test_torch_parity_helpers import jax_scenes, run_both, to_numpy_tree

GAINS = dict(kn=800.0, zeta=0.6, share=4.0, mu=0.8, mu_grip=0.6,
             v_eps=0.01, max_pen=0.006, max_vn=0.5)


def _soa_case(seed, S=108, G=37, B=5, K=9):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.uniform(*s).astype(np.float32)  # noqa: E731
    pos = [f(0.0, 0.06, (S, B)) for _ in range(3)]
    vel = [f(-0.3, 0.3, (S, B)) for _ in range(3)]
    rad = f(0.006, 0.02, (S, B))
    mass = np.repeat(f(0.02, 0.1, (S // K, B)), K, axis=0)
    live = np.repeat((rng.rand(S // K, B) > 0.2).astype(np.float32), K, 0)
    recv = live * (rng.rand(S, B) > 0.1)
    gpos = [f(0.0, 0.06, (G, B)) for _ in range(3)]
    gvel = [f(-1.0, 1.0, (G, B)) for _ in range(3)]
    grad = np.concatenate([[0.0489], np.full(G - 1, 0.0095)]).astype(np.float32)
    ones = np.ones((G, B), np.float32)
    rows = (*pos, *vel, rad, mass, recv.astype(np.float32))
    cols = tuple(np.concatenate([a, b]) for a, b in zip(
        (*pos, *vel, rad, mass, live),
        (*gpos, *gvel, grad[:, None] * ones, ones, ones)))
    return rows, cols


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_forces_plain_matches_pallas(seed):
    rows, cols = _soa_case(seed)
    want, got = run_both(
        lambda *a: jnp.stack(contact_pallas.pairwise_forces(
            a[:9], a[9:], 9, interpret=True, **GAINS)),
        lambda *a: torch.stack(contact.pairwise_forces(a[:9], a[9:], 9, **GAINS)),
        *rows, *cols)
    fmax = float(np.abs(want).max())
    assert fmax > 1.0  # the case has real contacts
    assert got.shape == want.shape == (3, 108, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * fmax)


@pytest.fixture(scope="module")
def attached_case():
    batch, _ = jax_scenes(4, seed=3)
    obj = jax.vmap(lambda o, g: jstepper.attach(
        o, g, jnp.arange(12) == 0, jnp.asarray(ATTACHED_GRASP)))(
            batch.objects, batch.gripper)
    batch = batch.replace(objects=obj)
    tgt = jax.vmap(lambda g: JGripper(
        pos=g.pos + jnp.array([0.05, -0.03, 0.02]), yaw=g.yaw + 0.4,
        tilt=g.tilt, curl=g.curl + 0.3))(batch.gripper)
    return batch, tgt


@pytest.mark.parametrize("n_steps", [5, 8])
def test_run_steps_batched_matches_jax(attached_case, n_steps):
    batch, tgt = attached_case
    want = to_numpy_tree(
        jstepper.run_steps_batched(batch, tgt, n_steps, interpret=True))
    scenes = bridge.scene_from_numpy(to_numpy_tree(batch))
    t = to_numpy_tree(tgt)
    target = Gripper(**{k: bridge.to_tensor(v) for k, v in t.items()})
    got = bridge.scene_to_numpy(
        stepper.run_steps_batched(scenes, target, n_steps))
    for name in ("pos", "quat", "vel", "omega"):
        np.testing.assert_allclose(got["objects"][name],
                                   want["objects"][name], atol=1e-6,
                                   err_msg=name)
    for name in ("pos", "yaw", "tilt", "curl"):
        np.testing.assert_allclose(got["gripper"][name],
                                   want["gripper"][name], atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(got["t"], want["t"])
