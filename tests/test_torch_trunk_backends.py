"""Parity: the eval trunk's backends, the module eval forward (the oracle)
and the decision-parity entry point, against the JAX package, on the CPU.

- A shallow trunk (block_config (2, 2, 2, 2), 64 px) through
  trunk_features_eval and score_eval for each backend against JAX's same
  backend in bf16 (Pallas in interpret mode): within 5% of the largest
  output, scores with equal argmax (PARITY dev 12). JAX's `pallas` branch
  reads the module global fast_trunk.BLOCK_CONFIG for its depths
  (fast_trunk.py:383-387): it is patched test-locally.
- AffordanceNet.score (the oracle) against Flax model.apply(train=False,
  method=AffordanceNet.score): 1e-4 of the largest output in float32; 5%
  with equal argmax in bf16.
- The entry point's decision rule, and the entry point on a shallow model
  over rendered scenes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.models import affordance as jaff
from smg_tpu.models import fast_trunk as jft
from smg_tpu_torch.cli import decision_parity as dp
from smg_tpu_torch.models import fast_trunk as tft

from test_torch_parity_helpers import models, score_inputs

SHALLOW = (2, 2, 2, 2)
S, B, M = 64, 2, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small eager ops (the rendering's physics settle above all) slow down
    many-fold when several test workers each run PyTorch's full thread pool;
    this module runs one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shallow(dtype):
    """(flax model, variables, port model, scene, masks) with shallow
    trunks; the Flax patches hold until the module's tests end."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jft, "BLOCK_CONFIG", SHALLOW)
    model, variables, port = models(mp, dtype, SHALLOW, S)
    scene, masks = score_inputs(1, B, M, S)
    return mp, (model, variables, port, scene, masks)


@pytest.fixture(scope="module")
def shallow():
    mp, res = _shallow("bfloat16")
    yield res
    mp.undo()


@pytest.fixture(scope="module")
def shallow_f32():
    mp, res = _shallow("float32")
    yield res
    mp.undo()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("backend", ["xla_fl", "xla_pk", "pallas"])
def test_trunk_backend_matches_jax(shallow, backend):
    _, variables, port, scene, masks = shallow
    x = np.concatenate([scene, masks.reshape((-1,) + masks.shape[2:])])
    p, s = variables["params"], variables["batch_stats"]
    want = jft.trunk_features_eval(p["grasp_trunk"], s["grasp_trunk"], jnp.asarray(x),
                                   interpret=True, backend=backend)
    got = tft.trunk_features_eval(port.grasp_trunk, torch.as_tensor(x), backend)
    assert got.dtype == torch.bfloat16 and got.shape == (x.shape[0], 2, 2, 128)
    assert float(np.asarray(want, np.float32).std()) > 1e-2      # alive at depth
    assert _rel(got.float(), want) < 0.05


@pytest.mark.parametrize("backend", ["xla_pk", "pallas"])
def test_score_backend_matches_jax(shallow, backend):
    _, variables, port, scene, masks = shallow
    want = np.asarray(jft.score_eval(variables["params"], variables["batch_stats"],
                                     jnp.asarray(scene), jnp.asarray(masks), 1,
                                     interpret=True, backend=backend), np.float32)
    got = port.score_eval(torch.as_tensor(scene), torch.as_tensor(masks), 0,
                          backend).numpy()
    assert float(want.std()) > 1e-3
    assert _rel(got, want) < 0.05
    np.testing.assert_array_equal(got[..., 0].argmax(1), want[..., 0].argmax(1))


def _oracle_pair(models_and_inputs, style):
    model, variables, port, scene, masks = models_and_inputs
    want = np.asarray(model.apply(variables, jnp.asarray(scene), jnp.asarray(masks),
                                  style, False, method=jaff.AffordanceNet.score),
                      np.float32)
    got = port.score(torch.as_tensor(scene), torch.as_tensor(masks), style).numpy()
    assert got.shape == want.shape == (B, M, 1) and float(want.std()) > 1e-3
    return got, want


@pytest.mark.parametrize("style", [0, 1, 2])
def test_oracle_matches_flax_float32(shallow_f32, style):
    got, want = _oracle_pair(shallow_f32, style)
    assert _rel(got, want) < 1e-4


def test_oracle_matches_flax_bf16(shallow):
    got, want = _oracle_pair(shallow, 1)
    assert _rel(got, want) < 0.05
    np.testing.assert_array_equal(got[..., 0].argmax(1), want[..., 0].argmax(1))


@pytest.mark.parametrize("backend", ["xla", "xla_conv", "xla_s2d", "fl"])
def test_unported_backends_raise(shallow, backend):
    port, scene = shallow[2], shallow[3]
    with pytest.raises(ValueError):
        tft.trunk_features_eval(port.grasp_trunk, torch.as_tensor(scene), backend)


def test_decision_rule():
    """tests/test_decision_parity.py:163-187 on hand-made scores."""
    ref = torch.tensor([[0.1, 0.5, 0.2], [0.3, 0.31, 0.0]])[..., None]
    valid = torch.tensor([[True, True, True], [True, True, False]])
    ok = dp.check_decisions(ref, ref + 0.004, valid)
    assert ok["ok"] and ok["decided"] == 2 and ok["flips_on_decided"] == 0
    # Scene 1's margin (0.01) is below 2x the error: undecided, so its flip
    # does not count; scene 0 stays decided.
    flip = ref.clone()
    flip[1, 0, 0], flip[1, 1, 0] = 0.31, 0.30
    res = dp.check_decisions(ref, flip, valid)
    assert res["ok"] and res["decided"] == 1 and res["argmax_agree"] == 1
    wrong = ref.clone()
    wrong[0, 0, 0] = 0.9                        # error beyond 0.25 x spread
    assert not dp.check_decisions(ref, wrong, valid)["ok"]
    flat = torch.full_like(ref, 0.2)            # no spread: a vacuous oracle
    assert not dp.check_decisions(flat, flat, valid)["ok"]


def test_decision_tolerance():
    """The rule's 0.25 holds at 224 (and at 64 px) whatever the witness
    reads; at 640 it widens to WITNESS_FACTOR x the witness's ratio, never
    below 0.25."""
    assert dp.tolerance(224, 0.6) == dp.TOL_FRAC == dp.tolerance(S, 0.6)
    assert dp.tolerance(640, 0.6) == pytest.approx(dp.WITNESS_FACTOR * 0.6)
    assert dp.tolerance(640, 0.05) == dp.TOL_FRAC


def _pool_to(depth, s):
    """224 -> s by max-pooling k x k blocks after a crop to s * k
    (tests/test_decision_parity.py:52-59)."""
    k = 224 // s
    crop = depth[..., :s * k, :s * k]
    return crop.reshape(crop.shape[:-2] + (s, k, s, k)).amax(dim=(-3, -1))


def test_decision_parity_entry_point_shallow():
    """The entry point's model, rendering and rule on a shallow trunk at
    64 px (rendered depths max-pooled from 224), every backend and style."""
    model, oracle = dp.make_models(S, seed=0, device="cpu", block_config=SHALLOW)
    assert oracle.grasp_trunk.dtype == torch.float32
    masked, obj_depth, valid = dp.render(4, "cpu", settle_steps=20)
    assert masked.shape == (4, 224, 224) and obj_depth.shape[:2] == valid.shape
    assert bool(valid.any(1).all())
    scene_imgs, mask_imgs = dp.prepare(_pool_to(masked, S), _pool_to(obj_depth, S), S)
    res = dp.evaluate(model, oracle, scene_imgs, mask_imgs, valid)
    assert set(res) == {(b, s) for b in tft.BACKENDS for s in dp.STYLES}
    assert not any(r["witness_bound"] for r in res.values())
    bad = {k: r for k, r in res.items() if not (r["ok"] and r["strict_ok"])}
    assert not bad, bad


def test_decision_parity_snapshot_is_refused():
    """A --snapshot that names no file is refused before any work (the
    entry point loads a run's snapshot since the checkpoints were ported;
    tests/test_torch_cli.py::test_snapshot_carried_to_640 loads one)."""
    with pytest.raises(SystemExit):
        dp.main(["--snapshot", "logs/run/models/snapshot", "--device", "cpu"])
