"""The port's checkpoints and snapshot (smg_tpu_torch/train/checkpoints.py).

- A JAX TrainerState (online and target params + batch_stats, optax's
  Adam count / mu / nu, the iteration) crosses bridge.load_trainer_state
  into a port Trainer, a checkpoint save and restore into a fresh Trainer,
  and bridge.trainer_state_to_numpy: every array comes back bit for bit.
- A restored trainer's next Adam step equals the original's, bit for bit.
- The snapshot restores params and BatchNorm running statistics into the
  online and the target net.
- CheckpointManager's cadence, pruning and atomic writes.

Shallow trunks (one layer per block) at input 64 keep the JAX init's
compile short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smg_tpu_torch import bridge
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.train import checkpoints
from smg_tpu_torch.train.trainer import TrainConfig, Trainer, TrainerState

from test_torch_parity_helpers import (flat_tree, init_flax_all, rand_stats,
                                       shallow_trunk_patch, to_numpy_tree)

BLOCKS = (1, 1, 1, 1)
SIZE = 64
C_FINAL = 68      # 64 + 32 -> 48, 80 -> 40, 72 -> 36, 68


def port_trainer(seed=None) -> Trainer:
    t = Trainer(TrainConfig(model=ModelConfig(input_size=SIZE, dtype="float32",
                                              block_config=BLOCKS)), device="cpu")
    if seed is not None:
        t.init_state(torch.Generator().manual_seed(seed))
    return t


@pytest.fixture(scope="module")
def jax_tree():
    """A JAX TrainerState as load_trainer_state's numpy tree, with a target
    net and Adam moments of their own."""
    from smg_tpu.models import affordance as jaff

    with pytest.MonkeyPatch.context() as mp:
        shallow_trunk_patch(mp, BLOCKS, jnp.float32)
        jm = jaff.ModelConfig(method="reinforcement", input_size=SIZE, dtype="float32")
        variables = init_flax_all(jaff.AffordanceNet(jm), C_FINAL, jm.feature_hw, 0)
    params = variables["params"]
    rng = np.random.RandomState(3)
    tx = optax.adam(1e-4)
    opt = tx.init(params)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), params)
        upd, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
    target = jax.tree_util.tree_map(lambda a: 0.5 * a + 0.1, variables["params"])
    return to_numpy_tree({
        "params": params, "batch_stats": rand_stats(variables["batch_stats"], 0),
        "target_params": target,
        "target_stats": rand_stats(variables["batch_stats"], 1),
        "adam": {"count": opt[0].count, "mu": opt[0].mu, "nu": opt[0].nu},
        "iteration": jnp.asarray(7, jnp.int32)})


def test_trainer_state_round_trip(jax_tree, tmp_path):
    pt = port_trainer()
    state = bridge.load_trainer_state(pt, jax_tree)
    mgr = checkpoints.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, pt, state)
    fresh = port_trainer(seed=11)
    restored = mgr.restore(fresh)
    assert restored.iteration == 7
    got = bridge.trainer_state_to_numpy(fresh, restored)
    assert int(got["adam"]["count"]) == int(jax_tree["adam"]["count"]) == 2
    assert int(got["iteration"]) == 7
    for key in ("params", "batch_stats", "target_params", "target_stats"):
        want, have = flat_tree(jax_tree[key]), flat_tree(got[key])
        assert want.keys() == have.keys(), key
        for k in want:
            np.testing.assert_array_equal(have[k], want[k], err_msg=f"{key} {k}")
    for key in ("mu", "nu"):
        want, have = flat_tree(jax_tree["adam"][key]), flat_tree(got["adam"][key])
        assert want.keys() == have.keys(), key
        for k in want:
            np.testing.assert_array_equal(have[k], want[k], err_msg=f"adam {key} {k}")


def _adam_steps(trainer: Trainer, seed: int, n: int) -> None:
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        for p in trainer.model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        trainer.opt.step()


def test_restored_adam_continues_bitwise(tmp_path):
    a = port_trainer(seed=1)
    _adam_steps(a, 5, 2)
    mgr = checkpoints.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, a, TrainerState(iteration=2))
    b = port_trainer(seed=2)
    assert mgr.restore(b).iteration == 2
    _adam_steps(a, 9, 1)
    _adam_steps(b, 9, 1)
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name


def _scramble_stats(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=g) - 0.5)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)


def test_snapshot_restores_params_and_stats(tmp_path):
    src = port_trainer(seed=4)
    _scramble_stats(src.model, 4)
    path = str(tmp_path / "models" / "snapshot")
    (tmp_path / "models").mkdir()
    checkpoints.save_params(path, src.model)
    dst = port_trainer(seed=5)
    checkpoints.load_snapshot(dst, path)
    want = src.model.state_dict()
    assert any("running_var" in k for k in want)
    for net in (dst.model, dst.target):
        for name, t in net.state_dict().items():
            assert torch.equal(t, want[name]), name


def test_manager_cadence_pruning_and_atomicity(tmp_path):
    t = port_trainer(seed=6)
    mgr = checkpoints.CheckpointManager(str(tmp_path / "ckpt"), save_every=2,
                                        max_to_keep=2)
    assert mgr.latest_step() is None
    saved = [s for s in range(1, 8) if mgr.maybe_save(s, t, TrainerState(s))]
    assert saved == [2, 4, 6]
    assert mgr.steps() == [4, 6]
    # A write cut short leaves only its temporary name: never the latest.
    (tmp_path / "ckpt" / ".8.pt.tmp").write_bytes(b"partial")
    assert mgr.latest_step() == 6
    assert mgr.restore(port_trainer()).iteration == 6
    with pytest.raises(FileNotFoundError):
        checkpoints.CheckpointManager(str(tmp_path / "empty")).restore(t)
