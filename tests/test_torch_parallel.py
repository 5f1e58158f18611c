"""Data parallelism (smg_tpu_torch/parallel/) on the CPU: gloo process
groups of two ranks against the one-process step, the counterpart of
tests/test_parallel.py's sharded-against-unsharded checks
(tests/test_parallel.py:119-147). Every rendezvous is a FileStore in the
test's tmp_path, so concurrent test workers never share one.

- `dryrun_multichip(2)` (the port of __graft_entry__.dryrun_multichip):
  two sharded training steps, iteration 2, finite losses, valid
  experience in step 2, the replicas' weights equal.
- Two training steps on 2 and on 4 scenes (tiny trunk, float32,
  shortened phases), sharded over 2 ranks against the one-process
  train_step from the same seed: losses to relative 1e-5, every scene's
  actions and rewards equal, the parameters after the updates within
  1e-6 absolute, the running statistics within 1e-6; place_loop_state's
  cut of the whole batch's initial state within 1e-6 of init_loop
  settling the rank's scenes alone. Adam's epsilon is
  1e-3 here (test_torch_parallel_workers.ADAM_EPS says why: at 1e-8 the
  first step moves a weight by lr times the sign of a gradient that may
  be rounding noise; 13 of 6.7 million weights then differ by 2 lr).
- Trainer.update over 2 ranks against the one-process update on the same
  experience, where the ranks hold different numbers of valid scenes (2
  and 1; 2 and 0) and different styles (a BatchNorm that only the other
  rank's scenes touch): the loss to relative 1e-5 (the global valid
  count as the normaliser), the parameters and statistics within 1e-6.
- scene_slice and the draws: a SceneSlice's spawn and epsilon-greedy
  draws are the slice of the whole batch's.
"""

import numpy as np
import pytest
import torch

from smg_tpu_torch.parallel import dryrun, mesh
from smg_tpu_torch.physics import scene as scene_mod
from smg_tpu_torch.physics.state import SceneSlice
from smg_tpu_torch.train.trainer import Trainer, TrainerState

import test_torch_parallel_workers as workers

torch.set_num_threads(1)  # as test_torch_parity_helpers.py: one thread per xdist worker


def _store(tmp_path) -> str:
    return f"file://{tmp_path / 'rendezvous'}"


def test_dryrun_multichip(tmp_path, capfd):
    dryrun.spawn_ranks(dryrun._dryrun_rank, 2, init_method=_store(tmp_path))
    assert "dryrun_multichip ok: world=2 batch=2" in capfd.readouterr().out


@pytest.mark.parametrize("n_scenes", [2, 4])
def test_sharded_steps_match_one_process(tmp_path, n_scenes):
    out = tmp_path / "rank0.pt"
    dryrun.spawn_ranks(workers.steps_worker, 2, str(out), n_scenes, 2,
                       init_method=_store(tmp_path))
    got = torch.load(out)
    train_cfg, loop_cfg = workers.loop_cfgs(n_scenes)
    want = workers.run_steps(Trainer(train_cfg, device="cpu"), loop_cfg, 2)
    assert want["losses"][0] == 0.0 and want["losses"][1] > 0
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert torch.equal(got["actions"], want["actions"])
    assert torch.equal(got["rewards"], want["rewards"])
    torch.testing.assert_close(got["params"], want["params"], atol=1e-6, rtol=0)
    torch.testing.assert_close(got["stats"], want["stats"], atol=1e-6, rtol=0)
    assert got["placed_err"] <= 1e-6, got["placed_err"]


@pytest.mark.parametrize("styles,valid", [
    ((0, 1, 2, 1), (True, True, True, False)),     # 2 and 1 valid scenes
    ((0, 0, 1, 2), (True, False, False, False)),   # 1 and 0; styles split
])
def test_sharded_update_global_normaliser(tmp_path, styles, valid):
    out = tmp_path / "rank0.pt"
    dryrun.spawn_ranks(workers.update_worker, 2, str(out), 5, styles, valid,
                       init_method=_store(tmp_path))
    got = torch.load(out)
    trainer, exp, labels = workers.update_case(5, styles, valid)
    _, loss = trainer.update(TrainerState(0), exp, labels)
    want = workers.update_results(trainer, loss)
    assert want["loss"] > 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    torch.testing.assert_close(got["params"], want["params"], atol=1e-6, rtol=0)
    torch.testing.assert_close(got["stats"], want["stats"], atol=1e-6, rtol=0)


def test_scene_slice_draws():
    """Without a group: rank 0 of 1 holds everything; a SceneSlice's spawn
    is the slice of the whole batch's spawn from the same seed."""
    assert mesh.world() == 1 and mesh.rank() == 0
    assert mesh.scene_slice(4) == SceneSlice(0, 4, 4)
    whole = scene_mod.reset_scene(torch.Generator().manual_seed(3), 4, "cpu",
                                  settle_steps=0)
    part = scene_mod.reset_scene(torch.Generator().manual_seed(3), 4, "cpu",
                                 settle_steps=0, scene_slice=SceneSlice(2, 4, 4))
    for f in ("pos", "quat", "shape_type", "half_extents", "active"):
        assert torch.equal(getattr(part.objects, f), getattr(whole.objects, f)[2:4]), f
    from smg_tpu_torch.policy import arbitrate as arb

    rng = np.random.RandomState(0)
    g = torch.as_tensor(rng.randn(4, 12, 1).astype(np.float32))
    gs = torch.full((4, 12, 12), -100.0)
    valid = torch.ones(4, 12, dtype=torch.bool)
    c = torch.zeros(4, 12, 2)
    kw = dict(is_testing=False, explore_prob=0.5, is_ets=True)
    a = arb.select_action(g, g, gs, valid, c, generator=torch.Generator().manual_seed(1),
                          **kw)
    b = arb.select_action(g[1:3], g[1:3], gs[1:3], valid[1:3], c[1:3],
                          generator=torch.Generator().manual_seed(1),
                          scene_slice=SceneSlice(1, 3, 4), **kw)
    assert torch.equal(a.explored[1:3], b.explored) and torch.equal(a.action[1:3], b.action)
