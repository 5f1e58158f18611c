"""Parity of one testing-mode act step, and the port's import hygiene.

One train_step at B = 4 with env.is_testing=True, a float32 shallow
DenseNet (block_config (2, 2, 2, 2), given to the Flax model through a
test-local monkeypatch of smg_tpu.models.affordance.make_trunk) and ~5-step
primitive phases, against JAX loop.train_step with executor="vmap" (which
the JAX package pins equal to the batched executor). Both sides start from
the same bridged LoopState and weights. Compared: scores (1e-4 of the
largest), the chosen action and its ids, pixels and value, the executed
outcome and reward, the counters and the done flags, and the next scenes
where no episode ended (a finished scene is re-spawned from each side's
own RNG; float states to 1e-5 of each field's scale).

Also: `import smg_tpu_torch` (and its whole act and training path) leaves
jax out of sys.modules.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.envs import primitives as jprim
from smg_tpu.envs import smg_env as jenv
from smg_tpu.models import affordance as jaff
from smg_tpu.train import loop as jloop
from smg_tpu.train import trainer as jtr
from smg_tpu_torch import bridge
from smg_tpu_torch.envs import primitives as prim
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.train import loop
from smg_tpu_torch.train.trainer import TrainConfig, Trainer, TrainerState

from test_torch_parity_helpers import (
    init_flax_all,
    jax_scenes,
    rand_stats,
    shallow_trunk_patch,
    to_numpy_tree,
    torch_tree_to_numpy,
)

B = 4
SHALLOW = (2, 2, 2, 2)
PHASES = dict(steps_move_above=5, steps_preclose=5, steps_descend=5,
              steps_squeeze=5, steps_lift=5, steps_pad_align=5,
              steps_finish=5)


REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def stepped():
    return run_one_step()


def run_one_step():
    """One act step on both sides from the same bridged LoopState."""
    mp = pytest.MonkeyPatch()
    shallow_trunk_patch(mp, SHALLOW, jnp.float32)
    try:
        jcfg_m = jaff.ModelConfig(method="reinforcement", input_size=224,
                                  dtype="float32")
        jtrainer = jtr.Trainer(jtr.TrainConfig(
            model=jcfg_m, method="reinforcement", scene_chunk=B))
        variables = init_flax_all(jtrainer.model, 128, jcfg_m.feature_hw, 0)
        params = variables["params"]
        stats = rand_stats(variables["batch_stats"], 0)
        tstate = jtr.TrainerState(
            params=params, batch_stats=stats, target_params=params,
            target_stats=stats, opt_state=jtrainer.tx.init(params),
            iteration=jnp.asarray(0, jnp.int32))
        ecfg = dict(is_pe=True, is_oo=True, method="reinforcement",
                    is_testing=True)
        jcfg = jloop.LoopConfig(
            env=jenv.EnvConfig(**ecfg), batch_size=B, reset_settle_steps=10,
            primitive=jprim.PrimitiveParams(**PHASES), executor="vmap")
        batch, tree = jax_scenes(B, seed=4, settle_steps=150, is_testing=True)
        jstate = jloop.LoopState(
            scenes=batch, trainer=tstate,
            counters=jloop.EpisodeCounters.zeros(B),
            prev=jloop.blank_prev(B), key=jax.random.PRNGKey(0))

        @jax.jit
        def step_and_scores(st):
            # One compiled program: the step, plus the scores of the same
            # observation (XLA shares the observe and trunk work).
            obs = jax.vmap(jenv.observe)(st.scenes)
            depths = jax.vmap(jenv.masked_scene_depth)(obs)
            scores = jtrainer.score_scene_batch(
                st.trainer, depths, obs.seg.masks, obs.seg.valid)
            return jloop.train_step(jtrainer, jcfg, st), scores, obs, depths

        (jstate2, jmetrics), jscores, jobs, depths = step_and_scores(jstate)
    finally:
        mp.undo()

    ptrainer = Trainer(TrainConfig(
        model=ModelConfig(method="reinforcement", input_size=224,
                          dtype="float32", block_config=SHALLOW),
        method="reinforcement", scene_chunk=B), device="cpu")
    bridge.load_affordance_params(ptrainer.model, to_numpy_tree(params),
                                  to_numpy_tree(stats))
    pcfg = loop.LoopConfig(
        env=env.EnvConfig(**ecfg), batch_size=B, reset_settle_steps=10,
        primitive=prim.PrimitiveParams(**PHASES))
    pstate = loop.LoopState(
        scenes=bridge.scene_from_numpy(tree), trainer=TrainerState(0),
        counters=loop.EpisodeCounters.zeros(B, "cpu"),
        prev=loop.blank_prev(B, "cpu"), generator=torch.Generator())
    pstate2, pmetrics = loop.train_step(ptrainer, pcfg, pstate)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    pscores = ptrainer.score_scene_batch(
        TrainerState(0), t(depths), t(jobs.seg.masks), t(jobs.seg.valid))
    return dict(
        jstate=dict(scenes=to_numpy_tree(jstate2.scenes),
                    counters=to_numpy_tree(jstate2.counters),
                    prev=to_numpy_tree(jstate2.prev)),
        jm=to_numpy_tree(jmetrics),
        jscores=to_numpy_tree(jscores),
        pstate=dict(scenes=bridge.scene_to_numpy(pstate2.scenes),
                    counters=torch_tree_to_numpy(pstate2.counters),
                    prev=torch_tree_to_numpy(pstate2.prev)),
        pm=torch_tree_to_numpy(pmetrics),
        pscores=torch_tree_to_numpy(pscores), pcfg=pcfg, ptrainer=ptrainer,
        pstate0=pstate)


def test_scores(stepped):
    for k in ("gra_conf", "suc_conf"):
        w, g = stepped["jscores"][k], stepped["pscores"][k]
        live = w > -1e8
        assert live.any()
        np.testing.assert_array_equal(g > -1e8, live)
        scale = np.abs(w[live]).max()
        assert np.abs(g[live] - w[live]).max() <= 1e-4 * scale, k


def test_action_and_metrics(stepped):
    jm, pm = stepped["jm"], stepped["pm"]
    for k in ("action", "explored", "best_pix", "objects_number",
              "episodes_done", "episode_iter", "episode_succ",
              "grasp_success", "suction_success", "gs_success", "reward",
              "label_value", "seg_valid0"):
        np.testing.assert_array_equal(pm[k], jm[k], err_msg=k)
    scale = np.abs(jm["predicted_value"]).max()
    np.testing.assert_allclose(pm["predicted_value"], jm["predicted_value"],
                               atol=1e-4 * scale)
    assert float(pm["loss"]) == 0.0


def test_choice_outcome_counters(stepped):
    jp, pp = stepped["jstate"]["prev"], stepped["pstate"]["prev"]
    for k, w in jp["choice"].items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(pp["choice"][k], w,
                                       atol=1e-4 * max(1.0, np.abs(w).max()),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(pp["choice"][k], w, err_msg=k)
    for k in ("suction_success", "grasp_success", "gs_success"):
        np.testing.assert_array_equal(pp["outcome"][k], jp["outcome"][k])
    np.testing.assert_allclose(pp["outcome"]["tip_divergence"],
                               jp["outcome"]["tip_divergence"], atol=1e-5)
    for k in ("style", "valid", "exec_mask"):
        np.testing.assert_array_equal(pp["exp"][k], jp["exp"][k], err_msg=k)
    np.testing.assert_array_equal(pp["objects_number"], jp["objects_number"])
    for k, w in stepped["jstate"]["counters"].items():
        np.testing.assert_array_equal(stepped["pstate"]["counters"][k], w,
                                      err_msg=k)


def test_next_scenes(stepped):
    done = stepped["jm"]["episodes_done"]
    keep = ~done
    assert keep.any(), "every episode ended: nothing to compare"
    want = stepped["jstate"]["scenes"]
    got = stepped["pstate"]["scenes"]
    for part in ("objects", "gripper"):
        for k, w in want[part].items():
            g, w = got[part][k][keep], w[keep]
            if w.dtype.kind == "f":
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, w, atol=1e-5 * scale, err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_array_equal(got["t"][keep], want["t"][keep])
    # Re-spawned scenes: fresh and settled (the port's own RNG).
    assert (got["t"][done] == 10).all()


def test_port_imports_no_jax():
    """Every module of smg_tpu_torch (found by pkgutil.walk_packages, so a
    new module needs no listing), chip_smoke.py's imports, with its
    kernel wrappers, and stage_parity.py's load without jax, flax or
    smg_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import smg_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(smg_tpu_torch.__path__, "
        "'smg_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "chip_smoke.launch_counters()\n"
        "import stage_parity\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flax', 'smg_tpu.')) or m == 'smg_tpu')\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or 'smg_tpu_torch.cli.main' not in mods else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
