"""The plain reference against the port's own float32 computation on the
CPU: the affordance scores against the module forward
(`AffordanceNet.score` through `Trainer.score_scene_batch` with
fast_eval "off") at a shallow depth with the benchmark's weights, the
learner update against `Trainer.update` at a shallow depth from the same
weights, the arbitration against `arbitrate.select_action` and the
geometry against `smg_env.compute_geometry`."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from smgbench import traffic, weights
from smgbench.entries import decide, learn
from smgbench.reference import densenet as dn
from smgbench.reference import policy as ref_policy
from smgbench.reference import scores as ref_scores
from smgbench.reference import train as ref_train
from smgbench.tests.helpers import TINY_CATALOG, tiny, tiny_config, tiny_traffic

torch.set_num_threads(1)
HERE = Path(__file__).resolve().parents[1]
CONFIG = json.loads((HERE / "configs" / "densenet121-224.json").read_text())
SPEC = json.loads((HERE / "traffic" / "observations.json").read_text())


def _port_scores(config, sc):
    config = json.loads(json.dumps(config))
    config["model"]["dtype"] = "float32"
    config["train"]["fast_eval"] = "off"
    trainer, _ = decide.build_program(config, "cpu")
    trainer.model.load_state_dict(weights.make(config, 11, "cpu"))
    obs = decide.observation(sc)
    from smg_tpu_torch.envs import smg_env

    s = trainer.score_scene_batch(None, smg_env.masked_scene_depth(obs), sc.masks, sc.valid)
    return s.gra_conf[..., 0], s.suc_conf[..., 0], s.gs_conf


@pytest.mark.parametrize("input_size,heightmap,blocks", [(64, 64, [1, 1, 1, 1]),
                                                         (64, 64, [2, 1, 2, 1]),
                                                         (448, 224, [1, 1, 1, 1])])
def test_scores_match_module_forward(input_size, heightmap, blocks):
    config = tiny_config(CONFIG, input_size)
    config["architecture"]["block_config"] = blocks
    spec = tiny_traffic(SPEC) if heightmap == 64 else dict(
        SPEC, enveloping_count=[0, 2], sucking_count=[0, 2], **TINY_CATALOG)
    sc = traffic.make_pool(spec, 1, 2, 2**31 + 3, "cpu")[0]
    port = _port_scores(config, sc)
    ref = ref_scores.scores(weights.make(config, 11, "cpu"), config, sc.depth, sc.masks,
                            sc.valid, chunk=8)
    N = sc.valid.shape[1]
    ii, jj = torch.triu_indices(N, N, offset=1)
    pair_ok = sc.valid[:, ii] & sc.valid[:, jj]
    for p, r, ok in ((port[0], ref[0], sc.valid), (port[1], ref[1], sc.valid),
                     (port[2][:, ii, jj], ref[2][:, ii, jj], pair_ok)):
        assert bool(ok.any())
        assert not bool(torch.isnan(r[ok]).any()) and bool(torch.isnan(r[~ok]).all())
        torch.testing.assert_close(p[ok], r[ok], rtol=1e-4, atol=1e-4 * float(r[ok].abs().max()))


# The update's tolerance, relative: float32 on both sides, summed in other
# orders. The depth is dithered by 1e-3 so that no image has flat regions:
# a channel constant over an image has a variance of 0, which the port
# takes as E[x^2] - E[x]^2 and the reference about its mean, and the two
# roundings then part by up to 3e-3 in the gradients below it.
UPDATE_RTOL = 2e-4


def _adam(grads, lr, b1, b2, eps):
    """Adam's change of a leaf over len(grads) steps from zero moments."""
    m = v = change = 0.0
    for t, g in enumerate(grads, 1):
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        change = change - lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
    return change


def test_update_matches_trainer_update():
    """Two updates from the same weights on the same batches, float32: the
    loss of each, every leaf's first gradient, the running statistics
    after both, and each side's change against Adam's from its own
    gradients."""
    from smg_tpu_torch.train.trainer import Experience, TrainerState

    cell = json.loads((HERE / "workloads" / "learn.224.b64.json").read_text())
    spec = json.loads((HERE / "traffic" / "experiences.json").read_text())
    cell, config, spec = tiny(cell, CONFIG, spec)
    config["model"]["dtype"] = "float32"
    config["architecture"]["block_config"] = [2, 1, 2, 1]
    cell = dict(cell, batch=6, pool_batches=2)
    gen = torch.Generator().manual_seed(3)
    batches = []
    for ex in learn.experience_pool(spec, cell, 2**31 + 9, "cpu"):
        depth = ex.scene_depth + 1e-3 * torch.rand(ex.scene_depth.shape, generator=gen)
        batches.append((depth, ex.exec_mask, torch.tensor([0, 1, 2, 0, 1, 2]), ex.labels))
    w = weights.make(config, 31, "cpu")
    trainer, _ = decide.build_program(config, "cpu")
    trainer.model.load_state_dict(w)
    named = dict(trainer.model.named_parameters())
    upd = ref_train.Update(w, config)
    state, losses, grads, ref_grads = TrainerState(), [], [], []
    for depth, mask, style, labels in batches:
        exp = Experience(scene_depth=depth, exec_mask=mask, style=style,
                         valid=torch.ones_like(style, dtype=torch.bool))
        state, loss = trainer.update(state, exp, labels)
        ref_loss, ref_g = upd.step(depth, mask, style, labels)
        losses.append((float(loss), ref_loss))
        grads.append({k: p.grad.clone() for k, p in named.items()})
        ref_grads.append(ref_g)
    for mine, ref in losses:
        assert abs(mine - ref) <= UPDATE_RTOL * abs(ref), losses
    med = ref_train.median(ref_train.norms(ref_grads[0]).values())
    for k in named:
        ref = ref_grads[0][k]
        gap = float((grads[0][k] - ref).norm()) / max(float(ref.norm()), med)
        assert gap <= UPDATE_RTOL, (k, gap)
    train = config["train"]
    hyper = (train["learning_rate"], train["adam_b1"], train["adam_b2"], train["adam_eps"])
    for k, p in named.items():
        if float(ref_grads[0][k].norm()) < learn.KEEP * med:
            continue     # a gradient of rounding alone (norm5.bias under the head's BN)
        for change, gs in ((p.detach() - w[k], [g[k] for g in grads]),
                           (upd.w[k].detach() - w[k], [g[k] for g in ref_grads])):
            # a thousandth of a step: Adam's float32 rounding where g is near 0
            torch.testing.assert_close(change, _adam(gs, *hyper), rtol=1e-4, atol=1e-3 * hyper[0])
    buffers = dict(trainer.model.named_buffers())
    ref_stats = {f"{b}.{key}": t for b, mv in upd.running.items()
                 for key, t in zip(("running_mean", "running_var"), mv)}
    moved = 0
    for k, t in ref_stats.items():
        change = t - w[k]
        gap = float((buffers[k] - w[k] - change).norm())
        assert gap <= UPDATE_RTOL * max(float(change.norm()), 1e-6), (k, gap)
        moved += float(change.norm()) > 0
    assert moved >= len(ref_stats) * 2 // 3      # gs_head, unused while tied, keeps its own


def test_rounded_references_depart_in_order():
    """bf16 rounding of every conv's operands departs from float32 less than
    fp8's does."""
    config = tiny_config(CONFIG)
    sc = traffic.make_pool(tiny_traffic(SPEC), 1, 2, 4, "cpu")[0]
    w = weights.make(config, 12, "cpu")
    out = [ref_scores.scores(w, config, sc.depth, sc.masks, sc.valid, 8, rnd)[0][sc.valid]
           for rnd in (None, dn.bf16_rounding, dn.fp8_rounding)]
    e16 = float((out[1] - out[0]).norm())
    e8 = float((out[2] - out[0]).norm())
    assert 0 < e16 < e8 / 3


def _random_scores(gen, B, N, levels=None):
    x = torch.randn((B, N, 1), generator=gen)
    g = torch.randn((B, N, N), generator=gen)
    if levels:
        x, g = (torch.round(t * levels) / levels for t in (x, g))   # ties
    valid = torch.rand((B, N), generator=gen) < 0.5
    valid[:, 0] |= ~valid.any(dim=1)
    return x, x.clone() + torch.randn((B, N, 1), generator=gen), g, valid


@pytest.mark.parametrize("is_ets,levels", [(True, None), (True, 2), (False, None)])
def test_arbitration_matches_select_action(is_ets, levels):
    from smg_tpu_torch.policy import arbitrate as arb

    gen = torch.Generator().manual_seed(7)
    gra, suc, gs, valid = _random_scores(gen, 256, 12, levels)
    neg = torch.full_like(gra, -1e9)
    gra = torch.where(valid[..., None], gra, neg)
    suc = torch.where(valid[..., None], suc, neg)
    centers = torch.randint(0, 224, (256, 12, 2), generator=gen).float()
    port = arb.select_action(gra, suc, gs, valid, centers, is_ets=is_ets, is_testing=True)
    mine = ref_policy.arbitrate(gra.numpy(), suc.numpy(), gs.numpy(), valid.numpy(),
                                "reinforcement", is_ets)
    for name in decide.INTS:
        np.testing.assert_array_equal(mine[name], getattr(port, name).numpy(), err_msg=name)
    assert set(np.unique(mine["action"])) <= ({0, 1, 2} if is_ets else {0, 1})


def test_geometry_matches_compute_geometry():
    from smg_tpu_torch.envs import smg_env
    from smg_tpu_torch.policy import arbitrate as arb

    config = json.loads(json.dumps(CONFIG))
    _, env = decide.build_program(tiny_config(config), "cpu")
    sc = traffic.make_pool(SPEC, 1, 24, 21, "cpu")[0]
    gen = torch.Generator().manual_seed(8)
    gra, suc, gs, _ = _random_scores(gen, 24, 12)
    neg = torch.full_like(gra, -1e9)
    gra = torch.where(sc.valid[..., None], gra, neg)
    suc = torch.where(sc.valid[..., None], suc, neg)
    choice = arb.select_action(gra, suc, gs, sc.valid, sc.centers, is_ets=True, is_testing=True)
    obs = decide.observation(sc)
    port = smg_env.compute_geometry(choice, obs, env)
    geo = ref_policy.Geometry(np.array(SPEC["workspace_m"])[:, 0], SPEC["resolution_m"])
    mine = geo.decide({n: getattr(choice, n).long().numpy()
                       for n in ("action", "grasp_obj", "suction_obj")},
                      sc.centers.double().numpy(), sc.corners.double().numpy(),
                      sc.valid.numpy(), sc.number.numpy(), sc.depth.double().numpy())
    np.testing.assert_allclose(port.grasp_position.numpy(), mine["grasp_position"], atol=2e-6)
    np.testing.assert_allclose(port.suction_position.numpy(), mine["suction_position"], atol=2e-6)
    np.testing.assert_allclose(port.open_distance.numpy(), mine["opening"], atol=2e-6)
    d = np.mod(np.abs(port.grasp_angle.numpy() - mine["grasp_angle"]), math.pi)
    d = np.minimum(d, math.pi - d)
    assert float(np.minimum(d, np.abs(d - math.pi / 2)).max()) < 1e-4
    d = np.mod(np.abs(port.suction_angle.numpy() - mine["suction_angle"]), 2 * math.pi)
    assert float(np.minimum(d, 2 * math.pi - d).max()) < 1e-4
    assert float(np.abs(mine["suction_angle"]).max()) > 0     # OO turned some cup


def test_control_geometry_departs():
    sc = traffic.make_pool(SPEC, 1, 8, 22, "cpu")[0]
    choice = {"action": np.ones(8, np.int64), "grasp_obj": np.zeros(8, np.int64),
              "suction_obj": np.zeros(8, np.int64)}
    args = (choice, sc.centers.double().numpy(), sc.corners.double().numpy(), sc.valid.numpy(),
            sc.number.numpy(), sc.depth.double().numpy())
    origin = np.array(SPEC["workspace_m"])[:, 0]
    exact = ref_policy.Geometry(origin, SPEC["resolution_m"]).decide(*args)
    low = ref_policy.Geometry(origin, SPEC["resolution_m"], q=ref_policy.bf16).decide(*args)
    gap = np.abs(exact["grasp_position"] - low["grasp_position"]).max()
    assert 1e-4 < gap < 0.05
    assert ref_policy.bf16(1.0 + 2**-9) == 1.0 and ref_policy.bf16(1.0 + 3 * 2**-9) == 1.0 + 2**-7
