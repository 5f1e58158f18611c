"""Trainer.score_scene_batch's packed scoring (PARITY dev 18), on the CPU
with the tiny trunk: only the valid objects' and pairs' images go to the
eval trunks, packed across scenes into calls of at most
Trainer.image_budget images.

- Scenes with 0, 1, 3 and all 12 valid slots, ETS on and off, R = 1 and
  R = 4: every valid entry equals the module forward of that scene's
  valid slots or pairs scored unpacked, to TOL of the largest valid
  |score| (eval BatchNorm works per image, but on the CPU a call's rows
  round by a few float32 ulps differently with its other rows); the
  entries no consumer reads hold -1e9 (objects) and -100 (pairs), exactly;
  greedy arbitration chooses the same on the packed scores as on scores
  of every slot and pair; no trunk call exceeds the budget.
- A budget below one scene's images splits the scene, its scene images
  repeated in each part, with the same scores; pack_calls' grouping.

The last test is marked `gpu` and skips without a CUDA device: on the
card, score_scene_batch waits for the device once, to read `valid`. This
file imports neither jax nor smg_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_packed_scoring.py
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.physics.state import N_SLOTS
from smg_tpu_torch.policy.arbitrate import ActionChoice, select_action
from smg_tpu_torch.train import trainer as trainer_mod
from smg_tpu_torch.train.trainer import TrainConfig, Trainer
from smg_tpu_torch.utils import profiling

torch.set_num_threads(1)  # one thread per xdist worker

S = 32                     # the tiny trunk at input 32: one feature pixel
VALID_COUNTS = (0, 1, 3, N_SLOTS)
TOL = 1e-5                 # of the largest valid |score|: float32 sums in another order


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    """The fills (-1e9, -100) exact, the scores to TOL of the largest."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    fill = (want == -1e9) | (want == -100.0)
    torch.testing.assert_close(got[fill], want[fill], rtol=0, atol=0)
    if (~fill).any():
        torch.testing.assert_close(got[~fill], want[~fill], rtol=0,
                                   atol=TOL * float(want[~fill].abs().max()))


def _trainer(ets: bool, R: int, chunk: int = 1, device="cpu") -> Trainer:
    t = Trainer(TrainConfig(model=ModelConfig(trunk="tiny", input_size=S, dtype="float32",
                                              num_rotations=R, tied_ets_head=False),
                            is_ets=ets, scene_chunk=chunk), device=device)
    t.init_state(torch.Generator(device=device).manual_seed(5))
    return t


def _scenes(counts=VALID_COUNTS, device="cpu"):
    """(masked depth, masks, valid) of one scene per count, its valid
    slots spread over the 12 (the first scene's masks exist, unused)."""
    g = torch.Generator().manual_seed(2)
    B = len(counts)
    masks = torch.zeros(B, N_SLOTS, S, S, dtype=torch.bool)
    for n in range(N_SLOTS):
        y, x = 1 + (n % 4) * 8, 1 + (n // 4) * 10
        masks[:, n, y:y + 6, x:x + 7] = True
    valid = torch.zeros(B, N_SLOTS, dtype=torch.bool)
    for b, c in enumerate(counts):
        valid[b, torch.randperm(N_SLOTS, generator=g)[:c]] = True
    depth = torch.rand(B, S, S, generator=g) * 0.05 * masks.any(1)
    return depth.to(device), masks.to(device), valid.to(device)


def _unpacked(t: Trainer, depth, masks, valid, every_slot: bool = False):
    """The scores scene by scene through AffordanceNet.score, each
    scene's valid slots and pairs (or every one) in one call, -1e9 and
    -100 elsewhere."""
    net, R = t.model, t.cfg.model.num_rotations
    B = depth.shape[0]
    gra = torch.full((B, N_SLOTS, R), -1e9)
    suc = torch.full((B, N_SLOTS, R), -1e9)
    gs = torch.full((B, N_SLOTS, N_SLOTS), -100.0)
    pi, pj = np.triu_indices(N_SLOTS, k=1)
    for b in range(B):
        v = torch.ones(N_SLOTS, dtype=torch.bool) if every_slot else valid[b]
        scene = t._prep(depth[b:b + 1])
        if v.any():
            objs = t._prep(depth[b:b + 1, None] * masks[b:b + 1, v])
            rot = t._rotated_scenes(scene)
            gra[b, v] = net.score(rot, objs, 0)[0, ..., 0]
            suc[b, v] = net.score(rot, objs, 1)[0, ..., 0]
        ok = (v[pi] & v[pj]).numpy()
        if t.cfg.is_ets and ok.any():
            i, j = pi[ok], pj[ok]
            pairs = t._prep(depth[b:b + 1, None] * (masks[b:b + 1, i] | masks[b:b + 1, j]))
            gs[b, i, j] = net.score(scene, pairs, 2)[0, :, 0]
    if every_slot:
        gra = torch.where(valid[..., None], gra, torch.full_like(gra, -1e9))
        suc = torch.where(valid[..., None], suc, torch.full_like(suc, -1e9))
    return gra, suc, gs


def _scored(t: Trainer, depth, masks, valid):
    """score_scene_batch's scores and the images of each trunk call."""
    profiling.reset()
    profiling.enable()
    try:
        sc = t.score_scene_batch(None, depth, masks, valid)
        calls = [s.counts["trunk_images"] for s in profiling.spans()
                 if s.name == "score_eval"]
        useful = profiling.counters()["trunk_images_useful"]
    finally:
        profiling.enable(False)
        profiling.reset()
    return sc, calls, useful


def _choices_equal(a: ActionChoice, b: ActionChoice) -> None:
    """Actions, targets and rotations the same; the chosen scores to TOL."""
    for f in dataclasses.fields(ActionChoice):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.is_floating_point():
            _close(x, y)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=f.name)


@pytest.mark.parametrize("ets", [True, False])
@pytest.mark.parametrize("R", [1, 4])
def test_packed_scores_are_the_unpacked_scores(ets, R):
    t = _trainer(ets, R)
    depth, masks, valid = _scenes()
    sc, calls, useful = _scored(t, depth, masks, valid)
    want = _unpacked(t, depth, masks, valid)
    for got, w in zip((sc.gra_conf, sc.suc_conf, sc.gs_conf), want):
        _close(got, w)
    # The fills: every invalid object slot, every pair not of two valid
    # objects (and the lower triangle) read nothing but the fill.
    assert bool((sc.gra_conf[~valid] == -1e9).all()) and bool((sc.suc_conf[~valid] == -1e9).all())
    pi, pj = np.triu_indices(N_SLOTS, k=1)
    live = torch.zeros_like(sc.gs_conf, dtype=torch.bool)
    if ets:
        live[:, pi, pj] = valid[:, pi] & valid[:, pj]
    assert bool((sc.gs_conf[~live] == -100.0).all()) and bool((sc.gs_conf[live] > -100).all())
    # Nothing but the useful images is sent; no call exceeds the budget,
    # and the calls are several (scene_chunk 1: one scene's budget).
    n = valid.sum(1)
    need = int((2 * R * (n > 0) + 2 * n).sum())
    if ets:
        p = n * (n - 1) // 2
        need += int(((p > 0) + p).sum())
    assert sum(calls) == useful == need
    assert max(calls) <= t.image_budget and len(calls) > (3 if ets else 2)


@pytest.mark.parametrize("ets", [True, False])
def test_arbitration_chooses_alike_on_packed_and_every_slot_scores(ets):
    t = _trainer(ets, 1)
    depth, masks, valid = _scenes((2, 3, 12, 1, 5))
    packed = t.score_scene_batch(None, depth, masks, valid)
    every = _unpacked(t, depth, masks, valid, every_slot=True)
    _close(packed.gra_conf, every[0])
    if ets:   # every pair scored: pairs with an invalid member read scores
        pi, pj = np.triu_indices(N_SLOTS, k=1)
        assert bool((every[2][:, pi, pj] > -100.0).all())
        assert bool((packed.gs_conf[:, pi, pj] == -100.0).any())
    centers = torch.rand(valid.shape + (2,), generator=torch.Generator().manual_seed(3)) * S
    a, b = (select_action(*scores, valid, centers, is_ets=ets, is_testing=True)
            for scores in ((packed.gra_conf, packed.suc_conf, packed.gs_conf), every))
    _choices_equal(a, b)


def test_a_scene_over_the_budget_is_split(monkeypatch):
    """R = 4 without ETS: 4 + n images a scene. At a budget of 7 the
    12-slot scene is split into four calls of 3 objects, each with the
    scene's 4 rotations; the 3-object scene fits one call."""
    t = _trainer(False, 4)
    depth, masks, valid = _scenes((3, N_SLOTS, 1))
    want, calls_whole, _ = _scored(t, depth, masks, valid)
    monkeypatch.setattr(Trainer, "image_budget", property(lambda self: 7))
    got, calls, useful = _scored(t, depth, masks, valid)
    for k in ("gra_conf", "suc_conf"):
        _close(getattr(got, k), getattr(want, k))
    # Grasp and suction each: [3-object scene], [12-slot scene] x 4, [1 object].
    assert calls == [n for n in (7, 7, 7, 7, 7, 5) for _ in range(2)]
    assert sum(calls) == useful + 3 * 2 * 4
    assert calls_whole == [7, 7, 16, 16, 5, 5]


def test_pack_calls_groups_consecutive_scenes():
    u = lambda n: np.arange(n)[:, None]  # noqa: E731
    units = [(0, u(3)), (2, u(2)), (3, u(9)), (5, u(1))]
    calls = trainer_mod.pack_calls(units, 1, 8)
    assert [[(b, len(x)) for b, x in c] for c in calls] == [
        [(0, 3), (2, 2)], [(3, 7)], [(3, 2), (5, 1)]]
    # Every unit once, in order; the split scene's parts repeat its scene.
    got = [(b, int(i)) for c in calls for b, x in c for i in x[:, 0]]
    assert got == [(b, int(i)) for b, x in units for i in x[:, 0]]
    assert trainer_mod.pack_calls([], 1, 8) == []
    with pytest.raises(ValueError, match="budget"):
        trainer_mod.pack_calls(units, 4, 4)


def _syncs(caught) -> int:
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 4])
def test_scoring_waits_for_the_card_once(R):
    """Under torch.cuda.set_sync_debug_mode("warn"), one score_scene_batch
    (ETS on, several packed calls) warns once: the read of `valid`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: host-device syncs exist only there")
    dev = torch.device("cuda:0")
    t = _trainer(True, R, device=dev)
    depth, masks, valid = _scenes(device=dev)
    with torch.no_grad():
        t.score_scene_batch(None, depth, masks, valid)       # warm: lazy init
    torch.cuda.synchronize()
    counts = []
    for on in (False, True):
        profiling.enable(on)
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with torch.no_grad():
                        t.score_scene_batch(None, depth, masks, valid)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            counts.append(_syncs(w))
        finally:
            profiling.enable(False)
            profiling.reset()
    assert counts == [1, 1], counts
