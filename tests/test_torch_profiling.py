"""The recorder of smg_tpu_torch/utils/profiling.py: spans and counters,
their two clocks, the trees that Trainer.score_scene_batch and
Trainer.update record, and that recording changes no result.

The last test is marked `gpu` and skips without a CUDA device: on the
card, recording adds no host-device synchronization. This file imports
neither jax nor smg_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_profiling.py
"""

import math
import time
import warnings

import pytest
import torch

from smg_tpu_torch.envs.smg_env import EnvConfig, Observation, compute_geometry
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.perception.segment import Segmentation
from smg_tpu_torch.physics.state import N_SLOTS
from smg_tpu_torch.policy.arbitrate import select_action
from smg_tpu_torch.train.trainer import Experience, TrainConfig, Trainer, TrainerState
from smg_tpu_torch.utils import profiling

torch.set_num_threads(1)  # as test_torch_parity_helpers.py: one thread per xdist worker

S = 32        # the tiny trunk at input 32: one feature pixel
B = 3
CHUNK = 2


@pytest.fixture
def recording():
    """The recorder on and empty; off and empty afterwards."""
    profiling.reset()
    profiling.enable()
    yield
    profiling.enable(False)
    profiling.reset()


def _trainer(device="cpu", seed=0, ets=True) -> Trainer:
    t = Trainer(TrainConfig(model=ModelConfig(trunk="tiny", input_size=S, dtype="float32"),
                            is_ets=ets, scene_chunk=CHUNK), device=device)
    t.init_state(torch.Generator(device=device).manual_seed(seed))
    return t


def _scenes(device="cpu"):
    """(masked depth, masks, valid) of B scenes: 3, 1 and 0 valid objects."""
    g = torch.Generator().manual_seed(1)
    masks = torch.zeros(B, N_SLOTS, S, S, dtype=torch.bool)
    for n in range(N_SLOTS):
        y, x = 2 + (n % 4) * 7, 2 + (n // 4) * 9
        masks[:, n, y:y + 5, x:x + 6] = True
    valid = torch.zeros(B, N_SLOTS, dtype=torch.bool)
    valid[0, :3] = True
    valid[1, 5] = True
    depth = torch.rand(B, S, S, generator=g) * 0.05 * masks.any(1)
    return depth.to(device), masks.to(device), valid.to(device)


def _experience(device="cpu"):
    depth, masks, _ = _scenes(device)
    style = torch.tensor([0, 1, 0], dtype=torch.int32, device=device)
    exp = Experience(scene_depth=depth, exec_mask=masks[:, 0], style=style,
                     valid=torch.ones(B, dtype=torch.bool, device=device))
    return exp, torch.tensor([0.5, 1.0, 0.25], device=device)


def test_off_records_nothing():
    profiling.reset()
    assert not profiling.enabled()
    a, b = profiling.span("a"), profiling.span("b", style=1)
    assert a is b
    with a:
        profiling.count("n", 3)
        profiling.count("n", torch.ones((), dtype=torch.int64))
    assert profiling.spans() == [] and profiling.counters() == {}


def test_spans_nest_with_parents_and_roots(recording):
    with profiling.span("a") as a:
        with profiling.span("b", style=2) as b:
            with profiling.span("c"):
                pass
        with profiling.span("d"):
            pass
    with profiling.span("e") as e:
        pass
    got = [(s.name, s.parent, s.root, s.attrs) for s in profiling.spans()]
    assert got == [("a", None, a.id, {}), ("b", a.id, a.id, {"style": 2}),
                   ("c", b.id, a.id, {}), ("d", a.id, a.id, {}), ("e", None, e.id, {})]
    ids = [s.id for s in profiling.spans()]
    assert len(set(ids)) == len(ids)
    by = {s.id: s for s in profiling.spans()}
    for s in profiling.spans():
        assert s.start_ns <= s.end_ns and s.start_wall_ns <= s.end_wall_ns
        if s.parent is not None:
            p = by[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_tensor_counts_stay_on_the_device_until_read(recording, monkeypatch):
    """A tensor count is summed as a tensor; nothing reads its value until
    `counters()` is asked."""
    def read(*_):
        raise AssertionError("a count was read")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__int__", "__float__", "__bool__", "__index__"):
            m.setattr(torch.Tensor, name, read)
        with profiling.span("a") as a:
            profiling.count("n", torch.tensor(2))
            profiling.count("n", 3)
            profiling.count("n", torch.tensor(4))
            profiling.count("k", 5)
        assert isinstance(a.counts["n"], torch.Tensor) and a.counts["k"] == 5
    assert profiling.counters() == {"n": 9, "k": 5}


def test_a_count_outside_any_span_is_dropped(recording):
    profiling.count("n", 4)
    with profiling.span("a") as a:
        profiling.count("n", 2)
    profiling.count("n", torch.tensor(7))
    assert a.counts == {"n": 2} and profiling.counters() == {"n": 2}


def test_both_clocks_within_a_millisecond(recording):
    """Each edge reads both clocks, in order with reads just outside the
    span on every try; on the best of five tries (a descheduled thread
    on a loaded host spoils one) each edge lies within 1 ms of them."""
    worst = []
    for _ in range(5):
        p0, w0 = time.perf_counter_ns(), time.time_ns()
        with profiling.span("a") as a:
            time.sleep(0.02)
        p1, w1 = time.perf_counter_ns(), time.time_ns()
        assert p0 <= a.start_ns <= a.end_ns <= p1
        assert w0 <= a.start_wall_ns <= a.end_wall_ns <= w1
        assert a.seconds >= 0.02
        worst.append(max(a.start_ns - p0, p1 - a.end_ns, a.start_wall_ns - w0,
                         w1 - a.end_wall_ns))
    assert min(worst) < 1_000_000


def test_scoring_tree_and_image_counts(recording):
    """One score_scene_batch span whose children are the packed trunk
    calls, one score_eval each (grasp and suction per object call, then
    the ETS calls); every image sent to a trunk counted, and the useful
    ones as smgbench/bounds.py counts them."""
    t = _trainer()
    depth, masks, valid = _scenes()
    profiling.reset()
    with torch.no_grad():
        t.score_scene_batch(None, depth, masks, valid)
    spans = profiling.spans()
    root = spans[0]
    assert root.name == "score_scene_batch" and root.parent is None
    assert [(s.name, s.attrs) for s in spans[1:]] == [
        ("score_eval", {"style": 0}), ("score_eval", {"style": 1}),
        ("score_eval", {"style": 2})]
    assert all(s.parent == root.id and s.root == root.id for s in spans[1:])
    # Only the valid objects' and pairs' images are sent: 3 objects 2 + 1
    # + 6 + 3, 1 object 2 + 2, none 0. Grasp and suction each get both
    # scenes' images (1 + 3, 1 + 1) in one call of the image budget
    # (CHUNK (1 + 66) = 134), ETS the first scene's (1 + 3).
    assert profiling.counters() == {"trunk_images": 16, "trunk_images_useful": 16}
    assert root.counts == {"trunk_images_useful": 16}
    assert [s.counts["trunk_images"] for s in spans[1:]] == [6, 6, 4]
    # The images sent, not a formula: five slots and no ETS send the first
    # scene's 1 + 3 a style; the second scene's one object is slot 5.
    t = _trainer(ets=False)
    profiling.reset()
    with torch.no_grad():
        t.score_scene_batch(None, depth, masks[:, :5], valid[:, :5])
    assert profiling.counters() == {"trunk_images": 8, "trunk_images_useful": 8}


def test_update_tree_in_order(recording):
    t = _trainer()
    exp, labels = _experience()
    profiling.reset()
    t.update(TrainerState(), exp, labels)
    got = [(s.name, s.attrs) for s in profiling.spans()]
    assert got == [("update", {}), ("update.forward", {"style": 0}),
                   ("update.forward", {"style": 1}), ("update.backward", {}),
                   ("update.adam", {}), ("update.bn_stats", {})]
    root = profiling.spans()[0]
    assert all(s.parent == root.id for s in profiling.spans()[1:])


def test_results_bitwise_equal_with_the_recorder_on_and_off():
    depth, masks, valid = _scenes()
    exp, labels = _experience()
    out = []
    for on in (False, True):
        profiling.enable(on)
        try:
            t = _trainer()
            with torch.no_grad():
                sc = t.score_scene_batch(None, depth, masks, valid)
            _, loss = t.update(TrainerState(), exp, labels)
            out.append([sc.gra_conf, sc.suc_conf, sc.gs_conf, loss]
                       + [v.detach().clone() for v in t.model.state_dict().values()])
        finally:
            profiling.enable(False)
            profiling.reset()
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _decide(t: Trainer, depth, masks, valid):
    """One greedy decision with PE and OO, as the act step makes it."""
    n = int(valid.shape[1])
    cx = torch.arange(n, device=depth.device, dtype=torch.float32) * 2 + 5
    centers = torch.stack([cx, cx], -1).expand(B, n, 2).contiguous()
    off = torch.tensor([[-2.0, -2.0], [2.0, -2.0], [2.0, 2.0], [-2.0, 2.0]],
                       device=depth.device)
    corners = centers[:, :, None] + off
    seg = Segmentation(masks=masks, valid=valid, number=valid.sum(1).to(torch.int32),
                       boxes=corners[:, :, ::2], centers=centers, box_corners=corners,
                       rect_sizes=torch.full((B, n, 2), 4.0, device=depth.device),
                       rect_angles=torch.zeros(B, n, device=depth.device))
    obs = Observation(depth_hm=depth, color_hm=torch.zeros(B, S, S, 3, device=depth.device),
                      seg=seg)
    sc = t.score_scene_batch(None, depth, masks, valid)
    choice = select_action(sc.gra_conf, sc.suc_conf, sc.gs_conf, valid, centers,
                           is_ets=True, is_testing=True)
    return compute_geometry(choice, obs, EnvConfig(is_testing=True, is_ets=True,
                                                   is_pe=True, is_oo=True))


def _syncs(caught) -> int:
    """The sync-debug warnings among caught ones (the mode's own notice,
    given once, is another)."""
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_recording_adds_no_sync_on_the_card():
    """Under torch.cuda.set_sync_debug_mode("warn"), a decision and an
    update warn as often with the recorder on as off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: host-device syncs exist only there")
    dev = torch.device("cuda:0")
    t = _trainer(dev)
    depth, masks, valid = _scenes(dev)
    exp, labels = _experience(dev)
    with torch.no_grad():
        _decide(t, depth, masks, valid)              # warm: lazy init syncs once
    t.update(TrainerState(), exp, labels)
    torch.cuda.synchronize()
    warned = {}
    for on in (False, True, False, True):
        profiling.enable(on)
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with torch.no_grad():
                        _decide(t, depth, masks, valid)
                    n_decide = _syncs(w)
                    t.update(TrainerState(), exp, labels)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            warned.setdefault(on, []).append((n_decide, _syncs(w) - n_decide))
            torch.cuda.synchronize()
        finally:
            profiling.enable(False)
            profiling.reset()
    assert warned[True] == warned[False], warned
    assert warned[False][0][1] > 0       # the update's own syncs are seen
