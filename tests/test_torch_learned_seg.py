"""Parity: the port's learned segmentation front end (perception/nms.py,
perception/learned.py) against the JAX package's, on the CPU, and the
port's learned-mask loop, segmenter trainer and evaluator.

Tolerances:
- NMS: keep masks bit-equal on random boxes and on the quirk cases (slot
  order, not score order; the strict raw-area gate; +1-inclusive IoU);
  IoU to 1e-6.
- SlotSegmenter forward, float32, width 16, input 64: logits within 1e-4
  of the largest |logit| (f32 convolutions summed in other orders).
- One train_step_segmenter (Adam, lr 1e-3): the loss to 1e-4 relative,
  every parameter leaf after the step to 1e-4 relative L2.
- predict_segmentation fed the same logits on both sides (a test-local
  stand-in for the model): every Segmentation field equal. The port's
  min-area-rect angle table is the correctly rounded one and XLA's f32
  cos / sin are not (tests/test_torch_scene_render.py), so this test
  hands the port JAX's table (a test-local patch) to compare the rest.
- The learned-mask loop (port only): two training steps with the tiny
  trunk; the JAX package's own loop test is `slow`.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smg_tpu.perception import learned as jlearned
from smg_tpu.perception import nms as jnms
from smg_tpu_torch import bridge
from smg_tpu_torch.cli import eval_segmenter, train_segmenter
from smg_tpu_torch.envs.primitives import PrimitiveParams
from smg_tpu_torch.envs.smg_env import EnvConfig
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.perception import learned, minrect, nms
from smg_tpu_torch.physics.state import N_SLOTS
from smg_tpu_torch.train.loop import LoopConfig, init_loop, train_step
from smg_tpu_torch.train.trainer import TrainConfig, Trainer

from test_torch_parity_helpers import flat_tree, rel_l2, to_numpy_tree

S = 64           # the forward / train-step parity input
H = 224          # predict_segmentation's frame (its area gate is area / 5)
SHORT = PrimitiveParams(steps_move_above=3, steps_preclose=3, steps_descend=3,
                        steps_squeeze=3, steps_lift=3, steps_pad_align=3,
                        steps_finish=3)


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

_JAX_NMS = jax.jit(jax.vmap(lambda b, v: jnms.nms(b, v, 0.40, 16.0, 10035.2)))


def _random_boxes(rng, B, n=N_SLOTS):
    xy = rng.randint(0, 200, (B, n, 2)).astype(np.float32)
    wh = rng.randint(0, 110, (B, n, 2)).astype(np.float32)
    # Near-duplicates of an earlier slot, so that suppression happens.
    dup = rng.rand(B, n) < 0.3
    src = rng.randint(0, n, (B, n))
    jit = rng.randint(-4, 5, (B, n, 2)).astype(np.float32)
    xy = np.where(dup[..., None], np.take_along_axis(xy, src[..., None], 1) + jit, xy)
    boxes = np.stack([xy, xy + wh], axis=2)
    return boxes, rng.rand(B, n) < 0.85


def _quirk_boxes():
    """One scene per quirk: slot order decides (a small box first suppresses
    a bigger later one); raw area exactly at the gates (4 x 4 = 16 and
    area / 5) is not a candidate; +1-inclusive IoU decides overlap."""
    boxes = np.zeros((3, N_SLOTS, 2, 2), np.float32)
    valid = np.zeros((3, N_SLOTS), bool)
    boxes[0, 0] = [[10, 10], [30, 30]]
    boxes[0, 1] = [[10, 10], [32, 32]]      # IoU(0, 1) = 441/529 > 0.4
    boxes[0, 2] = [[100, 100], [140, 150]]
    valid[0, :3] = True
    boxes[1, 0] = [[0, 0], [4, 4]]          # raw area 16: not > 16
    boxes[1, 1] = [[0, 0], [4, 5]]          # 20 > 16
    boxes[1, 2] = [[0, 0], [112, 89.6]]     # raw area 10035.2: not < area / 5
    valid[1, :3] = True
    boxes[2, 0] = [[0, 0], [9, 9]]
    boxes[2, 1] = [[5, 0], [14, 9]]         # +1 areas: IoU 50/150 = 1/3 < 0.4
    boxes[2, 2] = [[4, 0], [13, 9]]         # 60/140 > 0.4: suppressed by 0
    valid[2, :3] = True
    return boxes, valid


def test_nms_quirks():
    boxes, valid = _quirk_boxes()
    keep = nms.nms(torch.as_tensor(boxes), torch.as_tensor(valid), 0.40, 16.0, 10035.2)
    want = np.asarray(_JAX_NMS(jnp.asarray(boxes), jnp.asarray(valid)))
    np.testing.assert_array_equal(keep.numpy(), want)
    assert keep[0, :3].tolist() == [True, False, True]
    assert keep[1, :3].tolist() == [False, True, False]
    assert keep[2, :3].tolist() == [True, True, False]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_random(seed):
    boxes, valid = _random_boxes(np.random.RandomState(seed), 64)
    keep = nms.nms(torch.as_tensor(boxes), torch.as_tensor(valid), 0.40, 16.0, 10035.2)
    want = np.asarray(_JAX_NMS(jnp.asarray(boxes), jnp.asarray(valid)))
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < want.sum() < valid.sum()
    iou = nms.iou_matrix(torch.as_tensor(boxes)).numpy()
    want_iou = np.asarray(jax.vmap(jnms.iou_matrix)(jnp.asarray(boxes)))
    np.testing.assert_allclose(iou, want_iou, rtol=1e-6, atol=1e-7)
    # Without a gate: the same keep mask as the JAX default arguments.
    got = nms.nms(torch.as_tensor(boxes), torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.vmap(jnms.nms)(jnp.asarray(boxes), jnp.asarray(valid))))


# ---------------------------------------------------------------------------
# SlotSegmenter
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def segmenters():
    """(flax model, params, port model) with the same float32 weights of
    width 16; GroupNorm scales and biases drawn away from identity."""
    cfg = jlearned.SegmenterConfig(width=16, dtype="float32")
    model = jlearned.SlotSegmenter(cfg)
    params = jax.jit(lambda k: model.init(k, jnp.zeros((1, S, S, 4)), False))(
        jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(0)
    params = {k: ({"scale": rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32),
                   "bias": rng.uniform(-0.2, 0.2, v["bias"].shape).astype(np.float32)}
                  if k.startswith("GroupNorm") else
                  {"kernel": np.asarray(v["kernel"]),
                   "bias": rng.uniform(-0.1, 0.1, v["bias"].shape).astype(np.float32)})
              for k, v in to_numpy_tree(params).items()}
    port = learned.SlotSegmenter(learned.SegmenterConfig(width=16, dtype="float32"))
    bridge.load_segmenter_params(port, params)
    return model, jax.tree_util.tree_map(jnp.asarray, params), port


def _seg_batch(seed, B=2):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, S, S, 4).astype(np.float32)
    x[..., 3] *= 0.06
    ids = rng.randint(-1, N_SLOTS, (B, S, S)).astype(np.int32)
    ids[:, :, : S // 2] = -1
    return x, ids


def test_segmenter_forward(segmenters):
    model, params, port = segmenters
    x, _ = _seg_batch(1)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x), False))
    got = port(torch.as_tensor(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, S, S, N_SLOTS + 1)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    # The bridge goes back to the same tree.
    back = flat_tree(bridge.dump_segmenter_params(port))
    for k, v in flat_tree(to_numpy_tree(params)).items():
        np.testing.assert_array_equal(back[k], v)


def test_train_step(segmenters):
    model, params, _ = segmenters
    x, ids = _seg_batch(2)
    tx = optax.adam(1e-3)
    step = jax.jit(lambda p, o, x, i: jlearned.train_step_segmenter(model, p, o, tx, x, i))
    new, _, jloss = step(params, tx.init(params), jnp.asarray(x), jnp.asarray(ids))
    port = learned.SlotSegmenter(learned.SegmenterConfig(width=16, dtype="float32"))
    bridge.load_segmenter_params(port, to_numpy_tree(params))
    opt = learned.new_optimizer(port, 1e-3)
    loss = learned.train_step_segmenter(port, opt, torch.as_tensor(x).permute(0, 3, 1, 2),
                                        torch.as_tensor(ids))
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    got = flat_tree(bridge.dump_segmenter_params(port))
    for k, v in flat_tree(to_numpy_tree(new)).items():
        assert rel_l2(got[k], v, 1e-6) <= 1e-4, k


def test_segmenter_bf16_casts():
    """bf16: convolutions in bf16, GroupNorm and the logits in f32."""
    port = learned.init_segmenter(torch.Generator().manual_seed(0),
                                  learned.SegmenterConfig(width=16), device="cpu")
    x = torch.rand(1, 4, S, S)
    out = port(x)
    assert out.dtype == torch.float32 and out.shape == (1, N_SLOTS + 1, S, S)
    ref = learned.SlotSegmenter(learned.SegmenterConfig(width=16, dtype="float32"))
    ref.load_state_dict(port.state_dict())
    with torch.no_grad():
        err = float((out - ref(x)).abs().max() / ref(x).abs().max())
    assert 0 < err < 0.05


# ---------------------------------------------------------------------------
# predict_segmentation
# ---------------------------------------------------------------------------


def _painted_logits(seed, B=4):
    """Logits of painted slot rectangles, overlapping and of every size:
    one-hot * 4 plus uniform noise below 1 (no ties)."""
    rng = np.random.RandomState(seed)
    ids = np.full((B, H, H), -1, np.int32)
    for b in range(B):
        for s in rng.permutation(N_SLOTS)[: rng.randint(4, N_SLOTS + 1)]:
            y, x = rng.randint(0, 110, 2)
            h, w = rng.randint(2, 150, 2)
            ids[b, y:y + h, x:x + w] = s
    onehot = np.eye(N_SLOTS + 1, dtype=np.float32)[ids + 1]
    return (onehot * 4 + rng.rand(B, H, H, N_SLOTS + 1)).astype(np.float32)


class _Stub:
    def __init__(self, logits):
        self.logits = logits

    def apply(self, _vars, x, _train):
        return self.logits[None]


def test_predict_segmentation_fields(monkeypatch):
    logits = _painted_logits(3)
    zc, zd = jnp.zeros((H, H, 3)), jnp.zeros((H, H))
    want = to_numpy_tree(jax.jit(jax.vmap(
        lambda lg: jlearned.predict_segmentation(_Stub(lg), {}, zc, zd)))(
        jnp.asarray(logits)))
    theta = jnp.arange(minrect.N_ANGLES, dtype=jnp.float32) * (jnp.pi / 2.0 / minrect.N_ANGLES)
    table = tuple(torch.as_tensor(np.array(t)) for t in (theta, jnp.cos(theta), jnp.sin(theta)))
    monkeypatch.setattr(minrect, "_angle_table", lambda device: table)
    lg = torch.as_tensor(logits).permute(0, 3, 1, 2)
    got = learned.predict_segmentation(lambda x: lg, torch.zeros(4, H, H, 3),
                                       torch.zeros(4, H, H))
    for f, w in want.items():
        np.testing.assert_array_equal(getattr(got, f).numpy(), w, err_msg=f)
    # The gate and NMS removed some slots but kept most of them.
    painted = (logits.argmax(-1)[:, None] - 1 == np.arange(N_SLOTS)[:, None, None]).sum((2, 3))
    assert 0 < want["valid"].sum() < (painted >= 16).sum()


def test_perfect_predictions_survive_the_gate():
    """One-hot logits of an exact id buffer keep every visible object (the
    min-area gate fix, PARITY dev 17)."""
    from smg_tpu_torch.envs import smg_env as env

    cfg = EnvConfig(settle_steps=20)
    scenes = env.reset(torch.Generator().manual_seed(43), 2, cfg, "cpu")
    obs = env.observe(scenes)
    _, ids, _ = env.ortho.render_heightmap(scenes.objects)
    logits = torch.nn.functional.one_hot((ids + 1).long(), N_SLOTS + 1).permute(0, 3, 1, 2)
    pred = learned.predict_segmentation(lambda x: 10.0 * logits.float(), obs.color_hm,
                                        obs.depth_hm)
    assert int(obs.seg.valid.sum()) >= 2
    np.testing.assert_array_equal(pred.valid.numpy(), obs.seg.valid.numpy())
    np.testing.assert_array_equal(pred.masks.numpy(), obs.seg.masks.numpy())


# ---------------------------------------------------------------------------
# The loop, the trainer CLI, the evaluator
# ---------------------------------------------------------------------------


def _tiny_trainer():
    return Trainer(TrainConfig(model=ModelConfig(method="reinforcement", trunk="tiny",
                                                 input_size=224), scene_chunk=2),
                   device="cpu")


def test_loop_runs_on_learned_masks():
    seg = learned.init_segmenter(torch.Generator().manual_seed(0),
                                 learned.SegmenterConfig(width=8), device="cpu")
    # A segmenter that finds objects: the oracle of the exact id buffer.
    from smg_tpu_torch.envs import smg_env as env

    class Oracle(torch.nn.Module):
        scenes = None

        def forward(self, x):
            _, ids, _ = env.ortho.render_heightmap(self.scenes.objects)
            return torch.nn.functional.one_hot((ids + 1).long(),
                                               N_SLOTS + 1).permute(0, 3, 1, 2).float()

    trainer = _tiny_trainer()
    oracle = Oracle()
    cfg = LoopConfig(env=EnvConfig(is_pe=True, is_oo=True, settle_steps=20,
                                   segmentation="learned"),
                     batch_size=2, reset_settle_steps=10, primitive=SHORT, segmenter=oracle)
    state = init_loop(0, trainer, cfg)
    numbers = []
    for _ in range(2):
        oracle.scenes = state.scenes
        state, m = train_step(trainer, cfg, state)
        numbers.append(int(m.objects_number.sum()))
    assert torch.isfinite(m.loss) and state.trainer.iteration == 2
    assert numbers[0] > 0
    # The trained segmenter module runs through the same loop.
    cfg = LoopConfig(env=cfg.env, batch_size=2, reset_settle_steps=10, primitive=SHORT,
                     segmenter=seg)
    state, m = train_step(trainer, cfg, state)
    assert torch.isfinite(m.loss)


def test_learned_requires_segmenter():
    trainer = _tiny_trainer()
    cfg = LoopConfig(env=EnvConfig(segmentation="learned", settle_steps=5), batch_size=2,
                     reset_settle_steps=5, primitive=SHORT)
    state = init_loop(0, trainer, cfg)
    with pytest.raises(ValueError, match="segmenter"):
        train_step(trainer, cfg, state)


def test_train_segmenter_and_eval(tmp_path, capsys):
    out = str(tmp_path / "seg.pt")
    small = learned.SegmenterConfig(width=8)
    losses = train_segmenter.train(4, 2, out, settle_steps=10, log_every=1, device="cpu",
                                   cfg=small)
    assert len(losses) == 4 and losses[-1] < losses[0]
    model = learned.load_segmenter(out, "cpu", small)
    for perspective in (False, True):
        res = eval_segmenter.evaluate(model, 2, True, True, 5, 0.005, perspective, "cpu")
        assert res["visible_objects"] > 0
        assert 0.0 <= res["miou"] <= 1.0 and 0.0 <= res["fg_bg_pixel_acc"] <= 1.0
    with pytest.raises(ValueError, match="orbax"):
        learned.load_segmenter(str(tmp_path), "cpu")
    # The entry points with their flags.
    train_segmenter.main(["--steps", "1", "--batch_size", "1", "--cpu", "--out", out])
    eval_segmenter.main(["--checkpoint", out, "--scenes", "1", "--cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["catalog"] == "training" and line["scenes"] == 1


def test_eval_metrics():
    ids = np.full((1, 32, 32), -1, np.int32)
    ids[0, :8, :8] = 0
    ids[0, 10:20, 10:20] = 1
    pred = ids.copy()
    pred[0, 10:20, 10:15] = -1              # slot 1 at IoU 0.5
    pred[0, 25:30, 25:30] = 3               # 25 px where nothing is
    m = eval_segmenter.metrics(ids, pred, N_SLOTS)
    assert m == {"visible_objects": 2, "miou": 0.75, "detection_rate_iou50": 1.0,
                 "false_positive_slots": 1,
                 "fg_bg_pixel_acc": round(1 - 75 / 1024, 4)}
