"""Parity of the rotation axis (ModelConfig.num_rotations > 1) and the
untied ETS head (tied_ets_head=False) against the JAX package, float32 on
the CPU, and the port's copies of utils/vis.py's helpers.

- rotate_image_nearest at R in {4, 16}, every angle, S = 224 and 64, in
  both of the JAX trainer's forms of the angle (a Python float rounded
  once in scoring, trainer.py:306; the float32 index times 2 pi / R in the
  labels, :597), each against the jitted JAX function: the same pixels
  (at most MAX_ROT_PIXELS differing, counted; ROADMAP §3).
- With shallow float32 DenseNets at input 224 (test_torch_parity_helpers'
  make_trainers, R = 3, the head untied, ETS on): score_scene_batch (every
  rotation of grasp and suction, the ETS pairs of valid objects at
  rotation 0) to 1e-4 of the largest live score, as
  tests/test_torch_loop.py holds R = 1; its
  rotation 0 against an R = 1 port trainer on the same weights;
  dqn_labels with exploit rotations in [0, R) to 1e-4 of the largest
  label; _eval_styled(rotations=) on all three styles and rotations to
  1e-4.
- A training step of the tiny trunk at R = 2 with the head untied:
  (B, N, R) scores, best_pix's rotation columns in [0, R), a finite loss.
- The bridge carries all six parts either way; AffordanceNet.head(2) is
  gs_head when untied, suction_head when tied; decision parity's model
  is tied, and its weights in an untied model score style 2 through
  gs_head; info/config.json records both fields.
- vis: pcwrite's .ply files byte-identical, read_ply, affordance_grid
  and color_difference identical to the JAX module's.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.models import affordance as jaff
from smg_tpu.policy import arbitrate as jarb
from smg_tpu.utils import vis as jvis
from smg_tpu_torch import bridge
from smg_tpu_torch.models import affordance as aff
from smg_tpu_torch.policy import arbitrate as arb
from smg_tpu_torch.train.trainer import TrainerState
from smg_tpu_torch.utils import vis

from test_torch_parity_helpers import (
    TRAIN_S as S,
    jax_trainer_state,
    make_trainers,
    shallow_train_patch,
    to_numpy_tree,
    to_port as _t,
    train_images,
)

R = 3
B = 2
N = 12
MAX_ROT_PIXELS = 4   # differing pixels allowed per rotation set (measured: 0)


# ---------------------------------------------------------------------------
# rotate_image_nearest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [224, 64])
@pytest.mark.parametrize("rotations", [4, 16])
def test_rotate_image_nearest(size, rotations):
    img = np.random.RandomState(size + rotations).rand(rotations, size, size, 3)
    img = img.astype(np.float32)
    idx = np.arange(rotations, dtype=np.int32)

    def labels_form(imgs, rot):     # trainer.py:594-599
        return jax.vmap(lambda im, r: jaff.rotate_image_nearest(
            im, r.astype(jnp.float32) * (2.0 * jnp.pi / rotations)))(imgs, rot)

    def scoring_form(imgs):         # trainer.py:305-310
        return jnp.stack([jaff.rotate_image_nearest(
            imgs[r], jnp.asarray(r * (2.0 * jnp.pi / rotations))) for r in range(rotations)])

    want_l = np.asarray(jax.jit(labels_form)(img, idx))
    want_s = np.asarray(jax.jit(scoring_form)(img))
    got_l = aff.rotate_image_nearest(
        torch.as_tensor(img), aff.rotation_angles(torch.as_tensor(idx), rotations)).numpy()
    got_s = torch.stack([aff.rotate_image_nearest(
        torch.as_tensor(img[r]), r * (2.0 * math.pi / rotations))
        for r in range(rotations)]).numpy()
    for name, got, want in (("labels", got_l, want_l), ("scoring", got_s, want_s)):
        differ = int((got != want).any(-1).sum())
        print(f"S {size}, R {rotations}, {name} form: {differ} pixels differ")
        assert differ <= MAX_ROT_PIXELS, (name, differ)
    # Rotation 0 is the image; a quarter turn of an even grid moves pixels.
    np.testing.assert_array_equal(got_l[0], img[0])
    assert (got_l[rotations // 4] != img[rotations // 4]).any()


# ---------------------------------------------------------------------------
# Scoring, labels and the styled eval at R = 3, head untied
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rot():
    mp = pytest.MonkeyPatch()
    shallow_train_patch(mp)
    yield make_trainers(B=B, unroll="off", is_ets=True, num_rotations=R,
                        tied_ets_head=False)
    mp.undo()


def _scenes(seed, n):
    """n random depth maps with 4 rectangular objects in slots 0-3."""
    rng = np.random.RandomState(seed)
    depth, _ = train_images(seed, n)
    masks = np.zeros((n, N, S, S), bool)
    for b in range(n):
        for k in range(4):
            y, x = rng.randint(20, 160, 2)
            masks[b, k, y:y + 40, x:x + 40] = True
    valid = np.zeros((n, N), bool)
    valid[:, :4] = True
    return depth, masks, valid


def _live_close(got, want, tol=1e-4):
    live = want > -1e8
    assert live.any()
    np.testing.assert_array_equal(got > -1e8, live)
    scale = np.abs(want[live]).max()
    err = np.abs(got[live] - want[live]).max()
    assert err <= tol * scale, (err, scale)
    return err / scale


def test_score_scene_batch(rot):
    jt, params, stats, pt = rot
    assert pt.model.head(2) is pt.model.gs_head
    depth, masks, valid = _scenes(11, B)
    want = to_numpy_tree(jax.jit(jt.score_scene_batch)(
        jax_trainer_state(jt, params, stats), jnp.asarray(depth), jnp.asarray(masks),
        jnp.asarray(valid)))
    got = pt.score_scene_batch(TrainerState(0), _t(depth), _t(masks), _t(valid))
    for k in ("gra_conf", "suc_conf"):
        assert getattr(got, k).shape == (B, N, R)
        print(k, "gap", _live_close(getattr(got, k).numpy(), want[k]))
    # The pairs of valid objects: the port scores only those (PARITY dev 18).
    ii, jj = np.triu_indices(N, k=1)
    pairs = np.zeros((B, N, N), bool)
    pairs[:, ii, jj] = valid[:, ii] & valid[:, jj]
    assert pairs.any() and (want["gs_conf"][pairs] > -100.0).all()
    print("gs_conf gap", _live_close(got.gs_conf.numpy()[pairs], want["gs_conf"][pairs]))
    # Different rotations score differently; rotation 0 is the R = 1 scoring.
    assert np.abs(np.diff(want["gra_conf"][valid], axis=-1)).max() > 1e-3
    one = dataclasses.replace(pt.cfg, model=dataclasses.replace(pt.cfg.model, num_rotations=1))
    pt1 = type(pt)(one, device="cpu")
    pt1.model.load_state_dict(pt.model.state_dict())
    got1 = pt1.score_scene_batch(TrainerState(0), _t(depth), _t(masks), _t(valid))
    for k in ("gra_conf", "suc_conf"):
        _live_close(getattr(got, k)[..., :1].numpy(), getattr(got1, k).numpy(), 1e-6)
    _live_close(got.gs_conf.numpy()[pairs], got1.gs_conf.numpy()[pairs], 1e-6)


_CHOICE_FIELDS = [f.name for f in dataclasses.fields(arb.ActionChoice)]


def _choice(exploit, rng):
    n = len(exploit)
    ids = lambda: np.stack([rng.randint(0, 4, n), rng.randint(0, R, n)], 1)  # noqa: E731
    c = {k: np.zeros(n, np.int32) for k in _CHOICE_FIELDS}
    c.update(action=np.asarray(exploit, np.int32), exploit_action=np.asarray(exploit, np.int32),
             explored=np.zeros(n, bool), best_pix=np.zeros((n, 6), np.int32))
    for k in ("bestg_id", "bests_id", "bestgs_g_id", "bestgs_s_id", "bestgs_pair"):
        c[k] = ids().astype(np.int32)
    for k in ("predicted_value", "bestg_conf", "bests_conf", "bestgs_conf"):
        c[k] = np.zeros(n, np.float32)
    return (jarb.ActionChoice(**{k: jnp.asarray(v) for k, v in c.items()}),
            arb.ActionChoice(**{k: _t(v) for k, v in c.items()}))


def test_dqn_labels_rotated(rot):
    from smg_tpu.envs import smg_env as jenv
    from smg_tpu_torch.envs import smg_env as env

    jt, params, stats, pt = rot
    rng = np.random.RandomState(12)
    n = 6
    exploit = [0, 1, 2, 0, 1, 2]
    j_prev, p_prev = _choice(exploit, rng)
    j_next, p_next = _choice(exploit, rng)
    rew = dict(suction_success=[0, 1, 0, 0, 1, 0], grasp_success=[1, 0, 0, 1, 0, 0],
               gs_success=[0, 0, 0.5, 0, 0, 0.5], tip_divergence=[0] * n)
    rew = {k: np.asarray(v, np.float32) for k, v in rew.items()}
    j_out = jenv.StepOutcome(**{k: jnp.asarray(v) for k, v in rew.items()})
    p_out = env.StepOutcome(**{k: _t(v) for k, v in rew.items()})
    num = np.full(n, 4, np.int32)
    depth, masks, _ = _scenes(13, n)
    want, _ = jax.jit(jt.dqn_labels)(jax_trainer_state(jt, params, stats), j_prev, j_out,
                                     jnp.asarray(num), jnp.asarray(depth), jnp.asarray(masks),
                                     j_next)
    got, _ = pt.dqn_labels(TrainerState(0), p_prev, p_out, _t(num), _t(depth), _t(masks),
                           p_next)
    want, got = np.asarray(want), got.numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # The rotation reaches the label: at rotation 0 the labels move.
    p_zero = dataclasses.replace(p_next, **{k: torch.stack(
        [getattr(p_next, k)[:, 0], torch.zeros_like(getattr(p_next, k)[:, 1])], 1)
        for k in ("bestg_id", "bests_id", "bestgs_g_id")})
    at0, _ = pt.dqn_labels(TrainerState(0), p_prev, p_out, _t(num), _t(depth), _t(masks),
                           p_zero)
    turned = np.asarray(j_next.bestg_id)[:, 1] > 0
    assert np.abs(at0.numpy() - got).max() > 1e-6 and turned.any()


def test_eval_styled_rotations(rot):
    jt, params, stats, pt = rot
    n = 6
    depth, mask = train_images(14, n)
    styles = np.array([0, 1, 2, 2, 1, 0], np.int32)
    rots = np.array([0, 1, 2, 1, 2, 0], np.int32)
    want = np.asarray(jax.jit(jt._eval_styled)(
        params, stats, jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(styles),
        jnp.asarray(rots)))
    got = pt._eval_styled(pt.model, _t(depth), _t(mask), _t(styles), _t(rots)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    plain = pt._eval_styled(pt.model, _t(depth), _t(mask), _t(styles)).numpy()
    np.testing.assert_array_equal(plain[rots == 0], got[rots == 0])
    assert (plain[rots > 0] != got[rots > 0]).all()


# ---------------------------------------------------------------------------
# The port's own: a rotated, untied training step; bridge; config; parity
# ---------------------------------------------------------------------------


def test_train_step_tiny_rotated():
    from smg_tpu_torch.envs.primitives import PrimitiveParams
    from smg_tpu_torch.envs.smg_env import EnvConfig
    from smg_tpu_torch.models.affordance import ModelConfig
    from smg_tpu_torch.train import loop
    from smg_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(
        model=ModelConfig(trunk="tiny", input_size=224, num_rotations=2, tied_ets_head=False),
        is_ets=True), device="cpu")
    short = PrimitiveParams(**{f.name: 3 for f in dataclasses.fields(PrimitiveParams)
                               if f.name.startswith("steps_")})
    cfg = loop.LoopConfig(env=EnvConfig(is_pe=True, is_oo=True, is_ets=True, settle_steps=5),
                          batch_size=2, reset_settle_steps=3, primitive=short)
    state = loop.init_loop(0, trainer, cfg)
    for _ in range(2):
        state, m = loop.train_step(trainer, cfg, state)
        assert bool(((m.best_pix[:, [0, 3]] >= 0) & (m.best_pix[:, [0, 3]] < 2)).all())
        assert torch.isfinite(m.loss)
    scores = trainer.score_scene_batch(state.trainer, torch.zeros(2, 224, 224),
                                       torch.zeros(2, N, 224, 224, dtype=torch.bool),
                                       torch.ones(2, N, dtype=torch.bool))
    assert scores.gra_conf.shape == scores.suc_conf.shape == (2, N, 2)


@pytest.mark.parametrize("tied", [True, False])
def test_bridge_round_trip(tied):
    from smg_tpu_torch.models.affordance import AffordanceNet, ModelConfig

    cfg = ModelConfig(trunk="tiny", input_size=64, tied_ets_head=tied)
    src, dst = AffordanceNet(cfg), AffordanceNet(cfg)
    aff.init_params(src, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in src.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
    params, stats = bridge.dump_affordance_params(src)
    assert set(params) == set(bridge.AFFORDANCE_PARTS)
    bridge.load_affordance_params(dst, params, stats)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    assert dst.head(2) is (dst.suction_head if tied else dst.gs_head)
    assert not torch.equal(src.gs_head.conv0.weight, src.suction_head.conv0.weight)


def test_decision_parity_model_follows_flag():
    from smg_tpu_torch.cli import decision_parity as dp

    tied = dp.make_model(224, device="cpu", block_config=(1, 1, 1, 1), dtype="float32")
    untied = aff.AffordanceNet(dataclasses.replace(tied.cfg, tied_ets_head=False))
    untied.load_state_dict(tied.state_dict())
    assert tied.head(2) is tied.suction_head and untied.head(2) is untied.gs_head
    x = aff.preprocess_depth(torch.rand(3, 224, 224) * 0.06, tied.cfg)
    scene, masks = x[:1], x[None, 1:]
    for style in (0, 1):
        assert torch.equal(tied.score_eval(scene, masks, style),
                           untied.score_eval(scene, masks, style))
    assert not torch.equal(tied.score_eval(scene, masks, 2), untied.score_eval(scene, masks, 2))


def test_config_records_rotation_fields():
    from smg_tpu_torch.utils import config as cfg_mod

    cfg = cfg_mod.parse_args(["--cpu"])
    assert (cfg.to_dict()["train"]["model"]["num_rotations"],
            cfg.to_dict()["train"]["model"]["tied_ets_head"]) == (1, True)
    model = dataclasses.replace(cfg.train.model, num_rotations=16, tied_ets_head=False)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, model=model))
    d = cfg.to_dict()["train"]["model"]
    assert (d["num_rotations"], d["tied_ets_head"]) == (16, False)


# ---------------------------------------------------------------------------
# utils/vis.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("colors", [True, False])
def test_pcwrite_read_ply(tmp_path, colors):
    rng = np.random.RandomState(0)
    xyz = rng.randn(50, 3).astype(np.float32)
    rgb = (rng.rand(50, 3) * 255).astype(np.uint8) if colors else None
    jvis.pcwrite(xyz, str(tmp_path / "want.ply"), rgb)
    vis.pcwrite(xyz, str(tmp_path / "got.ply"), rgb)
    assert (tmp_path / "got.ply").read_bytes() == (tmp_path / "want.ply").read_bytes()
    for a, b in zip(vis.read_ply(str(tmp_path / "got.ply")),
                    jvis.read_ply(str(tmp_path / "want.ply"))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_affordance_grid():
    rng = np.random.RandomState(2)
    maps = rng.rand(16, 32, 32) * 1.2 - 0.1
    imgs = rng.rand(16, 32, 32, 3)
    for best in ((1, 10, 12), (15, 0, 31)):
        got = vis.affordance_grid(maps, imgs, best)
        want = jvis.affordance_grid(maps, imgs, best)
        assert got.shape == (128, 128, 3) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_color_difference():
    rng = np.random.RandomState(3)
    cs = rng.rand(5, 3)
    a = (rng.rand(16, 16, 3) * 255).round()
    b = a.copy()
    b[:8] = (rng.rand(8, 16, 3) * 255).round()
    for x, y in ((a, b), (a, a), (b, a)):
        assert vis.color_difference(x, y, cs) == jvis.color_difference(x, y, cs)
