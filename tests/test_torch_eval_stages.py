"""The eval path stage by stage, TrainConfig.fast_eval and the stem's gray
tap, on the CPU.

- TrainConfig.fast_eval (trainer.py:69, :505-515): "off" scores through
  the module forward (AffordanceNet.score) bit for bit, "on" and "auto"
  through fast_trunk.score_eval, in score_scene_batch (act step, ETS
  pairs included) and in the labels' _eval_styled.
- The gray tap: the fast stem convolves channel 0 with conv0's kernel
  summed over its input channels, exact only when the three input
  channels are equal; they are, bit for bit, on the trainer's real inputs
  (_prep of rendered scenes, masks and ETS pairs; _rotated_scenes).
- stage_parity.py's comparison at a shallow depth: its step-by-step
  module forward is the module forward bit for bit, and its stage list,
  output keys, dump and arbitration counts.

Run as a script on a dump of stage_parity.py (`PYTHONPATH=. python
tests/test_torch_eval_stages.py DUMP.npz [--out FILE]`), it compares the JAX package's
fast eval path (backend "xla_conv") and Flax module forward with the
port's, stage by stage, on the dumped weights and inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import stage_parity as sp
from smg_tpu_torch.cli import decision_parity as dp
from smg_tpu_torch.envs import smg_env
from smg_tpu_torch.models import affordance as aff
from smg_tpu_torch.models import fast_trunk as tft
from smg_tpu_torch.physics.state import N_SLOTS
from smg_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

SHALLOW = (1, 1, 1, 1)
# JAX's K2 kernel runs whole 128-channel groups: two layers a block.
PKG_SHALLOW = (2, 2, 2, 2)


def _trainer(fast_eval: str, trunk: str = "densenet121", num_rotations: int = 1) -> Trainer:
    """A shallow float32 trainer (bf16 convolutions are slow on the CPU;
    the routing does not depend on the dtype)."""
    model = aff.ModelConfig(method="reinforcement", trunk=trunk, input_size=224,
                            num_rotations=num_rotations, block_config=SHALLOW,
                            dtype="float32")
    trainer = Trainer(TrainConfig(model=model, is_ets=True, fast_eval=fast_eval), "cpu")
    if trunk == "densenet121":
        trainer.model.load_state_dict(dp.make_model(224, seed=3, device="cpu",
                                                    block_config=SHALLOW).state_dict())
    return trainer


def _scene_batch(C: int = 2, seed: int = 0):
    """Random heightmaps with blob masks: depth (C, 224, 224), masks
    (C, N, 224, 224) bool, valid (C, N)."""
    rng = np.random.RandomState(seed)
    depth = torch.as_tensor(rng.rand(C, 224, 224).astype(np.float32) * 0.06)
    yy, xx = np.mgrid[:224, :224]
    masks = np.zeros((C, N_SLOTS, 224, 224), bool)
    valid = np.zeros((C, N_SLOTS), bool)
    for c in range(C):
        for n in range(3 + c):
            cy, cx = rng.randint(30, 194, 2)
            masks[c, n] = (yy - cy) ** 2 + (xx - cx) ** 2 < 15 ** 2
            valid[c, n] = True
    return depth, torch.as_tensor(masks), torch.as_tensor(valid)


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
def test_fast_eval_routes_scoring(mode):
    trainer = _trainer(mode)
    net = trainer.model
    depth, masks, valid = _scene_batch(1)
    got = trainer.score_scene_batch(None, depth, masks, valid)
    fn = net.score if mode == "off" else net.score_eval
    scene = trainer._prep(depth)
    want_g = fn(scene[:, None], trainer._prep(depth[:, None] * masks), 0)[..., 0]
    # The one scene's valid objects and pairs as one unpacked call: the
    # images the packed call gets, so every route's rows are exact. Only
    # the module forward's rows do not depend on the call's other rows
    # (the plain head_eval's matmuls move by an ulp with the row count).
    v = valid[0]
    objs = trainer._prep(depth[:, None] * masks[:, v])
    for style, conf in ((0, got.gra_conf), (1, got.suc_conf)):
        torch.testing.assert_close(conf[valid], fn(scene[:, None], objs, style)[0, :, 0],
                                   rtol=0, atol=0)
        assert bool((conf[~valid] == -1e9).all())
    if mode == "off":
        torch.testing.assert_close(got.gra_conf[valid], want_g[valid], rtol=0, atol=0)
    pi, pj = np.triu_indices(N_SLOTS, k=1)
    pair_ok = (valid[:, pi] & valid[:, pj])[0]
    pi, pj = pi[pair_ok.numpy()], pj[pair_ok.numpy()]
    pairs = trainer._prep(depth[:, None] * (masks[:, pi] | masks[:, pj]))
    torch.testing.assert_close(got.gs_conf[:, pi, pj], fn(scene, pairs, 2)[..., 0],
                               rtol=0, atol=0)
    live = torch.zeros_like(got.gs_conf, dtype=torch.bool)
    live[0, pi, pj] = True
    assert len(pi) == 3 and bool((got.gs_conf[~live] == -100.0).all())
    # The labels' target scoring, one style per scene.
    depth, masks, valid = _scene_batch(2)
    styles = torch.tensor([0, 2])
    ex = masks[:, 0]
    out = trainer._eval_styled(net, depth, ex, styles)
    for i, s in enumerate(styles.tolist()):
        one = fn(trainer._prep(depth[i:i + 1]), trainer._prep(depth[i:i + 1] * ex[i:i + 1])[:, None], s)
        assert float(out[i]) == float(one[0, 0, 0])
    # The two routes are not the same function: the switch is live.
    other = (net.score_eval if mode == "off" else net.score)(
        scene[:1], trainer._prep(depth[:1, None] * masks[:1]), 0)
    assert not torch.equal(other[..., 0], want_g[:, :, 0])


def test_fast_eval_resolution():
    assert _trainer("auto").use_fast_eval and _trainer("on").use_fast_eval
    assert not _trainer("off").use_fast_eval
    tiny = _trainer("auto", trunk="tiny")
    assert not tiny.use_fast_eval
    with pytest.raises(ValueError, match="fast_eval"):
        _ = _trainer("fast").use_fast_eval
    # "on" with the tiny trunk asks for kernels that run DenseNet-121 only.
    depth, masks, valid = _scene_batch(1)
    with pytest.raises(TypeError, match="DenseNet-121"):
        _trainer("on", trunk="tiny").score_scene_batch(None, depth, masks, valid)


def _channels_equal(x: torch.Tensor) -> bool:
    return torch.equal(x[..., 0], x[..., 1]) and torch.equal(x[..., 0], x[..., 2])


@pytest.mark.parametrize("input_size", [224, 640])
def test_gray_tap_inputs_are_triplicated(input_size):
    """Every trunk input the trainer makes from rendered scenes has three
    equal channels, so the fast stem's gray tap computes conv0 exactly up
    to the rounding of the summed kernel."""
    cfg = smg_env.EnvConfig(is_testing=True, is_ets=True, settle_steps=20)
    obs = smg_env.observe(smg_env.reset(torch.Generator().manual_seed(5), 2, cfg, "cpu"))
    depth, masks = smg_env.masked_scene_depth(obs), obs.seg.masks
    assert bool(obs.seg.valid.any())
    model = aff.ModelConfig(input_size=input_size, num_rotations=4, block_config=SHALLOW)
    trainer = Trainer(TrainConfig(model=model, is_ets=True), "cpu")
    pi, pj = np.triu_indices(N_SLOTS, k=1)
    scene = trainer._prep(depth)
    streams = {"scene": scene, "masks": trainer._prep(depth[:, None] * masks),
               "pairs": trainer._prep(depth[:, None] * (masks[:, pi] | masks[:, pj])),
               "rotated": trainer._rotated_scenes(scene)}
    assert streams["rotated"].shape == (2, 4, input_size, input_size, 3)
    for name, x in streams.items():
        assert float(x[..., 0].std()) > 0.1, name
        assert _channels_equal(x), name
    # The gray tap against the full conv0 in float64 on one real image.
    w = torch.randn(64, 3, 7, 7, generator=torch.Generator().manual_seed(0))
    x = streams["rotated"][:1, 1].permute(0, 3, 1, 2)
    full = torch.nn.functional.conv2d(x.double(), w.double(), stride=2, padding=3)
    gray = torch.nn.functional.conv2d(x[:, :1].double(), w.double().sum(1, keepdim=True),
                                      stride=2, padding=3)
    torch.testing.assert_close(gray, full, rtol=1e-12, atol=1e-9)


# ---------------------------------------------------------------------------
# stage_parity.py at a shallow depth
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shallow_models():
    model, oracle = dp.make_models(224, seed=0, device="cpu", block_config=SHALLOW)
    depth, masks, valid = _scene_batch(1, seed=4)
    obj = depth[:, None] * masks[:, :4]
    scene_imgs, mask_imgs = dp.prepare(depth, obj, 224)
    return model, oracle, scene_imgs, mask_imgs, valid[:, :4]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_module_stages_are_the_module_forward(shallow_models, dtype):
    model = shallow_models[0] if dtype == "bfloat16" else shallow_models[1]
    scene, masks = shallow_models[2], shallow_models[3]
    seen = []
    with torch.no_grad():
        got = sp.module_score(model, scene, masks, 1, lambda k, t: seen.append(k))
        want = model.score(scene, masks, 1)
    assert torch.equal(got, want)
    names = sp.stage_names(SHALLOW)
    assert [k for k in seen if ".layer" not in k] == names[:-1]
    assert [k for k in seen if ".layer" in k] == [f"block{i}.layer1" for i in range(1, 5)]


def test_stage_parity_probe(shallow_models, tmp_path):
    model, oracle, scene, masks, valid = shallow_models
    out = sp.probe(model, oracle, scene, masks, valid, [0, 2], source="shallow")
    assert set(out) == {"source", "input_size", "scenes", "images", "device", "styles",
                        "reproduced"}
    assert out["images"] == 5 and out["device"] == "cpu"
    for s in ("0", "2"):
        r = out["styles"][s]
        assert list(r["stages"]) == sp.stage_names(SHALLOW)
        for k, row in r["stages"].items():
            want = {sp.BF16, *sp.BACKENDS}
            if k.startswith("block"):
                want.discard("pallas")      # K7 keeps a block's output inside
            assert set(row) == want, k
            for e in row.values():
                assert set(e) == {"max_abs", "rel_l2"} and np.isfinite(e["rel_l2"])
        assert set(r["layers"]) == {f"block{i}.layer1" for i in range(1, 5)}
        assert set(r["scores"]) == {sp.BF16, *sp.BACKENDS}
        assert set(r["ratio"]) == set(sp.BACKENDS)
        assert r["bn"]["block3.layer1"]["norm2"]["min_var"] > 0
        assert r["departing"] in (None, *sp.stage_names(SHALLOW))
    size = sp.dump(model, 2, scene, masks, valid, str(tmp_path / "d.npz"), {"source": "shallow"})
    with np.load(tmp_path / "d.npz") as z:
        meta = z["meta"].item()
        assert '"trunk_key": "gs_trunk"' in meta and '"head_key": "suction_head"' in meta
        assert z["inputs/masks"].shape == (1, 4, 224, 224)
        assert z["params/gs_trunk/conv0/kernel"].shape == (7, 7, 3, 64)
        assert z["batch_stats/suction_head/norm0/var"].dtype == np.float32
    assert size > 0


def test_stage_parity_arbitration():
    res = sp.arbitration("", 1, "cpu", block_config=SHALLOW, settle_steps=20)
    assert res["scenes"] == 1
    for path in ("fast_xla_fl", sp.BF16, sp.REF):
        r = res[path]
        assert abs(sum(r["shares"].values()) - 1.0) < 1e-6
        assert 0 <= r["action_flips"] <= 1 and 0 <= r["target_flips"] <= 1
    assert res[sp.REF]["action_flips"] == 0 and res[sp.REF]["target_flips"] == 0


# ---------------------------------------------------------------------------
# The port against the JAX package, stage by stage, on one style's weights
# ---------------------------------------------------------------------------

GROUP = 128


def load_dump(path: str) -> dict:
    """A stage_parity.py dump: {"params", "batch_stats"} nested numpy
    trees of the style's trunk and head, the inputs rebuilt to three
    channels, and "meta"."""
    import json

    tree = {"params": {}, "batch_stats": {}}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith(("params/", "batch_stats/")):
                parts = key.split("/")
                node = tree[parts[0]]
                for p in parts[1:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = z[key]
        tree["scene"] = np.repeat(z["inputs/scene"][..., None], 3, -1)
        tree["masks"] = np.repeat(z["inputs/masks"][..., None], 3, -1)
        tree["valid"] = z["inputs/valid"]
        tree["meta"] = json.loads(z["meta"].item())
    return tree


def block_config_of(tp: dict) -> tuple:
    n = sum(1 for k in tp if k.startswith("denseblock"))
    return tuple(len(tp[f"denseblock{i + 1}"]) for i in range(n))


def jax_fast_stages(tp, ts, hp, hs, x, B: int, conv2: str = "conv"):
    """smg_tpu.models.fast_trunk's eval path (trunk_features_eval's xla
    branch, :356-381, then score_eval's pairing and head_eval, :966-1014)
    composed of its own functions, with every stage kept: {stage: array}.
    The block loop is _dense_block_xla_segs' generic one (:262-276), which
    "xla_conv" runs, with each layer's new channels kept."""
    import jax.numpy as jnp
    from smg_tpu.models import fast_trunk as jft

    out = {}
    y = jft._stem(tp, ts, x, conv2)
    out["stem"] = y
    segs = [y]
    bc = block_config_of(tp)
    for i in range(len(bc)):
        segs, layers = _jax_block(tp[f"denseblock{i + 1}"], ts[f"denseblock{i + 1}"], segs, conv2)
        for l, new in enumerate(layers):
            out[f"block{i + 1}.layer{l + 1}"] = new
        out[f"block{i + 1}"] = jnp.concatenate(segs, -1)
        if i < len(bc) - 1:
            segs = jft._transition_xla(tp[f"transition{i + 1}"], ts[f"transition{i + 1}"],
                                       segs, conv2)
            out[f"transition{i + 1}"] = jnp.concatenate(segs, -1)
    a, b = jft._bn(tp["norm5"], ts["norm5"])
    feats = (jnp.concatenate(segs, -1).astype(jnp.float32) * a + b).astype(jnp.bfloat16)
    out["norm5"] = feats
    both = _pairs_jax(feats, B)
    a0, b0 = jft._bn(hp["norm0"], hs["norm0"])
    h = jnp.maximum(both.astype(jnp.float32) * a0 + b0, 0.0).astype(jnp.bfloat16)
    out["head.norm0"] = h
    k0 = hp["conv0"]["kernel"]
    h = jnp.dot(h.reshape(-1, k0.shape[2]), k0.reshape(k0.shape[2], 64).astype(jnp.bfloat16),
                preferred_element_type=jnp.float32).reshape(both.shape[:3] + (64,))
    out["head.conv0"] = h
    a1, b1 = jft._bn(hp["norm1"], hs["norm1"])
    h = jnp.maximum(h * a1 + b1, 0.0).astype(jnp.bfloat16)
    out["head.norm1"] = h
    k1 = hp["conv1"]["kernel"]
    out["scores"] = jnp.dot(h.reshape(both.shape[0], -1),
                            k1.reshape(-1, k1.shape[-1]).astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
    return out


def _jax_block(bp, bs, segs, conv2: str):
    """_dense_block_xla_segs' generic loop (fast_trunk.py:262-276): (the
    block's segments, each layer's new channels)."""
    import jax.numpy as jnp
    from smg_tpu.models import fast_trunk as jft

    segs, layers = list(segs), []
    pend_c = segs[-1].shape[-1] % GROUP
    for l in range(len(bp)):
        n = f"denselayer{l + 1}"
        new = jft._dense_layer_xla(bp[n], bs[n], segs, conv2)
        layers.append(new)
        if pend_c == 0:
            segs.append(new)
        else:
            segs[-1] = jnp.concatenate([segs[-1], new], axis=-1)
        pend_c = (pend_c + 32) % GROUP
    return segs, layers


def _pairs_jax(feats, B: int):
    """score_eval's head input: scene features beside each mask's."""
    import jax.numpy as jnp

    scene, mask = feats[:B], feats[B:]
    M = mask.shape[0] // B
    h, w, c = scene.shape[1:]
    rep = jnp.broadcast_to(scene[:, None], (B, M, h, w, c)).reshape(B * M, h, w, c)
    return jnp.concatenate([rep, mask.astype(rep.dtype)], -1)


def flax_module_stages(tp, ts, hp, hs, x, B: int, dtype: str):
    """The Flax module forward (DenseNetTrunk, then AffordanceHead on the
    pairs, as AffordanceNet.score composes them, affordance.py:132-165)
    with its stages captured: {stage: array}."""
    import jax
    import jax.numpy as jnp
    from smg_tpu.models import affordance as jaff
    from smg_tpu.models import densenet as jdn

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    bc = block_config_of(tp)
    trunk = jdn.DenseNetTrunk(block_config=bc, dtype=jdt)
    fhw = x.shape[1] // 32
    head = jaff.AffordanceHead(hp["conv1"]["kernel"].shape[-1], fhw, jdt)

    def keep(mdl, method):
        return method == "__call__" and mdl.name is not None and (
            mdl.name.startswith(("denseblock", "denselayer", "transition"))
            or mdl.name in ("norm5", "norm0", "conv0", "norm1"))

    feats, st = trunk.apply({"params": tp, "batch_stats": ts}, x, False,
                            capture_intermediates=keep, mutable=["intermediates"])
    it = st["intermediates"]
    out = {"stem": it["denseblock1"]["denselayer1"]["__call__"][0][..., :64]}
    for i in range(len(bc)):
        blk = it[f"denseblock{i + 1}"]
        for l in range(bc[i]):
            out[f"block{i + 1}.layer{l + 1}"] = blk[f"denselayer{l + 1}"]["__call__"][0][..., -32:]
        out[f"block{i + 1}"] = blk["__call__"][0]
        if i < len(bc) - 1:
            out[f"transition{i + 1}"] = it[f"transition{i + 1}"]["__call__"][0]
    out["norm5"] = feats
    scores, hst = head.apply({"params": hp, "batch_stats": hs}, _pairs_jax(feats, B), False,
                             capture_intermediates=keep, mutable=["intermediates"])
    hit = hst["intermediates"]
    out["head.norm0"] = jax.nn.relu(hit["norm0"]["__call__"][0])
    out["head.conv0"] = hit["conv0"]["__call__"][0]
    out["head.norm1"] = jax.nn.relu(hit["norm1"]["__call__"][0])
    out["scores"] = scores
    return out


def port_models(tree: dict, input_size: int):
    """The port's bf16 and float32 AffordanceNets with the dump's trunk and
    head loaded (other parts at their init)."""
    from smg_tpu_torch import bridge

    meta = tree["meta"]
    out = []
    for dtype in ("bfloat16", "float32"):
        m = aff.AffordanceNet(aff.ModelConfig(method="reinforcement", input_size=input_size,
                                              dtype=dtype,
                                              block_config=block_config_of(
                                                  tree["params"][meta["trunk_key"]])))
        for key in (meta["trunk_key"], meta["head_key"]):
            bridge.load_module(getattr(m, key), tree["params"][key], tree["batch_stats"][key])
        out.append(m.eval())
    return out


def port_stages(model, style: int, scene, masks, path: str) -> dict:
    """The port's stages on one chunk: the module forward ("module") or a
    fast backend, {stage: float32 numpy NHWC}."""
    out = {}

    def tap(k, t):
        out[k] = t.float().numpy().copy()

    s, m = torch.as_tensor(scene), torch.as_tensor(masks)
    with torch.no_grad():
        if path == "module":
            sc = sp.module_score(model, s, m, style, tap)
        else:
            sc = tft.score_eval(model.trunk(style), model.head(style), s, m,
                                model.cfg.num_out, path, tap)
    out["scores"] = sc.reshape(-1, sc.shape[-1]).float().numpy()
    return out


class StageErrors:
    """Running max |error| and relative L2 of each (stage, path) against a
    reference, over chunks."""

    def __init__(self):
        self.acc: dict = {}

    def add(self, path: str, got: dict, ref: dict) -> None:
        for k, v in got.items():
            if k not in ref:
                continue
            r = np.asarray(ref[k], np.float64)
            d = np.asarray(v, np.float64).reshape(r.shape) - r
            a = self.acc.setdefault((k, path), [0.0, 0.0, 0.0])
            a[0] = max(a[0], float(np.abs(d).max()))
            a[1] += float((d * d).sum())
            a[2] += float((r * r).sum())

    def table(self) -> dict:
        out: dict = {}
        for (k, p), (mx, dd, rr) in self.acc.items():
            out.setdefault(k, {})[p] = {"max_abs": mx, "rel_l2": (dd / max(rr, 1e-300)) ** 0.5}
        return out


def jitted(fn, as_written: bool = True):
    """fn jitted, compiled per input shape; as_written: with XLA's excess
    precision off (test_torch_parity_helpers.AS_WRITTEN), so that JAX's
    bf16 programs round wherever they say, as a TPU and the port do."""
    import jax

    from test_torch_parity_helpers import AS_WRITTEN

    cache = {}

    def call(x):
        if x.shape not in cache:
            lowered = jax.jit(fn).lower(x)
            cache[x.shape] = lowered.compile(compiler_options=AS_WRITTEN if as_written else None)
        return cache[x.shape](x)
    return call


def compare_packages(tree: dict, paths=("port:xla_fl", "port:xla_pk", "port:pallas"),
                     as_written: bool = True) -> dict:
    """Every path against the JAX package's float32 module forward, chunk
    by chunk (one scene and its masks at a time: eval BatchNorm is per
    image): the JAX fast path ("xla_conv"), the Flax module forward in
    bf16, the port's module forward in float32 and bf16, and `paths`.
    JAX's programs are compiled `as_written` (see jitted). Returns
    {"stages": {stage: {path: errors}}, "scores": {path: rule}}."""
    import jax.numpy as jnp

    meta = tree["meta"]
    tk, hk = meta["trunk_key"], meta["head_key"]
    tp, ts = tree["params"][tk], tree["batch_stats"][tk]
    hp, hs = tree["params"][hk], tree["batch_stats"][hk]
    scene, masks, valid = tree["scene"], tree["masks"], tree["valid"]
    S = scene.shape[1]
    style = meta["style"]
    port_bf, port_f32 = port_models(tree, S)

    j_fast = jitted(lambda x: jax_fast_stages(tp, ts, hp, hs, x, 1), as_written)
    j_mod = {d: jitted(lambda x, d=d: flax_module_stages(tp, ts, hp, hs, x, 1, d), as_written)
             for d in ("float32", "bfloat16")}
    errs = StageErrors()
    scores: dict = {}
    for b in range(scene.shape[0]):
        x = np.concatenate([scene[b:b + 1], masks[b]], 0)
        ref = {k: np.asarray(v, np.float32) for k, v in j_mod["float32"](jnp.asarray(x)).items()}
        got = {"jax:xla_conv": j_fast(jnp.asarray(x)), "jax:bf16_module": j_mod["bfloat16"](jnp.asarray(x))}
        got = {p: {k: np.asarray(v, np.float32) for k, v in g.items()} for p, g in got.items()}
        got["port:f32_module"] = port_stages(port_f32, style, scene[b:b + 1], masks[b:b + 1], "module")
        got["port:bf16_module"] = port_stages(port_bf, style, scene[b:b + 1], masks[b:b + 1], "module")
        for p in paths:
            got[p] = port_stages(port_bf, style, scene[b:b + 1], masks[b:b + 1], p.split(":")[1])
        for p, g in got.items():
            errs.add(p, g, ref)
            scores.setdefault(p, []).append(g["scores"].reshape(-1))
        scores.setdefault("ref", []).append(ref["scores"].reshape(-1))
    M = masks.shape[1]
    ref_sc = torch.as_tensor(np.stack(scores.pop("ref"))).reshape(-1, M, 1)
    rule = {p: dp.check_decisions(ref_sc, torch.as_tensor(np.stack(v)).reshape(-1, M, 1),
                                  torch.as_tensor(valid))
            for p, v in scores.items()}
    return {"stages": errs.table(), "scores": rule, "meta": meta, "as_written": as_written}


def block_check(tree: dict, block: int, scenes: int = 2, as_written: bool = True) -> dict:
    """Dense block `block` alone, every path on one input: the float32
    module forward's block input rounded to bf16, of the first `scenes`
    scenes. Against the Flax DenseBlock in float32 on that input: JAX's
    `xla_fl` (its TPU kernel, dense_layer_pallas.dense_block_fused, in
    interpret mode), its `xla_conv` loop, the Flax block in bf16; the
    port's K2 and K5 routes (plain versions on the CPU) and its module
    block in bf16. Each layer's error is read from its 32 channels of the
    block output. Returns {"block" and "layer<l>": {path: errors}}."""
    import jax
    import jax.numpy as jnp
    from smg_tpu.models import densenet as jdn
    from smg_tpu.ops import dense_layer_pallas as dlp
    from smg_tpu_torch.ops import dense_layer as k2

    meta = tree["meta"]
    tk = meta["trunk_key"]
    tp, ts = tree["params"][tk], tree["batch_stats"][tk]
    hk = meta["head_key"]
    hp, hs = tree["params"][hk], tree["batch_stats"][hk]
    bp, bs = tp[f"denseblock{block}"], ts[f"denseblock{block}"]
    L = len(bp)
    names = [f"denselayer{l + 1}" for l in range(L)]
    port_bf = port_models(tree, tree["scene"].shape[1])[0]
    trunk = port_bf.trunk(meta["style"])
    layers = tft.trunk_operands(trunk)["blocks"][block - 1]
    pblock = getattr(trunk, f"denseblock{block}")
    source = "stem" if block == 1 else f"transition{block - 1}"
    mod = jitted(lambda x: flax_module_stages(tp, ts, hp, hs, x, 1, "float32")[source])

    def jblock(dt):
        m = jdn.DenseBlock(L, 32, 4, dt)
        return jitted(lambda x: m.apply({"params": bp, "batch_stats": bs}, x, False), as_written)

    def split(x):
        return [x[..., o:o + GROUP] for o in range(0, x.shape[-1], GROUP)]

    ref_fn, bf_fn = jblock(jnp.float32), jblock(jnp.bfloat16)
    conv_fn = jitted(lambda x: jnp.concatenate(_jax_block(bp, bs, split(x), "conv")[0], -1),
                     as_written)
    fl_fn = jitted(lambda x: jnp.concatenate(
        dlp.dense_block_fused(bp, bs, split(x), names, interpret=True), -1), as_written)
    errs = StageErrors()
    for b in range(scenes):
        x = np.concatenate([tree["scene"][b:b + 1], tree["masks"][b]], 0)
        xin = jnp.asarray(mod(jnp.asarray(x)), jnp.bfloat16)
        C0 = xin.shape[-1]
        ref = np.asarray(ref_fn(xin.astype(jnp.float32)), np.float32)
        got = {"jax:bf16_module": bf_fn(xin), "jax:xla_conv": conv_fn(xin), "jax:xla_fl": fl_fn(xin)}
        got = {p: np.asarray(v, np.float32) for p, v in got.items()}
        xt = torch.as_tensor(np.array(xin.astype(jnp.float32))).to(torch.bfloat16)
        buf = torch.zeros(xt.shape[:3] + (C0 + 32 * L,), dtype=torch.bfloat16)
        buf[..., :C0] = xt
        fl, pk = buf.clone(), buf.clone()
        for lay in layers:
            k2.dense_layer_plain(fl, *lay)
        tft._dense_block_pk(pk, layers)
        with torch.no_grad():
            mb = pblock(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        for p, t in (("port:xla_fl", fl), ("port:xla_pk", pk), ("port:bf16_module", mb)):
            got[p] = t.float().numpy()
        for p, g in got.items():
            parts = {"block": g, **{f"layer{l + 1}": g[..., C0 + 32 * l:C0 + 32 * (l + 1)]
                                    for l in range(L)}}
            refs = {"block": ref, **{f"layer{l + 1}": ref[..., C0 + 32 * l:C0 + 32 * (l + 1)]
                                     for l in range(L)}}
            errs.add(p, parts, refs)
    return errs.table()


def stem_diagnosis(tree: dict, scenes: int = 3, top: int = 3) -> dict:
    """The gray tap against the module's conv0, port only, on the first
    `scenes` scenes of a dump: for the stem channels with the largest
    block-1 norm1 folds, each form's rounding of the summed conv0 kernel
    (the bf16 kernel's sum over taps minus the float32 one) and the mean
    error of the stem output against the float32 module forward's (a
    bias); then the fast path's errors (stem, block 1, scores; relative L2)
    with its own stem and with the module's three-channel bf16 conv0 in
    its place, beside the bf16 module forward's."""
    import torch.nn.functional as F

    bf, f32 = port_models(tree, tree["scene"].shape[1])
    style = tree["meta"]["style"]
    trunk = bf.trunk(style)
    scene = torch.as_tensor(tree["scene"][:scenes])
    masks = torch.as_tensor(tree["masks"][:scenes])
    keys = ("stem", "block1", "norm5")

    def grab(store):
        return lambda k, t: store.__setitem__(k, t.float().clone()) if k in keys else None

    ref: dict = {}
    with torch.no_grad():
        ref_scores = sp.module_score(f32, scene, masks, style, grab(ref))

    def errors(fn):
        got: dict = {}
        with torch.no_grad():
            sc = fn(grab(got))
        out = {k: float((got[k] - ref[k]).norm() / ref[k].norm()) for k in keys}
        out["scores"] = float((sc - ref_scores).norm() / ref_scores.norm())
        return out, got

    w = trunk.conv0.weight.detach()
    fast = lambda tap: tft.score_eval(trunk, bf.head(style), scene, masks, 1, "xla_fl", tap)  # noqa: E731
    res = {"fast": errors(fast)}
    res["bf16_module"] = errors(lambda tap: sp.module_score(bf, scene, masks, style, tap))

    def module_conv0(x, kg):
        y = F.conv2d(x.to(torch.bfloat16).permute(0, 3, 1, 2), w.to(torch.bfloat16),
                     stride=2, padding=3)
        return y.permute(0, 2, 3, 1).contiguous()

    own = tft._stem_conv
    tft._stem_conv = module_conv0
    try:
        res["fast_with_module_conv0"] = errors(fast)
    finally:
        tft._stem_conv = own
    layer1 = getattr(trunk, "denseblock1").denselayer1.norm1
    a1, _ = tft.fold_bn(layer1)
    k32 = w.float().sum(dim=(2, 3))                 # (64, 3) per input channel
    gray = w.float().sum(1).to(torch.bfloat16).float().sum(dim=(1, 2)) - k32.sum(1)
    module = w.to(torch.bfloat16).float().sum(dim=(1, 2, 3)) - k32.sum(1)
    channels = {}
    for c in torch.argsort(a1[:w.shape[0]].abs(), descending=True)[:top].tolist():
        channels[c] = {"norm1_a": float(a1[c]), "kernel_sum": float(k32[c].sum()),
                       "rounding_gray_tap": float(gray[c]), "rounding_module": float(module[c]),
                       **{f"stem_bias_{p}": float((res[p][1]["stem"][..., c]
                                                   - ref["stem"][..., c]).mean())
                          for p in ("fast", "bf16_module")}}
    return {"scenes": scenes, "channels": channels,
            "errors": {p: e for p, (e, _) in res.items()}}


def stage_order(res: dict) -> list:
    """The table's stages in forward order, each block's layers after it."""
    names = list(res["stages"])
    blocks = sorted({int(k[5]) for k in names if k.startswith("block")})
    order = []
    for k in sp.stage_names(tuple(blocks)):
        order.append(k)
        if k.startswith("block"):
            order += sorted((n for n in names if n.startswith(k + ".layer")),
                            key=lambda n: int(n.rsplit("layer", 1)[1]))
    return [k for k in order if k in res["stages"]]


def print_packages(res: dict) -> None:
    paths = sorted({p for row in res["stages"].values() for p in row})
    print("stage | " + " | ".join(paths))
    for k in stage_order(res):
        row = res["stages"][k]
        print(f"{k} | " + " | ".join(
            "-" if p not in row else f"{row[p]['max_abs']:.4g} / {row[p]['rel_l2']:.4g}"
            for p in paths))
    print("scores (error / spread) | " + " | ".join(
        f"{res['scores'][p]['err_over_spread']:.4f}" for p in paths))


def main(argv=None) -> int:
    import argparse
    import json

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    torch.set_num_threads(8)
    ap = argparse.ArgumentParser(description="The port against the JAX package, stage "
                                             "by stage, on a stage_parity.py dump")
    ap.add_argument("dump")
    ap.add_argument("--out", default="")
    ap.add_argument("--block", type=int, default=0,
                    help="also that dense block alone, JAX's xla_fl kernel among the paths")
    ap.add_argument("--stem", type=int, default=0,
                    help="also the gray tap against the module's conv0 on N scenes (port only)")
    ap.add_argument("--excess_precision", action="store_true",
                    help="compile JAX's programs with XLA:CPU's default excess precision")
    args = ap.parse_args(argv)
    tree = load_dump(args.dump)
    as_written = not args.excess_precision
    res = compare_packages(tree, as_written=as_written)
    print_packages(res)
    if args.stem:
        res["stem"] = stem_diagnosis(tree, args.stem)
        for c, row in res["stem"]["channels"].items():
            print(f"stem channel {c}: " + ", ".join(f"{k} {v:.4g}" for k, v in row.items()))
        for p, e in res["stem"]["errors"].items():
            print(f"{p}: " + ", ".join(f"{k} {v:.4f}" for k, v in e.items()))
    if args.block:
        res["block_check"] = {"block": args.block,
                              "table": block_check(tree, args.block, min(2, len(tree["scene"])),
                                                   as_written)}
        rows = res["block_check"]["table"]
        paths = sorted({p for row in rows.values() for p in row})
        print(f"block {args.block} alone | " + " | ".join(paths))
        for k, row in rows.items():
            print(f"{k} | " + " | ".join(f"{row[p]['max_abs']:.4g} / {row[p]['rel_l2']:.4g}"
                                         for p in paths))
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


@pytest.fixture(scope="module")
def shallow_packages():
    """(flax model, variables, a dump-like tree of style 0) at 64 pixels."""
    from test_torch_parity_helpers import models, score_inputs, to_numpy_tree

    mp = pytest.MonkeyPatch()
    model, variables, _ = models(mp, "bfloat16", PKG_SHALLOW, 64, seed=2)
    scene, masks = score_inputs(3, 2, 3, 64)
    p, st = to_numpy_tree(variables["params"]), to_numpy_tree(variables["batch_stats"])
    tree = {"params": {k: p[k] for k in ("grasp_trunk", "grasp_head")},
            "batch_stats": {k: st[k] for k in ("grasp_trunk", "grasp_head")},
            "scene": scene, "masks": masks, "valid": np.ones((2, 3), bool),
            "meta": {"style": 0, "trunk_key": "grasp_trunk", "head_key": "grasp_head"}}
    yield model, variables, tree
    mp.undo()


def test_jax_stage_composition_is_jax_score_eval(shallow_packages):
    """The composed JAX fast path and Flax module forward give the JAX
    package's own scores: fast_trunk.score_eval(backend="xla_conv") and
    AffordanceNet.score, each in its own jitted program."""
    import jax
    import jax.numpy as jnp
    from smg_tpu.models import affordance as jaff
    from smg_tpu.models import fast_trunk as jft

    model, variables, tree = shallow_packages
    p, st = variables["params"], variables["batch_stats"]
    scene, masks = jnp.asarray(tree["scene"]), jnp.asarray(tree["masks"])
    x = jnp.concatenate([scene, masks.reshape((-1,) + masks.shape[2:])])
    args = (p["grasp_trunk"], st["grasp_trunk"], p["grasp_head"], st["grasp_head"])
    got = jax.jit(lambda x: jax_fast_stages(*args, x, 2))(x)
    want = jax.jit(lambda s, m: jft.score_eval(p, st, s, m, 1, backend="xla_conv"))(scene, masks)
    np.testing.assert_array_equal(np.asarray(got["scores"]).reshape(2, 3, 1), np.asarray(want))
    mod = jax.jit(lambda x: flax_module_stages(*args, x, 2, "bfloat16"))(x)
    want = jax.jit(lambda s, m: model.apply(variables, s, m, 0, False,
                                            method=jaff.AffordanceNet.score))(scene, masks)
    np.testing.assert_array_equal(np.asarray(mod["scores"]).reshape(2, 3, 1), np.asarray(want))
    assert set(got) == set(mod)
    np.testing.assert_array_equal(np.asarray(mod["stem"]), np.asarray(mod["block1"])[..., :64])


def test_compare_packages_shallow(shallow_packages):
    """The package comparison on a shallow dump-like tree: its paths and
    stages, and the two float32 module forwards agree (1e-4 relative)."""
    res = compare_packages(shallow_packages[2])
    paths = {"jax:xla_conv", "jax:bf16_module", "port:f32_module", "port:bf16_module",
             "port:xla_fl", "port:xla_pk", "port:pallas"}
    assert set(res["scores"]) == paths
    names = stage_order(res)
    assert [k for k in names if ".layer" not in k] == sp.stage_names(PKG_SHALLOW)
    for k in names:
        want = paths - ({"port:pallas"} if k.startswith("block") else set())
        assert set(res["stages"][k]) == want, k
        assert res["stages"][k]["port:f32_module"]["rel_l2"] < 1e-4, k
    assert res["scores"]["port:f32_module"]["err_over_spread"] < 1e-3


def test_block_check_shallow(shallow_packages):
    """One dense block alone on every path, JAX's K2 kernel in interpret
    mode among them: the port's K2 plain version stands within
    KERNEL_TOL of it (the kernels' parity bound)."""
    from test_torch_parity_helpers import KERNEL_TOL

    rows = block_check(shallow_packages[2], 1, scenes=1)
    assert set(rows) == {"block", "layer1", "layer2"}
    paths = {"jax:bf16_module", "jax:xla_conv", "jax:xla_fl", "port:xla_fl", "port:xla_pk",
             "port:bf16_module"}
    assert set(rows["layer1"]) == paths
    for p in paths:
        assert rows["layer2"][p]["rel_l2"] < 0.05, p
    for k in ("layer1", "layer2"):
        assert abs(rows[k]["port:xla_fl"]["rel_l2"] - rows[k]["jax:xla_fl"]["rel_l2"]) < KERNEL_TOL


def test_stem_diagnosis_shallow(shallow_packages):
    """The gray-tap diagnosis on a dump-like tree: its channels, each
    form's kernel-sum rounding, and the fast path with the module's conv0."""
    res = stem_diagnosis(shallow_packages[2], scenes=1, top=2)
    assert len(res["channels"]) == 2
    for row in res["channels"].values():
        assert set(row) == {"norm1_a", "kernel_sum", "rounding_gray_tap", "rounding_module",
                            "stem_bias_fast", "stem_bias_bf16_module"}
    assert set(res["errors"]) == {"fast", "bf16_module", "fast_with_module_conv0"}
    for e in res["errors"].values():
        assert set(e) == {"stem", "block1", "norm5", "scores"} and max(e.values()) < 0.1
    # The module's conv0 in the fast path gives the module's stem.
    assert res["errors"]["fast_with_module_conv0"]["stem"] == pytest.approx(
        res["errors"]["bf16_module"]["stem"], rel=1e-6)


def _flat_depths(rng, n: int, S: int) -> torch.Tensor:
    """Depth maps of a flat table with round objects: (n, S, S)."""
    d = np.zeros((n, S, S), np.float32)
    yy, xx = np.mgrid[:S, :S]
    for i in range(n):
        for _ in range(rng.randint(1, 4)):
            cy, cx = rng.randint(S // 8, S - S // 8, 2)
            r = rng.randint(S // 20 + 1, S // 8 + 2)
            d[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0.02, 0.06)
    return torch.as_tensor(d)


@pytest.mark.parametrize("gray_tap", [True, False], ids=["gray_tap", "folds_only"])
def test_snapshot_stem_departs_alike_in_both_packages(gray_tap, tmp_path):
    """The cause of the fast eval path's departure on a trained snapshot,
    in both packages: the stem's gray tap (conv0's taps summed over the
    input channels, rounded once to bf16: smg_tpu/models/fast_trunk.py:39,
    the port's fast_trunk._build_operands) shifts the stem channels where
    the summed taps do not fit bf16, and BatchNorm folds at the snapshot's
    running variances carry the shift on (decision_parity.snapshot_stem_,
    numpy seed 0; a shallow trunk at 64 pixels; JAX compiled as written).

    - The gray tap is the same bf16 kernel in both packages, bit for bit.
    - Both fast paths ("xla_conv" in JAX, "xla_fl" in the port) and both
      bf16 module forwards stand within 1.25x of their counterpart from the
      float32 module forward at every stage from the stem to the head's
      norm1. The scores, six values at this size, read the last product's
      rounding more than the path (JAX's XLA:CPU program reads 0.016-0.017
      there with the gray tap over seeds 0-2, the port 0.007-0.009).
    - With gray_tap the fast paths stand 2x or more farther from it than
      the bf16 module forwards at the stem, in both packages; with the same
      folds and taps that fit bf16 they stand within 1.25x of them."""
    S, B, M = 64, 2, 3
    rng = np.random.RandomState(0)
    x = aff.preprocess_depth(_flat_depths(rng, B * (M + 1), S), aff.ModelConfig(input_size=S))
    scene, masks = x[:B], x[B:].reshape(B, M, S, S, 3)
    model, oracle = dp.make_models(S, seed=0, device="cpu", block_config=SHALLOW)
    for m in (model, oracle):
        dp.snapshot_stem_(m, x, seed=0, gray_tap=gray_tap)
    path = str(tmp_path / "case.npz")
    sp.dump(oracle, 0, scene, masks, torch.ones(B, M, dtype=torch.bool), path, {"source": "case"})
    tree = load_dump(path)
    kg_jax = tree["params"]["grasp_trunk"]["conv0"]["kernel"].sum(axis=2)
    kg_port = tft.trunk_operands(model.grasp_trunk)["kg"][:, 0].permute(1, 2, 0).float().numpy()
    np.testing.assert_array_equal(bf16_of(kg_jax), kg_port)
    assert (bf16_of(kg_jax) != kg_jax).any() == gray_tap
    res = compare_packages(tree, paths=("port:xla_fl",))
    for k in sp.stage_names(SHALLOW)[:-1]:
        e = {p: v["rel_l2"] for p, v in res["stages"][k].items()}
        for a, b in (("port:xla_fl", "jax:xla_conv"), ("port:bf16_module", "jax:bf16_module")):
            assert e[a] <= 1.25 * e[b] and e[b] <= 1.25 * e[a], (k, e)
    e = {p: v["rel_l2"] for p, v in res["stages"]["stem"].items()}
    for fast, mod in (("port:xla_fl", "port:bf16_module"), ("jax:xla_conv", "jax:bf16_module")):
        if gray_tap:
            assert e[fast] >= 2.0 * e[mod], e
        else:
            assert e[fast] <= 1.25 * e[mod], e


def bf16_of(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (to nearest even), as float32."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


if __name__ == "__main__":
    import sys

    sys.exit(main())
