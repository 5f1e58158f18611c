"""Where the port's fast eval path parts from the module forward: a stage-by-stage probe.

    python3 stage_parity.py [--snapshot logs/<run>/models/snapshot]
        [--styles 0 1 2] [--scenes 8] [--out FILE.json] [--dump DIR]
        [--arbitrate N]

On the decision-parity inputs (cli/decision_parity.py::render and
::prepare: 8 rendered cluttered scenes, 104 trunk images at input 224) it
runs, for each style, three paths on the same weights:

- (a) the float32 module forward (DenseNetTrunk.forward and
  AffordanceHead.forward in float32), the oracle;
- (b) the same module forward in bf16;
- (c) the fast eval path, `fast_trunk.score_eval`, for each backend;

and compares them at every stage boundary: the stem output (block 1's
input), each dense block's output, each transition's output, norm5, the
head after norm0 + ReLU, after conv0 and after norm1 + ReLU, and the
scores. Per stage and path: the largest absolute error and the relative
L2 error against (a); per stage the folded BatchNorm's max |a|
(a = scale * rsqrt(var + 1e-5)) and min running_var. The scores also get
decision parity's rule (per-object error over the oracle's spread). The
first stage where some backend's relative L2 error exceeds twice the bf16
module forward's is the departing stage; the table of its dense block,
per layer (the 32 new channels of each), is printed with each layer's
norm1 / norm2 statistics. The `pallas` backend fuses a block with its
transition (K7): it shows the stem, the transitions and norm5 only.

--dump DIR writes one style's trunk and head (a style that reproduces the
strict rule's failure on every backend while the bf16 module forward
holds it, else the style whose worst backend stands farthest above the
bf16 module forward) as Flax-layout float32 numpy
(bridge.dump_affordance_params), with the rendered inputs, to
DIR/stages_style<S>.npz (about 26 MB compressed at DenseNet-121), for a
comparison against the JAX package on the CPU
(tests/test_torch_eval_stages.py, run as a script).

--arbitrate N renders N scenes of the b32 protocol's testing environment
(held-out catalog, ETS on), scores them through Trainer.score_scene_batch
with the fast path (bf16, `xla_fl`), the bf16 module forward and the
float32 module forward, and counts the greedy arbitrations
(policy/arbitrate.py::select_action, testing mode) and their targets that
differ from the float32 module forward's, with each path's action shares.

Prints the tables and, as its last line, one JSON object (also written to
--out). Runs on the card unless --device says otherwise. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from smg_tpu_torch import bridge
from smg_tpu_torch.cli import decision_parity as dp
from smg_tpu_torch.models import fast_trunk
from smg_tpu_torch.models.densenet import BLOCK_CONFIG, bn_eval, no_tf32

BACKENDS = fast_trunk.BACKENDS
REF, BF16 = "f32_module", "bf16_module"
DEPART_FACTOR = 2.0
INPUT_SIZE = 224   # the protocol's, where the trained snapshot's parity failed
TRUNK_NAMES = ("grasp_trunk", "suction_trunk", "gs_trunk")
PROTOCOL_FLAGS = ("--is_sim --method reinforcement --is_ets --is_pe --is_oo --batch_size 32 "
                  "--trunk densenet121 --input_size 224 --is_testing "
                  "--obj_mesh_dir datasets/testing")


def stage_names(block_config) -> list:
    """The stage boundaries in forward order."""
    names = ["stem"]
    for i in range(len(block_config)):
        names.append(f"block{i + 1}")
        if i < len(block_config) - 1:
            names.append(f"transition{i + 1}")
    return names + ["norm5", "head.norm0", "head.conv0", "head.norm1", "scores"]


def module_trunk(trunk, x: torch.Tensor, tap) -> torch.Tensor:
    """DenseNetTrunk.forward (eval) step by step, the same operations in the
    same order, with tap(name, NHWC tensor) at the fast path's stages."""
    dt = trunk.dtype
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    with no_tf32():
        h = x.to(dt).permute(0, 3, 1, 2)
        h = F.conv2d(h, trunk.conv0.weight.to(dt), stride=2, padding=3)
        h = F.max_pool2d(torch.relu(bn_eval(h, trunk.norm0, dt)), 3, 2, padding=1)
        tap("stem", nhwc(h))
        n = len(trunk.block_config)
        for i in range(n):
            block = getattr(trunk, f"denseblock{i + 1}")
            for l, layer in enumerate(block.children()):
                h = layer(h)
                tap(f"block{i + 1}.layer{l + 1}", nhwc(h[:, -layer.conv2.out_channels:]))
            tap(f"block{i + 1}", nhwc(h))
            if i < n - 1:
                h = getattr(trunk, f"transition{i + 1}")(h)
                tap(f"transition{i + 1}", nhwc(h))
        h = bn_eval(h, trunk.norm5, dt)
        tap("norm5", nhwc(h))
    return nhwc(h)


def module_head(head, x: torch.Tensor, tap) -> torch.Tensor:
    """AffordanceHead.forward step by step (NHWC x), with taps."""
    dt = x.dtype
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    with no_tf32():
        h = torch.relu(bn_eval(x.permute(0, 3, 1, 2), head.norm0, dt))
        tap("head.norm0", nhwc(h))
        h = F.conv2d(h, head.conv0.weight.to(dt))
        tap("head.conv0", nhwc(h))
        h = torch.relu(bn_eval(h, head.norm1, dt))
        tap("head.norm1", nhwc(h))
        h = F.conv2d(h, head.conv1.weight.to(dt))
    return h.reshape(h.shape[0], -1).float()


def module_score(model, scene_img, mask_imgs, style: int, tap) -> torch.Tensor:
    """AffordanceNet.score (R = 1) through module_trunk and module_head."""
    x, B, R = fast_trunk.trunk_input(scene_img, mask_imgs)
    feats = module_trunk(model.trunk(style), x, tap)
    pair = fast_trunk.pair_features(feats, B, R)
    return module_head(model.head(style), pair, tap).reshape(B, -1, model.cfg.num_out)


def _bn_stats(bn) -> dict:
    a, _ = fast_trunk.fold_bn(bn)
    return {"max_abs_a": float(a.abs().max()), "min_var": float(bn.running_var.min())}


def bn_of_stages(model, style: int) -> dict:
    """{stage or layer: folded statistics of the BatchNorm(s) it applies}."""
    trunk, head = model.trunk(style), model.head(style)
    out = {"stem": _bn_stats(trunk.norm0), "norm5": _bn_stats(trunk.norm5),
           "head.norm0": _bn_stats(head.norm0), "head.norm1": _bn_stats(head.norm1)}
    for i in range(len(trunk.block_config)):
        block = getattr(trunk, f"denseblock{i + 1}")
        for l, layer in enumerate(block.children()):
            out[f"block{i + 1}.layer{l + 1}"] = {
                "norm1": _bn_stats(layer.norm1), "norm2": _bn_stats(layer.norm2)}
        if i < len(trunk.block_config) - 1:
            out[f"transition{i + 1}"] = _bn_stats(getattr(trunk, f"transition{i + 1}").norm)
    return out


def _errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    d = (got.float() - ref).double()
    return {"max_abs": float(d.abs().max()),
            "rel_l2": float(torch.linalg.vector_norm(d)
                            / max(float(torch.linalg.vector_norm(ref.double())), 1e-30))}


def compare_style(model, oracle, scene_imgs, mask_imgs, valid, style: int,
                  backends=BACKENDS) -> dict:
    """One style's stage table: {"stages": {stage: {path: errors}},
    "layers": {layer: {path: errors}}, "scores": {path: decision rule},
    "bn": statistics, "departing": first departing stage or None,
    "ratio": {backend: its score error ratio over the bf16 module's}}."""
    ref: dict = {}
    ref_scores = module_score(oracle, scene_imgs, mask_imgs, style,
                              lambda k, t: ref.__setitem__(k, t.float().clone()))
    table: dict = {}

    def record(path):
        def tap(name, t):
            table.setdefault(name, {})[path] = _errors(t, ref[name])
        return tap

    scores = {REF: ref_scores,
              BF16: module_score(model, scene_imgs, mask_imgs, style, record(BF16))}
    trunk, head = model.trunk(style), model.head(style)
    for b in backends:
        scores[b] = fast_trunk.score_eval(trunk, head, scene_imgs, mask_imgs,
                                          model.cfg.num_out, b, record(b))
    del ref
    rule = {p: dp.check_decisions(ref_scores, s, valid) for p, s in scores.items() if p != REF}
    for p in rule:
        table.setdefault("scores", {})[p] = _errors(scores[p], ref_scores)
    names = stage_names(trunk.block_config)
    stages = {k: table[k] for k in names}
    layers = {k: v for k, v in table.items() if ".layer" in k}
    departing = None
    for k in names:
        base = stages[k][BF16]["rel_l2"]
        if any(stages[k][b]["rel_l2"] > DEPART_FACTOR * base for b in backends if b in stages[k]):
            departing = k
            break
    wit = rule[BF16]["err_over_spread"]
    return {"stages": stages, "layers": layers, "scores": rule, "bn": bn_of_stages(model, style),
            "departing": departing,
            "ratio": {b: rule[b]["err_over_spread"] / max(wit, 1e-12) for b in backends}}


def _block_of(stage: str, n_blocks: int) -> int:
    """The dense block whose layers the departing stage's table lists."""
    for i in range(n_blocks, 0, -1):
        if stage.startswith((f"block{i}", f"transition{i}")):
            return i
    return 1 if stage == "stem" else n_blocks


def _fmt(e: dict | None) -> str:
    return "-" if e is None else f"{e['max_abs']:.4g} / {e['rel_l2']:.4g}"


def print_style(style: int, res: dict, paths, n_blocks: int) -> None:
    print(f"== style {style}: max abs / rel L2 against the float32 module forward ==")
    print("stage | " + " | ".join(paths) + " | max|a| | min var")
    for k, row in res["stages"].items():
        bn = res["bn"].get(k, {})
        print(f"{k} | " + " | ".join(_fmt(row.get(p)) for p in paths)
              + f" | {bn.get('max_abs_a', float('nan')):.4g} | {bn.get('min_var', float('nan')):.4g}")
    print("scores (error / spread) | " + " | ".join(
        f"{res['scores'][p]['err_over_spread']:.4f}" for p in paths))
    dep = res["departing"]
    print(f"departing stage (a backend over {DEPART_FACTOR}x the bf16 module): {dep}")
    if dep is None:
        return
    blk = _block_of(dep, n_blocks)
    print(f"-- block {blk} per layer (new channels): paths, then norm1 / norm2 max|a|, min var --")
    for k, row in res["layers"].items():
        if not k.startswith(f"block{blk}."):
            continue
        bn = res["bn"][k]
        print(f"{k} | " + " | ".join(_fmt(row.get(p)) for p in paths)
              + f" | {bn['norm1']['max_abs_a']:.4g}, {bn['norm1']['min_var']:.4g}"
              + f" / {bn['norm2']['max_abs_a']:.4g}, {bn['norm2']['min_var']:.4g}")


def worst_style(styles: dict, reproduced=()) -> int:
    """A style in `reproduced` first, then the one whose worst backend's
    score ratio over the bf16 module forward's is the largest."""
    return max(styles, key=lambda s: (s in reproduced, max(styles[s]["ratio"].values())))


def dump(model, style: int, scene_imgs, mask_imgs, valid, path: str, meta: dict) -> int:
    """The style's trunk and head, Flax layout, float32, and the inputs
    (the depth channel) to an .npz; returns its size in bytes."""
    params, stats = bridge.dump_affordance_params(model)
    trunk_key = TRUNK_NAMES[style]
    head_key = next(n for n in ("grasp_head", "suction_head", "gs_head")
                    if getattr(model, n) is model.head(style))
    arrays = {}

    def flat(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(f"{prefix}/{k}", v)
            else:
                arrays[f"{prefix}/{k}"] = np.asarray(v, np.float32)

    for key in (trunk_key, head_key):
        flat(f"params/{key}", params[key])
        flat(f"batch_stats/{key}", stats[key])
    arrays["inputs/scene"] = scene_imgs[..., 0].float().cpu().numpy()
    arrays["inputs/masks"] = mask_imgs[..., 0].float().cpu().numpy()
    arrays["inputs/valid"] = valid.cpu().numpy()
    meta = dict(meta, style=style, trunk_key=trunk_key, head_key=head_key)
    arrays["meta"] = np.array(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)
    return os.path.getsize(path)


def arbitration(snapshot: str, n: int, device, seed: int = 11, block_config=BLOCK_CONFIG,
                scene_chunk: int = 4, settle_steps: int | None = None) -> dict:
    """Greedy testing-mode arbitrations of n held-out scenes under the fast
    path, the bf16 module forward and the float32 module forward (the
    snapshot's weights, or else decision parity's random construction)."""
    from smg_tpu_torch.envs import smg_env
    from smg_tpu_torch.policy import arbitrate as arb
    from smg_tpu_torch.train.trainer import Trainer
    from smg_tpu_torch.utils import config as cfg_mod

    cfg = cfg_mod.parse_args(PROTOCOL_FLAGS.split())
    if settle_steps is not None:
        cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, settle_steps=settle_steps))
    gen = torch.Generator(device=device).manual_seed(seed)
    obs = smg_env.observe(smg_env.reset(gen, n, cfg.env, device))
    depth, seg = smg_env.masked_scene_depth(obs), obs.seg
    choices = {}
    for name, fast, dtype in (("fast_xla_fl", "on", "bfloat16"), (BF16, "off", "bfloat16"),
                              (REF, "off", "float32")):
        model_cfg = dataclasses.replace(cfg.train.model, dtype=dtype, block_config=block_config)
        tc = dataclasses.replace(cfg.train, model=model_cfg, fast_eval=fast,
                                 scene_chunk=scene_chunk)
        trainer = Trainer(tc, device)
        if snapshot:
            dp.load_snapshot(trainer.model, snapshot)
        else:
            trainer.model.load_state_dict(dp.make_model(
                224, device="cpu", block_config=block_config).state_dict())
        sc = trainer.score_scene_batch(None, depth, seg.masks, seg.valid)
        choices[name] = arb.select_action(sc.gra_conf, sc.suc_conf, sc.gs_conf, seg.valid,
                                          seg.centers, method=cfg.env.method,
                                          is_ets=cfg.env.is_ets, is_testing=True)
        del trainer
    ref = choices[REF]
    out = {"scenes": n, "seed": seed}
    for name, c in choices.items():
        shares = {k: float((c.action == v).float().mean())
                  for k, v in (("suction", arb.ACTION_SUCTION), ("grasp", arb.ACTION_GRASP),
                               ("ets", arb.ACTION_ETS))}
        target = torch.stack([c.grasp_obj, c.suction_obj], 1)
        ref_target = torch.stack([ref.grasp_obj, ref.suction_obj], 1)
        out[name] = {"shares": shares,
                     "action_flips": int((c.action != ref.action).sum()),
                     "target_flips": int(((c.action == ref.action)
                                          & (target != ref_target).any(1)).sum())}
    return out


def probe(model, oracle, scene_imgs, mask_imgs, valid, styles, backends=BACKENDS,
          source: str = "") -> dict:
    """compare_style for each style, its tables printed; the JSON object
    without the dump and the arbitrations."""
    paths = (BF16,) + tuple(backends)
    res = {}
    with torch.no_grad():
        for s in styles:
            res[s] = compare_style(model, oracle, scene_imgs, mask_imgs, valid, s,
                                   tuple(backends))
            print_style(s, res[s], paths, len(model.grasp_trunk.block_config))
    dev = scene_imgs.device
    return {"source": source, "input_size": int(scene_imgs.shape[1]),
            "scenes": int(scene_imgs.shape[0]),
            "images": int(scene_imgs.shape[0] * (1 + mask_imgs.shape[1])),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "styles": {str(s): r for s, r in res.items()},
            # The strict rule's failure reproduced: every backend over 0.25
            # of the spread while the bf16 module forward stays under it.
            "reproduced": [s for s, r in res.items()
                           if all(r["scores"][b]["err_over_spread"] > dp.TOL_FRAC
                                  for b in backends)
                           and r["scores"][BF16]["err_over_spread"] < dp.TOL_FRAC]}


def run(args) -> dict:
    device = torch.device(args.device)
    model, oracle = (dp.make_model(INPUT_SIZE, args.seed, device, tuple(args.block_config),
                                   dtype, args.snapshot) for dtype in ("bfloat16", "float32"))
    masked, obj_depth, valid = dp.render(args.scenes, device)
    scene_imgs, mask_imgs = dp.prepare(masked, obj_depth, INPUT_SIZE)
    source = args.snapshot or f"decision_parity's random construction, seed {args.seed}"
    out = probe(model, oracle, scene_imgs, mask_imgs, valid, args.styles, source=source)
    if args.dump:
        s = worst_style({int(s): r for s, r in out["styles"].items()}, out["reproduced"])
        path = os.path.join(args.dump, f"stages_style{s}.npz")
        size = dump(model, s, scene_imgs, mask_imgs, valid, path,
                    {"source": source, "input_size": INPUT_SIZE, "scenes": args.scenes})
        out["dump"] = {"path": path, "style": s, "bytes": size}
        print(f"dumped style {s} to {path} ({size} bytes)")
    if args.arbitrate:
        out["arbitration"] = arbitration(args.snapshot, args.arbitrate, device,
                                         block_config=tuple(args.block_config))
        print("arbitration:", json.dumps(out["arbitration"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snapshot", default="", help="a run's models/snapshot")
    ap.add_argument("--styles", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0, help="the random construction's seed")
    ap.add_argument("--block_config", type=int, nargs="+", default=list(BLOCK_CONFIG),
                    help="a shallow trunk (random construction only)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="", help="also write the JSON here")
    ap.add_argument("--dump", default="", help="directory for the style's weights and inputs")
    ap.add_argument("--arbitrate", type=int, default=0,
                    help="scenes of the testing environment to arbitrate on")
    args = ap.parse_args(argv)
    if args.snapshot and not os.path.isfile(args.snapshot):
        ap.error(f"--snapshot {args.snapshot}: no such file")
    if args.snapshot and tuple(args.block_config) != BLOCK_CONFIG:
        ap.error("--block_config applies to the random construction only")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("stage_parity: no CUDA device is available")
    out = run(args)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
