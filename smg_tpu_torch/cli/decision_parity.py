"""Decision-level parity of an eval backend against the module oracle.

Port of scripts/decision_parity.py. On rendered cluttered scenes at
production scale (DenseNet-121, 224-pixel heightmaps, input 224 or 640),
it scores every style through `AffordanceNet.score_eval(backend=...)`, the
fast bf16 eval path over the port's kernels, and through
`AffordanceNet.score`, the module eval forward (the oracle) in float32,
and checks the rule of tests/test_decision_parity.py:163-187:

  (a) the largest per-object value error is below tol x the oracle's
      largest per-scene value spread (and that spread exceeds 0.05);
  (b) the argmax object is equal on every scene whose top-2 margin
      exceeds 2x that error, and at least one scene is so decided.

tol is the rule's 0.25. At the input sizes in WITNESS_SIZES (640) it is
the larger of 0.25 and WITNESS_FACTOR times the error ratio that the
module eval forward in bf16 (the Flax model's own computation in its
working dtype, which the JAX script compares against) shows against the
float32 oracle on the same case: at full depth with random weights bf16
rounding alone exceeds 0.25 of the spread there, and only the one-object
scene is decided, so at 640 the rule guards against gross errors and its
argmax part is not tested ("argmax_tested" false). "strict_ok" reports the
rule at 0.25 at every size.

The weights are the test's discriminative construction
(tests/test_decision_parity.py:147-160): Flax's default conv init (LeCun
normal, variance 1 / fan_in) with every kernel scaled 1.5x, and BatchNorm
statistics that keep the ReLU chain alive at depth
(tests/test_fast_trunk.py:20-41), from a seeded torch.Generator. The
port's init_params draws He normal (variance 2 / fan_in), so its kernels
are scaled by 1.5 / sqrt(2). At plain init full-depth trunks map the
objects to near-equal values and the check would be vacuous; at He x 1.5
the values explode.

    python -m smg_tpu_torch.cli.decision_parity [--scenes 8]
        [--input_size 224|640] [--backend xla_fl|xla_pk|pallas]

Prints one JSON line (per style: the error, the spread, the tolerance,
the decided scenes, argmax agreement) and exits 1 when a check fails. Runs
on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch
from torch import nn

from smg_tpu_torch.envs import smg_env
from smg_tpu_torch.models.affordance import (AffordanceNet, ModelConfig, init_params,
                                             preprocess_depth)
from smg_tpu_torch.models.densenet import BLOCK_CONFIG
from smg_tpu_torch.models.fast_trunk import BACKENDS

STYLES = (0, 1, 2)
CONV_SCALE = 1.5 / math.sqrt(2.0)   # He normal -> 1.5 x LeCun normal
TOL_FRAC = 0.25
MIN_SPREAD = 0.05
# Where bf16 rounding alone misses the rule at random weights: the bf16
# module forward reads 0.232-0.641 of the spread at 640, 0.103-0.237 at
# 224; the backends read 0.77-1.55 times the bf16 module forward's ratio at
# 640 (chip_smoke.py on an H100 80GB HBM3 at 700 W).
WITNESS_SIZES = (640,)
WITNESS_FACTOR = 2.0
# (lo, hi) of the uniform draw of each BatchNorm tensor.
ALIVE_RANGES = {"running_mean": (-0.1, 0.1), "running_var": (0.5, 1.5),
                "weight": (0.5, 1.5), "bias": (0.05, 0.4)}


def alive_stats_(model: nn.Module, gen: torch.Generator) -> None:
    """Every BatchNorm's statistics, scale and bias drawn uniform in
    ALIVE_RANGES: means near zero and biases slightly positive keep 58
    stacked ReLUs alive."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                for name, (lo, hi) in ALIVE_RANGES.items():
                    t = getattr(m, name)
                    t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)


def make_model(input_size: int, seed: int = 0, device="cuda",
               block_config=BLOCK_CONFIG, dtype: str = "bfloat16") -> AffordanceNet:
    """The check's model: conv kernels 1.5 x LeCun normal (He init x
    CONV_SCALE), alive BatchNorm statistics; made on the CPU from `seed`,
    then moved. The weights do not depend on dtype, the compute does."""
    model = AffordanceNet(ModelConfig(method="reinforcement", input_size=input_size,
                                      dtype=dtype, block_config=block_config))
    init_params(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.mul_(CONV_SCALE)
    alive_stats_(model, torch.Generator().manual_seed(seed + 1))
    return model.to(device)


def render(n_scenes: int, device, seed: int = 7,
           settle_steps: int = smg_env.EnvConfig.settle_steps):
    """n cluttered scenes (reset, observe, masked_scene_depth): the masked
    scene depth (n, 224, 224), each object's depth (n, K, 224, 224) and
    the valid object slots (n, K)."""
    cfg = smg_env.EnvConfig(is_cluttered=True, settle_steps=settle_steps)
    gen = torch.Generator(device=device).manual_seed(seed)
    obs = smg_env.observe(smg_env.reset(gen, n_scenes, cfg, device))
    masked = smg_env.masked_scene_depth(obs)
    return masked, masked[:, None] * obs.seg.masks, obs.seg.valid


def check_decisions(ref: torch.Tensor, got: torch.Tensor, valid: torch.Tensor,
                    tol_frac: float = TOL_FRAC) -> dict:
    """The rule of tests/test_decision_parity.py:163-187 on (B, M, 1)
    scores with a (B, M) validity mask; returns its numbers and "ok"."""
    ref, got = ref[..., 0].float().cpu(), got[..., 0].float().cpu()
    valid = valid.cpu()
    neg = torch.zeros_like(ref).masked_fill(~valid, -1e9)
    rv, gv = ref + neg, got + neg
    spread = rv.amax(1) - torch.where(valid, ref, 1e9).amin(1)
    err = float(((got - ref) * valid).abs().max())
    top2 = rv.sort(1).values
    decided = (top2[:, -1] - top2[:, -2]) > 2 * err
    am_ref, am_got = rv.argmax(1), gv.argmax(1)
    flips = int((decided & (am_ref != am_got)).sum())
    max_spread, scale = float(spread.max()), float(ref.abs().max())
    return {
        "per_object_err": err, "max_spread": max_spread, "oracle_max_abs": scale,
        "err_over_spread": err / max(max_spread, 1e-9), "tol_frac": tol_frac,
        "max_rel_err": err / max(scale, 1e-3),
        "decided": int(decided.sum()), "scenes": int(ref.shape[0]),
        # A scene with one valid object is decided whatever the error.
        "decided_multi": int((decided & (valid.sum(1) > 1)).sum()),
        "argmax_agree": int((am_ref == am_got).sum()), "flips_on_decided": flips,
        "ok": (max_spread > MIN_SPREAD and err < tol_frac * max_spread
               and bool(decided.any()) and flips == 0),
    }


def tolerance(input_size: int, witness_ratio: float) -> float:
    """The rule's fraction of the spread at input_size, given the witness's
    error ratio (see the module docstring)."""
    if input_size in WITNESS_SIZES:
        return max(TOL_FRAC, WITNESS_FACTOR * witness_ratio)
    return TOL_FRAC


def evaluate(model: AffordanceNet, oracle: AffordanceNet, scene_imgs, mask_imgs, valid,
             backends=BACKENDS, styles=STYLES) -> dict:
    """{(backend, style): check_decisions} of `model`'s backends against
    `oracle`'s module eval forward (the same weights in float32), run once
    per style: the rule at TOL_FRAC, or at an input size in WITNESS_SIZES
    with the tolerance from `model`'s own module forward (the witness; see
    the module docstring). Each result also holds the witness's ratio,
    "witness_bound", "strict_ok" (the rule at TOL_FRAC) and
    "argmax_tested" (a scene with two or more objects is decided)."""
    size = scene_imgs.shape[1]
    out = {}
    for style in styles:
        ref = oracle.score(scene_imgs, mask_imgs, style)
        witness = check_decisions(ref, model.score(scene_imgs, mask_imgs, style), valid)
        tol = tolerance(size, witness["err_over_spread"])
        for backend in backends:
            got = model.score_eval(scene_imgs, mask_imgs, style, backend)
            res = check_decisions(ref, got, valid, tol)
            res["strict_ok"] = check_decisions(ref, got, valid)["ok"]
            res["witness_err_over_spread"] = witness["err_over_spread"]
            res["witness_bound"] = size in WITNESS_SIZES
            res["argmax_tested"] = res["decided_multi"] > 0
            out[(backend, style)] = res
    return out


def make_models(input_size: int, seed: int = 0, device="cuda", block_config=BLOCK_CONFIG):
    """(the bf16 model, its float32 twin for the oracle): the same weights."""
    return tuple(make_model(input_size, seed, device, block_config, dtype)
                 for dtype in ("bfloat16", "float32"))


def prepare(masked, obj_depth, input_size: int):
    """Trunk inputs at input_size: (n, S, S, 3) scenes, (n, K, S, S, 3) masks."""
    cfg = ModelConfig(input_size=input_size)
    return preprocess_depth(masked, cfg), preprocess_depth(obj_depth, cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--input_size", type=int, default=224, choices=(224, 640))
    ap.add_argument("--backend", default="xla_fl", choices=BACKENDS)
    ap.add_argument("--seed", type=int, default=0, help="weights and statistics")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--snapshot", default="",
                    help="not available yet: trained checkpoints come with the "
                         "checkpoint slice; the run stops with an error if given")
    args = ap.parse_args(argv)
    if args.snapshot:
        ap.error("--snapshot needs the checkpoint slice, which is not ported yet")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("decision_parity: no CUDA device is available")
    model, oracle = make_models(args.input_size, args.seed, args.device)
    masked, obj_depth, valid = render(args.scenes, args.device)
    scene_imgs, mask_imgs = prepare(masked, obj_depth, args.input_size)
    res = evaluate(model, oracle, scene_imgs, mask_imgs, valid, (args.backend,))
    agree = sum(r["argmax_agree"] for r in res.values())
    total = sum(r["scenes"] for r in res.values())
    out = {"source": f"1.5 x LeCun-normal convs + alive stats, seed {args.seed}",
           "scenes": args.scenes, "input_size": args.input_size,
           "backend": args.backend, "device": str(args.device),
           "styles": {str(s): r for (_, s), r in res.items()},
           "argmax_agreement_rate": agree / total,
           "ok": all(r["ok"] for r in res.values())}
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
