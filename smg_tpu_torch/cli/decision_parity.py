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

Without --snapshot the weights are the test's discriminative construction
(tests/test_decision_parity.py:147-160): Flax's default conv init (LeCun
normal, variance 1 / fan_in) with every kernel scaled 1.5x, and BatchNorm
statistics that keep the ReLU chain alive at depth
(tests/test_fast_trunk.py:20-41), from a seeded torch.Generator: He
normal (variance 2 / fan_in, untruncated) scaled by 1.5 / sqrt(2). At
plain init full-depth trunks map the objects to near-equal values and the
check would be vacuous; at He x 1.5 the values explode. These are the
check's own weights, not init_params' (Flax's truncated LeCun normal):
they stay what every recorded decision-parity reading was taken on.

With --snapshot the weights are a trained run's models/snapshot
(train/checkpoints.py::save_params) instead. A snapshot trained at input
224 scores at 640 with its heads' global 7 x 7 conv carried onto the
20 x 20 feature grid (`carry_head_kernel`): the 640 input is the 224
heightmap zoomed 2x and padded by 96 pixels, 3 feature cells, so each
kernel tap covers the 2 x 2 cells of its zoomed patch at a quarter of
its weight, and the border cells get 0.

    python -m smg_tpu_torch.cli.decision_parity [--scenes 8]
        [--input_size 224|640] [--backend xla_fl|xla_pk|pallas]
        [--snapshot logs/<run>/models/snapshot]

Prints one JSON line (per style: the error, the spread, the tolerance,
the decided scenes, argmax agreement) and exits 1 when a check fails. Runs
on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from smg_tpu_torch.envs import smg_env
from smg_tpu_torch.models.affordance import (AffordanceNet, ModelConfig,
                                             preprocess_depth)
from smg_tpu_torch.models.densenet import BLOCK_CONFIG, DenseNetTrunk, bn_eval, no_tf32
from smg_tpu_torch.models.fast_trunk import BACKENDS
from smg_tpu_torch.train import checkpoints

STYLES = (0, 1, 2)
CONV_SCALE = 1.5 / math.sqrt(2.0)   # He normal -> 1.5 x LeCun normal
TOL_FRAC = 0.25
MIN_SPREAD = 0.05
# Where bf16 rounding alone misses the rule at random weights: the bf16
# module forward reads 0.232-0.641 of the spread at 640, 0.103-0.237 at
# 224; the backends read 0.77-1.55 times the bf16 module forward's ratio at
# 640 (chip_smoke.py on an H100 80GB HBM3 at 700 W). The witness stays for
# trained snapshots too: on the b32 run's snapshot (run_port_b32.sh, the
# same card) the backends read 0.097-0.129 at 224 and 0.152-0.281 at 640,
# xla_pk's style 2 above 0.25, against the bf16 module forward's
# 0.152-0.227 there.
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


# The stem's statistic on a trained cold snapshot (cold seed 1's grasp
# trunk, stage_parity.py on an H100): conv0 taps of mean |w| 0.068; norm0's
# running variances from 2.6e-3 to 6.7e-2 (minimum to 90th percentile),
# block 1's norm1 from 1.1e-2 (the fold a up to 9.6 on a stem channel).
SNAPSHOT_TAP_STD = 0.068
SNAPSHOT_VARS = {"norm0": (2.6e-3, 6.7e-2), "norm1": (1.1e-2, 1.0)}


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    _, e = torch.frexp(v)
    return torch.where(v == 0, torch.zeros_like(v), torch.ldexp(torch.ones_like(v), e - 8))


def snapshot_stem_(model: nn.Module, x: torch.Tensor, seed: int, gray_tap: bool = True) -> None:
    """Give every trunk of `model` the trained snapshot's stem statistic,
    drawn from a numpy seed, on the inputs x (N, S, S, 3):

    - conv0 reads input channel 0 through taps v exact in bf16 (normal,
      SNAPSHOT_TAP_STD); with gray_tap, channel 1 adds 0.75 bf16 steps of
      each tap (also exact), so the module forward's three-channel conv is
      exact while the fast path's gray tap, the taps summed over the input
      channels and rounded once (fast_trunk._build_operands), rounds every
      tap up by a quarter step: on the flat background of a depth map that
      is a bias of the channel. Without gray_tap both forms are exact;
    - norm0 and block 1's norm1 (on the stem's channels) at running
      variances log-uniform over SNAPSHOT_VARS, centred on x's means (scale
      1, bias 0), so that they amplify what their input carries.
    The model's float32 and bf16 twins take the same draw."""
    rng = np.random.RandomState(seed)
    dev = x.device

    def loguniform(lo, hi, n):
        v = np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.float32)
        return torch.as_tensor(v, device=dev)

    with torch.no_grad(), no_tf32():
        for trunk in (m for m in model.modules() if isinstance(m, DenseNetTrunk)):
            w = trunk.conv0.weight
            v = torch.as_tensor(rng.normal(0.0, SNAPSHOT_TAP_STD, (w.shape[0],) + w.shape[2:])
                                .astype(np.float32), device=dev).to(torch.bfloat16).float()
            w.zero_()
            w[:, 0] = v
            if gray_tap:
                w[:, 1] = 0.75 * bf16_ulp(v)
            y = F.conv2d(x.float().permute(0, 3, 1, 2), w, stride=2, padding=3)
            n0 = trunk.norm0
            n0.running_mean.copy_(y.mean(dim=(0, 2, 3)))
            n0.running_var.copy_(loguniform(*SNAPSHOT_VARS["norm0"], w.shape[0]))
            n0.weight.fill_(1.0)
            n0.bias.zero_()
            stem = F.max_pool2d(torch.relu(bn_eval(y, n0, torch.float32)), 3, 2, padding=1)
            c = stem.shape[1]
            for layer in trunk.denseblock1.children():
                n1 = layer.norm1
                n1.running_mean[:c] = stem.mean(dim=(0, 2, 3))
                n1.running_var[:c] = loguniform(*SNAPSHOT_VARS["norm1"], c)


def carry_head_kernel(w: torch.Tensor, feature_hw: int) -> torch.Tensor:
    """A head's global conv kernel (O, C, 7, 7) trained at input 224 ->
    (O, C, 20, 20) for input 640 (see the module docstring)."""
    k = w.shape[-1]
    pad = (feature_hw - 2 * k) // 2
    if (k, feature_hw) != (7, 20):
        raise ValueError(f"no carry of a {k} x {k} head kernel to {feature_hw} x {feature_hw}")
    w2 = w.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) / 4.0
    return F.pad(w2, (pad, pad, pad, pad))


def load_snapshot(model: AffordanceNet, path: str) -> None:
    """A run's snapshot into `model`, the heads' global convs carried to
    the model's feature grid where the snapshot's input size differs."""
    state = checkpoints.load_params(path)
    want = model.state_dict()
    for name, w in state.items():
        if name.endswith("head.conv1.weight") and w.shape != want[name].shape:
            state[name] = carry_head_kernel(w, model.cfg.feature_hw)
    model.load_state_dict(state)


def make_model(input_size: int, seed: int = 0, device="cuda",
               block_config=BLOCK_CONFIG, dtype: str = "bfloat16",
               snapshot: str = "") -> AffordanceNet:
    """The check's model: a trained snapshot's weights, or else conv
    kernels 1.5 x LeCun normal (He normal x CONV_SCALE) with alive BatchNorm
    statistics, made on the CPU from `seed`; then moved. The weights do not
    depend on dtype, the compute does. Style 2 scores through
    `AffordanceNet.head(2)`, which follows the model's tied_ets_head
    (scripts/decision_parity.py:102)."""
    model = AffordanceNet(ModelConfig(method="reinforcement", input_size=input_size,
                                      dtype=dtype, block_config=block_config))
    if snapshot:
        load_snapshot(model, snapshot)
        return model.to(device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_in", nonlinearity="relu",
                                        generator=gen)
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


def make_models(input_size: int, seed: int = 0, device="cuda", block_config=BLOCK_CONFIG,
                snapshot: str = ""):
    """(the bf16 model, its float32 twin for the oracle): the same weights."""
    return tuple(make_model(input_size, seed, device, block_config, dtype, snapshot)
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
                    help="a run's models/snapshot in place of the random weights")
    args = ap.parse_args(argv)
    if args.snapshot and not os.path.isfile(args.snapshot):
        ap.error(f"--snapshot {args.snapshot}: no such file")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("decision_parity: no CUDA device is available")
    model, oracle = make_models(args.input_size, args.seed, args.device,
                                snapshot=args.snapshot)
    masked, obj_depth, valid = render(args.scenes, args.device)
    scene_imgs, mask_imgs = prepare(masked, obj_depth, args.input_size)
    res = evaluate(model, oracle, scene_imgs, mask_imgs, valid, (args.backend,))
    agree = sum(r["argmax_agree"] for r in res.values())
    total = sum(r["scenes"] for r in res.values())
    source = (args.snapshot if args.snapshot
              else f"1.5 x LeCun-normal convs + alive stats, seed {args.seed}")
    out = {"source": source,
           "scenes": args.scenes, "input_size": args.input_size,
           "backend": args.backend, "device": str(args.device),
           "styles": {str(s): r for (_, s), r in res.items()},
           "argmax_agreement_rate": agree / total,
           "ok": all(r["ok"] for r in res.values())}
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
