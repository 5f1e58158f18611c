"""K5's and K7's tile plans against the card: every candidate tiling timed.

    python3 k5k7_plans.py --out DIR [--what k5,k7] [--sizes 224,640]

For each dense block of DenseNet-121 at each input size with 104 images,
times K5 (one layer: its time does not depend on C) and K7 (the whole block
with the norm5 epilogue) under the CANDIDATES tilings of
conv2.tile_candidates (whose patch fits the kernel) that the current cost
model ranks best, by forcing each on the wrapper's plan (device ms,
chip_smoke.device_ms), and checks each against the plain version. Then fits
each plan's cost-model constants to these times: a grid of the constants,
each scored by the log-error of cost x (one fitted time unit) against the
measured times, and reports per block the plan's pick, the fastest tiling and
the pick under the fitted constants. Prints one line per block and writes
k5k7_plans.json to --out. `--refit FILE` refits the constants to an earlier
run's times, with this tree's cost models, and needs no card. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_IMAGES = 104
CANDIDATES = 40   # timed per block: the lowest-cost tilings by the current model


def _best(cands, cost, n=CANDIDATES):
    """The n candidates of lowest model cost (all of them if fewer)."""
    return sorted(cands, key=cost)[:n]


def _fit(rows, cost, grid):
    """The constants of `grid` (dict name -> values) whose cost(consts, row)
    times one least-squares unit (in log space) fits rows' measured ms best."""
    best = None
    for values in itertools.product(*grid.values()):
        consts = dict(zip(grid, values))
        logs = [math.log(r["ms"]) - math.log(cost(consts, r)) for r in rows]
        unit = sum(logs) / len(logs)
        err = math.sqrt(sum((x - unit) ** 2 for x in logs) / len(logs))
        if best is None or err < best[0]:
            best = (err, consts, math.exp(unit))
    return {"rms_log_err": best[0], "consts": best[1], "unit_ms": best[2]}


def fit(res, k5, k7, sms):
    """Each plan's cost-model constants fitted to a run's times (K5's
    staging and tile costs, K7's slice cost)."""
    out = {}
    if res["k5"]:
        def c5(k, r):
            saved = (k5.C2_STAGE_COST, k5.C2_TILE_COST)
            k5.C2_STAGE_COST, k5.C2_TILE_COST = k["stage"], k["tile"]
            try:
                return k5._c2_cost(N_IMAGES, r["H"], r["H"], *r["tile"], sms)
            finally:
                k5.C2_STAGE_COST, k5.C2_TILE_COST = saved
        out["k5"] = _fit(res["k5"], c5, {
            "stage": [0.002, 0.003, 0.004, 0.006, 0.008, 0.011, 0.015, 0.02],
            "tile": [0.0, 0.1, 0.2, 0.3, 0.5, 0.8, 1.2]})
    if res["k7"]:
        def c7(k, r):
            saved = k7.DL_SLICE_COST
            k7.DL_SLICE_COST = k["slice"]
            try:
                return k7._dl_cost(N_IMAGES, r["H"], r["H"], r["C0"], r["L"], *r["tile"], sms)
            finally:
                k7.DL_SLICE_COST = saved
        out["k7"] = _fit(res["k7"], c7, {
            "slice": [0.02, 0.03, 0.04, 0.05, 0.06, 0.08, 0.11, 0.15, 0.2, 0.3]})
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--what", default="k5,k7")
    ap.add_argument("--sizes", default="224,640")
    ap.add_argument("--refit", type=Path,
                    help="a k5k7_plans.json of an earlier run: refit its times, on any machine")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from smg_tpu_torch.ops import conv2 as k5, dense_block as k7

    if args.refit:
        res = json.loads(args.refit.read_text())
        for k, v in fit(res, k5, k7, k5.H100_SMS).items():
            print(f"fit {k}: {json.dumps(v)}", flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k5k7_plans.py: no CUDA device is available")
    import chip_smoke as cs
    from smg_tpu_torch.ops import _build

    _build.library()
    dev = torch.device("cuda:0")
    sms = _build.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    bf, N = torch.bfloat16, N_IMAGES
    res = {"card": cs.card_line(), "k5": [], "k7": []}
    plan_k5, plan_k7 = k5.conv2_plan, k7.dense_plan
    whats = args.what.split(",")
    for S in map(int, args.sizes.split(",")):
        for H, C0, L in cs.densenet_blocks(S):
            if "k5" in whats:
                h1 = torch.randn((N, H, H, 128), generator=gen, device=dev).to(bf)
                a, b = cs._bn(gen, 128, dev)
                w2 = (torch.randn((9, 128, 32), generator=gen, device=dev) * 0.03).to(bf)
                want = k5.conv2_bn_relu_plain(h1, a, b, w2)
                out = torch.empty_like(want)
                pick = k5.conv2_plan(N, H, H, sms)
                for tile in _best(k5.tile_candidates(N, H, H, k5.C2_PATCH_PIXELS),
                                  lambda c: k5._c2_cost(N, H, H, *c, sms)):
                    tiles = k5._tile_count(N, H, H, *tile)
                    patch = tile[0] * (tile[1] + 2) * (tile[2] + 2)
                    plan = k5.Conv3x3Plan(*tile, tiles, min(tiles, sms),
                                          k5.C3_WEIGHT_BYTES + 2 * patch * k5.C3_PIXEL_BYTES
                                          + k5.C2_BARRIER_BYTES)
                    k5.conv2_plan = lambda *_, p=plan: p
                    try:
                        k5.conv2_bn_relu(h1, a, b, w2, out=out)
                        err = cs.rel_err(out, want)
                        cs.check(err <= cs.TOL_BF16, f"K5 {S} H={H} {tile}: rel err {err}")
                        ms = cs.device_ms(lambda: k5.conv2_bn_relu(h1, a, b, w2, out=out))
                    finally:
                        k5.conv2_plan = plan_k5
                    res["k5"].append({"input": S, "H": H, "tile": tile, "tiles": tiles,
                                      "ms": ms, "pick": tile == pick[:3]})
                _report("K5", S, H, pick, res["k5"])
                del h1, want, out
            if "k7" in whats:
                packed = k7.pack_dense_block(cs._eval_layers(gen, dev, C0, L))
                Cf = C0 + 32 * L
                at, bt = cs._bn(gen, Cf, dev)
                ep = k7.pack_final_bn(at, bt)
                x = torch.randn((N, H, H, C0), generator=gen, device=dev).to(bf)
                buf = torch.zeros((N, H, H, Cf), dtype=bf, device=dev)
                buf[..., :C0] = x
                ref = buf.clone()
                want = k7.dense_block_apply_plain(ref, packed, ep, "final_bn")
                out = torch.empty_like(want)
                pick = k7.dense_plan(N, H, H, C0, L, sms)
                for tile in _best(k5.tile_candidates(N, H, H, k7.DL_PATCH_PIXELS),
                                  lambda c: k7._dl_cost(N, H, H, C0, L, *c, sms)):
                    tiles = k5._tile_count(N, H, H, *tile)
                    patch = tile[0] * (tile[1] + 2) * (tile[2] + 2)
                    plan = k5.Conv3x3Plan(*tile, tiles, min(tiles, sms),
                                          k7.DL_H2_OFFSET + 256 * patch + k7.DL_BARRIER_BYTES)
                    k7.dense_plan = lambda *_, p=plan: p
                    try:
                        k7.dense_block_apply(buf, packed, ep, "final_bn", out=out)
                        err = cs.rel_err(out, want)
                        cs.check(err <= cs.TOL_BF16, f"K7 {S} H={H} {tile}: rel err {err}")
                        ms = cs.device_ms(lambda: k7.dense_block_apply(
                            buf, packed, ep, "final_bn", out=out), calls=2)
                    finally:
                        k7.dense_plan = plan_k7
                    res["k7"].append({"input": S, "H": H, "C0": C0, "L": L, "tile": tile,
                                      "tiles": tiles, "ms": ms, "pick": tile == pick[:3]})
                _report("K7", S, H, pick, res["k7"])
                del packed, buf, ref, want, out, x
    res["fit"] = fit(res, k5, k7, sms)
    for k, v in res["fit"].items():
        print(f"fit {k}: {json.dumps(v)}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "k5k7_plans.json").write_text(json.dumps(res, indent=1))


def _report(name, S, H, pick, rows):
    rows = [r for r in rows if r["input"] == S and r["H"] == H]
    fast = min(rows, key=lambda r: r["ms"])
    picked = [r["ms"] for r in rows if r["pick"]]
    print(f"{name} {S} H={H}: plan {tuple(pick[:3])} "
          f"{f'{picked[0]:.4f} ms' if picked else 'not among the timed'}; fastest "
          f"{tuple(fast['tile'])} {fast['ms']:.4f} ms", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
