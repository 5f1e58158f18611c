"""K3 (the DenseNet transition) under variants of its kernel and tile plan, on one CUDA card.

    python3 k3_variants.py --out DIR [--variants base,pool_only,...]

Each variant is a copy of smg_tpu_torch/ with text substitutions in
csrc/common.cuh (its transition_kernel) and, optionally, other
(rows, cols) tiles forced on the plan for some channel counts. Each copy
builds transition.cu alone and, in a fresh process, times K3 at the three
transitions of DenseNet-121 at 224 and 640 with 104 images (device ms,
chip_smoke.device_ms, the median of three readings of 10 calls each) and
its error against the plain version. The diagnostic variants that skip a
phase (pool_only, product_only, k_rotated_product_only) compute wrong
outputs on purpose: they time the other phase. Prints one line per variant and writes k3_variants.json to --out.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

K_ROTATED = [("const int k0 = kt * KB;", "const int k0 = ((kt + blockIdx.x * 7) % KT) * KB;"),
             ("const int c = ((kt * KB + kk) >> 3) + (lane >> 4);",
              "const int c = ((((kt + blockIdx.x * 7) % KT) * KB + kk) >> 3) + (lane >> 4);")]

# name -> (substitutions in common.cuh, {C: (rows, cols)} forced on the plan)
VARIANTS = {
    "base": ([], {}),
    # the pool alone (the product loop runs no k-slice) / the product alone
    # (the pool stages nothing): where a transition's time goes
    "pool_only": ([("const int KT = Cp / KB;", "const int KT = 0;")], {}),
    "product_only": ([("const int n_stages = (BM / pr) * kcs;", "const int n_stages = 0;")], {}),
    # each block starts its weight k-slices at its own slice, so that the
    # blocks do not read the same lines of L2 at once (changes each block's
    # summation order: a diagnostic), with the product alone too
    "k_rotated": (K_ROTATED, {}),
    "k_rotated_product_only": (K_ROTATED + [("const int n_stages = (BM / pr) * kcs;",
                                             "const int n_stages = 0;")], {}),
    # six 8 KB pool stages in the same ring (five in flight, not two)
    "pool6": ([("constexpr int TR_POOL_STAGES = 3; ", "constexpr int TR_POOL_STAGES = 6; ")], {}),
    # a 64 KB ring of four stages for both phases (one block per SM at 224's shapes)
    "ring4": ([("constexpr int TR_STAGES = 3; ", "constexpr int TR_STAGES = 4; "),
               ("constexpr int TR_POOL_STAGES = 3; ", "constexpr int TR_POOL_STAGES = 4; ")], {}),
    # other tiles than the plan's: more blocks (t1_64, t1_32) or more rows (t2_128, t3_64)
    "t1_64": ([], {256: (64, 256)}),
    "t1_32": ([], {256: (32, 512), 512: (32, 512)}),
    "t2_128": ([], {512: (128, 128)}),
    "t3_64": ([], {1024: (64, 256)}),
}
RING_BYTES = {"ring4": 4 * 16384}


def child(root: Path, name: str) -> None:
    import torch

    sys.path.insert(0, str(root))
    from smg_tpu_torch.ops import _build

    _build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items() if k == "smg_transition"}
    _build.library()
    from smg_tpu_torch.ops import transition as k3

    if not Path(k3.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"smg_tpu_torch came from {k3.__file__}, not {root}")
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs

    forced = VARIANTS[name][1]
    planned = k3.transition_plan
    k3.TR_RING_BYTES = RING_BYTES.get(name, k3.TR_RING_BYTES)

    def plan(Q, C, C_out, sms=k3.H100_SMS):
        p = planned(Q, C, C_out, sms)
        if C in forced:
            rows, cols = forced[C]
            p = p._replace(rows=rows, cols=cols, grid=-(-Q // rows),
                           smem_bytes=k3.transition_smem(rows, C))
        return p._replace(smem_bytes=k3.transition_smem(p.rows, C))

    k3.transition_plan = plan
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    res = {}
    for S in cs.SIZES:
        for H, C in cs.transitions(S):
            x = torch.randn((cs.STREAMS, H, H, C), generator=gen, device=dev).to(torch.bfloat16)
            a, b = cs._bn(gen, C, dev)
            wt = (torch.randn((C, C // 2), generator=gen, device=dev) * C ** -0.5).to(
                torch.bfloat16)
            got = k3.transition(x, a, b, wt)
            err = cs.rel_err(got, k3.transition_plain(x, a, b, wt))
            ms = statistics.median(cs.device_ms(lambda: k3.transition(x, a, b, wt, out=got),
                                                calls=10) for _ in range(3))
            res[f"{S}/{H}x{H}x{C}"] = {"ms": ms, "rel_err": err}
    print("RESULT " + json.dumps({"card": cs.card_line(), "transitions": res}), flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True, help="directory for the JSON results")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated: " + ", ".join(VARIANTS))
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "NAME"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(Path(args.child[0]).resolve(), args.child[1])
    names = args.variants.split(",")
    if not set(names) <= set(VARIANTS):
        raise SystemExit(f"--variants: expected some of {', '.join(VARIANTS)}")
    work = args.out / "k3_variant_trees"
    results, failed = {}, []
    for name in names:
        root = work / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(HERE / "smg_tpu_torch", root / "smg_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for f in (root / "smg_tpu_torch" / "csrc").glob("*.cu"):
            if f.name != "transition.cu":
                f.unlink()
        cuh = root / "smg_tpu_torch" / "csrc" / "common.cuh"
        text = cuh.read_text()
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in common.cuh")
            text = text.replace(old, new)
        cuh.write_text(text)
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--out", str(args.out),
                            "--child", str(root), name], capture_output=True, text=True)
        line = next((l for l in r.stdout.splitlines() if l.startswith("RESULT ")), None)
        if line is None:
            failed.append(name)
            print(name, "FAILED", r.stdout[-2000:], r.stderr[-4000:], flush=True)
            continue
        results[name] = json.loads(line[len("RESULT "):])
        print(name, json.dumps({k: round(v["ms"], 5) for k, v in
                                results[name]["transitions"].items()}), flush=True)
        shutil.rmtree(root, ignore_errors=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "k3_variants.json").write_text(json.dumps(results, indent=1))
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise SystemExit(f"k3_variants.py: failed variants: {failed}")


if __name__ == "__main__":
    main(sys.argv[1:])
