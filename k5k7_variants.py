"""K5 and K7 under diagnostic variants of their kernels, on one CUDA card.

    python3 k5k7_variants.py --out DIR [--variants base,consumer_only,...] [--sizes 224]

Each variant is a copy of smg_tpu_torch/ with text substitutions in its
CUDA sources (csrc/conv2.cu, csrc/dense_block.cu, csrc/conv3x3_sm90.cuh,
csrc/sm90.cuh). Each copy builds in a fresh process and times, with 104
images at each input size, K5 on one layer of each dense block (times the
block's layer count: K5's time does not depend on C) and K7 on each whole
block with the norm5 epilogue (device ms, chip_smoke.device_ms). Every
variant but `base` leaves out part of the work on purpose and computes wrong
outputs: it times the rest. Since both kernels include conv3x3_sm90.cuh, a
variant of the 3x3 moves both. Prints one line per variant and writes
k5k7_variants.json to --out. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# K5's producer stages nothing (no loads, no transform, no zero fill): the
# consumers alone, on whatever the buffers hold.
NO_PRODUCER = [("      for (int bt = 0; bt < K5_BATCHES; ++bt) {",
                "      for (int bt = 0; bt < K5_BATCHES * (n_tiles < 0); ++bt) {"),
               ("      smg::cp_async_wait<3>();\n      transform(0);",
                "      if (n_tiles < 0) {\n      smg::cp_async_wait<3>();\n      transform(0);"),
               ("      transform(3);\n", "      transform(3);\n      }\n")]
# The 3x3's wgmmas replaced by an add that keeps its A fragments live.
NO_WGMMA = [("      wgmma_m64n32k16(d, a[ks], desc0 + (uint64_t)((tap * C3_CIN + ks * 16) * 64 >> 4),\n"
             "                      (accumulate || ks > 0) ? 1 : 0);",
             "      d[ks] += __uint_as_float(a[ks][0] ^ a[ks][1] ^ a[ks][2] ^ a[ks][3]);")]
# The warpgroup-wide wgmma fence, commit and wait made empty.
NO_SYNC = [('  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");',
            '  asm volatile("" ::: "memory");'),
           ('  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");',
            '  asm volatile("" ::: "memory");'),
           ('  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(N) : "memory");',
            '  asm volatile("" ::: "memory");')]
# Half the 3x3's ldmatrix: k-slices 4-7 of a tap reuse 0-3's registers.
HALF_LDMATRIX = [(
    "    for (int ks = 0; ks < 8; ++ks) ldmatrix_x4(row + (((2 * ks + hi) ^ (q & 7)) << 4), a[ks]);",
    "    for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(row + (((2 * ks + hi) ^ (q & 7)) << 4), a[ks]);\n"
    "    for (int ks = 4; ks < 8; ++ks) {\n"
    "      a[ks][0] = a[ks - 4][1]; a[ks][1] = a[ks - 4][2];\n"
    "      a[ks][2] = a[ks - 4][3]; a[ks][3] = a[ks - 4][0];\n"
    "    }")]

# name -> {file: [(old, new), ...]}
VARIANTS = {
    "base": {},
    # K5: the producer's loads skipped (it still zero-fills and transforms)
    "no_load": {"conv2.cu": [("          if (p >= 0) {\n            smg::cp_async16(",
                              "          if (p >= 0 && n_tiles < 0) {\n            smg::cp_async16(")]},
    # K5: the consumers skip their tasks; the producer alone
    "producer_only": {"conv2.cu": [(
        "      for (int u = wg * smg::C3W_TASK; u < M; u += 2 * smg::C3W_TASK) {",
        "      for (int u = wg * smg::C3W_TASK; u < M * (n_tiles < 0); u += 2 * smg::C3W_TASK) {")]},
    "consumer_only": {"conv2.cu": NO_PRODUCER},
    "consumer_only_no_wgmma": {"conv2.cu": NO_PRODUCER, "conv3x3_sm90.cuh": NO_WGMMA},
    "consumer_only_no_wgmma_no_sync": {"conv2.cu": NO_PRODUCER, "conv3x3_sm90.cuh": NO_WGMMA,
                                       "sm90.cuh": NO_SYNC},
    "consumer_only_half_ldmatrix": {"conv2.cu": NO_PRODUCER, "conv3x3_sm90.cuh": HALF_LDMATRIX},
    "consumer_only_half_ldmatrix_no_wgmma": {"conv2.cu": NO_PRODUCER,
                                             "conv3x3_sm90.cuh": HALF_LDMATRIX + NO_WGMMA},
    # K7: the fused layer without its 3x3 (GEMM, h2 and zero fill), without
    # its GEMM (no k-slices: 3x3 on relu(b2)), without the 3x3's stores
    "k7_no_3x3": {"dense_block.cu": [(
        "      for (int u = wg * smg::C3W_TASK; u < M; u += 2 * smg::C3W_TASK) {",
        "      for (int u = wg * smg::C3W_TASK; u < M * (n_tiles < 0); u += 2 * smg::C3W_TASK) {")]},
    "k7_no_gemm": {"dense_block.cu": [("  const int KT = C / DL_BK;", "  const int KT = 0;")]},
    "k7_no_3x3_store": {"dense_block.cu": [(
        "        smg::c3w_store(total, buf, t, u, wq, lane, H, W, Cf, C);",
        "        if (total[0] == 12345.0f) smg::c3w_store(total, buf, t, u, wq, lane, H, W, Cf, C);")]},
}


def child(root: Path, name: str, sizes) -> dict:
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as cs
    from smg_tpu_torch.ops import _build, conv2 as k5, dense_block as k7

    if not Path(k5.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"smg_tpu_torch came from {k5.__file__}, not {root}")
    _build.library()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    bf, N, res = torch.bfloat16, 104, {"variant": name, "card": cs.card_line()}
    for S in sizes:
        for H, C0, L in cs.densenet_blocks(S):
            h1 = torch.randn((N, H, H, 128), generator=gen, device=dev).to(bf)
            a, b = cs._bn(gen, 128, dev)
            w2 = (torch.randn((9, 128, 32), generator=gen, device=dev) * 0.03).to(bf)
            out = torch.empty((N, H, H, 32), dtype=bf, device=dev)
            res[f"K5 {S}/{H}"] = L * cs.device_ms(lambda: k5.conv2_bn_relu(h1, a, b, w2, out=out))
            del h1, out
            packed = k7.pack_dense_block(cs._eval_layers(gen, dev, C0, L))
            Cf = C0 + 32 * L
            ep = k7.pack_final_bn(*cs._bn(gen, Cf, dev))
            buf = torch.randn((N, H, H, Cf), generator=gen, device=dev).to(bf)
            fin = torch.empty_like(buf)
            res[f"K7 {S}/{H}"] = cs.device_ms(
                lambda: k7.dense_block_apply(buf, packed, ep, "final_bn", out=fin), calls=2)
            del buf, fin, packed
        for k in ("K5", "K7"):
            res[f"{k} {S} pass"] = sum(v for key, v in res.items()
                                       if key.startswith(f"{k} {S}/"))
    return res


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sizes", default="224")
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "NAME"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sizes = [int(x) for x in args.sizes.split(",")]
    if args.child:
        root, name = Path(args.child[0]).resolve(), args.child[1]
        res = child(root, name, sizes)
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"{name}.json").write_text(json.dumps(res, indent=1))
        print(name, json.dumps({k: round(v, 4) for k, v in res.items()
                                if isinstance(v, float)}), flush=True)
        return
    names = args.variants.split(",")
    if not set(names) <= set(VARIANTS):
        raise SystemExit(f"--variants: expected some of {', '.join(VARIANTS)}")
    work = args.out / "variants"
    results, failed = [], []
    for name in names:
        root = work / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(HERE / "smg_tpu_torch", root / "smg_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for fname, subs in VARIANTS[name].items():
            path = root / "smg_tpu_torch" / "csrc" / fname
            text = path.read_text()
            for old, new in subs:
                if old not in text:
                    raise SystemExit(f"{name}: {fname} has no {old!r}")
                text = text.replace(old, new)
            path.write_text(text)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--out", str(args.out),
               "--sizes", args.sizes, "--child", str(root), name]
        ok = subprocess.run(cmd).returncode == 0
        shutil.rmtree(root, ignore_errors=True)
        if not ok:
            failed.append(name)
            continue
        results.append(json.loads((args.out / f"{name}.json").read_text()))
    shutil.rmtree(work, ignore_errors=True)
    (args.out / "k5k7_variants.json").write_text(json.dumps(results, indent=1))
    if failed:
        raise SystemExit(f"k5k7_variants.py: failed variants: {failed}")


if __name__ == "__main__":
    main(sys.argv[1:])
