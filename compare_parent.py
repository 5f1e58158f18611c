"""Another commit of the port against this one on one CUDA card, in turns.

    python3 compare_parent.py --parent DIR --out DIR [--what k3,k7]

DIR holds a checkout of the other commit (for example
`git archive <commit> | tar -x -C DIR`, in a directory that git ignores).
Runs each comparison of --what, each run in a fresh process with its
checkout first on sys.path, in the order parent, this tree, this tree,
parent, with this file's chip_smoke.py for every checkout:

- k3: K3 (the transition) at its three shapes at 224 and 640 with 104
  images: chip_smoke.py's phase_transition (device ms per transition
  beside its bound and torch.matmul of the pooled tensor);
- k5: K5 (the `xla_pk` conv2) at its 58 layer shapes at 224 and 640:
  phase_conv2 (device ms per layer, summed per block and pass, beside
  F.conv2d of the 3x3 part at 224);
- k7: K7 (the `pallas` dense block) on the four blocks at 224 and 640:
  phase_dense_block (device ms per block, split by launch name);
- k6: K6 (the train-mode dense layer) at all layer shapes with 64 images:
  phase_dense_layer_train (a package whose K6 refuses images under 43
  pixels fails its 6 x 6 block);
- train: the b32 training path: init_loop + 3 training steps with
  fast_train_conv2="pk", per-phase host seconds, the loss and a digest of
  the object poses after each step.

Prints one line per run and writes <what>_<label>.json to --out. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TRAIN_STEPS = 3


def _load(root: Path):
    """This file's chip_smoke.py, with the package at `root` first on
    sys.path; checks that the package comes from there."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from smg_tpu_torch.ops import _build

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"smg_tpu_torch came from {_build.__file__}, not {root}")
    _build.library()
    return cs


def run_k3(cs, dev) -> dict:
    kernel = cs.phase_transition(dev)
    return {"kernels": [kernel], "transitions": cs.DETAIL["K3"]}


def run_k5(cs, dev) -> dict:
    kernel = cs.phase_conv2(dev)
    return {"kernels": [kernel], "layers": cs.DETAIL["K5"], "split": cs.DETAIL["K5_split"]}


def run_k7(cs, dev) -> dict:
    kernel = cs.phase_dense_block(dev)
    return {"kernels": [kernel], "blocks": cs.DETAIL["K7"], "split": cs.DETAIL["K7_split"]}


def run_k6(cs, dev) -> dict:
    kernels = cs.phase_dense_layer_train(dev)
    return {"kernels": kernels, "split": cs.DETAIL["K6_split"], "layers": cs.DETAIL["K6"]}


def run_train(cs, dev) -> dict:
    import torch
    from smg_tpu_torch.ops import dense_layer_train
    from smg_tpu_torch.train import loop
    from smg_tpu_torch.train.prod_config import make_prod_loop_cfg, make_prod_trainer

    trainer = make_prod_trainer(cs.B_MAIN, device=dev, fast_train_conv2="pk")
    cfg = make_prod_loop_cfg(cs.B_MAIN, is_testing=False)
    dense_layer_train.fwd_launches = dense_layer_train.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.init_loop(cs.SEED + 1, trainer, cfg)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "steps": []}
    for _ in range(TRAIN_STEPS):
        phases = {}
        last = [time.perf_counter()]
        t0 = last[0]
        state, m = loop.train_step(trainer, cfg, state, timer=cs.step_timer(phases, last))
        out["steps"].append({"seconds": time.perf_counter() - t0, "phases": phases,
                             "loss": float(m.loss),
                             "pose_digest": float(state.scenes.objects.pos.double().sum())})
    out["k6_launches"] = [dense_layer_train.fwd_launches, dense_layer_train.bwd_launches]
    return out


def child(what: str, root: Path, label: str, out_dir: Path) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_parent.py: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _load(root)
    dev = torch.device("cuda:0")
    res = {"label": label, "root": str(root), "card": cs.card_line(), **RUNS[what](cs, dev)}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{what}_{label}.json").write_text(json.dumps(res, indent=1))
    if what == "k3":
        print(label, json.dumps({f"{r['input']}/{r['C']}": r["ms"] for r in res["transitions"]}),
              flush=True)
    if what == "k5":
        print(label, json.dumps({f"{S}/{H}": ms for S, blocks in res["split"].items()
                                 for H, ms in blocks.items()}), flush=True)
    if what == "k7":
        print(label, json.dumps({f"{r['input']}/{r['H']}": {"ms": r["ms"], **r["split_ms"]}
                                 for r in res["blocks"] if "ms" in r}), flush=True)
    if what != "train":
        print(label, json.dumps({k["name"]: k["ms"] for k in res["kernels"]}), flush=True)
    else:
        for i, s in enumerate(res["steps"]):
            print(label, "step", i, f"{s['seconds']:.3f} s", json.dumps(
                {k: round(v, 4) for k, v in s["phases"].items()}),
                  f"loss {s['loss']!r} poses {s['pose_digest']!r}", flush=True)


RUNS = {"k3": run_k3, "k5": run_k5, "k7": run_k7, "k6": run_k6, "train": run_train}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="checkout of the other commit")
    ap.add_argument("--out", type=Path, required=True, help="directory for the JSON results")
    ap.add_argument("--what", default="k3,k7",
                    help="comma-separated comparisons: " + ", ".join(RUNS))
    ap.add_argument("--child", nargs=3, metavar=("WHAT", "ROOT", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        what, root, label = args.child
        return child(what, Path(root).resolve(), label, args.out)
    parent = args.parent.resolve()
    if not (parent / "smg_tpu_torch").is_dir():
        raise SystemExit(f"{parent} holds no smg_tpu_torch package")
    turns = [(parent, "parent_a"), (HERE, "change_a"), (HERE, "change_b"), (parent, "parent_b")]
    failed = []
    whats = args.what.split(",")
    if not set(whats) <= set(RUNS):
        raise SystemExit(f"--what: expected some of {', '.join(RUNS)}, got {args.what}")
    for what in whats:
        for root, label in turns:
            cmd = [sys.executable, str(Path(__file__).resolve()), "--parent", str(parent),
                   "--out", str(args.out), "--child", what, str(root), label]
            if subprocess.run(cmd).returncode != 0:
                failed.append(f"{what} {label}")
    if failed:
        raise SystemExit(f"compare_parent.py: failed runs: {failed}")


if __name__ == "__main__":
    main(sys.argv[1:])
