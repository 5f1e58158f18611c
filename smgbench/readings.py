"""The readings that the limits of a cell's comparison are set from.

    python3 -m smgbench.readings --workload <name> --seeds 1 2 ... \
        --control-seeds 7 8 9 [--out FILE]

For each of `--seeds`: the cell's set-up, one call of the timed path on
each pool batch, and the cell's comparison of the calls that a run with
that seed would sample: the program's readings. For each of
`--control-seeds`: the control in the program's place (the reference in
the next precision below the configuration's, as the entry's
`control_outputs` says) on the same sample, judged by the same
comparison: the control's readings. One JSON line per seed and side, then
a summary line with the largest program reading and the smallest control
reading of each number. A row's "detail" gives, per sampled batch and
style, the entries compared, the program's (or the control's) root mean
square error against float32, the bf16 reference's, and the float32
scores' standard deviation. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from smgbench import run as bench_run
from smgbench import trace as tr


def readings(workload: str, seeds, control_seeds, device: str = "cuda",
             cell_override=None, out=None, fault_seeds=()):
    """(program rows, control rows, summary)."""
    import torch

    bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    _, cell, config, spec = bench_run.cell_spec(bench, workload)
    if cell_override is not None:
        cell, config, spec = cell_override(cell, config, spec)
    entry = bench_run.load_module(bench_run.HERE / "entries" / f"{cell['entry']}.py",
                                  f"smgbench_entry_{cell['entry']}")
    dev = torch.device(device)
    rows = {"program": [], "control": []}

    def emit(side, seed, numbers, seconds):
        row = {"side": side, "seed": seed, **numbers, "seconds": seconds}
        rows[side].append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    sides = [("program", seeds, entry.program_reading),
             ("control", control_seeds, entry.control_reading)]
    if fault_seeds:
        sides.append(("half_batch", fault_seeds, entry.half_batch_reading))
    for side, side_seeds, read in sides:
        rows.setdefault(side, [])
        for seed in side_seeds:
            t0 = time.perf_counter()
            st = entry.setup(config, cell, spec, seed, dev)
            emit(side, seed, read(st, seed, tr.Spans(False)), time.perf_counter() - t0)
            del st
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    names = [k for k in cell["limits"]]
    summary = {"workload": workload,
               "program_max": {k: max(r[k] for r in rows["program"]) for k in names
                               if rows["program"]}}
    for side in rows:
        if side != "program" and rows[side]:
            summary[f"{side}_min"] = {k: min(r[k] for r in rows[side]) for k in names}
    line = json.dumps({"summary": summary})
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
    return rows["program"], rows["control"], summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="smgbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                   help="seeds of the planted half-batch fault (cells that train)")
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench_run.cache_env()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        readings(args.workload, args.seeds, args.control_seeds, out=out,
                 fault_seeds=args.fault_seeds)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
