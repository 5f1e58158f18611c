"""Run one cell of the benchmark once and print its result line.

    python3 -m smgbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the program built from the configuration, the kernels
loaded or built, the weights and the traffic pool made on the card, warm-up
calls over every shape) is timed as `setup_s`. Then one caller makes
calls in a closed loop: each starts when the last has returned, until
`--seconds` have passed; the window ends when the last call returns. With
`--trace 1` the benchmark's spans synchronize, the first `trace_seconds`
of the window run under torch.profiler, and the cell's per-layer metrics
are reported instead of its end-to-end ones. Once the window has closed,
the peak memory is read, the program's state is freed, and a sample of
the calls is judged against the plain reference: each compared number and
its limit go to standard error as its last lines, and into the result
line under "checks", its last key.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "smg_tpu")
def _profiled():
    """The profiler's activities: the device's alone, so that recording the
    host's operators does not slow the host that paces the calls."""
    import torch

    return [torch.profiler.ProfilerActivity.CUDA]


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its kernels into smg_tpu_torch/_build/ itself)."""
    cache = ROOT / ".smgbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str):
    """(cell entry of BENCHMARK.json, cell file, configuration, traffic)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    entry = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return (entry, load_json(HERE / "workloads" / f"{workload}.json"),
            load_json(ROOT / cfg["file"]), load_json(HERE / "traffic" / f"{entry['traffic']}.json"))


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else None


class Call(NamedTuple):
    start: float       # host clock, s
    end: float
    scenes: int        # scenes decided or experiences learned
    flops: float       # the useful FLOPs it needed
    profiled: bool     # made while the profiler ran


class Run:
    """What the metric readers read: the window's calls, spans, trace and
    counters, and the set-up time."""

    def __init__(self, workload: str, cell: dict, config: dict, entry, state, trace: bool):
        self.workload, self.cell, self.config = workload, cell, config
        self.entry, self.state, self.trace_on = entry, state, trace
        self.calls: list[Call] = []        # every call of the window
        self.window_s = 0.0
        self.setup_s = 0.0
        self.spans = None
        self.trace = None                  # trace.Trace of the profiled part
        self.counters: dict[str, list] = {}
        self.counting = False              # probes record while True


def window(run: Run, seconds: float, spans) -> list:
    """Calls back to back until `seconds` have passed; their answers."""
    import torch

    from smgbench import trace as tr

    entry, st = run.entry, run.state
    answers = []
    prof = None

    def profiling(on: bool):
        if not on:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        run.counting = spans.profiled = on

    if run.trace_on:
        prof = torch.profiler.profile(activities=_profiled())
        prof.__enter__()
        profiling(True)
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 - start >= seconds:
            break
        with spans("call"):
            a = entry.call(st, i, spans)
        t1 = time.perf_counter()
        answers.append(a)
        run.calls.append(Call(t0, t1, entry.scenes_of(st, a), entry.flops_of(st, a),
                              spans.profiled))
        i += 1
        if spans.profiled and t1 - start >= run.cell["trace_seconds"]:
            profiling(False)
    run.window_s = time.perf_counter() - start
    if spans.profiled:
        profiling(False)
    if prof is not None:
        run.trace = tr.Trace(prof, spans.marks, "call")
    return answers


def run_cell(workload: str, seed: int, seconds: float, trace: bool, bench: dict,
             device: str = "cuda", cell_override=None) -> tuple[dict, dict]:
    """Set up, measure and judge one run; (result line, checks).
    `cell_override(cell, config, traffic)` may change the specs (tests)."""
    import torch

    from smgbench import trace as tr

    entry_b, cell, config, spec = cell_spec(bench, workload)
    if cell_override is not None:
        cell, config, spec = cell_override(cell, config, spec)
    entry = load_module(HERE / "entries" / f"{cell['entry']}.py", f"smgbench_entry_{cell['entry']}")
    metrics = metrics_of(bench, workload, trace)
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py",
                                      "smgbench_metric_" + m["name"].replace(".", "_"))
               for m in metrics}
    dev = torch.device(device)
    t_entry = time.perf_counter()
    state = entry.setup(config, cell, spec, seed, dev)
    run = Run(workload, cell, config, entry, state, trace)
    for r in readers.values():
        if hasattr(r, "install"):
            r.install(run)
    spans = tr.Spans(trace and dev.type == "cuda")
    run.spans = spans
    t_warm = time.perf_counter()
    entry.warm(state, tr.Spans(False))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - _T0
    print(f"set-up seconds: imports and entry {t_entry - _T0:.3f}, warm-up "
          f"{time.perf_counter() - t_warm:.3f}, total {run.setup_s:.3f}", file=sys.stderr)

    answers = window(run, seconds, spans)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    outs = entry.release(state, answers, seed)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.judge(state, outs)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": len(run.calls), "failed": 0,
              "metrics": values, "device": device_info}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="smgbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    # One process with one host thread for torch's own operators: the host
    # launches the kernels, and idle worker threads only add jitter.
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench)
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
