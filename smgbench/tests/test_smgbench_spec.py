"""BENCHMARK.json against the benchmark's contract, the files it names,
and the modules the benchmark loads."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from smgbench import bounds

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fit_the_check():
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(group):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[group]
    entries = BENCH[group]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert set(e) <= allowed and NAME.match(e["name"]), e
        for k in ("why", "layer") + (("source",) if group == "configs" else ()):
            if k in e:
                assert _line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
    metric_names = [m["name"] for g in ("end_to_end", "per_layer") for m in BENCH[g]]
    assert len(set(metric_names)) == len(metric_names)


def test_configs_are_files_under_paths():
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert cfg["architecture"]["growth_rate"] == 32
        assert cfg["architecture"]["block_config"] == [6, 12, 24, 16]
        assert c["source"].startswith("https://")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_every_workload_names_what_exists():
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and _line(w["why"])
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        cell = json.loads((HERE / "workloads" / f"{w['name']}.json").read_text())
        assert (HERE / "entries" / f"{cell['entry']}.py").is_file()
        assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def _reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_bounds_and_metric_readers():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for g in ("end_to_end", "per_layer"):
        for m in BENCH[g]:
            assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        if m["unit"] == "%":
            assert m["name"].endswith("_roofline") or "mfu" in m["name"] or "share" in m["name"]


def test_moves_is_reported_in_every_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in cells:
            if _reports(cell, m):
                assert _reports(cell, target), (m["name"], cell)
    for cell in cells:
        got = [m["name"] for m in BENCH["end_to_end"] if _reports(cell, m)]
        assert "setup_s" in got and len(got) >= 2
        assert any(_reports(cell, m) for m in BENCH["per_layer"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"trainer", "policy", "models", "kernels", "device"}


def test_flop_counts_of_densenet121():
    arch = json.loads((HERE / "configs" / "densenet121-224.json").read_text())["architecture"]
    assert bounds.trunk_flops(arch, 224) == pytest.approx(5.20e9, rel=1e-3)
    assert bounds.trunk_flops(arch, 640) == pytest.approx(42.5e9, rel=1e-3)
    # One object: the grasp and suction trunks each see the scene and the
    # object, the ETS trunk nothing; two objects add the pair.
    t, h = bounds.trunk_flops(arch, 224), bounds.head_flops(arch, 224, 1024)
    assert bounds.decision_flops(arch, 224, 1024, [1]) == pytest.approx(4 * t + 2 * h)
    assert bounds.decision_flops(arch, 224, 1024, [2]) == pytest.approx(8 * t + 5 * h)


def test_kernel_work_matches_chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    for N, H, C in ((104, 56, 256), (52, 28, 512), (268, 14, 1024)):
        assert bounds.k3_work(N, H, H, C, C // 2) == chip_smoke._transition_work(N, H, C)


def test_no_jax_in_the_benchmark_or_its_program():
    """Importing the benchmark, its reference and the program's modules it
    drives loads no module whose top-level name is jax, jaxlib, flax or
    smg_tpu (smg_tpu_torch is another name)."""
    code = (
        "import sys; import smgbench, smgbench.run, smgbench.readings, smgbench.traffic, "
        "smgbench.weights, smgbench.bounds, smgbench.trace; "
        "import smgbench.reference.densenet, smgbench.reference.scores, "
        "smgbench.reference.policy; import smgbench.entries.decide as d; "
        "import smg_tpu_torch.envs.smg_env, smg_tpu_torch.train.trainer, "
        "smg_tpu_torch.policy.arbitrate, smg_tpu_torch.perception.segment; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    top = set(eval(out.strip().splitlines()[-1]))
    assert "smg_tpu_torch" in top and "smgbench" in top
    assert not top & {"jax", "jaxlib", "flax", "smg_tpu"}
