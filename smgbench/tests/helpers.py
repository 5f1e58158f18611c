"""A cell cut to a size that a CPU test run holds: DenseNet blocks of one
layer each, 64-pixel heightmaps at input 64, two scenes of at most four
small objects, two pool batches."""

import copy
import json
from pathlib import Path

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"

TINY_CATALOG = {
    "enveloping_catalog": [[0, [0.02, 0.01, 0.015]], [1, [0.012, 0.012, 0.03]],
                           [2, [0.014, 0.014, 0.014]], [0, [0.016, 0.016, 0.02]]],
    "sucking_catalog": [[0, [0.02, 0.016, 0.008]], [1, [0.015, 0.015, 0.01]]],
}


def tiny_traffic(spec: dict) -> dict:
    return dict(spec, heightmap_px=64, cells_used=4, enveloping_count=[0, 2],
                sucking_count=[0, 2], jitter_px=1.0,
                cells_px=[[14.5, 14.5], [46.5, 14.5], [14.5, 46.5], [46.5, 46.5]],
                **TINY_CATALOG)


def tiny_config(config: dict, input_size: int = 64) -> dict:
    config = copy.deepcopy(config)
    config["architecture"]["block_config"] = [1, 1, 1, 1]
    config["model"]["input_size"] = input_size
    return config


def tiny(cell: dict, config: dict, spec: dict):
    """cell_override for smgbench.run.run_cell and smgbench.readings."""
    if cell["entry"] == "learn":
        cell = dict(cell, batch=4, pool_batches=3, warmup_calls=3, check_steps=3,
                    trace_seconds=1.0)
        scenes = json.loads((TRAFFIC / f"{spec['scene_traffic']}.json").read_text())
        return cell, tiny_config(config), dict(spec, scene_spec=tiny_traffic(scenes))
    cell = dict(cell, batch=2, pool_batches=2, warmup_calls=1, sample_batches=2,
                reference_chunk=16, trace_seconds=1.0)
    return cell, tiny_config(config), tiny_traffic(spec)
