"""The traffic generator: repeatable by seed, and the draws it copies from
the port (object counts, catalogs, drop cells) still match the port."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from smgbench import traffic
from smgbench.tests.helpers import tiny_traffic

torch.set_num_threads(1)
SPEC = json.loads((Path(__file__).resolve().parents[1] / "traffic" / "observations.json").read_text())


def _same(a: traffic.Scenes, b: traffic.Scenes) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)


def test_repeats_by_seed():
    spec = tiny_traffic(SPEC)
    big = 2**31 + 9
    a = traffic.make_pool(spec, 2, 3, big, "cpu")
    b = traffic.make_pool(spec, 2, 3, big, "cpu")
    c = traffic.make_pool(spec, 2, 3, big + 1, "cpu")
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not all(_same(x, y) for x, y in zip(a, c))


def test_counts_follow_spawn_objects():
    """The count draw is physics/scene.py::spawn_objects': 0-5 enveloping
    and 0-5 sucking objects, at least one sucking one when there is no
    enveloping one; both its frequencies and ours near the exact law."""
    from smg_tpu_torch.physics import scene as scene_mod

    exact = np.zeros(11)
    for g in range(6):
        for s in range(6):
            exact[g + (s if g else max(s, 1))] += 1 / 36
    B = 6000
    gen = torch.Generator().manual_seed(5)
    n_g, n_s = traffic.count_draw(SPEC, B, gen, "cpu")
    ours = np.bincount((n_g + n_s).numpy(), minlength=11) / B
    port = scene_mod.spawn_objects(torch.Generator().manual_seed(6), 1500, "cpu").active
    theirs = np.bincount(port.sum(dim=1).numpy(), minlength=13)[:11] / 1500
    assert ours[0] == 0 and theirs[0] == 0
    np.testing.assert_allclose(ours, exact, atol=0.015)
    np.testing.assert_allclose(theirs, exact, atol=0.03)
    assert SPEC["slots"] == scene_mod.N_SLOTS


def test_catalogs_and_cells_match_the_port():
    from smg_tpu_torch.physics import scene as scene_mod
    from smg_tpu_torch.physics import shapes

    for key, (kinds, half) in (("enveloping_catalog", shapes.ENVELOPING_CATALOG),
                               ("sucking_catalog", shapes.SUCKING_CATALOG)):
        assert [e[0] for e in SPEC[key]] == kinds.tolist()
        np.testing.assert_allclose([e[1] for e in SPEC[key]], half, rtol=0, atol=1e-7)
    assert SPEC["shape_codes"] == {"box": shapes.BOX, "cylinder": shapes.CYLINDER,
                                   "sphere": shapes.SPHERE}
    grid = scene_mod.drop_grid(False, "cpu").numpy()                      # (12, 2) m
    ws = np.array(SPEC["workspace_m"])
    px = (grid - ws[:, 0]) / SPEC["resolution_m"] - 0.5
    np.testing.assert_allclose(px, SPEC["cells_px"], atol=1e-4)


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_scenes_are_whole_and_apart(seed):
    """Full-size heightmaps: every valid object's whole footprint is its
    mask, no two masks meet, and the depth shows each object's top."""
    sc = traffic.make_pool(SPEC, 1, 4, seed, "cpu")[0]
    valid = sc.valid
    assert torch.equal(sc.number, valid.sum(dim=1).int())
    assert bool((valid.sum(dim=1) >= 1).all())
    pix = sc.masks.sum(dim=(2, 3))
    assert bool((pix[valid] >= 100).all()) and bool((pix[~valid] == 0).all())
    assert int(sc.masks.sum(dim=1).max()) <= 1
    union = sc.masks.any(dim=1)
    assert bool((sc.depth[union] > 0).all()) and bool((sc.depth[~union] == 0).all())
    inside = (sc.corners >= 0) & (sc.corners < SPEC["heightmap_px"])
    assert bool(inside[valid].all())
    mean = sc.corners.mean(dim=2)
    assert torch.equal(sc.centers[valid], mean[valid].int().float())
