"""Parity: the port's mesh ingest (utils/native.py's fitter, utils/meshes.py,
envs/smg_env.py::resolve_catalogs) against the JAX package's, on .obj files
the tests write.

Tolerances: none. The fits (shape type, half extents, centroid, mass,
inertia, counts) and the catalogs are bit-equal, natively and through the
pure-Python fallback; the native sphere compound equals the port's
physics/shapes.py::sphere_compound to 1e-6 (the C++ and torch f32 cos/sin).
"""

import os

import numpy as np
import pytest
import torch

from smg_tpu.utils import meshes as jmeshes
from smg_tpu.utils import native as jnative
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.physics import shapes
from smg_tpu_torch.utils import config as cfg_mod
from smg_tpu_torch.utils import meshes, native

import test_torch_parity_helpers  # noqa: F401  (one torch thread per worker)


def write_box(path, hx=0.03, hy=0.02, hz=0.015, center=(0.0, 0.0, 0.0)):
    with open(path, "w") as f:
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    f.write(f"v {center[0] + sx * hx} {center[1] + sy * hy} "
                            f"{center[2] + sz * hz}\n")
        f.write("f 1 2 3\nf 4 5 6\n")


def write_cylinder(path, R=0.02, hh=0.035, n=24):
    with open(path, "w") as f:
        for z in (-hh, hh):
            for i in range(n):
                a = 2 * np.pi * i / n
                f.write(f"v {R * np.cos(a)} {R * np.sin(a)} {z}\n")
        f.write("f 1 2 3\n")


def write_sphere(path, R=0.02, n=80, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            v = rng.randn(3)
            v = v / np.linalg.norm(v) * R
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        f.write("f 1 2 3\n")


WRITERS = {
    "box": lambda p: write_box(p, 0.03, 0.02, 0.015, center=(0.1, 0.0, 0.5)),
    "plate": lambda p: write_box(p, 0.025, 0.025, 0.008),
    "cylinder": write_cylinder,
    "sphere": write_sphere,
}
KINDS = {"box": native.BOX, "plate": native.BOX, "cylinder": native.CYLINDER,
         "sphere": native.SPHERE}


def mesh_dir(root):
    """enveloping/ + sucking/ with meshes of every kind and a non-.obj file."""
    for sub in ("enveloping", "sucking"):
        os.makedirs(root / sub, exist_ok=True)
    WRITERS["box"](str(root / "enveloping" / "bar.obj"))
    WRITERS["cylinder"](str(root / "enveloping" / "can.obj"))
    WRITERS["sphere"](str(root / "enveloping" / "ball.obj"))
    WRITERS["plate"](str(root / "sucking" / "plate.obj"))
    WRITERS["sphere"](str(root / "sucking" / "a_ball.obj"))
    (root / "sucking" / "notes.txt").write_text("x")   # robot.py:44-49 filter
    return str(root)


def assert_fits_equal(got, want):
    for f in ("shape_type", "mass", "n_vertices", "n_faces", "native"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("half_extents", "centroid", "inertia"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.fixture(scope="module")
def lib():
    lib = native.load_library()
    if lib is None:
        pytest.skip("native lib unavailable (no C++ toolchain)")
    return lib


@pytest.mark.parametrize("kind", sorted(WRITERS))
@pytest.mark.parametrize("use_native", [True, False])
def test_fit_matches_jax(tmp_path, request, kind, use_native):
    p = str(tmp_path / f"{kind}.obj")
    WRITERS[kind](p)
    if use_native:
        request.getfixturevalue("lib")
        got, want = native.fit_obj(p), jnative.fit_obj(p)
        assert got.native
    else:
        got, want = native._fit_obj_python(p, 300.0), jnative._fit_obj_python(p, 300.0)
    assert got.shape_type == KINDS[kind]
    assert_fits_equal(got, want)


def test_native_matches_python_fallback(tmp_path, lib):
    for kind, write in WRITERS.items():
        p = str(tmp_path / f"{kind}.obj")
        write(p)
        n, py = native.fit_obj(p), native._fit_obj_python(p, 300.0)
        assert n.shape_type == py.shape_type, kind
        np.testing.assert_allclose(n.half_extents, py.half_extents, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(n.mass, py.mass, rtol=1e-4)


def test_missing_file(lib):
    with pytest.raises(FileNotFoundError):
        native.fit_obj("/nonexistent/mesh.obj")


def test_sphere_compound_native(lib):
    for st, he in [(native.BOX, (0.03, 0.02, 0.015)), (native.CYLINDER, (0.02, 0.02, 0.035)),
                   (native.SPHERE, (0.02, 0.02, 0.02))]:
        he = np.asarray(he, np.float32)
        offs, radii = native.sphere_compound_native(st, he)
        joffs, jradii = jnative.sphere_compound_native(st, he)
        np.testing.assert_array_equal(offs, joffs)
        np.testing.assert_array_equal(radii, jradii)
        toffs, tradii = shapes.sphere_compound(torch.tensor([st]), torch.as_tensor(he)[None])
        np.testing.assert_allclose(offs, toffs[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(radii, tradii[0].numpy(), atol=1e-6)


def test_catalogs_match_jax(tmp_path, lib):
    d = mesh_dir(tmp_path)
    got, want = meshes.load_object_sets(d), jmeshes.load_object_sets(d)
    for (gt, gh), (wt, wh) in zip(got, want):
        assert gt.dtype == np.int32 and gh.dtype == np.float32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gh, wh)
    (g_types, _), (s_types, s_he) = got
    # Sorted file order; the square plate is a box, not a cylinder.
    assert g_types.tolist() == [native.SPHERE, native.BOX, native.CYLINDER]
    assert s_types.tolist() == [native.SPHERE, native.BOX]
    assert s_he[1, 2] == pytest.approx(0.008, abs=1e-5)


def test_empty_catalog_raises(tmp_path):
    (tmp_path / "enveloping").mkdir()
    with pytest.raises(FileNotFoundError):
        meshes.load_catalog(str(tmp_path / "enveloping"))


def test_resolve_catalogs_fits_once(tmp_path, lib, monkeypatch):
    d = mesh_dir(tmp_path)
    calls = []
    fit = native.fit_obj
    monkeypatch.setattr(native, "fit_obj", lambda *a: calls.append(a) or fit(*a))
    cfg = env.EnvConfig(obj_mesh_dir=d, settle_steps=5)
    first = env.resolve_catalogs(cfg)
    assert env.resolve_catalogs(cfg) is first
    assert len(calls) == 5
    for (gt, gh), (wt, wh) in zip(first, jmeshes.load_object_sets(d)):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gh, wh)


def test_reset_on_mesh_catalog(tmp_path, lib):
    d = mesh_dir(tmp_path)
    cfg = env.EnvConfig(obj_mesh_dir=d, settle_steps=5)
    (g_types, g_he), (s_types, s_he) = env.resolve_catalogs(cfg)
    sc = env.reset(torch.Generator().manual_seed(3), 4, cfg, "cpu")
    obj = sc.objects
    act = obj.active
    for kind, types, hes in ((0, g_types, g_he), (1, s_types, s_he)):
        sel = act & (obj.kind == kind)
        pairs = {(int(t), tuple(np.round(h, 6))) for t, h in zip(types, hes)}
        for t, h in zip(obj.shape_type[sel].tolist(), obj.half_extents[sel].numpy()):
            assert (t, tuple(np.round(h, 6))) in pairs
    assert bool(act.any())


def test_config_takes_mesh_dir(tmp_path):
    d = mesh_dir(tmp_path)
    cfg = cfg_mod.parse_args(["--obj_mesh_dir", d, "--cpu"])
    assert cfg.env.obj_mesh_dir == d
    os.remove(os.path.join(d, "sucking", "plate.obj"))
    os.remove(os.path.join(d, "sucking", "a_ball.obj"))
    with pytest.raises(SystemExit, match="no .obj meshes"):
        cfg_mod.parse_args(["--obj_mesh_dir", d])
