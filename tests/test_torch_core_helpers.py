"""Parity: the JAX package's public helpers that the port carries under the
same name (core/rotation.py's Euler, axis-angle and quaternion helpers,
core/tendon.py::finger_joint_angles, physics/shapes.py::bounding_radius,
render/ortho.py's instance_masks and upsample2x, utils/profiling.py's trace
and annotate), and a guard over the public surface.

Each helper against its JAX counterpart on numpy-seeded inputs, float32 to
rounding, plus the reference cases tests/test_core.py holds the JAX ones
to. The port's helpers take leading batch axes where JAX's take one item.
`trace` writes a Chrome trace under its directory naming the annotated
region.

The guard parses smg_tpu/**/*.py with ast (nothing is imported) and fails
for a public top-level def or class that no module of smg_tpu_torch/
defines and that LEFT_BEHIND does not list, or for an entry of LEFT_BEHIND
that the port now defines or the JAX package no longer has.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.core import rotation as jrot
from smg_tpu.core import tendon as jtendon
from smg_tpu.physics import shapes as jshapes
from smg_tpu.render import ortho as jortho
from smg_tpu_torch.core import rotation as rot
from smg_tpu_torch.core import tendon
from smg_tpu_torch.physics import shapes
from smg_tpu_torch.render import ortho
from smg_tpu_torch.utils import profiling

torch.set_num_threads(1)

ATOL = 1e-6
REPO = pathlib.Path(__file__).resolve().parent.parent


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _thetas(seed, n=20):
    return np.random.RandomState(seed).uniform(-1.2, 1.2, (n, 3)).astype(np.float32)


def _rotms(seed, n=20):
    """Random rotations, the angle over (-pi, pi), and the identity."""
    rng = np.random.RandomState(seed)
    axes = rng.randn(n, 3).astype(np.float32)
    angles = rng.uniform(-np.pi + 1e-3, np.pi - 1e-3, n).astype(np.float32)
    angles[0] = 0.0
    return np.stack([np.asarray(jrot.angle_axis2rotm(jnp.asarray(a), jnp.asarray(x)))
                     for a, x in zip(angles, axes)])


def test_euler2rotm():
    theta = _thetas(0)
    _close(rot.euler2rotm(_t(theta)), jax.vmap(jrot.euler2rotm)(jnp.asarray(theta)))
    # Reference euler2rotm = Rz @ Ry @ Rx (code/utils.py:169-183).
    a, b, c = 0.3, -0.5, 1.1
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    _close(rot.euler2rotm(_t([a, b, c])), rz @ ry @ rx)


def test_rotm2euler():
    theta = _thetas(1)
    theta[0, 1] = np.pi / 2          # the singular branch: sy ~ 0
    R = jax.vmap(jrot.euler2rotm)(jnp.asarray(theta))
    got = rot.rotm2euler(_t(R))
    _close(got, jax.vmap(jrot.rotm2euler)(R), atol=2e-6)
    _close(got[1:], theta[1:], atol=1e-5)       # the round trip off the singularity


def test_rotm2angle_axis():
    R = _rotms(2)
    angle, axis = rot.rotm2angle_axis(_t(R))
    want_angle, want_axis = jax.vmap(jrot.rotm2angle_axis)(jnp.asarray(R))
    _close(angle, want_angle, atol=2e-6)
    _close(axis, want_axis, atol=2e-6)
    assert float(angle[0]) == 0.0 and axis[0].tolist() == [0.0, 0.0, 1.0]
    # tests/test_core.py's case: 0.9 about +z.
    angle, axis = rot.rotm2angle_axis(rot.angle_axis2rotm(torch.tensor(0.9), [0.0, 0.0, 1.0]))
    assert abs(float(angle) - 0.9) < 1e-5
    _close(axis, [0, 0, 1], atol=1e-5)


def test_quat_identity_and_integrate():
    q = rot.quat_identity(device="cpu")
    assert q.dtype == torch.float32 and q.device.type == "cpu"
    _close(q, jrot.quat_identity())
    assert rot.quat_identity(dtype=torch.float64).dtype == torch.float64
    # tests/test_core.py's case: omega = (0, 0, 2) for 0.5 s is a yaw of 1.
    omega = torch.tensor([0.0, 0.0, 2.0])
    for _ in range(500):
        q = rot.quat_integrate(q, omega, 1e-3)
    R = rot.quat2rotm(q)
    assert abs(float(torch.atan2(R[1, 0], R[0, 0])) - 1.0) < 1e-3


def test_quat_rotate():
    rng = np.random.RandomState(3)
    q = np.asarray(jax.vmap(jrot.quat_from_axis_angle)(
        jnp.asarray(rng.randn(6, 3).astype(np.float32)),
        jnp.asarray(rng.uniform(-3, 3, 6).astype(np.float32))))
    v = rng.randn(6, 3).astype(np.float32)
    _close(rot.quat_rotate(_t(q), _t(v)), jrot.quat_rotate(jnp.asarray(q), jnp.asarray(v)),
           atol=2e-6)
    _close(rot.quat_rotate_inv(_t(q), _t(v)),
           jrot.quat_rotate_inv(jnp.asarray(q), jnp.asarray(v)), atol=2e-6)
    _close(rot.quat_rotate_inv(_t(q), rot.quat_rotate(_t(q), _t(v))), v, atol=1e-5)
    # tests/test_core.py's case: one quaternion on five vectors, as its matrix.
    v5 = rng.randn(5, 3).astype(np.float32)
    _close(rot.quat_rotate(_t(q[0]), _t(v5)), v5 @ np.asarray(rot.quat2rotm(_t(q[0]))).T,
           atol=1e-5)


def test_is_rotm():
    R = _rotms(4)
    bent = R.copy()
    bent[::2, 0, 0] += 1e-3
    both = np.concatenate([R, bent])
    got = rot.is_rotm(_t(both))
    want = np.array([bool(jrot.is_rotm(jnp.asarray(r))) for r in both])
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:len(R)].all() and not want[len(R)::2].any()
    np.testing.assert_array_equal(rot.is_rotm(_t(both), tol=1e-2).numpy(), True)


def test_finger_joint_angles():
    curls = np.random.RandomState(5).uniform(0.0, 1.2, (2, 3)).astype(np.float32)
    got = tendon.finger_joint_angles(_t(curls))
    assert got.shape == (2, 3, tendon.DEFAULT.segments_per_finger)
    _close(got, jtendon.finger_joint_angles(jnp.asarray(curls)))
    _close(tendon.finger_joint_angles(torch.tensor(0.8)), jtendon.finger_joint_angles(0.8))
    _close(got.sum(-1), curls, atol=1e-6)


def test_bounding_radius():
    rng = np.random.RandomState(6)
    types = np.array([shapes.BOX, shapes.CYLINDER, shapes.SPHERE] * 4, np.int32)
    he = rng.uniform(0.01, 0.06, (len(types), 3)).astype(np.float32)
    got = shapes.bounding_radius(torch.as_tensor(types), _t(he))
    _close(got, jax.vmap(jshapes.bounding_radius)(jnp.asarray(types), jnp.asarray(he)))


def test_instance_masks_and_upsample2x():
    rng = np.random.RandomState(7)
    ids = rng.randint(-1, 6, (2, 12, 10)).astype(np.int32)
    got = ortho.instance_masks(torch.as_tensor(ids), 5)
    assert got.shape == (2, 5, 12, 10) and got.dtype == torch.bool
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(jortho.instance_masks(jnp.asarray(ids[b]), 5)))
    for img in (rng.rand(6, 5).astype(np.float32), rng.rand(6, 5, 3).astype(np.float32)):
        np.testing.assert_array_equal(ortho.upsample2x(_t(img)).numpy(),
                                      np.asarray(jortho.upsample2x(jnp.asarray(img))))


def test_trace_names_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("smg_annotated_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    assert "smg_annotated_region" in files[0].read_text()


# ---------------------------------------------------------------------------
# The public surface
# ---------------------------------------------------------------------------

# Public top-level names of smg_tpu/ that the port does not define, each
# with the port name that took its place or why it stays behind.
LEFT_BEHIND = {
    # TPU kernel entry points, packers and geometry choosers: each kernel's
    # CUDA wrapper and Python tile plan take their place (ops/*.py).
    "dense_layer_fused": "ops/dense_layer.py::dense_layer (K2a)",
    "dense_layers_fused": "ops/dense_layer.py::dense_layer, one launch per layer (K2b)",
    "dense_block_fused": "models/fast_trunk.py::trunk_features_eval, backend xla_fl",
    "pack_layer": "K2's TPU weight packing; the CUDA kernel reads the plain weights",
    "pack_layers": "K2's TPU weight packing; the CUDA kernel reads the plain weights",
    "pack_w2": "K5's TPU weight packing; ops/conv2.py takes (9, 128, 32) weights",
    "layer_train_fwd": "ops/dense_layer_train.py::layer_fwd (K6a)",
    "layer_train_bwd": "ops/dense_layer_train.py::layer_bwd (K6b)",
    "supported": "a TPU kernel's VMEM gate; the CUDA kernels take every shape",
    "merge_supported": "K5's VMEM gate for its merged form",
    "BlockGeom": "K7's TPU geometry; ops/dense_block.py::dense_plan plans the CUDA kernel",
    "choose_geom": "K7's TPU geometry chooser; ops/dense_block.py::dense_plan",
    "quad_kernel": "the TPU stem's quad-phase conv0 taps; the port's stem is one conv",
    "quad_conv0": "the TPU stem's quad-phase conv0; the port's stem is one conv",
    "default_backend": "picks an eval lowering by jax.default_backend(); the port's "
                       "default is xla_fl on every device",
    # JAX sharding: parallel/mesh.py's process group and parallel/sharded.py.
    "make_mesh": "JAX sharding; parallel/mesh.py::init_data_parallel",
    "scene_sharding": "JAX sharding; parallel/mesh.py::scene_slice",
    "replicated": "JAX sharding; parallel/sharded.py keeps the nets on every rank",
    "shard_batch": "JAX sharding; parallel/mesh.py::scene_slice",
    "replicate": "JAX sharding; parallel/sharded.py::place_loop_state",
    # Other names.
    "min_area_rect": "perception/minrect.py::min_area_rects (the batched form)",
    "enable_persistent_cache": "the XLA compile cache",
    "readback": "a TPU timing workaround; torch.cuda.synchronize waits for the card",
}


def _public_defs(root: pathlib.Path) -> dict:
    """{name: first file} of the public top-level defs and classes."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")):
                out.setdefault(node.name, path.relative_to(REPO))
    return out


def _unported(jax_names: dict, port_names: dict) -> dict:
    return {n: str(f) for n, f in jax_names.items()
            if n not in port_names and n not in LEFT_BEHIND}


def test_public_surface():
    jax_names = _public_defs(REPO / "smg_tpu")
    port_names = _public_defs(REPO / "smg_tpu_torch")
    missing = _unported(jax_names, port_names)
    assert not missing, f"public JAX names with no counterpart in smg_tpu_torch: {missing}"
    stale = sorted(n for n in LEFT_BEHIND if n in port_names or n not in jax_names)
    assert not stale, f"LEFT_BEHIND entries the port defines or JAX lacks: {stale}"


@pytest.mark.parametrize("name", ["euler2rotm", "is_rotm", "finger_joint_angles",
                                  "bounding_radius", "upsample2x", "trace"])
def test_public_surface_sees_a_removal(name):
    """The guard's own check: without one of the ported names the port's
    surface leaves exactly that name unported."""
    jax_names = _public_defs(REPO / "smg_tpu")
    port_names = _public_defs(REPO / "smg_tpu_torch")
    del port_names[name]
    assert list(_unported(jax_names, port_names)) == [name]
