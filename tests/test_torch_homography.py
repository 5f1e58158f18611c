"""Parity: the port's perspective path (core/homography.py and
core/camera.py's get_pointcloud, transform_points, get_heightmap,
global_position, heightmap_pixel_to_world) against the JAX package's, on
the CPU, on numpy-seeded frames.

Tolerances:
- fit_homography, apply_homography, the point cloud and the rigid
  transform: to float32 rounding (rtol 1e-5, atol 1e-6 / 1e-5 of the scale).
- Warps: the 8 x 8 solve and the 3 x 3 inverse differ from XLA's in the
  last bits, so a sample point moves by ~1e-5 px. Bilinear values then
  agree to 1e-4 of the image's scale; a pixel whose sample point lies on
  the source's edge may flip between valid and zero, and with nearest
  sampling one on a .5 boundary may round to the neighbour. Such pixels
  are bounded at FLIP_BOUND of all pixels; every other pixel agrees.
- global_position on 16 random heightmap pixels: 1e-5 m;
  heightmap_pixel_to_world: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.core import camera as jcam
from smg_tpu.core import homography as jhg
from smg_tpu_torch.core import camera as cam
from smg_tpu_torch.core import homography as hg

import test_torch_parity_helpers  # noqa: F401  (one torch thread per worker)

FLIP_BOUND = 2e-3


def _quads(seed, n=8):
    rng = np.random.RandomState(seed)
    base = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    src = base * rng.uniform(50, 400, (n, 1, 2)) + rng.uniform(0, 100, (n, 1, 2))
    dst = src + rng.uniform(-20, 20, src.shape)
    return src.astype(np.float32), dst.astype(np.float32)


def test_fit_and_apply():
    src, dst = _quads(0)
    rng = np.random.RandomState(1)
    for s, d in zip(src, dst):
        H = hg.fit_homography(torch.as_tensor(s), torch.as_tensor(d)).numpy()
        Hj = np.asarray(jhg.fit_homography(jnp.asarray(s), jnp.asarray(d)))
        np.testing.assert_allclose(H, Hj, rtol=1e-5, atol=1e-6 * np.abs(Hj).max())
        pts = rng.uniform(0, 500, (64, 2)).astype(np.float32)
        got = hg.apply_homography(torch.as_tensor(Hj.copy()), torch.as_tensor(pts)).numpy()
        want = np.asarray(jhg.apply_homography(jnp.asarray(Hj), jnp.asarray(pts)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        # The fit maps its own corners onto dst.
        np.testing.assert_allclose(
            hg.apply_homography(torch.as_tensor(H), torch.as_tensor(s)).numpy(), d,
            atol=1e-2)


def _assert_warp_close(got, want, scale):
    bad = np.abs(got - want) > 1e-4 * scale
    if bad.ndim == 3:
        bad = bad.any(-1)
    assert bad.mean() <= FLIP_BOUND, f"{bad.mean():.2e} of pixels differ"


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_matches_jax(mode):
    rng = np.random.RandomState(2)
    img = rng.rand(60, 80, 3).astype(np.float32)
    # The image's corners onto a skewed quad inside the 64 x 48 output.
    src = np.array([[0, 0], [0, 59], [79, 59], [79, 0]], np.float32)
    dst = np.array([[2, 1], [5, 46], [62, 44], [59, 3]], np.float32)
    dst += rng.uniform(-1, 1, dst.shape).astype(np.float32)
    H = np.asarray(jhg.fit_homography(jnp.asarray(src), jnp.asarray(dst)))
    got = hg.warp_perspective(torch.as_tensor(img), torch.as_tensor(H.copy()), (48, 64),
                             mode).numpy()
    want = np.asarray(jhg.warp_perspective(jnp.asarray(img), jnp.asarray(H), (48, 64), mode))
    assert got.shape == want.shape == (48, 64, 3)
    assert (want != 0).mean() > 0.3
    _assert_warp_close(got, want, 1.0)
    gray = hg.warp_perspective(torch.as_tensor(img[..., 0]), torch.as_tensor(H.copy()), (48, 64),
                               mode).numpy()
    np.testing.assert_array_equal(gray, got[..., 0])


def test_warp_identity_nearest():
    img = torch.arange(16 * 16, dtype=torch.float32).reshape(16, 16)
    out = hg.warp_perspective(img, torch.eye(3), (16, 16), mode="nearest")
    np.testing.assert_array_equal(out.numpy(), img.numpy())


def _frames(seed, B):
    """B RGB-D frames at the reference camera: a table at ~0.69 m with
    random boxes of height up to 0.1 m."""
    rng = np.random.RandomState(seed)
    depth = np.full((B, cam.IMAGE_H, cam.IMAGE_W), 0.6929, np.float32)
    color = np.broadcast_to(np.float32([0.35, 0.35, 0.38]),
                            (B, cam.IMAGE_H, cam.IMAGE_W, 3)).copy()
    for b in range(B):
        for _ in range(6):
            y, x = rng.randint(0, 400), rng.randint(110, 480)
            h, w = rng.randint(10, 60, 2)
            depth[b, y:y + h, x:x + w] = 0.6929 - rng.uniform(0.01, 0.1)
            color[b, y:y + h, x:x + w] = rng.rand(3)
    return color, depth


def test_pointcloud_and_transform():
    _, depth = _frames(4, 1)
    camera = jcam.Camera.reference_overhead()
    K, pose = np.asarray(camera.intrinsics), np.asarray(camera.pose)
    got = cam.get_pointcloud(torch.as_tensor(depth[0]), K)
    want = np.asarray(jcam.get_pointcloud(jnp.asarray(depth[0]), jnp.asarray(K)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    world = cam.transform_points(torch.as_tensor(pose), got).numpy()
    jworld = np.asarray(jcam.transform_points(jnp.asarray(pose), jnp.asarray(want)))
    np.testing.assert_allclose(world, jworld, rtol=1e-5, atol=1e-5)
    # A batch of frames gives each frame's cloud.
    batched = cam.get_pointcloud(torch.as_tensor(np.stack([depth[0]] * 2)), K)
    np.testing.assert_array_equal(batched[1].numpy(), got.numpy())


def test_get_heightmap_matches_jax():
    color, depth = _frames(5, 2)
    camera = cam.Camera.reference_overhead()
    jcamera = jcam.Camera.reference_overhead()
    np.testing.assert_allclose(camera.pose.numpy(), np.asarray(jcamera.pose), atol=1e-6)
    got = cam.get_heightmap(torch.as_tensor(color), torch.as_tensor(depth),
                            camera.intrinsics, camera.pose)
    for b in range(2):
        want = jcam.get_heightmap(jnp.asarray(color[b]), jnp.asarray(depth[b]),
                                  jcamera.intrinsics, jcamera.pose)
        for name, g, w in zip(("color_hm", "depth_hm", "color_448", "depth_448"), got, want):
            g, w = g[b].numpy(), np.asarray(w)
            assert g.shape == w.shape, name
            _assert_warp_close(g, w, float(np.abs(w).max()))
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want[4]).max()))
    # One frame (no batch dim) gives the batch's first heightmaps.
    one = cam.get_heightmap(torch.as_tensor(color[0]), torch.as_tensor(depth[0]),
                            camera.intrinsics, camera.pose)
    for g1, gb in zip(one[:4], got[:4]):
        np.testing.assert_array_equal(g1.numpy(), gb[0].numpy())
    assert float(got[1].max()) > 0.01     # the boxes stand above the table


def test_global_position_and_grid():
    _, depth = _frames(6, 1)
    camera = jcam.Camera.reference_overhead()
    A_htor = jhg.fit_homography(
        jnp.asarray([[0.0, 0.0], [0.0, 224.0], [224.0, 224.0], [224.0, 0.0]]),
        jnp.asarray(jcam.ROI_SRC))
    rng = np.random.RandomState(7)
    for row, col in rng.randint(0, 224, (16, 2)):
        pix = np.array([0, row, col], np.int32)
        want = np.asarray(jcam.global_position(jnp.asarray(pix), A_htor, camera.intrinsics,
                                               camera.pose, jnp.asarray(depth[0])))
        got = cam.global_position(pix, torch.as_tensor(np.asarray(A_htor)),
                                  np.asarray(camera.intrinsics), np.asarray(camera.pose),
                                  torch.as_tensor(depth[0])).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        gx, gy = cam.heightmap_pixel_to_world(row, col)
        wx, wy = jcam.heightmap_pixel_to_world(row, col)
        assert float(gx) == float(wx) and float(gy) == float(wy)
