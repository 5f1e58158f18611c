"""Parity: the port's observe path (render + exact segmentation) against
JAX smg_env.observe on bridged scenes, and the port's own scene reset.

Tolerances: depth atol 1e-6 and ids, masks, valid and number equal, except
on silhouette pixels: a ray that grazes a curved or tilted surface (within
2 pixels of an object's mask edge) meets it where the discriminant is near
zero, so the two frameworks' last-bit differences in the body-frame
transform move its height by up to a few 1e-6, or flip hit and miss. Such
pixels are bounded at 0.1% of all pixels (and their heights at 1e-4).
Boxes and min-area-rect corners, sizes, angles: 1e-5 (relative and
absolute). Centers are the corner means truncated to int (segment.py:74-76):
where a mean lies within 1e-4 of an integer, a last-bit difference of a
corner (XLA's f32 sin/cos are not correctly rounded: 6 of the 180 angle
table entries differ from the correctly rounded values the port uses)
may truncate to the neighbouring pixel; everywhere else they are equal.
"""

import jax
import numpy as np
import pytest
import torch

from smg_tpu.envs import smg_env as jenv
from smg_tpu_torch import bridge
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.physics import scene as scene_mod
from smg_tpu_torch.physics.state import WORKSPACE

from test_torch_parity_helpers import jax_scenes, to_numpy_tree, torch_tree_to_numpy

FLIP_BOUND = 1e-3


@pytest.fixture(scope="module")
def observed():
    batch, tree = jax_scenes(4, seed=5, settle_steps=150)
    want = to_numpy_tree(jax.jit(jax.vmap(jenv.observe))(batch))
    got = torch_tree_to_numpy(env.observe(bridge.scene_from_numpy(tree)))
    return got, want


def _silhouette(masks: np.ndarray) -> np.ndarray:
    """(B, N, H, W) masks -> (B, H, W) pixels within 2 px of a mask edge."""
    from scipy.ndimage import binary_dilation, binary_erosion

    st = np.ones((1, 1, 5, 5), bool)
    ring = binary_dilation(masks, st) & ~binary_erosion(masks, st)
    return ring.any(axis=1)


def test_depth_and_color(observed):
    got, want = observed
    edge = _silhouette(want["seg"]["masks"] | got["seg"]["masks"])
    diff = np.abs(got["depth_hm"] - want["depth_hm"])
    off = diff > 1e-6
    assert not (off & ~edge).any(), "depth differs off the silhouettes"
    assert off.mean() <= FLIP_BOUND, f"{off.mean():.2e} of depth pixels differ"
    assert diff[off].max(initial=0.0) < 1e-4
    cdiff = np.abs(got["color_hm"] - want["color_hm"]).max(-1) > 1e-6
    assert not (cdiff & ~edge).any() and cdiff.mean() <= FLIP_BOUND


def test_masks_valid_number(observed):
    got, want = observed
    g, w = got["seg"], want["seg"]
    flips = g["masks"] != w["masks"]
    assert not (flips.any(1) & ~_silhouette(g["masks"] | w["masks"])).any()
    assert flips.mean() <= FLIP_BOUND, f"{flips.mean():.2e} of mask pixels differ"
    np.testing.assert_array_equal(g["valid"], w["valid"])
    np.testing.assert_array_equal(g["number"], w["number"])
    assert w["number"].min() >= 1


@pytest.mark.parametrize("field", ["boxes", "box_corners", "rect_sizes",
                                   "rect_angles"])
def test_rects(observed, field):
    got, want = observed
    np.testing.assert_allclose(got["seg"][field], want["seg"][field],
                               rtol=1e-5, atol=1e-5, err_msg=field)


def test_centers(observed):
    got, want = observed
    g, w = got["seg"], want["seg"]
    mean = w["box_corners"].mean(axis=2)
    at_boundary = np.abs(mean - np.round(mean)) < 1e-4
    diff = np.abs(g["centers"] - w["centers"])
    assert (diff[~at_boundary] == 0).all()
    assert (diff[at_boundary] <= 1).all()


def test_masked_scene_depth(observed):
    got, want = observed
    g = np.where(got["seg"]["masks"].any(1), got["depth_hm"], 0.0)
    t = env.masked_scene_depth(env.Observation(
        depth_hm=torch.as_tensor(got["depth_hm"]),
        color_hm=torch.as_tensor(got["color_hm"]),
        seg=env.seg_mod.Segmentation(**{k: torch.as_tensor(v) for k, v in
                                        got["seg"].items()})))
    np.testing.assert_array_equal(t.numpy(), g)
    w = np.asarray(jax.vmap(jenv.masked_scene_depth)(
        jax.tree_util.tree_map(jax.numpy.asarray, jenv.Observation(
            depth_hm=want["depth_hm"], color_hm=want["color_hm"],
            seg=jenv.seg_mod.Segmentation(**want["seg"])))))
    assert np.mean(np.abs(t.numpy() - w) > 1e-6) <= FLIP_BOUND


@pytest.mark.parametrize("is_testing", [False, True])
def test_reset_scene_rests(is_testing):
    gen = torch.Generator().manual_seed(7)
    sc = scene_mod.reset_scene(gen, 6, "cpu", is_testing=is_testing,
                               settle_steps=250)
    obj = sc.objects
    live = obj.on_table
    for name in ("pos", "quat", "vel", "omega"):
        assert torch.isfinite(getattr(obj, name)).all(), name
    assert bool((live.sum(1) >= 1).all())
    pos = obj.pos[live]
    he = obj.half_extents[live]
    assert bool(((pos[:, 0] > WORKSPACE[0, 0]) & (pos[:, 0] < WORKSPACE[0, 1])
                 & (pos[:, 1] > WORKSPACE[1, 0])
                 & (pos[:, 1] < WORKSPACE[1, 1])).all())
    # Resting at z ~ one of the half extents (a face, a side or a ball on
    # the table) for nearly all objects. Round objects may still roll:
    # the JAX package's settled scenes show the same speeds (< 0.5 m/s).
    assert bool(((pos[:, 2] > 0.0) & (pos[:, 2] < 0.12)).all())
    on_face = ((pos[:, 2:3] - he).abs() < 0.006).any(dim=1)
    assert float(on_face.float().mean()) >= 0.9
    assert bool((sc.t == 250).all())
