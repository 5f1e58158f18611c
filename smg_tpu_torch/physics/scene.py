"""Scene lifecycle: spawn and reset, batched, from a torch.Generator.

Port of smg_tpu/physics/scene.py. The distributions are the JAX
package's (0-5 enveloping + 1-5 sucking objects, drop cells from a
permutation of the first 10 grid cells, random yaw and tip), but the draws
come from torch's generator, so a seed gives other scenes than JAX's PRNG.
The settle runs through the batched stepper by default, or any stepper
with run_steps' signature (the per-scene stepper.run_steps under the
loop's "vmap" executor). Under a SceneSlice the whole batch is drawn and
only the slice's scenes are kept and settled.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from smg_tpu_torch.core import rotation as rot
from smg_tpu_torch.physics import shapes, stepper
from smg_tpu_torch.physics.state import (
    DROP_Z,
    KIND_ENVELOPING,
    KIND_SUCKING,
    N_SLOTS,
    WORKSPACE,
    Gripper,
    Objects,
    Scene,
    SceneSlice,
)

_COLORS = np.array(
    [
        [0.89, 0.28, 0.22], [0.25, 0.55, 0.88], [0.32, 0.73, 0.35],
        [0.95, 0.71, 0.19], [0.67, 0.38, 0.84], [0.25, 0.78, 0.78],
        [0.91, 0.45, 0.63], [0.55, 0.48, 0.30], [0.45, 0.85, 0.35],
        [0.35, 0.40, 0.85], [0.85, 0.55, 0.25], [0.60, 0.60, 0.60],
    ]
)


def drop_grid(is_cluttered: bool, device) -> torch.Tensor:
    """The 12-cell (x, y) drop grid (scene.py:44-56), (12, 2)."""
    wl = WORKSPACE
    xx = torch.arange(3.0, device=device).repeat(4)
    yy = torch.arange(4.0, device=device).repeat_interleave(3)
    if is_cluttered:
        gx = wl[0, 0] + (wl[0, 1] - wl[0, 0] - 0.28) / 2 + 0.1 * xx + 0.09
        gy = wl[1, 0] + (wl[1, 1] - wl[1, 0] - 0.3) / 2 + 0.1 * yy
    else:
        gx = wl[0, 0] + (wl[0, 1] - wl[0, 0] - 0.28) / 2 + 0.14 * xx - 0.03
        gy = wl[1, 0] + (wl[1, 1] - wl[1, 0] - 0.3) / 2 + 0.1 * yy
    return torch.stack([gx, gy], dim=-1)


def default_catalogs(is_testing: bool = False):
    if is_testing:
        return (shapes.TESTING_ENVELOPING_CATALOG,
                shapes.TESTING_SUCKING_CATALOG)
    return shapes.ENVELOPING_CATALOG, shapes.SUCKING_CATALOG


def _randint(gen, low, high, shape, device):
    return torch.randint(low, high, shape, generator=gen, device=device)


def spawn_objects(gen: torch.Generator, B: int, device,
                  is_cluttered: bool = False, is_testing: bool = False,
                  catalogs=None) -> Objects:
    """Sample B fresh object sets into the fixed slots (scene.py:68-147)."""
    if catalogs is None:
        catalogs = default_catalogs(is_testing)
    f32 = dict(dtype=torch.float32, device=device)
    n_g = _randint(gen, 0, 6, (B, 1), device)
    n_s_raw = _randint(gen, 0, 6, (B, 1), device)
    n_s = torch.where(n_g > 0, n_s_raw, torch.clamp(n_s_raw, min=1))
    n_total = n_g + n_s

    slot = torch.arange(N_SLOTS, device=device)[None]
    active = slot < n_total
    kind = torch.where(slot < n_g, KIND_ENVELOPING, KIND_SUCKING).to(torch.int32)

    (g_types, g_he), (s_types, s_he) = (
        (torch.as_tensor(t, device=device), torch.as_tensor(h, device=device))
        for t, h in catalogs
    )
    gi = _randint(gen, 0, g_types.shape[0], (B, N_SLOTS), device)
    si = _randint(gen, 0, s_types.shape[0], (B, N_SLOTS), device)
    is_env = kind == KIND_ENVELOPING
    shape_type = torch.where(is_env, g_types[gi], s_types[si]).to(torch.int32)
    half_extents = torch.where(is_env[..., None], g_he[gi], s_he[si]).float()

    cells = drop_grid(is_cluttered, device)
    perm = torch.argsort(torch.rand((B, 10), generator=gen, device=device), 1)
    cell_idx = torch.where(slot < 10, perm[:, torch.clamp(slot[0], max=9)],
                           torch.zeros_like(slot))
    xy = cells[cell_idx]                                   # (B, N, 2)

    yaw = torch.rand((B, N_SLOTS), generator=gen, **f32) * (2 * math.pi)
    tip_ax = torch.randn((B, N_SLOTS, 3), generator=gen, **f32)
    tip_ang = torch.rand((B, N_SLOTS), generator=gen, **f32) * 0.4
    quat = rot.quat_mul(rot.quat_from_yaw(yaw),
                        rot.quat_from_axis_angle(tip_ax, tip_ang))

    z = DROP_Z + 0.01 * (slot % 3).float().expand(B, N_SLOTS)
    pos = torch.cat([xy, z[..., None]], dim=-1)
    parked = torch.tensor([0.0, 2.0, -5.0], **f32)
    pos = torch.where(active[..., None], pos, parked)

    flat_t = shape_type.reshape(-1)
    flat_h = half_extents.reshape(-1, 3)
    mass, inertia = shapes.mass_properties(flat_t, flat_h)
    sph_off, sph_r = shapes.sphere_compound(flat_t, flat_h)
    K = shapes.SPHERES_PER_OBJECT
    color = torch.as_tensor(_COLORS, **f32).expand(B, N_SLOTS, 3).clone()

    base = Objects.empty(B, device)
    return base.replace(
        pos=pos, quat=quat, shape_type=shape_type, half_extents=half_extents,
        color=color, kind=kind, active=active,
        mass=mass.reshape(B, N_SLOTS),
        inertia=inertia.reshape(B, N_SLOTS, 3),
        sph_offsets=sph_off.reshape(B, N_SLOTS, K, 3),
        sph_radii=sph_r.reshape(B, N_SLOTS, K),
    )


def reset_scene(gen: torch.Generator, B: int, device,
                is_cluttered: bool = False, is_testing: bool = False,
                settle_steps: int = 250,
                params: stepper.StepperParams = stepper.DEFAULT,
                catalogs=None, scene_slice: SceneSlice | None = None,
                run=stepper.run_steps_batched) -> Scene:
    """B fresh episode scenes: spawn, home the gripper, settle with `run`
    (scene.py:150-167). With scene_slice, B is the whole batch and the
    slice's scenes come back."""
    objects = spawn_objects(gen, B, device, is_cluttered, is_testing, catalogs)
    if scene_slice is not None:
        objects = objects.map(scene_slice.cut)
        B = scene_slice.hi - scene_slice.lo
    sc = Scene(objects=objects, gripper=Gripper.home(B, device),
               t=torch.zeros(B, dtype=torch.int32, device=device))
    return run(sc, sc.gripper, settle_steps, params)
