"""Analytic primitives and their sphere-compound proxies.

Port of smg_tpu/physics/shapes.py. Functions take a leading object axis
(M,) where JAX vmapped a lax.switch; all three branches are computed and
the one of each object's type is selected, which is what the switch
lowers to under vmap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BOX = 0
CYLINDER = 1
SPHERE = 2

SPHERES_PER_OBJECT = 9
DEFAULT_DENSITY = 300.0
MIN_MASS = 0.02

_BOX_SIGNS = np.array(
    [
        [-1, -1, -1], [1, -1, -1], [-1, 1, -1], [1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1],
    ],
    dtype=np.float32,
)


def _select(shape_type: torch.Tensor, box, cyl, sph):
    extra = (1,) * (box.dim() - shape_type.dim())
    st = shape_type.reshape(shape_type.shape + extra)
    return torch.where(st == BOX, box, torch.where(st == CYLINDER, cyl, sph))


def bounding_radius(shape_type: torch.Tensor, half_extents: torch.Tensor) -> torch.Tensor:
    """Conservative bounding-sphere radius (...,) of shapes (...,) with half
    extents (..., 3) (shapes.py:134-142): a box's corner, a cylinder's
    rim, a sphere's radius."""
    he = half_extents
    box = torch.linalg.norm(he, dim=-1)
    cyl = torch.sqrt(he[..., 0] ** 2 + he[..., 2] ** 2)
    return _select(shape_type, box, cyl, he[..., 0])


def sphere_compound(shape_type: torch.Tensor, half_extents: torch.Tensor):
    """(M,), (M, 3) -> offsets (M, 9, 3), radii (M, 9) (shapes.py:44-96)."""
    he = half_extents
    dt, dev = he.dtype, he.device
    M = he.shape[0]
    # Box.
    r_box = 0.5 * he.min(dim=-1).values
    inset = he - r_box[:, None]
    signs = torch.as_tensor(_BOX_SIGNS, dtype=dt, device=dev)
    offs_box = torch.cat(
        [signs[None] * inset[:, None, :], torch.zeros(M, 1, 3, dtype=dt, device=dev)],
        dim=1,
    )
    rad_box = torch.cat(
        [r_box[:, None].expand(M, 8), he.min(dim=-1).values[:, None]], dim=1
    )
    # Cylinder.
    R, hh = he[:, 0], he[:, 2]
    r_cyl = 0.5 * torch.minimum(R, hh)
    ring_r = R - r_cyl
    zoff = hh - r_cyl
    ang = torch.arange(8, dtype=dt, device=dev) * (2 * math.pi / 8)
    even = (torch.arange(8, device=dev) % 2 == 0)
    z = torch.where(even[None], -zoff[:, None], zoff[:, None])
    offs_cyl = torch.stack(
        [ring_r[:, None] * torch.cos(ang)[None],
         ring_r[:, None] * torch.sin(ang)[None], z], dim=2
    )
    offs_cyl = torch.cat([offs_cyl, torch.zeros(M, 1, 3, dtype=dt, device=dev)], 1)
    rad_cyl = torch.cat(
        [r_cyl[:, None].expand(M, 8), torch.minimum(R, hh)[:, None]], dim=1
    )
    # Sphere.
    offs_sph = torch.zeros(M, 9, 3, dtype=dt, device=dev)
    rad_sph = he[:, :1].expand(M, 9)
    return (_select(shape_type, offs_box, offs_cyl, offs_sph),
            _select(shape_type, rad_box, rad_cyl, rad_sph))


def mass_properties(shape_type: torch.Tensor, half_extents: torch.Tensor,
                    density: float = DEFAULT_DENSITY):
    """(mass (M,), body-frame diagonal inertia (M, 3)) (shapes.py:99-131)."""
    he = half_extents
    # Box.
    vol_b = 8.0 * he[:, 0] * he[:, 1] * he[:, 2]
    m_b = density * vol_b
    I_b = (m_b / 3.0)[:, None] * torch.stack(
        [he[:, 1] ** 2 + he[:, 2] ** 2,
         he[:, 0] ** 2 + he[:, 2] ** 2,
         he[:, 0] ** 2 + he[:, 1] ** 2], dim=1
    )
    # Cylinder.
    R, hh = he[:, 0], he[:, 2]
    vol_c = math.pi * R * R * 2 * hh
    m_c = density * vol_c
    Ixy = m_c * (3 * R * R + 4 * hh * hh) / 12.0
    Iz = 0.5 * m_c * R * R
    I_c = torch.stack([Ixy, Ixy, Iz], dim=1)
    # Sphere.
    Rs = he[:, 0]
    vol_s = 4.0 / 3.0 * math.pi * Rs ** 3
    m_s = density * vol_s
    Is = 0.4 * m_s * Rs * Rs
    I_s = torch.stack([Is, Is, Is], dim=1)

    m = _select(shape_type, m_b, m_c, m_s)
    I = _select(shape_type, I_b, I_c, I_s)
    scale = torch.clamp(MIN_MASS / m, min=1.0)
    return m * scale, I * scale[:, None]


def _catalog(entries):
    types = np.array([e[0] for e in entries], np.int32)
    hexts = np.array([e[1] for e in entries], np.float32)
    return types, hexts


# The procedural object catalogs (shapes.py:161-214), (type, half extents) [m].
ENVELOPING_CATALOG = _catalog([
    (BOX, (0.030, 0.015, 0.015)),
    (BOX, (0.035, 0.012, 0.012)),
    (BOX, (0.025, 0.025, 0.020)),
    (CYLINDER, (0.016, 0.016, 0.035)),
    (CYLINDER, (0.014, 0.014, 0.028)),
    (BOX, (0.028, 0.018, 0.014)),
    (CYLINDER, (0.020, 0.020, 0.024)),
    (SPHERE, (0.020, 0.020, 0.020)),
])

SUCKING_CATALOG = _catalog([
    (BOX, (0.025, 0.025, 0.008)),
    (BOX, (0.030, 0.020, 0.010)),
    (BOX, (0.020, 0.020, 0.012)),
    (CYLINDER, (0.022, 0.022, 0.008)),
    (CYLINDER, (0.018, 0.018, 0.012)),
    (BOX, (0.035, 0.025, 0.009)),
    (BOX, (0.022, 0.016, 0.010)),
    (CYLINDER, (0.026, 0.026, 0.010)),
])

TESTING_ENVELOPING_CATALOG = _catalog([
    (BOX, (0.033, 0.013, 0.018)),
    (BOX, (0.022, 0.022, 0.026)),
    (CYLINDER, (0.018, 0.018, 0.032)),
    (CYLINDER, (0.012, 0.012, 0.034)),
    (BOX, (0.031, 0.016, 0.011)),
    (SPHERE, (0.017, 0.017, 0.017)),
    (CYLINDER, (0.022, 0.022, 0.021)),
])

TESTING_SUCKING_CATALOG = _catalog([
    (BOX, (0.027, 0.022, 0.009)),
    (BOX, (0.018, 0.018, 0.013)),
    (CYLINDER, (0.024, 0.024, 0.009)),
    (CYLINDER, (0.016, 0.016, 0.013)),
    (BOX, (0.032, 0.028, 0.008)),
    (BOX, (0.024, 0.014, 0.011)),
    (CYLINDER, (0.028, 0.028, 0.011)),
])
