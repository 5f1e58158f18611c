"""Branchless ray-primitive intersection (port of smg_tpu/render/raycast.py).

Misses return +inf so the nearest-hit / highest-surface reductions stay
branchless. Inputs broadcast: rays o, d (..., 3) against per-object
shape_type (...) and half extents he (..., 3).
"""

from __future__ import annotations

import math

import torch

from smg_tpu_torch.physics import shapes

INF = math.inf


def _safe_div(a, b):
    eps = 1e-12
    sgn_eps = torch.where(b >= 0, torch.full_like(b, eps), torch.full_like(b, -eps))
    return a / torch.where(torch.abs(b) < eps, sgn_eps, b)


def ray_box(o, d, he):
    t1 = _safe_div(-he - o, d)
    t2 = _safe_div(he - o, d)
    tmin = torch.minimum(t1, t2).max(dim=-1).values
    tmax = torch.maximum(t1, t2).min(dim=-1).values
    hit = (tmax >= tmin) & (tmax >= 0.0)
    return torch.where(hit, tmin, torch.full_like(tmin, INF))


def ray_sphere(o, d, r):
    b = (o * d).sum(dim=-1)
    c = (o * o).sum(dim=-1) - r * r
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    hit = (disc >= 0.0) & (t >= 0.0)
    inside = (disc >= 0.0) & (c < 0.0)
    t = torch.where(inside, torch.zeros_like(t), t)
    return torch.where(hit | inside, t, torch.full_like(t, INF))


def ray_cylinder(o, d, R, hh):
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1]
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - R * R
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_side = _safe_div(-b - sq, a)
    z_at = o[..., 2] + t_side * d[..., 2]
    side_ok = (disc >= 0.0) & (t_side >= 0.0) & (torch.abs(z_at) <= hh)
    inf = torch.full_like(t_side, INF)
    t_side = torch.where(side_ok, t_side, inf)

    t_top = _safe_div(hh - o[..., 2], d[..., 2])
    t_bot = _safe_div(-hh - o[..., 2], d[..., 2])

    def cap_ok(t):
        x = o[..., 0] + t * d[..., 0]
        y = o[..., 1] + t * d[..., 1]
        return (t >= 0.0) & (x * x + y * y <= R * R)

    t_top = torch.where(cap_ok(t_top), t_top, inf)
    t_bot = torch.where(cap_ok(t_bot), t_bot, inf)
    return torch.minimum(t_side, torch.minimum(t_top, t_bot))


def ray_primitive(o, d, shape_type, he):
    t_box = ray_box(o, d, he)
    t_cyl = ray_cylinder(o, d, he[..., 0], he[..., 2])
    t_sph = ray_sphere(o, d, he[..., 0])
    return torch.where(shape_type == shapes.BOX, t_box,
                       torch.where(shape_type == shapes.CYLINDER, t_cyl, t_sph))
