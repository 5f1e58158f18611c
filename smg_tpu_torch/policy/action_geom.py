"""Action geometry: PE (pre-enveloping) and OO (orientation optimization).

Port of smg_tpu/policy/action_geom.py on B scenes at once. The OO search
keeps the reference's order (action_geom.py:116-165): the 0/360-wrapping
free window first, then the widest interior run (first max on ties), with
least-occluding neighbours re-admitted round by round (n + 1 rounds).
"""

from __future__ import annotations

import math

import torch

from smg_tpu_torch.core import camera as cam
from smg_tpu_torch.utils import profiling

VALUE_THRESHOLD = 0.95
ANGLE_THRESHOLD = 45
FREE_EPS = 1e-6


def _pixel_to_world_xy(px: torch.Tensor, resolution: float = cam.HEIGHTMAP_RESOLUTION):
    """(..., 2) (col, row) pixels -> world (x, y)."""
    wl = torch.as_tensor(cam.WORKSPACE_LIMITS, device=px.device)
    x = wl[0, 0] + (px[..., 0] + 0.5) * resolution
    y = wl[1, 0] + (px[..., 1] + 0.5) * resolution
    return torch.stack([x, y], dim=-1)


def _sample_height(depth_hm: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Heights of depth (B, H, W) at pixels px (B, ..., 2) = (col, row)."""
    B, H, W = depth_hm.shape
    col = torch.clamp(px[..., 0].to(torch.int32), 0, W - 1).long()
    row = torch.clamp(px[..., 1].to(torch.int32), 0, H - 1).long()
    flat = (row * W + col).reshape(B, -1)
    return torch.gather(depth_hm.reshape(B, -1), 1, flat).reshape(col.shape)


def surface_position(center_px: torch.Tensor, depth_hm: torch.Tensor):
    """(B, 2) pixels -> (B, 3) world surface points."""
    xy = _pixel_to_world_xy(center_px)
    z = _sample_height(depth_hm, center_px)
    return torch.cat([xy, z[..., None]], dim=-1)


def _trunc_center(corners_px: torch.Tensor) -> torch.Tensor:
    return corners_px.mean(dim=-2).to(torch.int32).to(torch.float32)


def pe_grasp_geometry(corners_px: torch.Tensor, depth_hm: torch.Tensor,
                      is_pe: bool = True):
    """corners (B, 4, 2) -> position (B, 3), angle (B,), open distance (B,)
    (action_geom.py:69-104)."""
    with profiling.span("pe"):
        position = surface_position(_trunc_center(corners_px), depth_hm)
        B = corners_px.shape[0]
        if not is_pe:
            z = torch.zeros(B, device=corners_px.device)
            return position, z, z + 2.0
        w = _pixel_to_world_xy(corners_px)                         # (B, 4, 2)
        d01 = torch.linalg.norm(w[:, 0] - w[:, 1], dim=-1)
        d12 = torch.linalg.norm(w[:, 2] - w[:, 1], dim=-1)

        def side_angle(a, b):
            d = a - b
            return torch.remainder(torch.atan2(d[:, 1], d[:, 0]), math.pi)

        long01 = d01 > d12
        open_dist = torch.where(
            long01,
            d12 * torch.clamp(d01 / torch.clamp(d12, min=1e-9), max=1.2),
            d01 * torch.clamp(d12 / torch.clamp(d01, min=1e-9), max=1.2),
        )
        angle = torch.where(long01, side_angle(w[:, 0], w[:, 1]),
                            side_angle(w[:, 2], w[:, 1]))
        return position, angle, open_dist


def _bearings_deg(points_px: torch.Tensor, center_px: torch.Tensor):
    """Reference bearing convention (action_geom.py:107-113)."""
    dx = center_px[..., 0] - points_px[..., 0]
    dy = center_px[..., 1] - points_px[..., 1]
    ang = torch.remainder(torch.atan2(dx, dy), 2 * math.pi)
    return ang * (180.0 / math.pi)


def _select_free_window(free: torch.Tensor):
    """Reference-order free-window selection over (B, 360) masks
    (action_geom.py:116-165). Returns found (B,), angle (B,) degrees."""
    f = free.to(torch.int64)
    B, n = f.shape
    idx = torch.arange(n, device=f.device)
    all_free = (f == 1).all(dim=1)
    leading = torch.where(all_free, n, torch.argmin(f, dim=1))
    trailing = torch.where(all_free, n, torch.argmin(f.flip(1), dim=1))
    angle_left = leading - 1
    angle_right = trailing - 1
    start_last = n - trailing
    width = angle_left + angle_right
    wrap_ok = (f[:, 0] == 1) & (f[:, n - 1] == 1) & (width >= ANGLE_THRESHOLD)
    wrap_mid = torch.where(angle_left > angle_right,
                           angle_left - width // 2, start_last + width // 2)

    # Run length ending at each bin: i - (last zero index at or before i).
    last_zero = torch.cummax(torch.where(f == 0, idx, torch.full_like(idx, -1)),
                             dim=1).values
    runs = torch.where(f == 1, idx - last_zero, torch.zeros_like(f))
    nxt_zero = torch.cat([f[:, 1:] == 0,
                          torch.ones(B, 1, dtype=torch.bool, device=f.device)], 1)
    is_end = (f == 1) & nxt_zero
    widths = torch.where(is_end & (runs - 1 >= ANGLE_THRESHOLD), runs,
                         torch.zeros_like(runs))
    best_end = torch.argmax(widths, dim=1)
    best_w = widths.gather(1, best_end[:, None])[:, 0]
    lin_ok = best_w > 0
    start = best_end - best_w + 1
    lin_mid = (start + best_end) // 2
    found = wrap_ok | lin_ok
    angle = torch.where(wrap_ok, wrap_mid, lin_mid)
    return found, torch.remainder(angle, n).to(torch.float32)


def oo_suction_angle(target: torch.Tensor, centers_px: torch.Tensor,
                     corners_px: torch.Tensor, valid: torch.Tensor,
                     depth_hm: torch.Tensor, is_oo: bool = True):
    """Suction point (B, 3) and OO rotation (B,) radians
    (action_geom.py:168-259). target (B,), centers (B, N, 2),
    corners (B, N, 4, 2), valid (B, N), depth (B, H, W)."""
    with profiling.span("oo"):
        B, n = valid.shape
        dev = valid.device
        bidx = torch.arange(B, device=dev)
        tl = target.long()
        position = surface_position(_trunc_center(corners_px[bidx, tl]), depth_hm)
        if not is_oo:
            return position, torch.zeros(B, device=dev)
        tc = centers_px[bidx, tl]                                    # (B, 2)

        h_center = _sample_height(depth_hm, centers_px)
        h_corners = _sample_height(depth_hm, corners_px).amax(dim=2)
        heights = torch.maximum(h_center, h_corners)                 # (B, N)
        cw = _pixel_to_world_xy(centers_px)
        dist = torch.linalg.norm(cw - cw[bidx, tl][:, None], dim=-1)
        dh = torch.clamp(heights - heights[bidx, tl][:, None], min=0.0)
        w = torch.exp(-dh / torch.clamp(dist, min=0.001))

        bear = _bearings_deg(corners_px, tc[:, None, None, :])      # (B, N, 4)
        diff = torch.abs(bear[..., :, None] - bear[..., None, :])
        circ = torch.minimum(diff, 360.0 - diff)
        pair_flat = torch.argmax(circ.reshape(B, n, 16), dim=2)
        b_k = bear.gather(2, (pair_flat // 4)[..., None])[..., 0]
        b_l = bear.gather(2, (pair_flat % 4)[..., None])[..., 0]
        lo, hi = torch.minimum(b_k, b_l), torch.maximum(b_k, b_l)
        lo_i = lo.to(torch.int32)[..., None]
        hi_i = hi.to(torch.int32)[..., None]
        bins = torch.arange(360, device=dev)
        narrow = ((hi - lo) <= 180.0)[..., None]
        cover = torch.where(narrow, (bins >= lo_i) & (bins < hi_i),
                            (bins < lo_i) | (bins >= hi_i))          # (B, N, 360)
        slots = torch.arange(n, device=dev)
        occluder = valid & (slots[None] != target[:, None]) & (w < 1.0 - FREE_EPS)

        admitted = torch.zeros(B, n, dtype=torch.bool, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        result = torch.zeros(B, device=dev)
        ones = torch.ones_like(cover, dtype=w.dtype)
        for _ in range(n + 1):
            act = occluder & ~admitted
            contrib = torch.where(act[..., None] & cover, w[..., None], ones)
            av = torch.prod(contrib, dim=1)                          # (B, 360)
            all_ok = av.amin(dim=1) >= VALUE_THRESHOLD
            found, mid = _select_free_window(av >= 1.0 - FREE_EPS)
            new_result = torch.where(
                done, result,
                torch.where(all_ok, torch.zeros_like(result),
                            torch.where(found, mid, result)))
            new_done = done | all_ok | found
            rem = occluder & ~admitted
            wmax = torch.where(rem, w, torch.full_like(w, -math.inf)).amax(dim=1)
            admit_now = rem & (torch.abs(w - wmax[:, None]) < 0.001)
            admitted = torch.where(new_done[:, None], admitted, admitted | admit_now)
            result, done = new_result, new_done
        return position, torch.deg2rad(result)
