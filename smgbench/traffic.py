"""The general traffic generator: tabletop scenes from a seed, as the
parameters of a traffic file say (`traffic/<name>.json`).

A scene is a depth heightmap (metres above the table) with the exact
instance segmentation of its objects, in the form the port's exact
segmenter gives it (perception/segment.py): masks, validity, count,
axis-aligned boxes, centres and the four corners of each object's
footprint rectangle, in pixel coordinates (column, row) of pixel centres.
Object counts are drawn as physics/scene.py::spawn_objects draws them:
`enveloping_count` enveloping objects, then `sucking_count` sucking ones,
at least `sucking_min_when_no_enveloping` of those when there is no
enveloping object. Each object takes its (shape, half extents) from its
kind's catalog and stands upright on one of the first `cells_used` drop
cells, drawn without repeats, moved by up to `jitter_px` and turned by a
uniform yaw. The cells are far enough apart that no two footprints meet,
so every mask is the whole footprint. A box shows a flat top at twice its
half height, a cylinder a disc at twice its half height, a sphere a dome.

Every draw comes from one torch.Generator on the device the scenes are
made on, in a few calls for a whole batch. Nothing of the program is
imported: the parameters are copied into the traffic file.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class Scenes:
    """B scenes of N object slots on an S x S heightmap."""

    depth: torch.Tensor        # (B, S, S) f32, metres above the table
    masks: torch.Tensor        # (B, N, S, S) bool
    valid: torch.Tensor        # (B, N) bool
    number: torch.Tensor       # (B,) int32
    boxes: torch.Tensor        # (B, N, 2, 2) f32: [[col min, row min], [col max, row max]]
    centers: torch.Tensor      # (B, N, 2) f32, truncated to whole pixels
    corners: torch.Tensor      # (B, N, 4, 2) f32, in order around the rectangle
    rect_sizes: torch.Tensor   # (B, N, 2) f32, pixels
    rect_angles: torch.Tensor  # (B, N) f32, degrees


def _catalog(entries, device):
    kinds = torch.tensor([e[0] for e in entries], dtype=torch.int64, device=device)
    half = torch.tensor([e[1] for e in entries], dtype=torch.float32, device=device)
    return kinds, half


def count_draw(spec: dict, B: int, gen: torch.Generator, device):
    """(enveloping, sucking) object counts of B scenes, each (B,) int64."""
    lo_g, hi_g = spec["enveloping_count"]
    lo_s, hi_s = spec["sucking_count"]
    n_g = torch.randint(lo_g, hi_g + 1, (B,), generator=gen, device=device)
    n_s = torch.randint(lo_s, hi_s + 1, (B,), generator=gen, device=device)
    n_s = torch.where(n_g > 0, n_s,
                      torch.clamp(n_s, min=spec["sucking_min_when_no_enveloping"]))
    return n_g, n_s


def make_scenes(spec: dict, B: int, gen: torch.Generator, device) -> Scenes:
    """B scenes drawn from `gen` as `spec` (a traffic file) says."""
    S, N, res = spec["heightmap_px"], spec["slots"], spec["resolution_m"]
    codes = spec["shape_codes"]
    n_g, n_s = count_draw(spec, B, gen, device)
    slot = torch.arange(N, device=device)
    active = slot[None] < (n_g + n_s)[:, None]                       # (B, N)
    enveloping = slot[None] < n_g[:, None]
    kg, hg = _catalog(spec["enveloping_catalog"], device)
    ks, hs = _catalog(spec["sucking_catalog"], device)
    gi = torch.randint(0, kg.shape[0], (B, N), generator=gen, device=device)
    si = torch.randint(0, ks.shape[0], (B, N), generator=gen, device=device)
    kind = torch.where(enveloping, kg[gi], ks[si])
    half = torch.where(enveloping[..., None], hg[gi], hs[si])        # (B, N, 3) m

    cells = torch.tensor(spec["cells_px"], dtype=torch.float32, device=device)
    used = spec["cells_used"]
    if N > used and bool((n_g + n_s > used).any()):
        raise ValueError(f"more objects than the {used} drop cells")
    perm = torch.argsort(torch.rand((B, used), generator=gen, device=device), dim=1)
    cell = perm[:, torch.clamp(slot, max=used - 1)]
    jitter = (torch.rand((B, N, 2), generator=gen, device=device) * 2 - 1) * spec["jitter_px"]
    centre = cells[cell] + jitter                                    # (B, N, 2) px
    yaw = torch.rand((B, N), generator=gen, device=device) * (2 * math.pi)

    round_ = kind != codes["box"]
    hx = half[..., 0] / res
    hy = torch.where(round_, hx, half[..., 1] / res)                 # px
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    pix = torch.arange(S, dtype=torch.float32, device=device)
    dx = pix[None, None, None, :] - centre[..., 0, None, None]       # (B, N, 1, S)
    dy = pix[None, None, :, None] - centre[..., 1, None, None]       # (B, N, S, 1)
    c4, s4 = cos[..., None, None], sin[..., None, None]
    u = dx * c4 + dy * s4
    v = dy * c4 - dx * s4
    r2 = u * u + v * v
    inside_box = (u.abs() <= hx[..., None, None]) & (v.abs() <= hy[..., None, None])
    inside_disc = r2 <= (hx * hx)[..., None, None]
    masks = torch.where(round_[..., None, None], inside_disc, inside_box)
    masks &= active[..., None, None]

    hz = half[..., 2, None, None]
    flat_top = 2 * hz.expand_as(r2)
    dome = hz + torch.sqrt(torch.clamp(hz * hz - r2 * (res * res), min=0.0))
    height = torch.where((kind == codes["sphere"])[..., None, None], dome, flat_top)
    depth = torch.where(masks, height, torch.zeros_like(height)).amax(dim=1)

    local = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], device=device)
    lu = local[:, 0] * hx[..., None]                                 # (B, N, 4)
    lv = local[:, 1] * hy[..., None]
    corners = torch.stack([centre[..., 0, None] + lu * cos[..., None] - lv * sin[..., None],
                           centre[..., 1, None] + lu * sin[..., None] + lv * cos[..., None]], -1)
    centers = corners.mean(dim=2).to(torch.int32).to(torch.float32)

    big = torch.tensor(1e9, device=device)
    cols = torch.where(masks, pix[None, None, None, :], big)
    rows = torch.where(masks, pix[None, None, :, None], big)
    col_min, row_min = cols.amin(dim=(2, 3)), rows.amin(dim=(2, 3))
    col_max = torch.where(masks, pix[None, None, None, :], -big).amax(dim=(2, 3))
    row_max = torch.where(masks, pix[None, None, :, None], -big).amax(dim=(2, 3))
    boxes = torch.stack([torch.stack([col_min, row_min], -1),
                         torch.stack([col_max, row_max], -1)], dim=2)

    valid = active
    v2 = valid[..., None]
    zero = torch.zeros((), device=device)
    return Scenes(
        depth=depth,
        masks=masks,
        valid=valid,
        number=valid.sum(dim=1).to(torch.int32),
        boxes=torch.where(v2[..., None], boxes, zero),
        centers=torch.where(v2, centers, zero),
        corners=torch.where(v2[..., None], corners, zero),
        rect_sizes=torch.where(v2, torch.stack([2 * hx, 2 * hy], -1), zero),
        rect_angles=torch.where(valid, torch.rad2deg(yaw), zero),
    )


def make_pool(spec: dict, batches: int, batch: int, seed: int, device) -> list[Scenes]:
    """`batches` batches of `batch` scenes from one generator seeded with
    `seed`: the same seed gives the same pool."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [make_scenes(spec, batch, gen, device) for _ in range(batches)]


@dataclass
class Experiences:
    """B executed experiences: the masked scene depth, the executed mask,
    the style code and the label of each."""

    scene_depth: torch.Tensor   # (B, S, S) f32, zero off the objects
    exec_mask: torch.Tensor     # (B, S, S) bool
    style: torch.Tensor         # (B,) int32
    labels: torch.Tensor        # (B,) f32


def make_experiences(spec: dict, scene_spec: dict, labels: torch.Tensor, B: int,
                     gen: torch.Generator, device) -> Experiences:
    """B experiences drawn from `gen` as the experience traffic `spec` says,
    on scenes of `scene_spec`, labels drawn from the values `labels`."""
    sc = make_scenes(scene_spec, B, gen, device)
    counts, codes = spec["style_counts"], spec["style_codes"]
    n = sc.number.long()
    g, s, e = (float(counts[k]) for k in ("grasp", "suction", "ets"))
    u = torch.rand(B, generator=gen, device=device)
    two = n >= 2
    # With two objects the three styles in their shares; with one, grasp
    # and suction in theirs.
    total = torch.where(two, g + s + e, g + s)
    style = torch.where(u * total < g, codes["grasp"],
                        torch.where(u * total < g + s, codes["suction"], codes["ets"]))
    r = torch.rand((B, 2), generator=gen, device=device)
    first = torch.clamp((r[:, 0] * n).long(), max=n - 1)
    second = (first + 1 + torch.minimum((r[:, 1] * (n - 1)).long(),
                                        torch.clamp(n - 2, min=0))) % n
    b = torch.arange(B, device=device)
    exec_mask = sc.masks[b, first] | ((style == codes["ets"])[:, None, None]
                                      & sc.masks[b, second])
    pick = torch.randint(0, labels.shape[0], (B,), generator=gen, device=device)
    union = sc.masks.any(dim=1)
    return Experiences(scene_depth=torch.where(union, sc.depth, torch.zeros_like(sc.depth)),
                       exec_mask=exec_mask, style=style.to(torch.int32),
                       labels=labels.to(device)[pick])
