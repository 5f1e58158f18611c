"""K1: the pairwise penalty-contact sweep (csrc/contact.cu).

Port of smg_tpu/ops/contact_pallas.py::pairwise_forces. Per object sphere
(row, S = N*K) and scene (B), the force summed over T = S + G sources
(every object sphere, then the G gripper collider spheres): a penalty
normal force fn = max(0, kn*min(pen, max_pen) - cn*clip(vn)) with
cn = 2*zeta*sqrt(kn*m_eff/share), m_eff harmonic between objects and
m_row against the gripper, plus smooth Coulomb friction
mu*fn*tanh(|vt|/v_eps) (mu_grip for gripper sources). Same-owner pairs
(j // K) and dead spheres are masked. All state is scene-minor SoA:
(S, B) rows and (T, B) columns.
"""

from __future__ import annotations

import torch

from smg_tpu_torch.ops import _build

launches = 0


def pairwise_forces_plain(row_state, col_state, K: int, *, kn, zeta, share,
                          mu, mu_grip, v_eps, max_pen, max_vn):
    """Plain PyTorch version: the (S, T, B) pair terms, summed over T."""
    cx, cy, cz, vx, vy, vz, rad, mrow, live_row = (
        r[:, None, :] for r in row_state)
    sx, sy, sz, svx, svy, svz, srad, mcol, live_col = (
        c[None] for c in col_state)
    S, T = row_state[0].shape[0], col_state[0].shape[0]
    dev = row_state[0].device
    j = torch.arange(T, device=dev)
    is_grip = (j >= S)[None, :, None]
    col_owner = torch.where(j >= S, torch.full_like(j, -1), j // K)
    row_owner = torch.arange(S, device=dev) // K
    same = (row_owner[:, None] == col_owner[None, :])[..., None]

    dx, dy, dz = cx - sx, cy - sy, cz - sz
    dist2 = dx * dx + dy * dy + dz * dz
    inv_dist = torch.rsqrt(dist2 + 1e-18)
    pen = (rad + srad) - dist2 * inv_dist
    ok = ~same & (live_row > 0.0) & (live_col > 0.0) & (pen > 0.0)

    nx, ny, nz = dx * inv_dist, dy * inv_dist, dz * inv_dist
    rvx, rvy, rvz = vx - svx, vy - svy, vz - svz
    vn = torch.clamp(rvx * nx + rvy * ny + rvz * nz, -max_vn, max_vn)
    meff = torch.where(is_grip, mrow, mrow * mcol / (mrow + mcol))
    cn = 2.0 * zeta * torch.sqrt(kn * meff / share)
    fn = torch.clamp(kn * torch.clamp(pen, max=max_pen) - cn * vn, min=0.0)
    fn = torch.where(ok, fn, torch.zeros_like(fn))

    tx, ty, tz = rvx - vn * nx, rvy - vn * ny, rvz - vn * nz
    vt2 = tx * tx + ty * ty + tz * tz
    inv_vt = torch.rsqrt(vt2 + 1e-18)
    mu_j = torch.where(is_grip, torch.full_like(fn, mu_grip),
                       torch.full_like(fn, mu))
    ft = mu_j * fn * torch.tanh(vt2 * inv_vt / v_eps)
    fx = (fn * nx - ft * tx * inv_vt).sum(dim=1)
    fy = (fn * ny - ft * ty * inv_vt).sum(dim=1)
    fz = (fn * nz - ft * tz * inv_vt).sum(dim=1)
    return fx, fy, fz


def pairwise_forces(row_state, col_state, K: int, *, kn, zeta, share, mu,
                    mu_grip, v_eps, max_pen, max_vn):
    """Per-sphere contact forces (fx, fy, fz), each (S, B).

    row_state: 9 tensors (S, B) cx cy cz vx vy vz rad mass live;
    col_state: 9 tensors (T, B) of the same quantities for the sources.
    Any B: the TPU kernel's B % 128 lane rule does not apply here.
    """
    gains = dict(kn=kn, zeta=zeta, share=share, mu=mu, mu_grip=mu_grip,
                 v_eps=v_eps, max_pen=max_pen, max_vn=max_vn)
    if row_state[0].device.type == "cpu":
        return pairwise_forces_plain(row_state, col_state, K, **gains)
    rows = torch.stack(row_state)
    cols = torch.stack(col_state)
    return pairwise_forces_stacked(rows, cols, K, **gains)


def pairwise_forces_stacked(rows, cols, K: int, *, kn, zeta, share, mu,
                            mu_grip, v_eps, max_pen, max_vn):
    """Kernel launch on stacked state: rows (9, S, B), cols (9, T, B) f32
    on the card -> (fx, fy, fz), each (S, B)."""
    global launches
    _, S, B = rows.shape
    T = cols.shape[1]
    _build.check_cuda(rows, "rows", torch.float32, (9, S, B))
    _build.check_cuda(cols, "cols", torch.float32, (9, T, B))
    if cols.device != rows.device:
        raise ValueError("rows and cols must be on the same device")
    out = torch.empty((3, S, B), dtype=torch.float32, device=rows.device)
    _build.launch(
        "smg_contact_forces", rows.data_ptr(), cols.data_ptr(),
        out.data_ptr(), S, T, B, K, kn, zeta, share, mu, mu_grip, v_eps,
        max_pen, max_vn,
    )
    launches += 1
    return out[0], out[1], out[2]
