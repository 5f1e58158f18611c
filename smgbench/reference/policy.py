"""Plain reference of the greedy arbitration and the PE / OO geometry.

The SMG reference's decision rule (main.py, the testing branch): the best
grasp and suction object by their scores over the valid slots, the best
envelop-then-suck pair over the valid pairs (its grasp member the one with
the better grasp score), and the action whose best score is highest,
suction winning ties with neither, grasp the remaining case, ETS only
where a scene has more than one valid object. Then the action geometry
(its action_geom.py): pre-enveloping takes the footprint rectangle's long
side for the grasp angle and its short side, widened to at most 1.2 times
itself by the long one, for the opening; the suction point is the
rectangle's centre; orientation optimization turns the suction cup into
the widest free window of bearings around the target, where taller
neighbours cover the bearings between their corners with weights
exp(-height gap / distance), re-admitting the least occluding round by
round. Pixel (col, row) maps to the workspace at the pixel's centre.

NumPy, float64. `q`, when given, rounds after every operation: the
control's lower precision. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

SUCTION, GRASP, ETS = 0, 1, 2
NEG = -1e9
VALUE_THRESHOLD = 0.95
ANGLE_THRESHOLD = 45
FREE_EPS = 1e-6


def _ident(x):
    return x


def bf16(x):
    """x rounded to bfloat16 (nearest, ties to even), as float64."""
    a = np.asarray(x, dtype=np.float32).copy()
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def arbitrate(gra, suc, gs, valid, method: str = "reinforcement", is_ets: bool = True):
    """Greedy choice of B scenes from float32 scores gra, suc (B, N, R),
    gs (B, N, N) and valid (B, N): a dict of (B,) int arrays action,
    grasp_obj, grasp_rot, suction_obj, suction_rot."""
    gra, suc, gs = (np.asarray(a, np.float32) for a in (gra, suc, gs))
    valid = np.asarray(valid, bool)
    B, N, R = gra.shape
    b = np.arange(B)
    neg = np.float32(NEG)

    def best(conf):
        m = np.where(valid[..., None], conf, neg).reshape(B, -1)
        flat = np.argmax(m, axis=1)
        return m[b, flat], flat // R, flat % R

    g_conf, g_obj, g_rot = best(gra)
    s_conf, s_obj, s_rot = best(suc)
    g_rot_of = np.argmax(np.where(valid[..., None], gra, neg), axis=2)
    s_rot_of = np.argmax(np.where(valid[..., None], suc, neg), axis=2)
    g_any = np.where(valid, gra.max(axis=2), neg)
    ar = np.arange(N)
    pair_ok = valid[:, :, None] & valid[:, None, :] & (ar[:, None] < ar[None, :])
    pm = np.where(pair_ok, gs, np.float32(-100.0)).reshape(B, -1)
    flat = np.argmax(pm, axis=1)
    gs_conf = pm[b, flat]
    pi, pj = flat // N, flat % N
    g_first = g_any[b, pi] > g_any[b, pj]
    pg = np.where(g_first, pi, pj)
    ps = np.where(g_first, pj, pi)

    single = np.where(s_conf > g_conf, SUCTION, GRASP)
    if is_ets:
        ets = np.float32(2.0) * gs_conf if method == "reactive" else gs_conf
        multi_choice = np.where(s_conf > np.maximum(g_conf, ets), SUCTION,
                                np.where(ets > np.maximum(s_conf, g_conf), ETS, GRASP))
        action = np.where(valid.sum(axis=1) > 1, multi_choice, single)
    else:
        action = single
    is_g, is_s = action == GRASP, action == SUCTION
    return {
        "action": action,
        "grasp_obj": np.where(is_g, g_obj, pg),
        "grasp_rot": np.where(is_g, g_rot, g_rot_of[b, pg]),
        "suction_obj": np.where(is_s, s_obj, ps),
        "suction_rot": np.where(is_s, s_rot, s_rot_of[b, ps]),
    }


class Geometry:
    """PE / OO geometry on a workspace of `resolution` metres a pixel from
    `origin` (x, y), in float64 with `q` rounding after every operation."""

    def __init__(self, origin, resolution: float, q=None):
        self.q = q or _ident
        self.origin = np.asarray(origin, np.float64)
        self.res = resolution

    def world(self, px):
        q = self.q
        x = q(self.origin[0] + q(q(px[..., 0] + 0.5) * self.res))
        y = q(self.origin[1] + q(q(px[..., 1] + 0.5) * self.res))
        return np.stack([x, y], -1)

    @staticmethod
    def height(depth, px):
        B, H, W = depth.shape
        col = np.clip(np.trunc(px[..., 0]).astype(np.int64), 0, W - 1)
        row = np.clip(np.trunc(px[..., 1]).astype(np.int64), 0, H - 1)
        return depth.reshape(B, -1)[np.arange(B).reshape((B,) + (1,) * (col.ndim - 1)),
                                    row * W + col]

    def surface(self, corners, depth):
        centre = np.trunc(self.q(corners.mean(axis=-2)))
        xy = self.world(centre)
        return np.concatenate([xy, self.height(depth, centre)[..., None]], -1)

    def grasp(self, corners, depth):
        """corners (B, 4, 2) -> position (B, 3), angle (B,), opening (B,)."""
        q = self.q
        position = self.surface(corners, depth)
        w = self.world(corners)
        d01 = q(np.linalg.norm(q(w[:, 0] - w[:, 1]), axis=-1))
        d12 = q(np.linalg.norm(q(w[:, 2] - w[:, 1]), axis=-1))

        def side(a, c):
            d = q(a - c)
            return q(np.mod(q(np.arctan2(d[:, 1], d[:, 0])), np.pi))

        long01 = d01 > d12
        opening = np.where(long01,
                           q(d12 * np.minimum(q(d01 / np.maximum(d12, 1e-9)), 1.2)),
                           q(d01 * np.minimum(q(d12 / np.maximum(d01, 1e-9)), 1.2)))
        angle = np.where(long01, side(w[:, 0], w[:, 1]), side(w[:, 2], w[:, 1]))
        return position, angle, opening

    @staticmethod
    def free_window(free):
        """The reference's window over (B, 360) free bins: (found, degrees)."""
        B, n = free.shape
        f = free.astype(np.int64)
        out_found = np.zeros(B, bool)
        out_angle = np.zeros(B)
        for k in range(B):
            row = f[k]
            if row.all():
                lead = trail = n
            else:
                lead = int(np.argmin(row))
                trail = int(np.argmin(row[::-1]))
            left, right = lead - 1, trail - 1
            width = left + right
            if row[0] == 1 and row[-1] == 1 and width >= ANGLE_THRESHOLD:
                mid = left - width // 2 if left > right else (n - trail) + width // 2
                out_found[k], out_angle[k] = True, mid % n
                continue
            best_w, best_end, run = 0, 0, 0
            for i in range(n):
                run = run + 1 if row[i] else 0
                ends = row[i] and (i == n - 1 or not row[i + 1])
                if ends and run - 1 >= ANGLE_THRESHOLD and run > best_w:
                    best_w, best_end = run, i
            if best_w:
                start = best_end - best_w + 1
                out_found[k], out_angle[k] = True, ((start + best_end) // 2) % n
        return out_found, out_angle

    def suction(self, target, centers, corners, valid, depth):
        """Suction point (B, 3) and OO angle (B,) in radians."""
        q = self.q
        B, N = valid.shape
        b = np.arange(B)
        position = self.surface(corners[b, target], depth)
        tc = centers[b, target]
        heights = np.maximum(self.height(depth, centers),
                             self.height(depth, corners).max(axis=2))
        cw = self.world(centers)
        dist = q(np.linalg.norm(q(cw - cw[b, target][:, None]), axis=-1))
        dh = np.maximum(q(heights - heights[b, target][:, None]), 0.0)
        w = q(np.exp(q(-dh / np.maximum(dist, 0.001))))
        dx = q(tc[:, None, None, 0] - corners[..., 0])
        dy = q(tc[:, None, None, 1] - corners[..., 1])
        bear = q(q(np.mod(q(np.arctan2(dx, dy)), 2 * np.pi)) * (180.0 / np.pi))   # (B, N, 4)
        diff = np.abs(q(bear[..., :, None] - bear[..., None, :]))
        circ = np.minimum(diff, q(360.0 - diff)).reshape(B, N, 16)
        k = np.argmax(circ, axis=2)
        bk = np.take_along_axis(bear, (k // 4)[..., None], 2)[..., 0]
        bl = np.take_along_axis(bear, (k % 4)[..., None], 2)[..., 0]
        lo, hi = np.minimum(bk, bl), np.maximum(bk, bl)
        lo_i, hi_i = np.trunc(lo)[..., None], np.trunc(hi)[..., None]
        bins = np.arange(360)
        narrow = (q(hi - lo) <= 180.0)[..., None]
        cover = np.where(narrow, (bins >= lo_i) & (bins < hi_i), (bins < lo_i) | (bins >= hi_i))
        occluder = valid & (np.arange(N)[None] != target[:, None]) & (w < 1.0 - FREE_EPS)
        admitted = np.zeros((B, N), bool)
        done = np.zeros(B, bool)
        result = np.zeros(B)
        for _ in range(N + 1):
            act = occluder & ~admitted
            contrib = np.where(act[..., None] & cover, w[..., None], 1.0)
            av = np.ones((B, 360))
            for i in range(N):
                av = q(av * contrib[:, i])
            all_ok = av.min(axis=1) >= VALUE_THRESHOLD
            found, mid = self.free_window(av >= 1.0 - FREE_EPS)
            result = np.where(done, result, np.where(all_ok, 0.0, np.where(found, mid, result)))
            new_done = done | all_ok | found
            wmax = np.where(act, w, -np.inf).max(axis=1)
            admit = act & (np.abs(w - wmax[:, None]) < 0.001)
            admitted = np.where(new_done[:, None], admitted, admitted | admit)
            done = new_done
        return position, q(np.deg2rad(result))

    def decide(self, choice: dict, centers, corners, valid, number, depth,
               is_pe: bool = True, is_oo: bool = True):
        """The geometry of a choice: a dict of grasp_position (B, 3),
        grasp_angle, opening, suction_position (B, 3), suction_angle."""
        if not (is_pe and is_oo):
            raise NotImplementedError("the reference computes PE and OO together")
        B, N = valid.shape
        b = np.arange(B)
        g_obj, s_obj, action = choice["grasp_obj"], choice["suction_obj"], choice["action"]
        g_pos, g_angle, opening = self.grasp(corners[b, g_obj], depth)
        is_ets = action == ETS
        oo_valid = valid & ~((is_ets & (number > 2))[:, None]
                             & (np.arange(N)[None] == g_obj[:, None]))
        s_pos, s_angle = self.suction(s_obj, centers, corners, oo_valid, depth)
        s_angle = np.where(is_ets & (number == 2), 0.0, s_angle)
        return {"grasp_position": g_pos, "grasp_angle": g_angle, "opening": opening,
                "suction_position": s_pos, "suction_angle": s_angle}
