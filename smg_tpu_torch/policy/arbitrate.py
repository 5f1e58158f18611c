"""Action arbitration, batched over scenes.

Port of smg_tpu/policy/arbitrate.py: masked per-object / per-pair maxima,
the 2x ETS bonus of the reactive method, the 'grasp the pair member with
the better enveloping score' ordering, and epsilon-greedy exploration
(arbitrate.py:55-62, 143-156). In testing the explore probability is 0 and
no random number is drawn. In training each scene flips its own coin; the
draws come from the loop's torch.Generator, so they are not the JAX
package's bits (its tests compare distributions).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from smg_tpu_torch.physics.state import _Batched
from smg_tpu_torch.utils import profiling

ACTION_SUCTION = 0
ACTION_GRASP = 1
ACTION_ETS = 2

NEG = -1e9


@dataclass
class ActionChoice(_Batched):
    """Per-scene selected action; every field has a leading B."""

    action: torch.Tensor          # (B,) int32
    grasp_obj: torch.Tensor       # (B,) int32
    grasp_rot: torch.Tensor
    suction_obj: torch.Tensor
    suction_rot: torch.Tensor
    predicted_value: torch.Tensor  # (B,) f32
    explored: torch.Tensor        # (B,) bool
    best_pix: torch.Tensor        # (B, 6) int32
    bestg_id: torch.Tensor        # (B, 2) int32 [obj, rot]
    bests_id: torch.Tensor
    bestgs_g_id: torch.Tensor
    bestgs_s_id: torch.Tensor
    bestgs_pair: torch.Tensor
    bestg_conf: torch.Tensor      # (B,)
    bests_conf: torch.Tensor
    bestgs_conf: torch.Tensor
    exploit_action: torch.Tensor  # (B,) int32


def _pow_f32(base: float, n: int) -> torch.Tensor:
    """base ** n for an integer n >= 0 by square-and-multiply in float32,
    as XLA computes a float power with an integer exponent."""
    r = torch.tensor(1.0, dtype=torch.float32)
    b = torch.tensor(base, dtype=torch.float32)
    while n:
        if n & 1:
            r = r * b
        b = b * b
        n >>= 1
    return r


def explore_probability(iteration: int, decay: bool, is_testing: bool) -> float:
    """Parity: reference main.py:78,345 (arbitrate.py:55-62): the decay
    max(0.5 * 0.9998^iteration, 0.1) in float32, as the JAX package
    computes it."""
    if is_testing:
        return 0.0
    if decay:
        return float(torch.clamp(0.5 * _pow_f32(0.9998, int(iteration)), min=0.1))
    return 0.5


def _masked_best(conf: torch.Tensor, valid: torch.Tensor):
    """(max, [obj, rot]) of (B, N, R) scores under a (B, N) mask."""
    B, N, R = conf.shape
    masked = torch.where(valid[..., None], conf, torch.full_like(conf, NEG))
    flat = torch.argmax(masked.reshape(B, -1), dim=1)
    ids = torch.stack([flat // R, flat % R], dim=1).to(torch.int32)
    return masked.reshape(B, -1).amax(dim=1), ids


def _i32(x):
    return x.to(torch.int32)


def select_action(
    gra_conf: torch.Tensor,   # (B, N, R)
    suc_conf: torch.Tensor,   # (B, N, R)
    gs_conf: torch.Tensor,    # (B, N, N)
    valid: torch.Tensor,      # (B, N)
    centers: torch.Tensor,    # (B, N, 2)
    *,
    method: str = "reinforcement",
    is_ets: bool = False,
    is_testing: bool = True,
    explore_prob: float = 0.0,
    generator: torch.Generator | None = None,
    scene_slice=None,
) -> ActionChoice:
    """Pick the primitive + targets for B scenes (arbitrate.py:73-206).

    Out of testing, each scene explores with probability explore_prob: a
    uniform action over 2 primitives, or 3 with ETS (rand % 2 where only
    one object is valid), drawn from `generator`; under a SceneSlice
    (physics/state.py) for the whole batch, then cut to the slice."""
    with profiling.span("select_action"):
        B, n, _ = gra_conf.shape
        dev = gra_conf.device
        num = valid.sum(dim=1)
        bidx = torch.arange(B, device=dev)

        bestg_conf, bestg_id = _masked_best(gra_conf, valid)
        bests_conf, bests_id = _masked_best(suc_conf, valid)
        neg = lambda t: torch.full_like(t, NEG)  # noqa: E731
        gmask = torch.where(valid[..., None], gra_conf, neg(gra_conf))
        smask = torch.where(valid[..., None], suc_conf, neg(suc_conf))
        gro_best = _i32(torch.argmax(gmask, dim=2))
        sro_best = _i32(torch.argmax(smask, dim=2))
        gmax = gra_conf.amax(dim=2)
        gnu_best = torch.where(valid, gmax, torch.full_like(gmax, NEG))

        ar = torch.arange(n, device=dev)
        pair_ok = valid[:, :, None] & valid[:, None, :] & (ar[:, None] < ar[None, :])
        gs_masked = torch.where(pair_ok, gs_conf, torch.full_like(gs_conf, -100.0))
        flat = torch.argmax(gs_masked.reshape(B, -1), dim=1)
        pi, pj = flat // n, flat % n
        bestgs_conf = gs_masked.reshape(B, -1).amax(dim=1)
        g_first = gnu_best[bidx, pi] > gnu_best[bidx, pj]
        gs_g_obj = torch.where(g_first, pi, pj)
        gs_s_obj = torch.where(g_first, pj, pi)
        bestgs_g_id = _i32(torch.stack([gs_g_obj, gro_best[bidx, gs_g_obj].long()], 1))
        bestgs_s_id = _i32(torch.stack([gs_s_obj, sro_best[bidx, gs_s_obj].long()], 1))

        multi = num > 1
        suction_wins = bests_conf > bestg_conf
        single = torch.where(suction_wins, ACTION_SUCTION, ACTION_GRASP)
        if not is_ets:
            exploit = single
        else:
            ets_score = 2.0 * bestgs_conf if method == "reactive" else bestgs_conf
            exploit_multi = torch.where(
                bests_conf > torch.maximum(bestg_conf, ets_score),
                ACTION_SUCTION,
                torch.where(ets_score > torch.maximum(bests_conf, bestg_conf),
                            ACTION_ETS, ACTION_GRASP),
            )
            exploit = torch.where(multi, exploit_multi, single)
        exploit = _i32(exploit)
        if is_testing:
            explored = torch.zeros(B, dtype=torch.bool, device=dev)
            action = exploit
        else:
            n = B if scene_slice is None else scene_slice.total
            explored = torch.rand(n, generator=generator, device=dev) < explore_prob
            rand_raw = torch.randint(0, 3 if is_ets else 2, (n,), generator=generator,
                                     device=dev)
            if scene_slice is not None:
                explored, rand_raw = scene_slice.cut(explored), scene_slice.cut(rand_raw)
            if is_ets:
                rand_raw = torch.where(multi, rand_raw, rand_raw % 2)
            action = torch.where(explored, _i32(rand_raw), exploit)

        is_g = action == ACTION_GRASP
        is_s = action == ACTION_SUCTION
        grasp_obj = torch.where(is_g, bestg_id[:, 0], bestgs_g_id[:, 0])
        grasp_rot = torch.where(is_g, bestg_id[:, 1], bestgs_g_id[:, 1])
        suction_obj = torch.where(is_s, bests_id[:, 0], bestgs_s_id[:, 0])
        suction_rot = torch.where(is_s, bests_id[:, 1], bestgs_s_id[:, 1])
        predicted = torch.where(is_g, bestg_conf,
                                torch.where(is_s, bests_conf, bestgs_conf))

        cx = _i32(centers[..., 0])
        cy = _i32(centers[..., 1])
        zero = torch.zeros_like(grasp_rot)
        gl, sl = grasp_obj.long(), suction_obj.long()
        g_pix = torch.stack([grasp_rot, cy[bidx, gl], cx[bidx, gl]], 1)
        s_pix = torch.stack([suction_rot, cy[bidx, sl], cx[bidx, sl]], 1)
        z3 = torch.stack([zero, zero, zero], 1)
        best_pix = torch.where(
            is_g[:, None], torch.cat([g_pix, z3], 1),
            torch.where(is_s[:, None], torch.cat([z3, s_pix], 1),
                        torch.cat([g_pix, s_pix], 1)),
        )
        return ActionChoice(
            action=action, grasp_obj=_i32(grasp_obj), grasp_rot=_i32(grasp_rot),
            suction_obj=_i32(suction_obj), suction_rot=_i32(suction_rot),
            predicted_value=predicted, explored=explored,
            best_pix=_i32(best_pix), bestg_id=bestg_id, bests_id=bests_id,
            bestgs_g_id=bestgs_g_id, bestgs_s_id=bestgs_s_id,
            bestgs_pair=_i32(torch.stack([pi, pj], 1)),
            bestg_conf=bestg_conf, bests_conf=bests_conf, bestgs_conf=bestgs_conf,
            exploit_action=exploit,
        )
