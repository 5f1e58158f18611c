"""The decide entry: one policy decision for a batch of observed scenes.

A call is the act step's path up to execution, as the port's loop runs it
in testing (train/loop.py::train_step): `smg_env.masked_scene_depth`, then
`Trainer.score_scene_batch` (the three styles' eval trunks and heads),
`arbitrate.select_action` (greedy) and `smg_env.compute_geometry` (PE and
OO), ending with the actions and poses copied to the host as an executor
or a robot needs them. Observations come from a pool made at set-up and
are used in turn.

What is judged, once the window has closed, on a sample of the calls
drawn from the seed (one call of each of `sample_batches` pool batches):

- `score_err_ratio`: per style, the root mean square of the program's
  score minus the float32 reference's over the valid objects (pairs for
  ETS) of the call's scenes, over the same of the reference computed with
  every conv's operands rounded to bfloat16 (the configuration's
  precision); the worst style of the worst call. Random weights make the
  scores' spread, and so any error over it, swing from seed to seed; the
  bf16 reference's own error swings with them.
- `choice_mismatch`: scenes whose action or targets differ from the
  reference's arbitration of the program's own scores (exact).
- `geom_gap`: the largest gap between the program's grasp and suction
  points (m), opening (m) and grasp angle (rad, modulo pi; either side of
  a square footprint) and the reference's float64 geometry of the
  program's choice.
- `oo_mismatch`: the share of sampled scenes whose orientation-optimized
  suction angle is more than 1e-3 rad from the reference's.
"""

from __future__ import annotations

import math
import random
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from smgbench import bounds, traffic, weights
from smgbench.reference import policy as ref_policy
from smgbench.reference import scores as ref_scores

INTS = ("action", "grasp_obj", "grasp_rot", "suction_obj", "suction_rot")
OO_TOL = 1e-3
# A footprint whose sides differ by less than this share is square: either
# side is its long side, and float32 rounding picks one (the catalogs'
# other rectangles differ by 20% or more).
SQUARE_TOL = 1e-3


@dataclass
class State:
    config: dict
    cell: dict
    traffic: dict
    trainer: object
    tstate: object
    env_cfg: object
    explore_prob: float
    obs: list
    scenes: list
    weights: dict
    flops: list          # useful FLOPs of a call on each pool batch


def build_program(config: dict, device):
    """The port's Trainer and EnvConfig, as the configuration states them."""
    from smg_tpu_torch.envs.smg_env import EnvConfig
    from smg_tpu_torch.models.affordance import ModelConfig
    from smg_tpu_torch.train.trainer import TrainConfig, Trainer

    model = ModelConfig(block_config=tuple(config["architecture"]["block_config"]),
                        **config["model"])
    trainer = Trainer(TrainConfig(model=model, **config["train"]), device=device)
    return trainer, EnvConfig(**config["env"])


def observation(sc: traffic.Scenes):
    """A traffic batch in the program's Observation form."""
    from smg_tpu_torch.envs.smg_env import Observation
    from smg_tpu_torch.perception.segment import Segmentation

    B, S = sc.depth.shape[:2]
    seg = Segmentation(masks=sc.masks, valid=sc.valid, number=sc.number, boxes=sc.boxes,
                       centers=sc.centers, box_corners=sc.corners,
                       rect_sizes=sc.rect_sizes, rect_angles=sc.rect_angles)
    color = torch.zeros((1, 1, 1, 3), device=sc.depth.device).expand(B, S, S, 3)
    return Observation(depth_hm=sc.depth, color_hm=color, seg=seg)


def setup(config: dict, cell: dict, spec: dict, seed: int, device) -> State:
    from smg_tpu_torch.policy import arbitrate as arb
    from smg_tpu_torch.train.trainer import TrainerState

    marks = [("start", time.perf_counter())]
    trainer, env_cfg = build_program(config, device)
    marks.append(("program", time.perf_counter()))
    w = weights.make(config, seed + 1, device)
    trainer.model.load_state_dict(w, strict=True)
    marks.append(("weights", time.perf_counter()))
    scenes = traffic.make_pool(spec, cell["pool_batches"], cell["batch"], seed, device)
    marks.append(("traffic", time.perf_counter()))
    print("set-up seconds: " + ", ".join(f"{n} {t - marks[k][1]:.3f}"
                                         for k, (n, t) in enumerate(marks[1:])),
          file=sys.stderr)
    arch, size = config["architecture"], config["model"]["input_size"]
    out = weights.trunk_channels(arch)
    flops = [bounds.decision_flops(arch, size, out, sc.number.tolist()) for sc in scenes]
    return State(config=config, cell=cell, traffic=spec, trainer=trainer,
                 tstate=TrainerState(), env_cfg=env_cfg,
                 explore_prob=arb.explore_probability(0, False, env_cfg.is_testing),
                 obs=[observation(sc) for sc in scenes], scenes=scenes, weights=w,
                 flops=flops)


@dataclass
class Answer:
    batch: int              # the pool batch decided
    ints: torch.Tensor      # (B, 5) host int32: INTS
    floats: torch.Tensor    # (B, 9) host f32: grasp xyz, angle, opening, suction xyz, angle
    scores: tuple           # the program's (gra, suc, gs) on the device


def call(st: State, i: int, span) -> Answer:
    from smg_tpu_torch.envs import smg_env
    from smg_tpu_torch.policy import arbitrate as arb

    k = i % len(st.obs)
    obs = st.obs[k]
    env = st.env_cfg
    with span("score"):
        depth = smg_env.masked_scene_depth(obs)
        sc = st.trainer.score_scene_batch(st.tstate, depth, obs.seg.masks, obs.seg.valid)
    with span("policy"):
        choice = arb.select_action(sc.gra_conf, sc.suc_conf, sc.gs_conf, obs.seg.valid,
                                   obs.seg.centers, method=env.method, is_ets=env.is_ets,
                                   is_testing=env.is_testing, explore_prob=st.explore_prob)
        geom = smg_env.compute_geometry(choice, obs, env)
    with span("fetch"):
        ints = torch.stack([getattr(choice, f) for f in INTS], 1).cpu()
        floats = torch.cat([geom.grasp_position, geom.grasp_angle[:, None],
                            geom.open_distance[:, None], geom.suction_position,
                            geom.suction_angle[:, None]], 1).cpu()
    return Answer(batch=k, ints=ints, floats=floats,
                  scores=(sc.gra_conf, sc.suc_conf, sc.gs_conf))


def scenes_of(st: State, answer: Answer) -> int:
    return answer.ints.shape[0]


def flops_of(st: State, answer: Answer) -> float:
    return st.flops[answer.batch]


def warm(st: State, span) -> None:
    """The warm-up calls, over `warmup_calls` pool batches (one shape)."""
    for i in range(st.cell["warmup_calls"]):
        call(st, i, span)


def sample(answers: list, n: int, seed: int) -> list:
    """One answer for each of up to n pool batches, drawn from the seed."""
    rng = random.Random(seed)
    by_batch = {}
    for a in answers:
        by_batch.setdefault(a.batch, []).append(a)
    batches = sorted(by_batch)
    rng.shuffle(batches)
    return [rng.choice(by_batch[b]) for b in sorted(batches[:n])]


def to_host(answer: Answer) -> dict:
    """The program's outputs of one call as numpy arrays."""
    gra, suc, gs = (t.float().cpu().numpy() for t in answer.scores)
    f = answer.floats.double().numpy()
    out = {"batch": answer.batch, "gra": gra, "suc": suc, "gs": gs,
           "grasp_position": f[:, 0:3], "grasp_angle": f[:, 3], "opening": f[:, 4],
           "suction_position": f[:, 5:8], "suction_angle": f[:, 8]}
    ints = answer.ints.long().numpy()
    out.update({name: ints[:, k] for k, name in enumerate(INTS)})
    return out


def reference(st: State, batch: int, rnd=None):
    """The reference's scores of one pool batch, numpy (NaN off the valid
    entries): float32, or with `rnd` rounding every conv's operands."""
    sc = st.scenes[batch]
    gra, suc, gs = ref_scores.scores(st.weights, st.config, sc.depth, sc.masks, sc.valid,
                                     st.cell["reference_chunk"], rnd)
    return gra.cpu().numpy(), suc.cpu().numpy(), gs.cpu().numpy()


def references(st: State, batch: int):
    """(float32, bf16) reference scores of one pool batch: the exact
    function, and the same arithmetic with every conv's operands rounded
    to bfloat16 (the configuration's precision, accumulated in float32)."""
    from smgbench.reference import densenet as dn

    return reference(st, batch), reference(st, batch, dn.bf16_rounding)


def _circ(d, period):
    d = np.mod(np.abs(d), period)
    return np.minimum(d, period - d)


def judge_one(st: State, out: dict, refs) -> dict:
    """The compared numbers of one call's outputs against the reference:
    refs is its (float32, bf16) scores of the call's batch."""
    sc = st.scenes[out["batch"]]
    valid = sc.valid.cpu().numpy()
    N = valid.shape[1]
    ii, jj = np.triu_indices(N, k=1)
    pair_ok = valid[:, ii] & valid[:, jj]
    ratio, detail = 0.0, []
    (r32, r16) = refs
    for style, ok in ((0, valid), (1, valid), (2, pair_ok)):
        pick = (lambda a: a[..., 0]) if style < 2 else (lambda a: a[:, ii, jj])
        prog = pick((out["gra"], out["suc"], out["gs"])[style])
        f32 = (r32[0], r32[1], r32[2][:, ii, jj])[style]
        b16 = (r16[0], r16[1], r16[2][:, ii, jj])[style]
        if not ok.any():
            continue
        base = f32[ok].astype(np.float64)
        err = math.sqrt(np.mean((prog[ok].astype(np.float64) - base) ** 2))
        own = math.sqrt(np.mean((b16[ok].astype(np.float64) - base) ** 2))
        ratio = max(ratio, err / own if own > 0 else (0.0 if err == 0 else math.inf))
        detail.append([out["batch"], style, int(ok.sum()), err, own, float(base.std())])
    env = st.config["env"]
    mine = ref_policy.arbitrate(out["gra"], out["suc"], out["gs"], valid,
                                env["method"], env["is_ets"])
    mismatch = np.zeros(valid.shape[0], bool)
    for name in INTS:
        mismatch |= mine[name] != out[name]
    spec = st.traffic
    geo = ref_policy.Geometry(np.array(spec["workspace_m"])[:, 0], spec["resolution_m"])
    corners = sc.corners.double().cpu().numpy()
    centers = sc.centers.double().cpu().numpy()
    choice = {n: out[n] for n in ("action", "grasp_obj", "suction_obj")}
    g = geo.decide(choice, centers, corners, valid, sc.number.cpu().numpy(),
                   sc.depth.double().cpu().numpy(), env["is_pe"], env["is_oo"])
    b = np.arange(valid.shape[0])
    side = corners[b, out["grasp_obj"]]
    w = geo.world(side)
    d01 = np.linalg.norm(w[:, 0] - w[:, 1], axis=-1)
    d12 = np.linalg.norm(w[:, 2] - w[:, 1], axis=-1)
    square = np.abs(d01 - d12) <= SQUARE_TOL * np.maximum(d01, d12)
    ang = _circ(out["grasp_angle"] - g["grasp_angle"], math.pi)
    ang = np.where(square, np.minimum(ang, _circ(ang - math.pi / 2, math.pi)), ang)
    gap = max(np.abs(out["grasp_position"] - g["grasp_position"]).max(),
              np.abs(out["suction_position"] - g["suction_position"]).max(),
              np.abs(out["opening"] - g["opening"]).max(), ang.max())
    oo = _circ(out["suction_angle"] - g["suction_angle"], 2 * math.pi) > OO_TOL
    return {"score_err_ratio": ratio, "choice_mismatch": int(mismatch.sum()),
            "geom_gap": float(gap), "oo_mismatch": float(oo.mean()), "scenes": valid.shape[0],
            "detail": detail}


def combine(parts: list) -> dict:
    """The numbers of a run from those of its sampled calls."""
    n = sum(p["scenes"] for p in parts)
    return {"score_err_ratio": max(p["score_err_ratio"] for p in parts),
            "choice_mismatch": sum(p["choice_mismatch"] for p in parts),
            "geom_gap": max(p["geom_gap"] for p in parts),
            "oo_mismatch": sum(p["oo_mismatch"] * p["scenes"] for p in parts) / n,
            "detail": [d for p in parts for d in p["detail"]]}


def release(st: State, answers: list, seed: int) -> list:
    """The sampled outputs on the host; the program's state freed."""
    outs = [to_host(a) for a in sample(answers, st.cell["sample_batches"], seed)]
    st.trainer = None
    st.obs = None
    answers.clear()
    return outs


def judge(st: State, outs: list) -> dict:
    """Compared numbers of the sampled outputs against the reference."""
    return combine([judge_one(st, out, references(st, out["batch"])) for out in outs])


def control_outputs(st: State, batch: int) -> dict:
    """The control in the program's place on one pool batch: the reference
    at fp8 (its conv inputs and kernels rounded to e4m3 under a per-tensor
    scale), arbitrated by the reference, its geometry in bfloat16."""
    from smgbench.reference import densenet as dn

    gra, suc, gs = reference(st, batch, dn.fp8_rounding)
    sc = st.scenes[batch]
    valid = sc.valid.cpu().numpy()
    gra = np.where(valid, gra, -1e9).astype(np.float32)[..., None]
    suc = np.where(valid, suc, -1e9).astype(np.float32)[..., None]
    gs = np.where(np.isnan(gs), -100.0, gs).astype(np.float32)
    env = st.config["env"]
    choice = ref_policy.arbitrate(gra, suc, gs, valid, env["method"], env["is_ets"])
    spec = st.traffic
    geo = ref_policy.Geometry(ref_policy.bf16(np.array(spec["workspace_m"])[:, 0]),
                              spec["resolution_m"], q=ref_policy.bf16)
    g = geo.decide(choice, sc.centers.double().cpu().numpy(), sc.corners.double().cpu().numpy(),
                   valid, sc.number.cpu().numpy(), ref_policy.bf16(sc.depth.cpu().numpy()),
                   env["is_pe"], env["is_oo"])
    return {"batch": batch, "gra": gra, "suc": suc, "gs": gs, **choice, **g}


def program_reading(st: State, seed: int, span) -> dict:
    """The comparison of a run with this seed, on one call of each pool
    batch (readings.py)."""
    answers = [call(st, k, span) for k in range(st.cell["pool_batches"])]
    return judge(st, release(st, answers, seed))


def control_reading(st: State, seed: int, span) -> dict:
    """The control's outputs on the batches a run with this seed samples,
    judged by the same comparison (readings.py)."""
    answers = [call(st, k, span) for k in range(st.cell["pool_batches"])]
    batches = [o["batch"] for o in release(st, answers, seed)]
    return combine([judge_one(st, control_outputs(st, b), references(st, b)) for b in batches])
