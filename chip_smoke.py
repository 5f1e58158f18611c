"""Smoke run of the PyTorch port on one CUDA GPU: build, check, drive.

    python3 chip_smoke.py

1. Fails at once when no CUDA device is visible; prints the card's name
   and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from smg_tpu_torch/csrc (nvcc, sm_90a).
3. One phase per kernel: the kernel against its plain PyTorch version on
   the card, at the shapes the act step gives it — K1 at B = 32 and 1024,
   K2 at every (H, C_in) of DenseNet-121 at 224, K3 at its three shapes,
   K4 at the stem — with each kernel's and plain version's median time
   from CUDA events.
4. The main path: make_prod_trainer(32) + make_prod_loop_cfg(32) with
   is_testing=True, init_loop with the seeded He init, then act steps,
   with per-phase times, the success rate and each kernel's launch count;
   plus one scene's trunk features against the plain bf16 path on the CPU.
5. Prints the kernel table as one JSON line, the card line, and last
   {"ok": true, "device": {...}}. Any failed check raises (exit code != 0).

Options: `--out DIR` writes the details (chip_smoke.json, and with
--profile the profiler table) to DIR; `--profile` adds one act step under
torch.profiler and a physics-step timing. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED = 0
B_MAIN = 32
ACT_STEPS = 3
STREAMS = 8 * 13      # one trunk pass: scene_chunk 8 scenes x (1 + 12 masks)
TOL_BF16 = 2.0 ** -6  # of the largest |value|: a few bf16 steps
DETAIL = {}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() on the device, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------


def phase_contact(dev):
    from smg_tpu_torch.ops import contact
    from smg_tpu_torch.physics import gripper as gr
    from smg_tpu_torch.physics import scene as scene_mod
    from smg_tpu_torch.physics import stepper

    prm = stepper.DEFAULT.contact
    gains = dict(kn=prm.kn, zeta=prm.zeta, share=prm.contact_share, mu=prm.mu,
                 mu_grip=prm.mu_gripper, v_eps=prm.v_eps,
                 max_pen=prm.max_pen, max_vn=prm.max_vn)
    worst, rows_out, ms, plain = 0.0, [], 0.0, 0.0
    for B in (32, 1024):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        # Scenes mid-drop (30 steps in) with the gripper lowered into the
        # pile: object-object, object-gripper and resting contacts.
        sc = scene_mod.reset_scene(gen, B, dev, settle_steps=30)
        g = sc.gripper
        g = g.replace(pos=torch.stack([sc.objects.pos[:, 0, 0],
                                       sc.objects.pos[:, 0, 1],
                                       torch.full_like(g.pos[:, 2], 0.1)], 1))
        row, _ = stepper._world_spheres_soa(sc.objects)
        gx, gy, gz, grad = gr.collider_spheres_soa(g.pos, g.yaw, g.tilt, g.curl)
        ones = torch.ones_like(gx)
        gv = torch.randn((3,) + gx.shape, generator=gen, device=dev) * 0.5
        cols = tuple(torch.cat([a, b]) for a, b in zip(
            row, (gx, gy, gz, gv[0], gv[1], gv[2], grad[:, None] * ones, ones,
                  ones)))
        rows_t, cols_t = torch.stack(row), torch.stack(cols)
        got = torch.stack(contact.pairwise_forces_stacked(rows_t, cols_t, 9, **gains))
        want = torch.stack(contact.pairwise_forces_plain(row, cols, 9, **gains))
        fmax = float(want.abs().max())
        check(fmax > 1.0, f"K1 B={B}: no contacts in the case")
        excess = ((got - want).abs() - 1e-5 * want.abs()).max()
        err_abs = float((got - want).abs().max())
        check(float(excess) <= 1e-5 * fmax,
              f"K1 B={B}: |err| {err_abs} over rtol 1e-5 + 1e-5 max|f|")
        k_ms = cuda_ms(lambda: contact.pairwise_forces_stacked(
            rows_t, cols_t, 9, **gains), reps=20)
        p_ms = cuda_ms(lambda: contact.pairwise_forces_plain(
            row, cols, 9, **gains), reps=10)
        worst = max(worst, err_abs)
        rows_out.append({"B": B, "max_abs_err": err_abs, "max_abs_force": fmax,
                         "ms": k_ms, "plain_ms": p_ms})
        print(f"K1 contact B={B}: max|err| {err_abs:.3e} (bound rtol 1e-5 + "
              f"{1e-5 * fmax:.2e}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if B == B_MAIN:
            ms, plain = k_ms, p_ms
    DETAIL["K1"] = rows_out
    return {"name": "K1 contact sweep", "route": "cuda",
            "source": "smg_tpu_torch/csrc/contact.cu",
            "replaces": "smg_tpu/ops/contact_pallas.py:160",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain}


def _bn(gen, c, dev):
    a = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.rand(c, generator=gen, device=dev) * 0.6 - 0.2
    return a, b


def phase_dense_layer(dev):
    from smg_tpu_torch.models.densenet import BLOCK_CONFIG
    from smg_tpu_torch.ops import dense_layer as k2

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    N, HW, C0 = STREAMS, 56, 64
    worst, tot_ms, tot_plain, rows = 0.0, 0.0, 0.0, []
    for L in BLOCK_CONFIG:
        C = C0 + 32 * L
        buf = torch.randn((N, HW, HW, C), generator=gen, device=dev).to(torch.bfloat16)
        for l in range(L):
            c_in = C0 + 32 * l
            a1, b1 = _bn(gen, c_in, dev)
            a2, b2 = _bn(gen, 128, dev)
            w1 = (torch.randn((c_in, 128), generator=gen, device=dev)
                  * (2 / c_in) ** 0.5).to(torch.bfloat16)
            w2 = (torch.randn((9, 128, 32), generator=gen, device=dev)
                  * (2 / 1152) ** 0.5).to(torch.bfloat16)
            ops = (a1, b1, w1, a2, b2, w2)
            k2.dense_layer(buf, c_in, *ops)
            got = buf[..., c_in:c_in + 32].clone()
            k2.dense_layer_plain(buf, c_in, *ops)
            want = buf[..., c_in:c_in + 32]
            err = rel_err(got, want)
            check(err <= TOL_BF16, f"K2 H={HW} C_in={c_in}: rel err {err:.5f}")
            err_abs = float((got.float() - want.float()).abs().max())
            k_ms = cuda_ms(lambda: k2.dense_layer(buf, c_in, *ops), reps=5)
            p_ms = cuda_ms(lambda: k2.dense_layer_plain(buf, c_in, *ops),
                           reps=2, warmup=1)
            worst = max(worst, err_abs)
            tot_ms += k_ms
            tot_plain += p_ms
            rows.append({"H": HW, "C_in": c_in, "rel_err": err,
                         "max_abs_err": err_abs, "ms": k_ms, "plain_ms": p_ms})
        print(f"K2 dense layers H={HW} C_in {C0}..{C - 32}: worst rel err "
              f"{max(r['rel_err'] for r in rows if r['H'] == HW):.5f} "
              f"(bound {TOL_BF16:.5f})")
        C0, HW = C // 2, HW // 2
        del buf
    DETAIL["K2"] = rows
    print(f"K2 one trunk pass ({len(rows)} layers, {N} images): kernel "
          f"{tot_ms:.3f} ms, plain {tot_plain:.3f} ms")
    return {"name": "K2 dense layer", "route": "cuda",
            "source": "smg_tpu_torch/csrc/dense_layer.cu",
            "replaces": "smg_tpu/ops/dense_layer_pallas.py:405",
            "max_abs_err": worst, "ms": tot_ms, "plain_ms": tot_plain}


def phase_transition(dev):
    from smg_tpu_torch.ops import transition as k3

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst, tot_ms, tot_plain, rows = 0.0, 0.0, 0.0, []
    for HW, C in ((56, 256), (28, 512), (14, 1024)):
        x = torch.randn((STREAMS, HW, HW, C), generator=gen, device=dev).to(torch.bfloat16)
        a, b = _bn(gen, C, dev)
        wt = (torch.randn((C, C // 2), generator=gen, device=dev)
              * C ** -0.5).to(torch.bfloat16)
        got = k3.transition(x, a, b, wt)
        want = k3.transition_plain(x, a, b, wt)
        err = rel_err(got, want)
        check(err <= TOL_BF16, f"K3 {HW}x{HW}x{C}: rel err {err:.5f}")
        err_abs = float((got.float() - want.float()).abs().max())
        k_ms = cuda_ms(lambda: k3.transition(x, a, b, wt))
        p_ms = cuda_ms(lambda: k3.transition_plain(x, a, b, wt), reps=5)
        worst = max(worst, err_abs)
        tot_ms += k_ms
        tot_plain += p_ms
        rows.append({"H": HW, "C": C, "rel_err": err, "max_abs_err": err_abs,
                     "ms": k_ms, "plain_ms": p_ms})
        print(f"K3 transition {HW}x{HW}x{C}: rel err {err:.5f} (bound "
              f"{TOL_BF16:.5f}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    DETAIL["K3"] = rows
    return {"name": "K3 transition", "route": "cuda",
            "source": "smg_tpu_torch/csrc/transition.cu",
            "replaces": "smg_tpu/ops/transition_pallas.py:110",
            "max_abs_err": worst, "ms": tot_ms, "plain_ms": tot_plain}


def phase_stem(dev):
    from smg_tpu_torch.ops import stem_pool as k4

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    y = torch.randn((STREAMS, 112, 112, 64), generator=gen, device=dev).to(torch.bfloat16)
    a, b = _bn(gen, 64, dev)
    got = k4.bn_relu_maxpool(y, a, b)
    want = k4.bn_relu_maxpool_plain(y, a, b)
    err = rel_err(got, want)
    check(got.shape == (STREAMS, 56, 56, 64), f"K4 shape {tuple(got.shape)}")
    check(err <= TOL_BF16, f"K4 stem: rel err {err:.5f}")
    err_abs = float((got.float() - want.float()).abs().max())
    k_ms = cuda_ms(lambda: k4.bn_relu_maxpool(y, a, b))
    p_ms = cuda_ms(lambda: k4.bn_relu_maxpool_plain(y, a, b))
    DETAIL["K4"] = {"rel_err": err, "max_abs_err": err_abs, "ms": k_ms,
                    "plain_ms": p_ms}
    print(f"K4 stem 112x112x64 -> 56x56: rel err {err:.5f} (bound "
          f"{TOL_BF16:.5f}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return {"name": "K4 stem BN/ReLU/maxpool", "route": "cuda",
            "source": "smg_tpu_torch/csrc/stem_pool.cu",
            "replaces": "smg_tpu/ops/stem_pool_pallas.py:143",
            "max_abs_err": err_abs, "ms": k_ms, "plain_ms": p_ms}


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def main_path(dev, kernels):
    from smg_tpu_torch.ops import contact, dense_layer, stem_pool, transition
    from smg_tpu_torch.train import loop
    from smg_tpu_torch.train.prod_config import make_prod_loop_cfg, make_prod_trainer

    counters = {"K1 contact sweep": contact, "K2 dense layer": dense_layer,
                "K3 transition": transition,
                "K4 stem BN/ReLU/maxpool": stem_pool}
    trainer = make_prod_trainer(B_MAIN, device=dev)
    cfg = make_prod_loop_cfg(B_MAIN, is_testing=True)
    check(cfg.env.is_testing and cfg.batch_size == B_MAIN, "config")

    for mod in counters.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.init_loop(SEED, trainer, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"init_loop (B={B_MAIN}, {cfg.env.settle_steps}-step settle): "
          f"{init_s:.3f} s")
    steps, successes, first_obs = [], [], None
    for i in range(ACT_STEPS):
        if i == 0:
            from smg_tpu_torch.envs import smg_env
            first_obs = smg_env.observe(state.scenes)
        phases = {}
        last = [time.perf_counter()]

        def mark(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            phases[name] = now - last[0]
            last[0] = now

        t0 = last[0]
        state, m = loop.train_step(trainer, cfg, state, timer=mark)
        total = time.perf_counter() - t0
        succ = (m.grasp_success > 0) | (m.suction_success > 0) | (m.gs_success > 0)
        for name, t in (("predicted_value", m.predicted_value),
                        ("pos", state.scenes.objects.pos),
                        ("quat", state.scenes.objects.quat)):
            check(bool(torch.isfinite(t).all()), f"step {i}: non-finite {name}")
        check(m.action.shape == (B_MAIN,), "action shape")
        check(bool(((m.action >= 0) & (m.action <= 2)).all()), "action range")
        successes.append(succ.float().mean().item())
        steps.append({"step": i, "seconds": total,
                      "phases": {k: round(v, 6) for k, v in phases.items()},
                      "success_rate": successes[-1],
                      "actions": m.action.tolist(),
                      "objects": m.objects_number.tolist(),
                      "done": int(m.episodes_done.sum())})
        print(f"act step {i}: {total:.3f} s  " + "  ".join(
            f"{k} {v:.3f}" for k, v in phases.items())
              + f"  success {successes[-1]:.3f}")
    torch.cuda.synchronize()
    for k in kernels:
        k["launches"] = counters[k["name"]].launches
    print("launches in the main path: " + ", ".join(
        f"{k['name'].split()[0]} {k['launches']}" for k in kernels))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched by the main path")
    DETAIL["main_path"] = {"init_s": init_s, "steps": steps,
                           "success_rate": statistics.mean(successes),
                           "steps_per_act": cfg.primitive.steps_per_act,
                           "reset_settle_steps": cfg.reset_settle_steps}
    print(f"success rate over {ACT_STEPS} steps x {B_MAIN} scenes: "
          f"{statistics.mean(successes):.4f}")
    reference_score(trainer, first_obs)
    return trainer, cfg, state, [s["seconds"] for s in steps]


def profile_act_step(trainer, cfg, state, step_seconds, out_dir):
    """--profile: one more act step under torch.profiler (device kernel
    time by name, kernel count, device busy share against the unprofiled
    steps' median wall time) and the physics step alone at B = 32 and 1024."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smg_tpu_torch.physics import scene as scene_mod
    from smg_tpu_torch.physics import stepper
    from smg_tpu_torch.train import loop

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = loop.train_step(trainer, cfg, state)
        torch.cuda.synchronize()
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kern)
    n_kern = sum(e.count for e in kern)
    wall = statistics.median(step_seconds)
    top = sorted(kern, key=dev_us, reverse=True)[:25]
    prof_out = {
        "device_kernel_ms": busy_us / 1e3, "kernels_launched": n_kern,
        "unprofiled_step_s": wall,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_kernels": [{"name": e.key[:120], "count": e.count,
                         "device_ms": dev_us(e) / 1e3} for e in top],
    }
    print(f"profiled act step: {n_kern} device kernels, {busy_us / 1e3:.1f} ms "
          f"of device time; busy share {prof_out['device_busy_share']:.4f} of "
          f"the {wall:.3f} s unprofiled step")
    for e in top[:10]:
        print(f"  {dev_us(e) / 1e3:9.2f} ms {e.count:7d}x  {e.key[:90]}")
    physics = []
    for B in (32, 1024):
        gen = torch.Generator(device=trainer.device).manual_seed(SEED)
        sc = scene_mod.reset_scene(gen, B, trainer.device, settle_steps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stepper.run_steps_batched(sc, sc.gripper, 100)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 100
        physics.append({"B": B, "ms_per_step": dt * 1e3,
                        "scene_steps_per_s": B / dt})
        print(f"physics step B={B}: {dt * 1e3:.3f} ms, {B / dt:.0f} scene-steps/s")
    prof_out["physics"] = physics
    DETAIL["profile"] = prof_out
    if out_dir is not None:
        sort_key = ("self_device_time_total"
                    if hasattr(ka[0], "self_device_time_total")
                    else "self_cuda_time_total")
        (out_dir / "profile_act_step.txt").write_text(
            ka.table(sort_by=sort_key, row_limit=60))


def reference_score(trainer, obs):
    """One scene's 13 trunk inputs (scene + 12 masked streams) through the
    grasp and suction trunks on the card (bf16 kernels) and on the CPU with
    the same weights through the plain versions in bf16 (the same rounding
    points): features to 5% of the largest (PARITY dev 12). The scores are
    reported, not bounded: with random weights the head's final 3136-term
    sum cancels heavily, so a 0.5% feature difference can move a score by
    several percent of its (small) value."""
    from smg_tpu_torch.envs import smg_env
    from smg_tpu_torch.models import fast_trunk
    from smg_tpu_torch.train.trainer import Trainer

    depth = smg_env.masked_scene_depth(obs)[:1]
    masks, valid = obs.seg.masks[:1], obs.seg.valid[:1]
    x = torch.cat([trainer._prep(depth), trainer._prep(depth[:, None] * masks)[0]])
    weights = {k: t.cpu() for k, t in trainer.model.state_dict().items()}
    got_scores = trainer.score_scene(depth, masks, valid)
    v = valid[0].cpu()
    check(bool(v.any()), "reference scene has no valid object")
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(trainer.cfg, model=dataclasses.replace(
            trainer.cfg.model, dtype=dtype))
        cpu = Trainer(cfg, device="cpu")
        cpu.model.load_state_dict(weights)
        if dtype == "bfloat16":
            for style, name in ((0, "grasp"), (1, "suction")):
                with torch.no_grad():
                    g = fast_trunk.trunk_features_eval(
                        trainer.model.trunk(style), x).float().cpu()
                    w = fast_trunk.trunk_features_eval(
                        cpu.model.trunk(style), x.cpu()).float()
                check(bool(torch.isfinite(g).all()), f"{name} trunk: non-finite")
                err = float((g - w).abs().max() / w.abs().max())
                l2 = float((g - w).norm() / w.norm())
                print(f"{name} trunk features (13 images) vs the bf16 CPU "
                      f"plain path: max err {err:.4f} of the largest (bound "
                      f"0.05), rel L2 {l2:.4f}")
                DETAIL.setdefault("reference", {})[f"{name}_trunk"] = {
                    "max_rel_err": err, "rel_l2": l2}
                check(err < 0.05, f"{name} trunk features: err {err:.4f}")
        want_scores = cpu.score_scene(depth.cpu(), masks.cpu(), valid.cpu())
        for name in ("gra_conf", "suc_conf"):
            g = getattr(got_scores, name)[0, :, 0].cpu()[v]
            w = getattr(want_scores, name)[0, :, 0][v]
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite")
            err = float((g - w).abs().max() / w.abs().max().clamp(min=1e-6))
            print(f"score {name} ({int(v.sum())} objects) vs the {dtype} CPU "
                  f"plain path: max err {err:.4f} of the largest (reported)")
            DETAIL.setdefault("reference", {})[f"{name}/{dtype}"] = err


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the details (JSON, profiler table)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more act step, time the physics step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from smg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s (nvcc: "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    DETAIL["build_seconds"] = build_s
    DETAIL["build_log"] = _build.build_log

    kernels = [phase_contact(dev), phase_dense_layer(dev),
               phase_transition(dev), phase_stem(dev)]
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    trainer, cfg, state, step_seconds = main_path(dev, kernels)
    if args.profile:
        profile_act_step(trainer, cfg, state, step_seconds, args.out)

    DETAIL["card"] = card
    DETAIL["kernels"] = kernels
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(DETAIL, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
