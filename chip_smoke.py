"""Smoke run of the PyTorch port on one CUDA GPU: build, check, drive.

    python3 chip_smoke.py

1. Fails at once when no CUDA device is visible; prints the card's name
   and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from smg_tpu_torch/csrc (nvcc, sm_90a).
3. One phase per kernel: the kernel against its plain PyTorch version on
   the card, at the shapes the main paths give it — K1 at B = 32 and 1024
   (also run twice for the same bits, and timed per launch over a loop of
   200), K2 at every (H, C_in) of DenseNet-121 at 224 and at 640 with
   104 images (with its 224 time per dense block split into its two
   launches by the profiler, beside the parts' cuBLAS and cuDNN
   yardsticks), K3 at its three transitions at 224 and at 640 with 104
   images (each beside its own bound and torch.matmul of the pooled
   tensor), K4 at the stem, K5 (the `xla_pk` conv2) at every (H, C_in) at 224 and
   at 640 with 104 images, K6a/K6b (the train-mode dense layer, forward and
   backward) at every (H, C_in) at 224 and 640 and at a 6 x 6 block 4 with
   64 images (with their 224 time per dense
   block split by launch name by the profiler, beside the parts' torch.matmul
   and torch.nn.grad.conv2d_* yardsticks), K7 (the `pallas` dense
   block) on the four blocks at 224 and at 640 with 104 images, both
   epilogues, taps_packed True and False (its time split by launch name,
   the epilogue on its own line) — with each kernel's and plain
   version's time and the least time the card could take for the same
   work (bound_ms, from the shapes): a kernel's time is its device time,
   its calls replayed from a CUDA graph (device_ms), a plain version's its
   eager time by CUDA events; K6
   composed over each whole dense block against its plain walk; and K3
   and K6 at the largest batch their wrappers take (32-bit indices).
4. The act path: make_prod_trainer(32) + make_prod_loop_cfg(32) with
   is_testing=True, init_loop with the seeded He init, then act steps,
   with per-phase times, the success rate and each kernel's launch count;
   plus one scene's trunk features against the plain bf16 path on the CPU.
5. The training path: make_prod_trainer(32, fast_train_conv2="pk") +
   make_prod_loop_cfg(32, is_testing=False), init_loop, 3 training steps
   (labels, update through K6, Adam) with per-phase times, the loss and
   state checks and each kernel's launch count; then one update with
   'conv' (autograd) against 'pk' on the same experience and weights
   (times, losses), and on 8 of its scenes the update's gradients through
   K6 against K6's plain versions on the CPU and against a float32 update.
6. The eval backends' path: the decision-parity entry point
   (smg_tpu_torch/cli/decision_parity.py) on 8 rendered scenes (104 images
   per trunk call) for the backends xla_fl, xla_pk and pallas x 3 styles at
   input 224 and 640, each score held to the module eval forward in float32
   (the oracle) by the decided-argmax rule (at 640 its tolerance witnessed
   by the bf16 module forward, see the entry point), with each kernel's
   launch count; then one 104-image
   trunk pass per backend and size, timed, its features within 5% of the
   oracle's largest |value|.
7. Prints the kernel table as one JSON line, the card line, and last
   {"ok": true, "device": {...}}. Any failed check raises (exit code != 0).

Options: `--out DIR` writes the details (chip_smoke.json, and with
--profile the profiler table) to DIR; `--profile` adds one act step under
torch.profiler and a physics-step timing. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED = 0
B_MAIN = 32
ACT_STEPS = 2
TRAIN_STEPS = 3
STREAMS = 8 * 13      # one trunk pass: scene_chunk 8 scenes x (1 + 12 masks)
TRAIN_IMAGES = 64     # one style group of the b32 update: 32 scenes x 2 streams
TOL_BF16 = 2.0 ** -6  # of the largest |value|: a few bf16 steps
# Gradients: bf16 operands with f32 sums in another order than the plain
# version's, through two BatchNorm backwards: relative L2.
TOL_GRAD = 1e-2
# The update's gradients at full depth on UPDATE_SCENES scenes, relative L2
# per network part. At random He-init weights the bf16 update's trunk
# gradients are fixed only to about half their norm: any change of
# rounding (K6 on the card against its plain versions on the CPU, at the
# same rounding points, read 0.48-0.53) flips bf16 ReLUs and near-constant
# channels of the masked streams' per-image BatchNorm amplify it. So the
# check is against the float32 'conv' update on the card: bf16 'pk' may be
# no farther from it than TRUTH_RATIO times bf16 'conv' is (read: 0.98-1.07
# times). K6 composed over whole blocks is held tightly by
# phase_dense_block_train, from one forward.
UPDATE_SCENES = 8
TRUTH_RATIO = 1.5
DP_SCENES = 8         # the decision-parity path: 8 x (1 + 12) = STREAMS images
SIZES = (224, 640)    # the trunk's input sizes (ModelConfig.input_size)
LOOP_LAUNCHES = 200   # K1's timing loop: back-to-back launches per reading
DETAIL = {}

# The card's published peaks (H100 SXM, dense, at 700 W): the bound of a
# kernel is the larger of its operations over the peak for their type and
# its bytes (each input read once, each output written once) over HBM's rate.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_RATE = 3.35e12


def densenet_blocks(size: int):
    """(H, C0, L) of DenseNet-121's four dense blocks at input `size`."""
    return tuple((size // (4 << i), c0, L)
                 for i, (c0, L) in enumerate(((64, 6), (128, 12), (256, 24), (512, 16))))


DENSENET_BLOCKS = densenet_blocks(224)


def bound(flops: float, nbytes: float, peak: float):
    """(bound_ms, bound_by) of work that does `flops` at `peak` and moves
    `nbytes` through device memory."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def with_bound(kernel: dict, flops: float, nbytes: float, peak: float) -> dict:
    ms, by = bound(flops, nbytes, peak)
    kernel.update(bound_ms=ms, bound_by=by, flops=flops, bytes=nbytes)
    return kernel


def densenet_layers():
    """(H, C_in) of DenseNet-121's 58 dense layers at input 224."""
    return [(H, C0 + 32 * l) for H, C0, L in DENSENET_BLOCKS for l in range(L)]


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


def device_ms(fn, calls=5, replays=3):
    """Median ms of one fn() on the device: `calls` calls captured in one
    CUDA graph, the graph replayed `replays` times, each replay timed by
    CUDA events and divided by `calls`. Unlike timing an eager call, this
    leaves out the host's cost of each call (the wrapper's checks and its
    ctypes call), which on a busy host exceeds a small kernel's time."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def loop_ms(fn, n=LOOP_LAUNCHES):
    """Per-launch mean ms of n back-to-back fn() calls, by CUDA events:
    (eager loop from Python, the same n calls replayed from one CUDA graph).
    The eager loop includes the host's cost of each call; the graph's
    replay leaves the device time and the per-node launch gap."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, device_ms(fn, calls=n, replays=1)


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
    worst, rows_out, res = 0.0, [], {}
    for B in (B_MAIN, 1024):
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
        again = torch.stack(contact.pairwise_forces_stacked(rows_t, cols_t, 9, **gains))
        check(torch.equal(got, again), f"K1 B={B}: two runs differ")
        eager_ms, k_ms = loop_ms(lambda: contact.pairwise_forces_stacked(
            rows_t, cols_t, 9, **gains))
        p_ms = cuda_ms(lambda: contact.pairwise_forces_plain(
            row, cols, 9, **gains), reps=10)
        worst = max(worst, err_abs)
        # The work this data needs: every pair's distance test (~17 f32
        # operations), and the force terms (~63 more) of the pairs in
        # contact; the kernel skips the rest, which add exactly zero. Bytes:
        # 9 (S + T) inputs and 3 S outputs per scene.
        S, T = rows_t.shape[1], cols_t.shape[1]
        n_contact = contact_pairs(row, cols, 9)
        b_ms, b_by = bound(17.0 * S * T * B + 63.0 * n_contact,
                           4.0 * (9 * (S + T) + 3 * S) * B, PEAK_F32)
        res[B] = (k_ms, p_ms, b_ms, b_by, n_contact)
        rows_out.append({"B": B, "max_abs_err": err_abs, "max_abs_force": fmax,
                         "ms": k_ms, "ms_eager_loop": eager_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "pairs_in_contact": n_contact})
        print(f"K1 contact B={B}: max|err| {err_abs:.3e} (bound rtol 1e-5 + "
              f"{1e-5 * fmax:.2e}), repeat bitwise equal; per launch over "
              f"{LOOP_LAUNCHES}: {k_ms:.5f} ms replayed from a CUDA graph, "
              f"{eager_ms:.5f} ms from an eager loop; plain {p_ms:.4f} ms; bound "
              f"{b_ms:.5f} ms ({b_by}; {n_contact} of {S * T * B} pairs in contact)")
    DETAIL["K1"] = rows_out
    k_ms, p_ms, b_ms, b_by, _ = res[B_MAIN]
    return {"name": "K1 contact sweep", "route": "cuda",
            "source": "smg_tpu_torch/csrc/contact.cu",
            "replaces": "smg_tpu/ops/contact_pallas.py:160",
            "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "ms_b1024": res[1024][0],
            "bound_ms_b1024": res[1024][2]}


def contact_pairs(row, cols, K):
    """The (row, source, scene) pairs in contact: K1's mask (distinct owners,
    both spheres live, penetration > 0)."""
    S, T = row[0].shape[0], cols[0].shape[0]
    d2 = sum((r[:, None] - c[None]) ** 2 for r, c in zip(row[:3], cols[:3]))
    pen = (row[6][:, None] + cols[6][None]) - d2 * torch.rsqrt(d2 + 1e-18)
    j = torch.arange(T, device=d2.device)
    col_owner = torch.where(j >= S, torch.full_like(j, -1), j // K)
    row_owner = torch.arange(S, device=d2.device) // K
    ok = ((row_owner[:, None] != col_owner[None])[..., None] & (row[8][:, None] > 0)
          & (cols[8][None] > 0) & (pen > 0))
    return int(ok.sum())


def _bn(gen, c, dev):
    a = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.rand(c, generator=gen, device=dev) * 0.6 - 0.2
    return a, b


def phase_dense_layer(dev):
    """K2 at all 58 layer shapes of DenseNet-121 at 224 and at 640 with 104
    images (one `xla_fl` trunk pass at each input size), each layer in
    place in its block buffer as the trunk runs it. The table's times are
    the 224 pass's; the 640 layers are checked, not timed."""
    from smg_tpu_torch.ops import dense_layer as k2

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    N = STREAMS
    worst, tot_ms, tot_plain, rows = 0.0, 0.0, 0.0, []
    for S in SIZES:
        for HW, C0, L in densenet_blocks(S):
            C = C0 + 32 * L
            buf = torch.randn((N, HW, HW, C), generator=gen, device=dev).to(torch.bfloat16)
            for c_in, *ops in _eval_layers(gen, dev, C0, L):
                k2.dense_layer(buf, c_in, *ops)
                got = buf[..., c_in:c_in + 32].clone()
                k2.dense_layer_plain(buf, c_in, *ops)
                want = buf[..., c_in:c_in + 32]
                err = rel_err(got, want)
                check(err <= TOL_BF16, f"K2 {S} H={HW} C_in={c_in}: rel err {err:.5f}")
                err_abs = float((got.float() - want.float()).abs().max())
                worst = max(worst, err_abs)
                row = {"input": S, "H": HW, "C_in": c_in, "rel_err": err,
                       "max_abs_err": err_abs}
                if S == 224:
                    row["ms"] = device_ms(lambda: k2.dense_layer(buf, c_in, *ops))
                    row["plain_ms"] = cuda_ms(lambda: k2.dense_layer_plain(buf, c_in, *ops),
                                              reps=2, warmup=1)
                    tot_ms += row["ms"]
                    tot_plain += row["plain_ms"]
                rows.append(row)
            print(f"K2 dense layers {S}: H={HW} C_in {C0}..{C - 32} ({N} images): worst "
                  f"rel err {max(r['rel_err'] for r in rows if r['input'] == S and r['H'] == HW):.5f} "
                  f"(bound {TOL_BF16:.5f})")
            del buf
    DETAIL["K2"] = rows
    print(f"K2 one xla_fl trunk pass at 224 (58 layers, {N} images): kernel "
          f"{tot_ms:.3f} ms, plain {tot_plain:.3f} ms")
    split = dense_layer_split(dev)
    flops = nbytes = 0.0
    for H, c_in in densenet_layers():
        P = N * H * H
        flops += 2.0 * P * c_in * 128 + 2.0 * P * 1152 * 32
        nbytes += 2.0 * P * (c_in + 32) + 2.0 * (c_in * 128 + 1152 * 32) + 8.0 * (c_in + 128)
    return with_bound({"name": "K2 dense layer", "route": "cuda",
                       "source": "smg_tpu_torch/csrc/dense_layer.cu",
                       "replaces": "smg_tpu/ops/dense_layer_pallas.py:405",
                       "max_abs_err": worst, "ms": tot_ms, "plain_ms": tot_plain,
                       "library_ms": None, "gemm_ms": split["gemm_ms"],
                       "conv3x3_ms": split["conv3x3_ms"], "matmul_ms": split["matmul_ms"],
                       "conv2d_ms": split["conv2d_ms"]}, flops, nbytes, PEAK_BF16)


def _profile_by_kernel(fn, reps):
    """Device ms per call of fn() by kernel name (torch.profiler over
    `reps` calls), the template arguments and parameters cut off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
        name = key.split("(")[0].split("<")[0].split("::")[-1].strip() or key[:40]
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def dense_layer_split(dev):
    """K2's time per dense block of one 104-image pass at 224, split into
    its two launches (the bottleneck GEMM, the 3x3) by device time per
    kernel name (torch.profiler over 3 passes), and the parts' library
    yardsticks at the same 58 shapes (median CUDA-event ms): torch.matmul
    of the bf16 prefix view by w1 for the bottleneck, F.conv2d in bf16
    channels_last on h2 for the 3x3, each timed like the kernels (device_ms).
    Neither computes K2's fused function."""
    import torch.nn.functional as F

    from smg_tpu_torch.ops import dense_layer as k2

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    bf, N, reps, rows = torch.bfloat16, STREAMS, 3, []
    for H, C0, L in DENSENET_BLOCKS:
        buf = torch.randn((N, H, H, C0 + 32 * L), generator=gen, device=dev).to(bf)
        layers = _eval_layers(gen, dev, C0, L)

        def block():
            for c_in, *ops in layers:
                k2.dense_layer(buf, c_in, *ops)

        parts = {"gemm": 0.0, "conv3x3": 0.0, "other": 0.0}
        for name, ms in _profile_by_kernel(block, reps).items():
            parts[next((p for p in ("gemm", "conv3x3") if p in name), "other")] += ms
        mm_ms = conv_ms = 0.0
        h2 = torch.randn((N, 128, H, H), generator=gen, device=dev).to(bf).to(
            memory_format=torch.channels_last)
        for c_in, _, _, w1, _, _, w2 in layers:
            x = buf[..., :c_in].reshape(-1, c_in)
            wc = w2.reshape(3, 3, 128, 32).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            mm_ms += device_ms(lambda: torch.matmul(x, w1))
            conv_ms += device_ms(lambda: F.conv2d(h2, wc, padding=1))
        rows.append({"H": H, "layers": L, "gemm_ms": parts["gemm"],
                     "conv3x3_ms": parts["conv3x3"], "other_ms": parts["other"],
                     "matmul_ms": mm_ms, "conv2d_ms": conv_ms})
        print(f"K2 split H={H} ({L} layers, {N} images): GEMM {parts['gemm']:.4f} ms, "
              f"3x3 {parts['conv3x3']:.4f} ms (other {parts['other']:.4f}); yardsticks "
              f"torch.matmul {mm_ms:.4f} ms, F.conv2d {conv_ms:.4f} ms")
        del buf, h2, layers
    tot = {k: sum(r[k] for r in rows) for k in rows[0] if k.endswith("_ms")}
    print(f"K2 split, one pass: GEMM {tot['gemm_ms']:.4f} ms + 3x3 "
          f"{tot['conv3x3_ms']:.4f} ms; yardsticks torch.matmul {tot['matmul_ms']:.4f} "
          f"ms, F.conv2d {tot['conv2d_ms']:.4f} ms")
    DETAIL["K2_split"] = {"blocks": rows, "pass": tot}
    return tot


def transitions(size: int):
    """(H, C) of DenseNet-121's three transitions at input `size` (C -> C/2)."""
    return [(H, C0 + 32 * L) for H, C0, L in densenet_blocks(size)[:3]]


def _transition_work(N, H, C):
    """(flops, bytes) of one transition: the 1x1's products on the pooled
    pixels; the input read once, the output written once, the weight and
    the folded BN read once."""
    P, Q, C_out = N * H * H, N * H * H / 4, C / 2
    return (2.0 * Q * C * C_out,
            2.0 * P * C + 2.0 * Q * C_out + 2.0 * C * C_out + 8.0 * C)


def phase_transition(dev):
    """K3 at the three transitions of DenseNet-121 at 224 and at 640 with
    104 images (one trunk pass at each size), each against its plain
    version and timed beside its own bound; beside them the parts'
    yardstick, torch.matmul of the pooled bf16 tensor (the pool is
    elementwise) by wt. The table's times are the 224 pass's."""
    from smg_tpu_torch.ops import transition as k3

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst, rows = 0.0, []
    tot = {S: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, matmul_ms=0.0, flops=0.0, bytes=0.0)
           for S in SIZES}
    for S in SIZES:
        for HW, C in transitions(S):
            x = torch.randn((STREAMS, HW, HW, C), generator=gen, device=dev).to(torch.bfloat16)
            a, b = _bn(gen, C, dev)
            wt = (torch.randn((C, C // 2), generator=gen, device=dev)
                  * C ** -0.5).to(torch.bfloat16)
            got = k3.transition(x, a, b, wt)
            want = k3.transition_plain(x, a, b, wt)
            err = rel_err(got, want)
            check(err <= TOL_BF16, f"K3 {S} {HW}x{HW}x{C}: rel err {err:.5f}")
            err_abs = float((got.float() - want.float()).abs().max())
            del want
            pooled = (torch.relu(x.float() * a + b).reshape(STREAMS, HW // 2, 2, HW // 2, 2, C)
                      .mean(dim=(2, 4)).to(torch.bfloat16).reshape(-1, C))
            flops, nbytes = _transition_work(STREAMS, HW, C)
            bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
            row = {"input": S, "H": HW, "C": C, "rel_err": err, "max_abs_err": err_abs,
                   "ms": device_ms(lambda: k3.transition(x, a, b, wt, out=got)),
                   "matmul_ms": device_ms(lambda: torch.matmul(pooled, wt)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            if hasattr(k3, "transition_plan"):   # (compare_parent.py runs older packages too)
                row["plan"] = list(k3.transition_plan(STREAMS * HW * HW // 4, C, C // 2))
            row["roofline_share"] = bound_ms / row["ms"]
            if S == 224:
                row["plain_ms"] = cuda_ms(lambda: k3.transition_plain(x, a, b, wt), reps=5)
                tot[S]["plain_ms"] += row["plain_ms"]
            for k in ("ms", "bound_ms", "matmul_ms"):
                tot[S][k] += row[k]
            tot[S]["flops"] += flops
            tot[S]["bytes"] += nbytes
            worst = max(worst, err_abs)
            rows.append(row)
            print(f"K3 transition {S}: {HW}x{HW}x{C} -> {C // 2} ({STREAMS} images): rel err "
                  f"{err:.5f} (bound {TOL_BF16:.5f}); kernel {row['ms']:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}; {row['roofline_share']:.1%} of it), "
                  f"torch.matmul of the pooled tensor {row['matmul_ms']:.4f} ms"
                  + (f", plain {row['plain_ms']:.4f} ms" if S == 224 else ""))
            del x, got, pooled
    DETAIL["K3"] = rows
    DETAIL["K3_pass"] = tot
    for S in SIZES:
        print(f"K3 one trunk pass at {S} (3 transitions, {STREAMS} images): kernel "
              f"{tot[S]['ms']:.4f} ms, bound {tot[S]['bound_ms']:.4f} ms, torch.matmul of "
              f"the pooled tensors {tot[S]['matmul_ms']:.4f} ms")
    t = tot[224]
    return with_bound({"name": "K3 transition", "route": "cuda",
                       "source": "smg_tpu_torch/csrc/transition.cu",
                       "replaces": "smg_tpu/ops/transition_pallas.py:110",
                       "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
                       "library_ms": None, "matmul_ms": t["matmul_ms"],
                       "ms_640": tot[640]["ms"], "bound_ms_640": tot[640]["bound_ms"]},
                      t["flops"], t["bytes"], PEAK_BF16)


def phase_index_limits(dev):
    """K3 and K6 at the largest batch their wrappers accept (the kernels
    index elements with 32-bit ints; the wrappers refuse 2^31 elements):
    K3 at the 224 pass's third transition (14 x 14 x 1024), K6a/K6b at
    block 4's last layer (7 x 7, 1024 channels); the images at both ends
    of the batch against the plain version on those images alone (the
    BatchNorm statistics are per image), and one image more refused."""
    from smg_tpu_torch.ops import dense_layer_train as k6
    from smg_tpu_torch.ops import transition as k3

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf, ends = torch.bfloat16, (slice(0, 1), slice(-2, None))
    H, C = 14, 1024
    n = (2 ** 31 - 1) // (H * H * C)
    x = torch.zeros((n, H, H, C), dtype=bf, device=dev)
    for e in ends:
        x[e] = torch.randn(x[e].shape, generator=gen, device=dev).to(bf)
    a, b = _bn(gen, C, dev)
    wt = (torch.randn((C, C // 2), generator=gen, device=dev) * C ** -0.5).to(bf)
    out = k3.transition(x, a, b, wt)
    errs = [rel_err(out[e], k3.transition_plain(x[e], a, b, wt)) for e in ends]
    check(max(errs) <= TOL_BF16, f"K3 at {n} images: rel err {errs}")
    del x, out
    big = torch.empty((n + 1, H, H, C), dtype=bf, device=dev)
    try:
        k3.transition(big, a, b, wt)
        refused = False
    except ValueError:
        refused = True
    check(refused, f"K3 took {n + 1} images of {H}x{H}x{C}")
    del big
    print(f"K3 at the largest batch it takes, {n} images of {H}x{H}x{C} "
          f"({n * H * H * C} elements): ends' rel err {max(errs):.5f}; {n + 1} refused")
    DETAIL["K3_limit"] = {"images": n, "rel_err": max(errs)}

    H, C0, L = DENSENET_BLOCKS[3]
    c_in, ld = C0 + 32 * (L - 1), C0 + 32 * L
    n = (2 ** 31 - 1) // (H * H * ld)
    buf = torch.zeros((n, H, H, ld), dtype=bf, device=dev)
    for e in ends:
        buf[e] = torch.randn(buf[e].shape, generator=gen, device=dev).to(bf)
    ops = _k6_layer(gen, dev, c_in)
    w1, s1, b1, w2, s2, b2 = ops
    h1, m1, v1, m2, v2 = k6.layer_fwd(buf, c_in, *ops)
    dbuf = torch.zeros((n, H, H, ld), device=dev)
    for e in ends:
        dbuf[e] = torch.randn(dbuf[e].shape, generator=gen, device=dev)
    d_k = dbuf.clone()
    k6.layer_bwd(buf, d_k, c_in, h1, w1, w2, s1, b1, s2, b2, m1, v1, m2, v2)
    errs = []
    for e in ends:
        ref = buf[e].clone()
        ref[..., c_in:] = 0
        rh1, *rm = k6.layer_fwd_plain(ref, c_in, *ops)
        errs += [rel_err(buf[e][..., c_in:], ref[..., c_in:]), rel_err(h1[e], rh1)]
        d_p = dbuf[e].clone()
        k6.layer_bwd_plain(buf[e], d_p, c_in, h1[e], w1, w2, s1, b1, s2, b2,
                           m1[e], v1[e], m2[e], v2[e])
        dx_k, dx_p = d_k[e][..., :c_in] - dbuf[e][..., :c_in], d_p[..., :c_in] - dbuf[e][..., :c_in]
        errs.append(float((dx_k - dx_p).norm() / dx_p.norm().clamp(min=1e-12)))
    check(max(errs[0::3] + errs[1::3]) <= TOL_BF16 and max(errs[2::3]) < TOL_GRAD,
          f"K6 at {n} images: rel errs (out, h1, dx) {errs}")
    del buf, dbuf, d_k, h1
    big = torch.empty((n + 1, H, H, ld), dtype=bf, device=dev)
    try:
        k6.layer_fwd(big, c_in, *ops)
        refused = False
    except ValueError:
        refused = True
    check(refused, f"K6 took {n + 1} images of {H}x{H}x{ld}")
    del big
    torch.cuda.empty_cache()
    print(f"K6 at the largest batch it takes, {n} images of {H}x{H}x{ld}: ends' rel err "
          f"out / h1 {max(errs[0::3] + errs[1::3]):.5f} (bound {TOL_BF16:.5f}), dx rel L2 "
          f"{max(errs[2::3]):.5f} (bound {TOL_GRAD}); {n + 1} refused")
    DETAIL["K6_limit"] = {"images": n, "rel_errs": errs}


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
    k_ms = device_ms(lambda: k4.bn_relu_maxpool(y, a, b))
    p_ms = cuda_ms(lambda: k4.bn_relu_maxpool_plain(y, a, b))
    DETAIL["K4"] = {"rel_err": err, "max_abs_err": err_abs, "ms": k_ms,
                    "plain_ms": p_ms}
    print(f"K4 stem 112x112x64 -> 56x56: rel err {err:.5f} (bound "
          f"{TOL_BF16:.5f}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    n_in, n_out = STREAMS * 112 * 112 * 64, STREAMS * 56 * 56 * 64
    return with_bound({"name": "K4 stem BN/ReLU/maxpool", "route": "cuda",
                       "source": "smg_tpu_torch/csrc/stem_pool.cu",
                       "replaces": "smg_tpu/ops/stem_pool_pallas.py:143",
                       "max_abs_err": err_abs, "ms": k_ms, "plain_ms": p_ms,
                       "library_ms": None},
                      3.0 * n_in + 9.0 * n_out, 2.0 * (n_in + n_out) + 8.0 * 64, PEAK_F32)


def phase_conv2(dev):
    """K5 at all 58 layer shapes of DenseNet-121 at 224 and at 640 with 104
    images (one trunk pass of the `xla_pk` backend at each input size), each
    written at its channel offset of a block buffer as the trunk does; per
    block also the plain variant's own (N, H, W, 32) output and the merge
    wrapper (pend kept). The table's times are the 224 pass's; at 640 the
    kernel alone is timed."""
    from smg_tpu_torch.ops import conv2 as k5

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    bf, N = torch.bfloat16, STREAMS
    worst, tot_ms, tot_plain, rows = 0.0, {}, 0.0, []
    flops = nbytes = 0.0
    for S in SIZES:
        tot_ms[S] = 0.0
        for H, C0, L in densenet_blocks(S):
            buf = torch.zeros((N, H, H, C0 + 32 * L), dtype=bf, device=dev)
            for l in range(L):
                c_in = C0 + 32 * l
                h1 = torch.randn((N, H, H, 128), generator=gen, device=dev).to(bf)
                a, b = _bn(gen, 128, dev)
                w2 = (torch.randn((9, 128, 32), generator=gen, device=dev)
                      * (2 / 1152) ** 0.5).to(bf)
                out = buf[..., c_in:c_in + 32]
                k5.conv2_bn_relu(h1, a, b, w2, out=out)
                want = k5.conv2_bn_relu_plain(h1, a, b, w2)
                err = rel_err(out, want)
                check(err <= TOL_BF16, f"K5 {S} H={H} C_in={c_in}: rel err {err:.5f}")
                err_abs = float((out.float() - want.float()).abs().max())
                row = {"input": S, "H": H, "C_in": c_in, "rel_err": err,
                       "max_abs_err": err_abs,
                       "ms": device_ms(lambda: k5.conv2_bn_relu(h1, a, b, w2, out=out))}
                tot_ms[S] += row["ms"]
                worst = max(worst, err_abs)
                if S == 224:
                    row["plain_ms"] = cuda_ms(lambda: k5.conv2_bn_relu_plain(h1, a, b, w2),
                                              reps=2, warmup=1)
                    tot_plain += row["plain_ms"]
                    P = N * H * H
                    flops += 2.0 * P * 1152 * 32
                    nbytes += 2.0 * P * (128 + 32) + 2.0 * 1152 * 32 + 8.0 * 128
                rows.append(row)
            own = k5.conv2_bn_relu(h1, a, b, w2)
            pend = torch.randn((N, H, H, 128), generator=gen, device=dev).to(bf)
            merged = k5.conv2_bn_relu_merge(h1, pend, a, b, w2, 32)
            errs = (rel_err(own, want), rel_err(merged[..., 32:64], want))
            check(max(errs) <= TOL_BF16, f"K5 {S} H={H} plain / merge variant: {errs}")
            check(torch.equal(merged[..., :32], pend[..., :32])
                  and torch.equal(merged[..., 64:], pend[..., 64:]),
                  f"K5 {S} H={H}: the merge variant changed the kept lanes")
            print(f"K5 conv2 {S}: H={H} C_in {C0}..{C0 + 32 * (L - 1)} ({N} images): "
                  f"worst rel err {max(r['rel_err'] for r in rows if r['H'] == H):.5f}, "
                  f"plain / merge variant {errs[0]:.5f} / {errs[1]:.5f} "
                  f"(bound {TOL_BF16:.5f})")
            del buf, h1, pend, merged, own, want
    DETAIL["K5"] = rows
    DETAIL["K5_pass_ms"] = tot_ms
    print(f"K5 one xla_pk trunk pass (58 layers, {N} images): kernel {tot_ms[224]:.3f} ms "
          f"at 224 (plain {tot_plain:.3f} ms), {tot_ms[640]:.3f} ms at 640")
    return with_bound({"name": "K5 conv2 BN/ReLU/3x3", "route": "cuda",
                       "source": "smg_tpu_torch/csrc/conv2.cu",
                       "replaces": "smg_tpu/ops/conv2_pallas.py:243",
                       "max_abs_err": worst, "ms": tot_ms[224], "plain_ms": tot_plain,
                       "library_ms": None}, flops, nbytes, PEAK_BF16)


def _eval_layers(gen, dev, C0, L):
    """Random operands of L eval dense layers (c_in, a1, b1, w1, a2, b2, w2)."""
    bf, layers = torch.bfloat16, []
    for l in range(L):
        c = C0 + 32 * l
        a1, b1 = _bn(gen, c, dev)
        a2, b2 = _bn(gen, 128, dev)
        w1 = (torch.randn((c, 128), generator=gen, device=dev) * (2 / c) ** 0.5).to(bf)
        w2 = (torch.randn((9, 128, 32), generator=gen, device=dev) * (2 / 1152) ** 0.5).to(bf)
        layers.append((c, a1, b1, w1, a2, b2, w2))
    return layers


def _block_work(N, H, C0, L, epilogue):
    """(flops, bytes) a dense block and its epilogue need: the products, and
    the block input read, the epilogue output written and the weights."""
    P, Cf = N * H * H, C0 + 32 * L
    flops = sum(2.0 * P * (C0 + 32 * l) * 128 + 2.0 * P * 1152 * 32 for l in range(L))
    weights = sum(2.0 * ((C0 + 32 * l) * 128 + 1152 * 32) + 8.0 * (C0 + 32 * l + 128)
                  for l in range(L)) + 8.0 * Cf
    if epilogue == "transition":
        flops += 2.0 * (P / 4) * Cf * (Cf / 2)
        out, weights = (P / 4) * (Cf / 2), weights + 2.0 * Cf * (Cf / 2)
    else:
        out = P * Cf
    return flops, 2.0 * P * C0 + 2.0 * out + weights


# K7's launches by kernel name: its epilogue on a line of its own.
K7_PARTS = (("gemm_bnrelu", "bottleneck GEMM"), ("conv3x3", "3x3"),
            ("transition", "transition epilogue"), ("final_bn", "norm5 epilogue"),
            ("gemm_bf16", "transition epilogue"))   # older commits: the WMMA GEMM


def phase_dense_block(dev):
    """K7 on the four dense blocks of DenseNet-121 at 224 and at 640 with
    104 images (blocks 1-3 with the transition epilogue, block 4 with
    norm5), with taps_packed True (the trunk's) and False: the epilogue
    output and the appended channels against the plain version. The
    table's times are the 224 pass's; at 640 the kernel alone is timed.
    Each timed block's device time is also split by launch name
    (torch.profiler over 2 calls): the bottleneck GEMMs, the 3x3s and the
    epilogue."""
    from smg_tpu_torch.ops import dense_block as k7

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    bf, N = torch.bfloat16, STREAMS
    worst, tot_ms, tot_plain, rows = 0.0, {S: 0.0 for S in SIZES}, 0.0, []
    split = {S: {label: 0.0 for _, label in K7_PARTS + (("", "other"),)} for S in SIZES}
    flops = nbytes = 0.0
    for S in SIZES:
        for i, (H, C0, L) in enumerate(densenet_blocks(S)):
            Cf = C0 + 32 * L
            packed = k7.pack_dense_block(_eval_layers(gen, dev, C0, L))
            at, bt = _bn(gen, Cf, dev)
            if i == 3:
                epilogue, ep = "final_bn", k7.pack_final_bn(at, bt)
            else:
                wt = (torch.randn((Cf, Cf // 2), generator=gen, device=dev)
                      * Cf ** -0.5).to(bf)
                epilogue, ep = "transition", k7.pack_transition(at, bt, wt)
            x = torch.randn((N, H, H, C0), generator=gen, device=dev).to(bf)
            for taps_packed in (True, False):
                buf = torch.zeros((N, H, H, Cf), dtype=bf, device=dev)
                buf[..., :C0] = x
                ref = buf.clone()
                got = k7.dense_block_apply(buf, packed, ep, epilogue,
                                           taps_packed=taps_packed)
                want = k7.dense_block_apply_plain(ref, packed, ep, epilogue, taps_packed)
                errs = (rel_err(got, want), rel_err(buf[..., C0:], ref[..., C0:]))
                check(torch.equal(buf[..., :C0], x), f"K7 {S} H={H}: block input changed")
                check(max(errs) <= TOL_BF16, f"K7 {S} H={H} {epilogue} taps_packed="
                      f"{taps_packed}: rel err (output, appended channels) {errs}")
                err_abs = float((got.float() - want.float()).abs().max())
                worst = max(worst, err_abs)
                row = {"input": S, "images": N, "H": H, "C0": C0, "layers": L,
                       "epilogue": epilogue, "taps_packed": taps_packed,
                       "rel_err": errs[0], "appended_rel_err": errs[1],
                       "max_abs_err": err_abs}
                timed = ""
                if taps_packed:
                    row["ms"] = device_ms(lambda: k7.dense_block_apply(
                        buf, packed, ep, epilogue, out=got), calls=3)
                    tot_ms[S] += row["ms"]
                    row["split_ms"] = _profile_by_kernel(lambda: k7.dense_block_apply(
                        buf, packed, ep, epilogue, out=got), 2)
                    for name, ms in row["split_ms"].items():
                        split[S][next((label for key, label in K7_PARTS if key in name),
                                      "other")] += ms
                    timed = (f"; kernel {row['ms']:.3f} ms (" + ", ".join(
                        f"{k} {v:.4f}" for k, v in row["split_ms"].items()) + ")")
                if taps_packed and S == 224:
                    row["plain_ms"] = cuda_ms(lambda: k7.dense_block_apply_plain(
                        ref, packed, ep, epilogue), reps=1, warmup=1)
                    tot_plain += row["plain_ms"]
                    f, nb = _block_work(N, H, C0, L, epilogue)
                    flops, nbytes = flops + f, nbytes + nb
                    timed += f", plain {row['plain_ms']:.3f} ms"
                rows.append(row)
                print(f"K7 dense block {S}: {H}x{H}, {C0} -> {Cf}, {N} images, {epilogue}, "
                      f"taps_packed {taps_packed}: rel err {errs[0]:.5f}, appended "
                      f"channels {errs[1]:.5f} (bound {TOL_BF16:.5f}){timed}")
                del buf, ref, got, want
    DETAIL["K7"] = rows
    DETAIL["K7_pass_ms"] = tot_ms
    DETAIL["K7_split"] = split
    print(f"K7 one pallas trunk pass (4 blocks, {N} images): kernel {tot_ms[224]:.3f} ms "
          f"at 224 (plain {tot_plain:.3f} ms), {tot_ms[640]:.3f} ms at 640")
    for S in SIZES:
        print(f"K7 split at {S} by launch name (one pass): " + ", ".join(
            f"{label} {ms:.4f} ms" for label, ms in split[S].items() if "epilogue" not in label))
        print(f"K7 epilogue at {S} (one pass): " + ", ".join(
            f"{label} {ms:.4f} ms" for label, ms in split[S].items() if "epilogue" in label))
    return with_bound({"name": "K7 dense block", "route": "cuda",
                       "source": "smg_tpu_torch/csrc/dense_block.cu",
                       "replaces": "smg_tpu/ops/dense_block_pallas.py:456",
                       "max_abs_err": worst, "ms": tot_ms[224], "plain_ms": tot_plain,
                       "library_ms": None, "ms_640": tot_ms[640], "split_ms": split[224],
                       "split_ms_640": split[640]}, flops, nbytes, PEAK_BF16)


def _k6_layer(gen, dev, c_in):
    """Random operands of one train-mode dense layer: kernel-layout bf16
    weights and f32 BatchNorm scale/bias."""
    bf = torch.bfloat16
    w1 = (torch.randn((c_in, 128), generator=gen, device=dev) * (2 / c_in) ** 0.5).to(bf)
    w2 = (torch.randn((9, 128, 32), generator=gen, device=dev) * (2 / 1152) ** 0.5).to(bf)
    s1, b1 = _bn(gen, c_in, dev)
    s2, b2 = _bn(gen, 128, dev)
    return w1, s1, b1, w2, s2, b2


def _conv_layer(dev, c_in, w1, s1, b1, w2, s2, b2):
    """A DenseLayer module holding the same weights, for the 'conv' form."""
    from smg_tpu_torch.models.densenet import DenseLayer

    lay = DenseLayer(c_in).to(dev)
    with torch.no_grad():
        lay.conv1.weight.copy_(w1.float().t().reshape(128, c_in, 1, 1))
        lay.conv2.weight.copy_(w2.float().reshape(3, 3, 128, 32).permute(3, 2, 0, 1))
        for bn, sc, bi in ((lay.norm1, s1, b1), (lay.norm2, s2, b2)):
            bn.weight.copy_(sc)
            bn.bias.copy_(bi)
    return lay


# Block 4 at input 192: 6 x 6 images, under the 43 pixels at which K6's
# 128-pixel tiles spanned at most 4 images.
SMALL_BLOCK = (6, 512, 16)


def phase_dense_layer_train(dev):
    """K6a/K6b against their plain versions at all 58 layer shapes of
    DenseNet-121 at 224 and at 640 with 64 images (one b32 style group),
    and at block 4 of input 192 (6 x 6 images), per-image statistics. The
    table's times are the 224 pass's; at 640 the first and last layer of
    each block are timed (kernels only), the 6 x 6 layers checked only. The
    yardstick: the 'conv' form's autograd forward + backward of the same
    layer (F.conv2d and matmuls; not one library call)."""
    from smg_tpu_torch.models import fast_trunk
    from smg_tpu_torch.ops import dense_layer_train as k6

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    N = TRAIN_IMAGES
    rows = []
    tot = dict(fwd=0.0, fwd_plain=0.0, bwd=0.0, bwd_plain=0.0, conv=0.0)
    worst_fwd = worst_bwd = 0.0
    flops_f = flops_b = bytes_f = bytes_b = 0.0
    shapes = ([(224, b) for b in DENSENET_BLOCKS] + [(640, b) for b in densenet_blocks(640)]
              + [(192, SMALL_BLOCK)])
    for S, (H, C0, L) in shapes:
        C = C0 + 32 * L
        buf = torch.randn((N, H, H, C), generator=gen, device=dev).to(torch.bfloat16)
        dbuf = torch.randn((N, H, H, C), generator=gen, device=dev)
        for l in range(L):
            c_in = C0 + 32 * l
            ops = _k6_layer(gen, dev, c_in)
            w1, s1, b1, w2, s2, b2 = ops
            got = k6.layer_fwd(buf, c_in, *ops)
            out = buf[..., c_in:c_in + 32].clone()
            want = k6.layer_fwd_plain(buf, c_in, *ops)
            ref = buf[..., c_in:c_in + 32]
            err_f = max([rel_err(out, ref)] + [rel_err(g, w) for g, w in zip(got, want)])
            check(err_f <= TOL_BF16, f"K6a {S} H={H} C_in={c_in}: rel err {err_f:.5f}")
            abs_f = float((out.float() - ref.float()).abs().max())
            h1, m1, v1, m2, v2 = want
            bwd_args = (h1, w1, w2, s1, b1, s2, b2, m1, v1, m2, v2)
            d_k, d_p = dbuf.clone(), dbuf.clone()
            g_k = k6.layer_bwd(buf, d_k, c_in, *bwd_args)
            g_p = k6.layer_bwd_plain(buf, d_p, c_in, *bwd_args)
            dx_k = d_k[..., :c_in] - dbuf[..., :c_in]
            dx_p = d_p[..., :c_in] - dbuf[..., :c_in]
            errs = [float((a - b).norm() / b.norm().clamp(min=1e-12))
                    for a, b in zip((dx_k, *g_k), (dx_p, *g_p))]
            check(max(errs) < TOL_GRAD, f"K6b {S} H={H} C_in={c_in}: rel L2 {errs}")
            abs_b = max(float((a - b).abs().max())
                        for a, b in zip((dx_k, *g_k), (dx_p, *g_p)))
            del d_p, g_p
            worst_fwd, worst_bwd = max(worst_fwd, abs_f), max(worst_bwd, abs_b)
            row = {"input": S, "H": H, "C_in": c_in, "fwd_rel_err": err_f,
                   "bwd_rel_l2": max(errs)}
            rows.append(row)
            if S != 224:
                if S == 640 and l in (0, L - 1):
                    row["fwd"] = device_ms(lambda: k6.layer_fwd(buf, c_in, *ops))
                    row["bwd"] = device_ms(lambda: k6.layer_bwd(buf, d_k, c_in, *bwd_args))
                del d_k
                continue
            t = dict(
                fwd=device_ms(lambda: k6.layer_fwd(buf, c_in, *ops)),
                fwd_plain=cuda_ms(lambda: k6.layer_fwd_plain(buf, c_in, *ops),
                                  reps=2, warmup=1),
                bwd=device_ms(lambda: k6.layer_bwd(buf, d_k, c_in, *bwd_args)),
                bwd_plain=cuda_ms(lambda: k6.layer_bwd_plain(buf, d_k, c_in, *bwd_args),
                                  reps=2, warmup=1))
            lay = _conv_layer(dev, c_in, *ops)
            x = buf[..., :c_in].detach().clone().requires_grad_(True)
            dout = dbuf[..., c_in:c_in + 32].to(torch.bfloat16)

            def conv_step():
                fast_trunk._dense_layer_conv(x, lay, []).backward(dout)

            t["conv"] = cuda_ms(conv_step, reps=3, warmup=1)
            del lay, x, d_k
            for k in tot:
                tot[k] += t[k]
            row.update(t)
            P = N * H * H
            gemm = 2.0 * P * c_in * 128 + 2.0 * P * 1152 * 32
            flops_f += gemm
            flops_b += 2 * gemm
            # The bytes the function needs, each input read once and each
            # output written once, in the TPU function's types: bf16
            # activations and weights, f32 moments, BN parameters and their
            # gradients, f32 dw1/dw2. The backward reads the prefix, h1 and a
            # bf16 dout and writes a bf16 dx; K6b's f32 block cotangent (read
            # and written per prefix element) is traffic of its design, not
            # part of the bound.
            weights = 2.0 * (c_in * 128 + 1152 * 32)
            moments, bn = 4.0 * N * (c_in + 128) * 2, 4.0 * (c_in + 128) * 2
            bytes_f += 2.0 * P * (c_in + 32 + 128) + weights + bn + moments
            bytes_b += (2.0 * P * (c_in + 128) + 2.0 * P * 32 + 2.0 * P * c_in
                        + weights + 2 * weights + 2 * bn + moments)
        block = [r for r in rows if (r["input"], r["H"]) == (S, H)]
        timed = "".join(f"; C_in {r['C_in']}: K6a {r['fwd']:.4f} ms, K6b {r['bwd']:.4f} ms"
                        for r in block if S == 640 and "fwd" in r)
        print(f"K6 train dense layers {S}: H={H} C_in {C0}..{C - 32} ({N} images): worst "
              f"fwd rel err {max(r['fwd_rel_err'] for r in block):.5f} "
              f"(bound {TOL_BF16:.5f}), worst bwd rel L2 "
              f"{max(r['bwd_rel_l2'] for r in block):.5f} (bound {TOL_GRAD}){timed}")
        del buf, dbuf
    DETAIL["K6"] = rows
    print(f"K6 one train trunk pass at 224 (58 layers, {N} images): K6a {tot['fwd']:.3f} ms "
          f"(plain {tot['fwd_plain']:.3f}), K6b {tot['bwd']:.3f} ms (plain "
          f"{tot['bwd_plain']:.3f}); 'conv' autograd forward + backward {tot['conv']:.3f} ms")
    split = dense_layer_train_split(dev)
    common = {"route": "cuda", "source": "smg_tpu_torch/csrc/dense_layer_train.cu",
              "library_ms": None, "conv_autograd_fwd_bwd_ms": tot["conv"],
              "library_parts_ms": split["library_ms"]}
    return [
        with_bound({"name": "K6a train dense layer fwd",
                    "replaces": "smg_tpu/ops/dense_layer_train_pallas.py:222",
                    "max_abs_err": worst_fwd, "ms": tot["fwd"], "split_ms": split["fwd_ms"],
                    "plain_ms": tot["fwd_plain"], **common}, flops_f, bytes_f, PEAK_BF16),
        with_bound({"name": "K6b train dense layer bwd",
                    "replaces": "smg_tpu/ops/dense_layer_train_pallas.py:442",
                    "max_abs_err": worst_bwd, "ms": tot["bwd"], "split_ms": split["bwd_ms"],
                    "plain_ms": tot["bwd_plain"], **common}, flops_b, bytes_b, PEAK_BF16),
    ]


def dense_layer_train_split(dev):
    """K6a's and K6b's device time per dense block of one 64-image train
    trunk pass at 224, by launch (kernel) name (torch.profiler over 2
    passes of the block's layers), and the parts' library yardsticks at the
    same 58 shapes, each timed like the kernels (device_ms) and never
    called by the port: torch.matmul for the bottleneck GEMM (x w1), dy1
    (dh1 w1^T) and dw1 (y1^T dh1); torch.nn.grad.conv2d_input and
    conv2d_weight (bf16, channels_last) for dy2 and dw2. None of them
    computes K6's fused functions."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    from smg_tpu_torch.ops import dense_layer_train as k6

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    bf, N, reps, rows = torch.bfloat16, TRAIN_IMAGES, 2, []
    for H, C0, L in DENSENET_BLOCKS:
        C = C0 + 32 * L
        buf = torch.randn((N, H, H, C), generator=gen, device=dev).to(bf)
        dbuf = torch.randn((N, H, H, C), generator=gen, device=dev)
        layers = [_k6_layer(gen, dev, C0 + 32 * l) for l in range(L)]
        saved = []

        def fwd():
            saved.clear()
            for l, ops in enumerate(layers):
                saved.append(k6.layer_fwd(buf, C0 + 32 * l, *ops))

        fwd_parts = _profile_by_kernel(fwd, reps)

        def bwd():
            for l in reversed(range(L)):
                w1, s1, b1, w2, s2, b2 = layers[l]
                h1, m1, v1, m2, v2 = saved[l]
                k6.layer_bwd(buf, dbuf, C0 + 32 * l, h1, w1, w2, s1, b1, s2, b2,
                             m1, v1, m2, v2)

        bwd_parts = _profile_by_kernel(bwd, reps)
        lib = dict(bottleneck_matmul=0.0, dy1_matmul=0.0, dw1_matmul=0.0,
                   dy2_conv2d_input=0.0, dw2_conv2d_weight=0.0)
        dh1 = torch.randn((N * H * H, 128), generator=gen, device=dev).to(bf)
        dy = torch.randn((N, 32, H, H), generator=gen, device=dev).to(bf).to(
            memory_format=torch.channels_last)
        y2 = torch.randn((N, 128, H, H), generator=gen, device=dev).to(bf).to(
            memory_format=torch.channels_last)
        for l, (w1, _, _, w2, _, _) in enumerate(layers):
            c_in = C0 + 32 * l
            x = buf[..., :c_in].reshape(-1, c_in)
            wc = w2.reshape(3, 3, 128, 32).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib["bottleneck_matmul"] += device_ms(lambda: torch.matmul(x, w1))
            lib["dy1_matmul"] += device_ms(lambda: torch.matmul(dh1, w1.t()))
            lib["dw1_matmul"] += device_ms(lambda: torch.matmul(x.t(), dh1))
            lib["dy2_conv2d_input"] += device_ms(
                lambda: conv2d_input(y2.shape, wc, dy, padding=1))
            lib["dw2_conv2d_weight"] += device_ms(
                lambda: conv2d_weight(y2, wc.shape, dy, padding=1))
        row = {"H": H, "layers": L, "fwd_ms": fwd_parts, "bwd_ms": bwd_parts,
               "fwd_total_ms": sum(fwd_parts.values()),
               "bwd_total_ms": sum(bwd_parts.values()), "library_ms": lib}
        rows.append(row)
        print(f"K6 split H={H} ({L} layers, {N} images): K6a "
              f"{row['fwd_total_ms']:.4f} ms " + json.dumps(
                  {k: round(v, 4) for k, v in fwd_parts.items()})
              + f"; K6b {row['bwd_total_ms']:.4f} ms " + json.dumps(
                  {k: round(v, 4) for k, v in bwd_parts.items()})
              + "; yardsticks " + json.dumps({k: round(v, 4) for k, v in lib.items()}))
        del buf, dbuf, layers, saved, dh1, dy, y2
    tot = {"fwd_ms": {}, "bwd_ms": {}, "library_ms": {}}
    for r in rows:
        for part in tot:
            for k, v in r[part].items():
                tot[part][k] = tot[part].get(k, 0.0) + v
    print("K6 split, one pass: K6a " + json.dumps(
        {k: round(v, 4) for k, v in tot["fwd_ms"].items()}) + "; K6b " + json.dumps(
        {k: round(v, 4) for k, v in tot["bwd_ms"].items()}) + "; yardsticks "
          + json.dumps({k: round(v, 4) for k, v in tot["library_ms"].items()}))
    DETAIL["K6_split"] = {"blocks": rows, "pass": tot}
    return tot


def phase_dense_block_train(dev):
    """K6 composed over each whole dense block of DenseNet-121 at 224, and
    block 4 at input 192 (6 x 6 images), 64
    images: the autograd Function the update runs (K6a layer by layer, then
    K6b in reverse, the prefix cotangent summed in an f32 block buffer)
    against the same walk through K6b's plain version from the same forward
    (K6a is deterministic: the two forwards give the same bits). Every
    gradient, the block input's and each layer's six, to relative L2
    TOL_GRAD."""
    from smg_tpu_torch.ops import dense_layer_train as k6

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf, N = torch.bfloat16, TRAIN_IMAGES
    rows = []
    for H, C0, L in DENSENET_BLOCKS + (SMALL_BLOCK,):
        x0 = torch.randn((N, H, H, C0), generator=gen, device=dev).to(bf).requires_grad_(True)
        layers = [[t.float().requires_grad_(True) for t in _k6_layer(gen, dev, C0 + 32 * l)]
                  for l in range(L)]
        # _k6_layer's order is (w1, s1, b1, w2, s2, b2), dense_block_train's too.
        buf, _ = k6.dense_block_train(x0, layers)
        dout = torch.randn(buf.shape, generator=gen, device=dev).to(bf)
        buf.backward(dout)
        with torch.no_grad():
            ref = torch.empty_like(buf)
            ref[..., :C0] = x0
            saved = [k6.layer_fwd(ref, C0 + 32 * l, w1.to(bf), s1, b1, w2.to(bf), s2, b2)
                     for l, (w1, s1, b1, w2, s2, b2) in enumerate(layers)]
            check(torch.equal(ref, buf), f"K6a block H={H}: forwards differ")
            dbuf = dout.float()
            errs = []
            for l in reversed(range(L)):
                w1, s1, b1, w2, s2, b2 = layers[l]
                dw1, dw2, ds1, db1, ds2, db2 = k6.layer_bwd_plain(
                    ref, dbuf, C0 + 32 * l, saved[l][0], w1.to(bf), w2.to(bf),
                    s1, b1, s2, b2, *saved[l][1:])
                errs += [_rel_l2(p.grad, g) for p, g in zip(
                    (w1, s1, b1, w2, s2, b2), (dw1, ds1, db1, dw2, ds2, db2))]
            errs.append(_rel_l2(x0.grad, dbuf[..., :C0].to(bf)))
        worst = max(errs)
        rows.append({"H": H, "C0": C0, "layers": L, "worst_rel_l2": worst,
                     "input_grad_rel_l2": errs[-1]})
        print(f"K6 whole dense block H={H} ({L} layers, {N} images): worst gradient "
              f"rel L2 {worst:.5f}, block input {errs[-1]:.5f} (bound {TOL_GRAD})")
        check(all(math.isfinite(e) for e in errs) and worst < TOL_GRAD,
              f"K6 block H={H}: gradients differ from the plain walk: {worst}")
        del x0, layers, buf, dout, ref, saved, dbuf
    DETAIL["K6_blocks"] = rows


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def launch_counters():
    """kernel name -> (module, counter attribute) of every wrapper."""
    from smg_tpu_torch.ops import (contact, conv2, dense_block, dense_layer,
                                   dense_layer_train, stem_pool, transition)

    return {"K1 contact sweep": (contact, "launches"),
            "K2 dense layer": (dense_layer, "launches"),
            "K3 transition": (transition, "launches"),
            "K4 stem BN/ReLU/maxpool": (stem_pool, "launches"),
            "K5 conv2 BN/ReLU/3x3": (conv2, "launches"),
            "K6a train dense layer fwd": (dense_layer_train, "fwd_launches"),
            "K6b train dense layer bwd": (dense_layer_train, "bwd_launches"),
            "K7 dense block": (dense_block, "launches")}

# The kernels each main path must launch (the act path's, the training
# path's and the decision-parity path's).
ACT_KERNELS = ("K1", "K2", "K3", "K4")
TRAIN_KERNELS = ("K1", "K2", "K3", "K4", "K6a", "K6b")
PARITY_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K7")


def zero_counts():
    for mod, attr in launch_counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in launch_counters().items()}


def step_timer(phases, last):
    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        phases[name] = now - last[0]
        last[0] = now
    return mark


def drive_act_path(dev, kernels):
    from smg_tpu_torch.train import loop
    from smg_tpu_torch.train.prod_config import make_prod_loop_cfg, make_prod_trainer

    trainer = make_prod_trainer(B_MAIN, device=dev)
    cfg = make_prod_loop_cfg(B_MAIN, is_testing=True)
    check(cfg.env.is_testing and cfg.batch_size == B_MAIN, "config")

    zero_counts()
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
        t0 = last[0]
        state, m = loop.train_step(trainer, cfg, state, timer=step_timer(phases, last))
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
    counts = read_counts()
    act_kernels = [k for k in kernels if k["name"].split()[0] in ACT_KERNELS]
    for k in act_kernels:
        k["launches"] = counts[k["name"]]
    print("launches in the act path: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in counts.items()))
    for k in act_kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched by the act path")
    DETAIL["act_path"] = {"launches": counts, "init_s": init_s, "steps": steps,
                           "success_rate": statistics.mean(successes),
                           "steps_per_act": cfg.primitive.steps_per_act,
                           "reset_settle_steps": cfg.reset_settle_steps}
    print(f"success rate over {ACT_STEPS} steps x {B_MAIN} scenes: "
          f"{statistics.mean(successes):.4f}")
    reference_score(trainer, first_obs)
    return trainer, cfg, state, [s["seconds"] for s in steps]


def _finite(t) -> bool:
    return bool(torch.isfinite(t).all())


def drive_train_path(dev, kernels):
    """The training main path: 3 b32 training steps with the update's dense
    layers through K6, then 'conv' against 'pk' on one update."""
    from smg_tpu_torch.train import loop
    from smg_tpu_torch.train.prod_config import make_prod_loop_cfg, make_prod_trainer

    trainer = make_prod_trainer(B_MAIN, device=dev, fast_train_conv2="pk")
    cfg = make_prod_loop_cfg(B_MAIN, is_testing=False)
    check(not cfg.env.is_testing and trainer.cfg.fast_train_conv2 == "pk", "config")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.init_loop(SEED + 1, trainer, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = []
    for i in range(TRAIN_STEPS):
        phases = {}
        last = [time.perf_counter()]
        t0 = last[0]
        state, m = loop.train_step(trainer, cfg, state, timer=step_timer(phases, last))
        total = time.perf_counter() - t0
        loss = float(m.loss)
        if i == 0:
            check(loss == 0.0, f"train step 0: loss {loss} on the blank prev, want 0")
        else:
            check(math.isfinite(loss) and loss > 0, f"train step {i}: loss {loss}")
        for name, t in (("label_value", m.label_value), ("reward", m.reward),
                        ("predicted_value", m.predicted_value),
                        ("pos", state.scenes.objects.pos),
                        ("quat", state.scenes.objects.quat)):
            check(_finite(t), f"train step {i}: non-finite {name}")
        check(all(_finite(t) for t in trainer.model.state_dict().values()),
              f"train step {i}: non-finite weights or running stats")
        with torch.no_grad():
            drift = max(float((p - q).abs().max()) for p, q in
                        zip(trainer.model.parameters(), trainer.target.parameters()))
        if i >= 1:
            check(drift > 0, f"train step {i}: online weights equal the target's")
        check(state.trainer.iteration == i + 1, "iteration count")
        steps.append({"step": i, "seconds": total, "loss": loss,
                      "phases": {k: round(v, 6) for k, v in phases.items()},
                      "online_target_max_diff": drift,
                      "explored": int(m.explored.sum()),
                      "actions": m.action.tolist()})
        print(f"train step {i}: {total:.3f} s  " + "  ".join(
            f"{k} {v:.3f}" for k, v in phases.items()) + f"  loss {loss:.5f}")
    torch.cuda.synchronize()
    counts = read_counts()
    print("launches in the training path: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in counts.items()))
    for k in kernels:
        k["launches_train"] = counts[k["name"]]
        if k["name"].startswith("K6"):
            k["launches"] = counts[k["name"]]
        if k["name"].split()[0] in TRAIN_KERNELS:
            check(counts[k["name"]] > 0,
                  f"{k['name']} was not launched by the training path")
    DETAIL["train_path"] = {"launches": counts, "init_s": init_s, "steps": steps}
    DETAIL["update_modes"] = compare_update_modes(trainer, state)


def _part_grads(model) -> dict:
    """Each network part's gradient (trunks and heads) as one f32 vector."""
    return {name: torch.cat([p.grad.float().ravel() for p in part.parameters()])
            for name, part in model.named_children()}


def _rel_l2(got, want) -> float:
    return float((got.float().cpu() - want.float().cpu()).norm() / want.float().norm())


def _update_grads(trainer, snap, exp, labels, iteration, mode):
    """(loss, per-part gradients) of one update from the weights in snap."""
    from smg_tpu_torch.train.trainer import TrainerState

    trainer.cfg = dataclasses.replace(trainer.cfg, fast_train_conv2=mode)
    trainer.model.load_state_dict(snap)
    _, loss = trainer.update(TrainerState(iteration), exp, labels)
    return float(loss), _part_grads(trainer.model)


def compare_update_modes(trainer, state):
    """The update's gradients through K6 at full depth, and its time.

    1. One b32 update with 'conv' (autograd of the conv form) against 'pk'
       (K6) on the same experience and weights, in turns pk, conv, conv, pk:
       both times; the losses agree to 5% (bf16 compute, PARITY dev 12), and
       two 'pk' runs give the same loss.
    2. On the first UPDATE_SCENES scenes, the bf16 'pk' and 'conv'
       gradients against the float32 'conv' update on the card: 'pk' is no
       farther from it than TRUTH_RATIO times 'conv' is, per network part.
       A part with no gradient in one run has none in the others. Reported:
       the 'pk' update on the card against the same update on the CPU (K6's
       plain versions, the same bf16 rounding points).
    """
    from smg_tpu_torch.train.trainer import Trainer, TrainerState

    exp = state.prev.exp
    check(bool(exp.valid.any()), "no valid experience to compare the update on")
    labels = trainer.current_reward(state.prev.choice, state.prev.outcome)
    model_snap = copy.deepcopy(trainer.model.state_dict())
    opt_snap = copy.deepcopy(trainer.opt.state_dict())
    cfg0, it = trainer.cfg, state.trainer.iteration
    res = {"pk": [], "conv": []}
    for mode in ("pk", "conv", "conv", "pk"):
        trainer.cfg = dataclasses.replace(cfg0, fast_train_conv2=mode)
        trainer.model.load_state_dict(model_snap)
        trainer.opt.load_state_dict(opt_snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = trainer.update(TrainerState(it), exp, labels)
        torch.cuda.synchronize()
        res[mode].append((time.perf_counter() - t0, float(loss)))
    loss_pk, loss_conv = res["pk"][0][1], res["conv"][0][1]
    diff = abs(loss_pk - loss_conv) / max(abs(loss_conv), 1e-6)
    print(f"update at b32 ({int(exp.valid.sum())} valid scenes, styles "
          f"{torch.bincount(exp.style[exp.valid].long(), minlength=3).tolist()}): "
          f"'pk' (K6) {', '.join(f'{t:.3f}' for t, _ in res['pk'])} s, 'conv' autograd "
          f"{', '.join(f'{t:.3f}' for t, _ in res['conv'])} s; loss {loss_pk:.6f} vs "
          f"{loss_conv:.6f} (rel diff {diff:.4f}, bound 0.05)")
    check(all(math.isfinite(l) for v in res.values() for _, l in v), "non-finite loss")
    check(res["pk"][0][1] == res["pk"][1][1], "K6 update loss differs between repeats")
    check(diff <= 0.05, f"'pk' and 'conv' losses differ by {diff:.4f}")

    sub = exp.map(lambda t: t[:UPDATE_SCENES])
    sub_labels = labels[:UPDATE_SCENES]
    check(bool(sub.valid.any()), f"no valid scene among the first {UPDATE_SCENES}")
    runs = {"pk": _update_grads(trainer, model_snap, sub, sub_labels, it, "pk"),
            "conv": _update_grads(trainer, model_snap, sub, sub_labels, it, "conv")}
    trainer.cfg = cfg0
    trainer.model.load_state_dict(model_snap)
    trainer.opt.load_state_dict(opt_snap)
    cpu = Trainer(cfg0, device="cpu")
    t0 = time.perf_counter()
    runs["pk plain"] = _update_grads(cpu, model_snap, sub.map(lambda t: t.cpu()),
                                     sub_labels.cpu(), it, "pk")
    cpu_s = time.perf_counter() - t0
    del cpu
    f32 = Trainer(dataclasses.replace(cfg0, model=dataclasses.replace(
        cfg0.model, dtype="float32")), device=trainer.device)
    runs["f32 conv"] = _update_grads(f32, model_snap, sub, sub_labels, it, "conv")
    del f32
    truth = runs["f32 conv"][1]
    live = [k for k, g in truth.items() if float(g.norm()) > 0]
    for name, (loss, g) in runs.items():
        check(math.isfinite(loss), f"{name} update: loss {loss}")
        for k in truth:
            if k not in live:
                check(float(g[k].norm()) == 0.0, f"{name} update: a gradient in {k}")
    check(len(live) >= 2, f"update gradients in {live} only")
    kp = {k: _rel_l2(runs["pk"][1][k], runs["pk plain"][1][k]) for k in live}
    to_f32 = {m: {k: _rel_l2(runs[m][1][k], truth[k]) for k in live} for m in ("pk", "conv")}
    pk_conv = {k: _rel_l2(runs["pk"][1][k], runs["conv"][1][k]) for k in live}
    fmt = lambda d: ", ".join(f"{k} {v:.4f}" for k, v in d.items())  # noqa: E731
    print(f"update gradients on {UPDATE_SCENES} scenes (styles "
          f"{torch.bincount(sub.style[sub.valid].long(), minlength=3).tolist()}), "
          f"relative L2 per part: K6 on the card vs the plain versions on the CPU "
          f"({cpu_s:.1f} s) (reported): {fmt(kp)}; bf16 'pk' vs f32: "
          f"{fmt(to_f32['pk'])}; bf16 'conv' vs f32: {fmt(to_f32['conv'])} (bound: 'pk' "
          f"<= {TRUTH_RATIO} x 'conv'); 'pk' vs 'conv': {fmt(pk_conv)}")
    check(all(to_f32["pk"][k] <= TRUTH_RATIO * to_f32["conv"][k] for k in live),
          f"'pk' gradients farther from float32 than 'conv': {to_f32}")
    return {"pk_s": [t for t, _ in res["pk"]], "conv_s": [t for t, _ in res["conv"]],
            "loss_pk": loss_pk, "loss_conv": loss_conv, "rel_diff": diff,
            "subset_scenes": UPDATE_SCENES, "kernel_vs_plain_rel_l2": kp,
            "to_f32_rel_l2": to_f32, "pk_vs_conv_rel_l2": pk_conv,
            "subset_losses": {k: v[0] for k, v in runs.items()}, "cpu_plain_s": cpu_s}


def drive_decision_parity(dev, kernels):
    """The eval backends' main path: the decision-parity entry point's
    check (smg_tpu_torch/cli/decision_parity.py) for every backend and
    style at input 224 and 640, on DP_SCENES rendered scenes (one trunk call
    of 8 x (1 + 12) = 104 images per score), from rendering to the rule,
    with the counts set to 0 just before and read just after. Returns
    {input size: (model, the 104 trunk inputs)} for phase_trunk_passes."""
    from smg_tpu_torch.cli import decision_parity as dp

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masked, obj_depth, valid = dp.render(DP_SCENES, dev)
    check(DP_SCENES * (1 + obj_depth.shape[1]) == STREAMS,
          f"{obj_depth.shape[1]} object slots: not {STREAMS} images per trunk call")
    runs, detail, failed = {}, {}, []
    for S in SIZES:
        model, oracle = dp.make_models(S, SEED, dev)
        scene_imgs, mask_imgs = dp.prepare(masked, obj_depth, S)
        res = dp.evaluate(model, oracle, scene_imgs, mask_imgs, valid)
        for (backend, style), r in res.items():
            rule = (f"{dp.WITNESS_FACTOR} x the bf16 module forward's "
                    f"{r['witness_err_over_spread']:.3f}, at least the rule's {dp.TOL_FRAC}; "
                    f"strict rule {'holds' if r['strict_ok'] else 'fails'}"
                    if r["witness_bound"] else
                    f"the rule's; the bf16 module forward reads "
                    f"{r['witness_err_over_spread']:.3f}")
            print(f"decision parity {S} {backend} style {style}: per-object err "
                  f"{r['per_object_err']:.4f} = {r['err_over_spread']:.3f} x the spread "
                  f"{r['max_spread']:.4f} (bound {r['tol_frac']:.3f}: {rule}); largest "
                  f"|value| {r['oracle_max_abs']:.4f}; decided {r['decided']}/{r['scenes']} "
                  f"({r['decided_multi']} with 2+ objects: argmax "
                  f"{'tested' if r['argmax_tested'] else 'not tested, informational'}), "
                  f"argmax agree {r['argmax_agree']}/{r['scenes']}, flips on decided "
                  f"{r['flips_on_decided']}: {'ok' if r['ok'] else 'FAILED'}")
            if not r["ok"]:
                failed.append((S, backend, style))
        rate = (sum(r["argmax_agree"] for r in res.values())
                / sum(r["scenes"] for r in res.values()))
        print(f"decision parity {S}: argmax agreement rate {rate:.4f} over "
              f"{len(res)} backend x style runs")
        detail[S] = {"argmax_agreement_rate": rate,
                     "runs": {f"{b}/{s}": r for (b, s), r in res.items()}}
        runs[S] = (model, oracle, torch.cat([scene_imgs, mask_imgs.flatten(0, 1)]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    print(f"decision-parity path ({seconds:.1f} s), launches: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in counts.items()))
    for k in kernels:
        k["launches_parity"] = counts[k["name"]]
        if k["name"].split()[0] in ("K5", "K7"):
            k["launches"] = counts[k["name"]]
        if k["name"].split()[0] in PARITY_KERNELS:
            check(counts[k["name"]] > 0,
                  f"{k['name']} was not launched by the decision-parity path")
    DETAIL["decision_parity"] = {"launches": counts, "seconds": seconds, **detail}
    return runs, failed


def phase_trunk_passes(runs):
    """One 104-image trunk_features_eval per backend at 224 and 640 (the
    decision-parity model's grasp trunk on its inputs): CUDA-event ms, and
    the features against the module eval forward's in float32 (the
    oracle's) within 5% of its largest |value|, as
    tests/test_fast_trunk.py:150-168 holds the JAX backends; relative L2
    reported, and the bf16 module forward's own gap beside them."""
    from smg_tpu_torch.models import fast_trunk

    rows, failed = [], []
    for S, (model, oracle, x) in runs.items():
        trunk = model.grasp_trunk
        with torch.no_grad():
            ref = oracle.grasp_trunk(x).float()
            o_ms = cuda_ms(lambda: trunk(x), reps=3, warmup=1)
            own = trunk(x).float()
        check(float(ref.std(dim=(0, 1, 2)).max()) > 1e-2, f"{S}: degenerate oracle")
        own_err = float((own - ref).abs().max() / ref.abs().max())
        own_l2 = float((own - ref).norm() / ref.norm())
        print(f"trunk pass {S}: the bf16 module forward ({o_ms:.3f} ms) vs the float32 "
              f"oracle: max err {own_err:.4f} of the largest, rel L2 {own_l2:.4f}")
        rows.append({"input": S, "backend": "module forward bf16", "ms": o_ms,
                     "max_rel_err": own_err, "rel_l2": own_l2})
        for backend in fast_trunk.BACKENDS:
            with torch.no_grad():
                got = fast_trunk.trunk_features_eval(trunk, x, backend).float()
                ms = cuda_ms(lambda: fast_trunk.trunk_features_eval(trunk, x, backend),
                             reps=5, warmup=1)
            check(got.shape == ref.shape and _finite(got), f"{S} {backend}: features")
            err = float((got - ref).abs().max() / ref.abs().max())
            l2 = float((got - ref).norm() / ref.norm())
            rows.append({"input": S, "backend": backend, "images": x.shape[0], "ms": ms,
                         "max_rel_err": err, "rel_l2": l2})
            print(f"trunk pass {S} {backend} ({x.shape[0]} images): {ms:.3f} ms; vs the "
                  f"float32 oracle: max err {err:.4f} of the largest (bound 0.05), "
                  f"rel L2 {l2:.4f}")
            if not err < 0.05:
                failed.append((S, backend, err))
    DETAIL["trunk_passes"] = rows
    check(not failed, f"trunk features off the oracle: {failed}")


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

    kernels = [phase_contact(dev), phase_dense_layer(dev), phase_transition(dev),
               phase_stem(dev), phase_conv2(dev), *phase_dense_layer_train(dev),
               phase_dense_block(dev)]
    phase_dense_block_train(dev)
    phase_index_limits(dev)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    trainer, cfg, state, step_seconds = drive_act_path(dev, kernels)
    if args.profile:
        profile_act_step(trainer, cfg, state, step_seconds, args.out)
    del trainer, state
    drive_train_path(dev, kernels)
    runs, parity_failed = drive_decision_parity(dev, kernels)
    phase_trunk_passes(runs)
    check(not parity_failed,
          f"decision parity failed for (input, backend, style) {parity_failed}")

    DETAIL["card"] = card
    DETAIL["kernels"] = kernels
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(DETAIL, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_b1024",
            "bound_ms_b1024")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys if k in kern}
                                  for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
