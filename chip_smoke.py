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
   at 640 with 104 images (its time per block, beside F.conv2d of its 3x3
   part at 224), K6a/K6b (the train-mode dense layer, forward and
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
   is_testing=True, init_loop with the seeded init, then act steps,
   with per-phase times, the success rate and each kernel's launch count;
   plus one scene's trunk features against the plain bf16 path on the CPU.
5. The per-scene executor, from the act path's trainer and last state: an
   act step with executor="vmap" and one with "batched" (times, every
   scene's success, their agreement reported); one physics step's contact
   force and torque of the two formulations from the same state, within
   1e-5 of the largest; eager physics-step times; K1-K4's launches (K1
   none in the vmap step).
6. The training path: make_prod_trainer(32, fast_train_conv2="pk") +
   make_prod_loop_cfg(32, is_testing=False), init_loop, 2 training steps
   (the second with delayed labels; labels, update through K6, Adam) with
   per-phase times, the loss and state checks and each kernel's launch
   count; then one update with 'conv' (autograd) against 'pk' on the same
   experience and weights (times, losses), and on the same batch the
   update's gradients through K6 against K6's plain versions on the CPU
   and against a float32 update.
7. The eval backends' path: the decision-parity entry point
   (smg_tpu_torch/cli/decision_parity.py) on 8 rendered scenes (104 images
   per trunk call) for the backends xla_fl, xla_pk and pallas x 3 styles at
   input 224 and 640, each score held to the module eval forward in float32
   (the oracle) by the decided-argmax rule (at 640 its tolerance witnessed
   by the bf16 module forward, see the entry point), and at 224 style 0
   once more under a trained snapshot's stem statistic (norm0 and block
   1's norm1 at its running variances: every backend under the strict rule
   and within 2 x the bf16 module forward's ratio), with each kernel's
   launch count; then one
   104-image
   trunk pass per backend and size, timed, its features within 5% of the
   oracle's largest |value|.
8. The rotations path: the production trainer with num_rotations 16 and
   the ETS head untied, ETS on (8 scenes a chunk x (16 rotated scene
   images + 12 masks) a grasp or suction trunk call). On the initial
   observation: the scores (32, 12, 16), rotation 0 against an R = 1
   trainer with the same weights (within 1e-3 of the spread; bitwise or
   not reported), two scenes' scores at every rotation and their ETS pairs
   (through gs_head) within 5% of the bf16 module forward's largest value,
   and the score phase at R = 16 and R = 1 (events, device time, trunk
   images per scene). Then one act step and 2 training steps: best_pix's
   rotation columns in [0, 16), finite losses, gs_head's parameters and
   statistics moved by a step whose batch executed ETS (at least one
   must), and K4 / K3 / K2 launched 1 / 3 / 58 times per eval trunk call.
9. In-process timings of the next paths: the SlotSegmenter's forward (b32)
   and training step (b16) and the batched NMS; one trunk-pretraining
   step at b16 (its batch and its step); CUDA events and device time.
10. Four paths side by side, one thread each, their entry points in
   subprocesses with their real argv and the launch counts set to 0 in
   each (so their step times are not one run's alone):
   - the CLI: `python -m smg_tpu_torch.cli.main` trains 2 iterations at
     b32 with the held flags (--method reinforcement --is_ets --is_pe
     --is_oo) and scene-0 imagery every iteration, then the run tree is
     checked (config.json, the ten transitions logs with B rows per step
     where the layout has them, their .bin mirrors read back equal when
     the native library loaded, one checkpoint, the snapshot, the imagery
     with a 480 x 640 RGB-D frame); then side by side it resumes with
     --continue_logging for 1 iteration (numbered 3, a second checkpoint)
     and tests 1 iteration with --is_testing --load_snapshot; K1-K4's
     launches summed over the three runs;
   - perception: .obj meshes written here, fitted (native, their shape
     types checked); side by side cli.main one iteration at b32 on that
     --obj_mesh_dir, cli.train_segmenter 40 steps at b16 on cluttered
     scenes (the loss falls), cli.main --trunk tiny and cli.smoke (tiny
     trunk); then side by side cli.eval_segmenter on 8 held-out scenes
     (base and --perspective arms) and cli.main with --segmentation
     learned on that checkpoint (a scene acts on a valid learned mask);
     K1-K4's launches summed over them;
   - trunk pretraining: `cli.pretrain_trunks` 20 steps at b16 (the mean of
     the last 5 losses under the first 5's); then side by side the
     checkpoint loaded into a trainer's six trunks, equal, with the
     update's modes compared at those warm weights after two training
     steps, and `cli.main` with the held flags and --pretrained_trunks for
     2 iterations (target trunks equal the checkpoint's, online trunks
     within one Adam step of it); K1-K4's launches;
   - the sharded step: in a subprocess with WORLD_SIZE 1 over NCCL, 2 b32
     training steps under fast_train_conv2="pk" through make_sharded_step,
     then the plain train_step from the same seed: the losses bit-equal;
     K1-K4 and K6's launches.
11. Prints the wall seconds of every phase as one JSON line
   ({"phase_seconds": {...}}, the build, each phase and its parts as
   "phase/part", the four side-by-side paths' own and their group's, and
   "total" since the script started), the kernel table as one JSON line
   (each kernel's launches also per path: act, train, parity, cli,
   perception, pretrain, vmap, sharded, rotations), the card line, and
   last {"ok": true, "device": {...}}. Any failed check raises (exit code
   != 0).

Options: `--out DIR` writes the details (chip_smoke.json, and with
--profile the profiler table) to DIR; `--profile` adds one act step under
torch.profiler and a physics-step timing; `--update_snapshot PATH` only
builds the kernels and compares the update's modes at a trained run's
snapshot (update_modes_on_snapshot). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

T_START = time.perf_counter()   # the phase table's total counts from here, torch's import too

import torch  # noqa: E402

SEED = 0
B_MAIN = 32
ACT_STEPS = 2
TRAIN_STEPS = 2       # the first on the blank previous step, the second with labels
STREAMS = 8 * 13      # one trunk pass: scene_chunk 8 scenes x (1 + 12 masks)
TRAIN_IMAGES = 64     # one style group of the b32 update: 32 scenes x 2 streams
TOL_BF16 = 2.0 ** -6  # of the largest |value|: a few bf16 steps
# Gradients: bf16 operands with f32 sums in another order than the plain
# version's, through two BatchNorm backwards: relative L2.
TOL_GRAD = 1e-2
# The update's gradients at full depth on the whole b32 batch, relative L2
# per network part. A head's gradient comes from its style's scenes alone,
# and on a few scenes two bf16 roundings of it part like noise: on 8 scenes
# of a warm batch grasp_head's 'pk' stood 2.4 x 'conv' from float32 (one
# style-0 scene), on 4 style-1 scenes suction_head's 2.4 x, where K6 on
# the card stood as far from its own plain version. At random weights the bf16 update's trunk
# gradients are fixed only to about half their norm: any change of
# rounding (K6 on the card against its plain versions on the CPU, at the
# same rounding points, read 0.48-0.53) flips bf16 ReLUs and near-constant
# channels of the masked streams' per-image BatchNorm amplify it. So the
# check is against the float32 'conv' update on the card: bf16 'pk' may be
# no farther from it than TRUTH_RATIO times bf16 'conv' is (read: 0.98-1.07
# times). K6 composed over whole blocks is held tightly by
# phase_dense_block_train, from one forward.
TRUTH_RATIO = 1.5
DP_SCENES = 8         # the decision-parity path: 8 x (1 + 12) = STREAMS images
# The decision-parity path's case under a trained snapshot's stem statistic:
# (input size, style), and its bound over the bf16 module forward's ratio:
# decision parity's witness factor. The ratio of two bf16 computations'
# largest per-object errors spreads past 1.25 where every rule holds: the
# backends read 0.96-1.43x the module forward under this statistic, and
# 0.97-1.36x on a trained snapshot (cold seed 0; NVIDIA H100 80GB HBM3, 700 W).
SNAPSHOT_CASE = (224, 0)
SNAPSHOT_FACTOR = 2.0
SIZES = (224, 640)    # the trunk's input sizes (ModelConfig.input_size)
LOOP_LAUNCHES = 200   # K1's timing loop: back-to-back launches per reading
DETAIL = {}
SECONDS = {}          # wall seconds by phase, and by "phase/part" within one
_SECONDS_LOCK = threading.Lock()
_PHASE = threading.local()   # .name: the phase this thread runs

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


def _phase_name() -> str:
    return getattr(_PHASE, "name", "")


@contextlib.contextmanager
def wall_clock(part: str):
    """Adds the block's wall seconds to SECONDS["<phase>/<part>"], under the
    phase this thread runs (`part` alone outside one)."""
    key = f"{_phase_name()}/{part}" if _phase_name() else part
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _SECONDS_LOCK:
            SECONDS[key] = SECONDS.get(key, 0.0) + dt


def side_by_side(calls: dict) -> dict:
    """Runs each function of `calls` (name -> function of no arguments) in a
    thread of its own under this thread's phase; {name: result} once all
    have ended, the first failure (in `calls`' order) raised then."""
    import concurrent.futures as cf

    phase = _phase_name()

    def run(fn):
        _PHASE.name = phase
        return fn()

    with cf.ThreadPoolExecutor(len(calls)) as pool:
        futures = {name: pool.submit(run, fn) for name, fn in calls.items()}
    return {name: f.result() for name, f in futures.items()}


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
    with wall_clock("split"):
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
    kernel alone is timed. At 224 each layer's 3x3 part alone is also timed
    as F.conv2d in bf16 channels_last on the same h2 (its yardstick: it
    computes neither the BN2 prologue nor the rounded taps)."""
    import torch.nn.functional as F

    from smg_tpu_torch.ops import conv2 as k5

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    bf, N = torch.bfloat16, STREAMS
    worst, tot_ms, tot_plain, rows = 0.0, {}, 0.0, []
    flops = nbytes = conv_ms = 0.0
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
                    h2c = torch.relu(h1.float() * a + b).to(bf).permute(0, 3, 1, 2)
                    wc = w2.reshape(3, 3, 128, 32).permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)
                    row["conv2d_ms"] = device_ms(lambda: F.conv2d(h2c, wc, padding=1))
                    conv_ms += row["conv2d_ms"]
                    del h2c
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
    split = {S: {H: sum(r["ms"] for r in rows if r["input"] == S and r["H"] == H)
                 for H, _, _ in densenet_blocks(S)} for S in SIZES}
    DETAIL["K5"] = rows
    DETAIL["K5_pass_ms"] = tot_ms
    DETAIL["K5_split"] = split
    print(f"K5 one xla_pk trunk pass (58 layers, {N} images): kernel {tot_ms[224]:.3f} ms "
          f"at 224 (plain {tot_plain:.3f} ms; its 3x3 part as F.conv2d {conv_ms:.3f} ms), "
          f"{tot_ms[640]:.3f} ms at 640")
    for S in SIZES:
        print(f"K5 split at {S} by block (one pass): " + ", ".join(
            f"H={H} {ms:.4f} ms" for H, ms in split[S].items()))
    return with_bound({"name": "K5 conv2 BN/ReLU/3x3", "route": "cuda",
                       "source": "smg_tpu_torch/csrc/conv2.cu",
                       "replaces": "smg_tpu/ops/conv2_pallas.py:243",
                       "max_abs_err": worst, "ms": tot_ms[224], "plain_ms": tot_plain,
                       "library_ms": None, "ms_640": tot_ms[640], "conv2d_ms": conv_ms,
                       "split_ms": split[224], "split_ms_640": split[640]},
                      flops, nbytes, PEAK_BF16)


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


# K7's launches by kernel name: its epilogue on a line of its own. A layer
# is one launch, the fused GEMM + h2 + 3x3; the two-launch names are those
# of older commits (compare_parent.py runs them).
K7_PARTS = (("dense_layer_sm90", "fused layer"),
            ("gemm_bnrelu", "bottleneck GEMM"), ("conv3x3", "3x3"),
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
    with wall_clock("split"):
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
# path's, the decision-parity path's and the CLI's).
ACT_KERNELS = ("K1", "K2", "K3", "K4")
TRAIN_KERNELS = ("K1", "K2", "K3", "K4", "K6a", "K6b")
PARITY_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K7")
CLI_KERNELS = ("K1", "K2", "K3", "K4")


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
    for k in kernels:
        k["launches_act"] = counts[k["name"]]
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
    with wall_clock("reference_score"):
        reference_score(trainer, first_obs)
    return trainer, cfg, state, [s["seconds"] for s in steps]


def _finite(t) -> bool:
    return bool(torch.isfinite(t).all())


def drive_train_path(dev, kernels):
    """The training main path: TRAIN_STEPS b32 training steps with the
    update's dense layers through K6, then 'conv' against 'pk' on one
    update."""
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
    with wall_clock("compare_update_modes"):
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


def compare_update_modes(trainer, state, weights: str = "", cpu_plain: bool = True):
    """The update's gradients through K6 at full depth, and its time; the
    printed lines name `weights` where given.

    1. One b32 update with 'conv' (autograd of the conv form) against 'pk'
       (K6) on the same experience and weights, in turns pk, conv, conv, pk:
       both times; the losses agree to 5% (bf16 compute, PARITY dev 12), and
       two 'pk' runs give the same loss.
    2. On the same batch, the bf16 'pk' and 'conv'
       gradients against the float32 'conv' update on the card: 'pk' is no
       farther from it than TRUTH_RATIO times 'conv' is, per network part.
       A part with no gradient in one run has none in the others. Reported
       where `cpu_plain`: the 'pk' update on the card against the same
       update on the CPU (K6's plain versions, the same bf16 rounding
       points).
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
    at = f" at {weights}" if weights else ""
    print(f"update at b32{at} ({int(exp.valid.sum())} valid scenes, styles "
          f"{torch.bincount(exp.style[exp.valid].long(), minlength=3).tolist()}): "
          f"'pk' (K6) {', '.join(f'{t:.3f}' for t, _ in res['pk'])} s, 'conv' autograd "
          f"{', '.join(f'{t:.3f}' for t, _ in res['conv'])} s; loss {loss_pk:.6f} vs "
          f"{loss_conv:.6f} (rel diff {diff:.4f}, bound 0.05)")
    check(all(math.isfinite(l) for v in res.values() for _, l in v), "non-finite loss")
    check(res["pk"][0][1] == res["pk"][1][1], "K6 update loss differs between repeats")
    check(diff <= 0.05, f"'pk' and 'conv' losses differ by {diff:.4f}")

    runs = {"pk": _update_grads(trainer, model_snap, exp, labels, it, "pk"),
            "conv": _update_grads(trainer, model_snap, exp, labels, it, "conv")}
    trainer.cfg = cfg0
    trainer.model.load_state_dict(model_snap)
    trainer.opt.load_state_dict(opt_snap)
    cpu_s = None
    if cpu_plain:
        cpu = Trainer(cfg0, device="cpu")
        t0 = time.perf_counter()
        with wall_clock("cpu_plain_update"):
            runs["pk plain"] = _update_grads(cpu, model_snap, exp.map(lambda t: t.cpu()),
                                             labels.cpu(), it, "pk")
        cpu_s = time.perf_counter() - t0
        del cpu
    f32 = Trainer(dataclasses.replace(cfg0, model=dataclasses.replace(
        cfg0.model, dtype="float32")), device=trainer.device)
    runs["f32 conv"] = _update_grads(f32, model_snap, exp, labels, it, "conv")
    del f32
    truth = runs["f32 conv"][1]
    live = [k for k, g in truth.items() if float(g.norm()) > 0]
    for name, (loss, g) in runs.items():
        check(math.isfinite(loss), f"{name} update: loss {loss}")
        for k in truth:
            if k not in live:
                check(float(g[k].norm()) == 0.0, f"{name} update: a gradient in {k}")
    check(len(live) >= 2, f"update gradients in {live} only")
    kp = ({k: _rel_l2(runs["pk"][1][k], runs["pk plain"][1][k]) for k in live}
          if cpu_plain else None)
    to_f32 = {m: {k: _rel_l2(runs[m][1][k], truth[k]) for k in live} for m in ("pk", "conv")}
    pk_conv = {k: _rel_l2(runs["pk"][1][k], runs["conv"][1][k]) for k in live}
    fmt = lambda d: ", ".join(f"{k} {v:.4f}" for k, v in d.items())  # noqa: E731
    print(f"update gradients{at} on the batch (styles "
          f"{torch.bincount(exp.style[exp.valid].long(), minlength=3).tolist()}), "
          f"relative L2 per part: "
          + (f"K6 on the card vs the plain versions on the CPU ({cpu_s:.1f} s) "
             f"(reported): {fmt(kp)}; " if cpu_plain else "")
          + "bf16 'pk' vs f32: "
          f"{fmt(to_f32['pk'])}; bf16 'conv' vs f32: {fmt(to_f32['conv'])} (bound: 'pk' "
          f"<= {TRUTH_RATIO} x 'conv'); 'pk' vs 'conv': {fmt(pk_conv)}")
    check(all(to_f32["pk"][k] <= TRUTH_RATIO * to_f32["conv"][k] for k in live),
          f"'pk' gradients farther from float32 than 'conv': {to_f32}")
    return {"pk_s": [t for t, _ in res["pk"]], "conv_s": [t for t, _ in res["conv"]],
            "loss_pk": loss_pk, "loss_conv": loss_conv, "rel_diff": diff,
            "kernel_vs_plain_rel_l2": kp,
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
    failed += snapshot_stem_case(dp, dev, masked, obj_depth, valid, detail)
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


def snapshot_stem_case(dp, dev, masked, obj_depth, valid, detail) -> list:
    """Decision parity under a trained snapshot's stem statistic
    (decision_parity.snapshot_stem_ from SEED, as
    tests/test_torch_eval_stages.py builds it): norm0 and block 1's norm1
    at cold seed 1's running variances, conv0 taps that fit bf16, so that
    the fast path's gray tap and the module forward round conv0 alike. At
    input SNAPSHOT_CASE[0], style SNAPSHOT_CASE[1], every backend holds the
    strict rule and stands within SNAPSHOT_FACTOR x the bf16 module
    forward's own error ratio: the kernels under the snapshot's folds
    compute what the module does. (The gray tap's rounding, the
    departure's cause on that snapshot, is the JAX package's own function
    and is held against it on the CPU.) Returns the failed (case, backend,
    style)."""
    S, style = SNAPSHOT_CASE
    model, oracle = dp.make_models(S, SEED, dev)
    scene_imgs, mask_imgs = dp.prepare(masked, obj_depth, S)
    x = torch.cat([scene_imgs, mask_imgs.flatten(0, 1)])
    for m in (model, oracle):
        dp.snapshot_stem_(m, x, SEED, gray_tap=False)
    res = dp.evaluate(model, oracle, scene_imgs, mask_imgs, valid, styles=(style,))
    failed = []
    for (backend, _), r in res.items():
        bound = SNAPSHOT_FACTOR * r["witness_err_over_spread"]
        r["snapshot_bound"] = bound
        r["snapshot_ok"] = r["strict_ok"] and r["err_over_spread"] <= bound
        print(f"decision parity, snapshot stem statistic {S} {backend} style {style}: "
              f"{r['err_over_spread']:.4f} x the spread {r['max_spread']:.4f}, the bf16 module "
              f"forward {r['witness_err_over_spread']:.4f} (ratio "
              f"{r['err_over_spread'] / max(r['witness_err_over_spread'], 1e-12):.3f}; bound "
              f"{bound:.4f} = {SNAPSHOT_FACTOR} x it; strict rule "
              f"{'holds' if r['strict_ok'] else 'fails'}); decided {r['decided']}/{r['scenes']}, "
              f"flips {r['flips_on_decided']}: {'ok' if r['snapshot_ok'] else 'FAILED'}")
        if not r["snapshot_ok"]:
            failed.append(("snapshot_stem", backend, style))
    detail["snapshot_stem"] = {f"{b}/{s}": r for (b, s), r in res.items()}
    return failed


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
    got_scores = trainer.score_scene_batch(None, depth, masks, valid)
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
        want_scores = cpu.score_scene_batch(None, depth.cpu(), masks.cpu(), valid.cpu())
        for name in ("gra_conf", "suc_conf"):
            g = getattr(got_scores, name)[0, :, 0].cpu()[v]
            w = getattr(want_scores, name)[0, :, 0][v]
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite")
            err = float((g - w).abs().max() / w.abs().max().clamp(min=1e-6))
            print(f"score {name} ({int(v.sum())} objects) vs the {dtype} CPU "
                  f"plain path: max err {err:.4f} of the largest (reported)")
            DETAIL.setdefault("reference", {})[f"{name}/{dtype}"] = err


# ---------------------------------------------------------------------------
# The CLI path: python -m smg_tpu_torch.cli.main / .smoke in subprocesses
# ---------------------------------------------------------------------------

CLI_TRAIN_ITERS = 2
CLI_FLAGS = ("--is_sim", "--method", "reinforcement", "--is_ets", "--is_pe", "--is_oo",
             "--batch_size", str(B_MAIN))
# Logs with B rows per step; clearance and episode_success get a row per
# finished episode, training_loss one per step.
PER_SCENE_LOGS = ("executed-action", "label-value", "reward-value", "predicted-value",
                  "use-heuristic", "is-exploit", "grasping_type")
# Runs `python -m <module> <args>` in this process with the launch counts
# set to 0 first, and writes the counts to <out> at its end.
CLI_RUNNER = (
    "import json, runpy, sys\n"
    "import chip_smoke\n"
    "out, module, args = sys.argv[1], sys.argv[2], sys.argv[3:]\n"
    "chip_smoke.zero_counts()\n"
    "sys.argv = [module, *args]\n"
    "try:\n"
    "    runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    with open(out, 'w') as f:\n"
    "        json.dump(chip_smoke.read_counts(), f)\n"
)


def run_cli(module: str, args, tmp: Path, tag: str):
    """One entry point in a subprocess with its real argv; (stdout,
    launch counts, seconds). A nonzero exit fails the run."""
    out = tmp / f"{tag}.counts.json"
    t0 = time.perf_counter()
    with wall_clock(tag):
        res = subprocess.run([sys.executable, "-c", CLI_RUNNER, str(out), module, *args],
                             capture_output=True, text=True, timeout=600,
                             cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:] + res.stderr[-4000:])
    check(res.returncode == 0, f"{tag}: python -m {module} exited {res.returncode}")
    print(f"cli {tag} ({seconds:.1f} s): " + " | ".join(
        line for line in res.stdout.splitlines()
        if line.startswith(("Training iteration", "Testing iteration", "done:", "smoke ok"))))
    return res.stdout, json.loads(out.read_text()), seconds


def sum_counts(runs) -> dict:
    """Each kernel's launches summed over the runs' counts."""
    total = {name: 0 for name in launch_counters()}
    for counts in runs:
        for name, c in counts.items():
            total[name] += c
    return total


def _log_rows(run_dir: Path, name: str):
    import numpy as np

    path = run_dir / "transitions" / f"{name}.log.txt"
    check(path.exists(), f"{path} is missing")
    return np.loadtxt(path, ndmin=2) if path.stat().st_size else np.zeros((0, 0))


def check_run_tree(run_dir: Path, iters: int) -> dict:
    """The CLI's run tree after `iters` training iterations at B_MAIN."""
    import numpy as np

    from smg_tpu_torch.utils import native
    from smg_tpu_torch.utils.logger import LOG_NAMES

    cfg = json.loads((run_dir / "info" / "config.json").read_text())
    check(cfg["loop"]["batch_size"] == B_MAIN, "info/config.json")
    rows = {name: _log_rows(run_dir, name) for name in LOG_NAMES}
    for name in PER_SCENE_LOGS:
        check(rows[name].shape[0] == iters * B_MAIN,
              f"{name}: {rows[name].shape[0]} rows, want {iters * B_MAIN}")
    check(rows["executed-action"].shape[1] == 7, "executed-action columns")
    check(rows["training_loss"][:, 0].tolist() == list(range(1, iters + 1)),
          f"training_loss iterations {rows['training_loss'][:, 0].tolist()}")
    check(rows["clearance"].shape[0] == rows["episode_success"].shape[0],
          "a clearance row per finished episode")
    mirrored = native.load_library() is not None
    if mirrored:
        for name, r in rows.items():
            if not r.size:
                continue
            back = np.stack(native.read_binary_log(
                str(run_dir / "transitions" / f"{name}.log.bin")))
            check(np.array_equal(back, r.astype(np.float32)),
                  f"{name}.log.bin differs from its text rows")
    ckpts = sorted(p.name for p in (run_dir / "models" / "ckpt").glob("*.pt"))
    check(ckpts == [f"{iters}.pt"], f"checkpoints {ckpts}")
    check((run_dir / "models" / "snapshot").is_file(), "models/snapshot")
    data = run_dir / "data"
    for i in range(1, iters + 1):
        for path in (data / "color-heightmaps" / f"{i:06d}.0.color.npy",
                     data / "depth-heightmaps" / f"{i:06d}.0.depth.npy",
                     run_dir / "visualizations" / f"{i:06d}.action.npy",
                     data / "color-images" / f"{i:06d}.0.color.npy"):
            check(path.is_file(), f"{path} is missing")
    frame = np.load(data / "color-images" / f"{iters:06d}.0.color.npy")
    check(frame.shape == (480, 640, 3) and bool(np.isfinite(frame).all()),
          f"RGB frame {frame.shape}")
    hm = np.load(data / "depth-heightmaps" / f"{iters:06d}.0.depth.npy")
    check(hm.shape == (224, 224) and bool(np.isfinite(hm).all()), "depth heightmap")
    print(f"run tree ok: rows {({k: int(v.shape[0]) for k, v in rows.items()})}, "
          f".log.bin mirrors {'equal to the text rows' if mirrored else 'not built'}, "
          f"checkpoints {ckpts}, RGB-D frame {frame.shape}")
    return {"rows": {k: int(v.shape[0]) for k, v in rows.items()},
            "bin_mirror": mirrored, "checkpoints": ckpts}


def drive_cli_path(kernels):
    """The experiment CLI's main path through its entry points, each in a
    subprocess with its real argv: python -m smg_tpu_torch.cli.main trains
    CLI_TRAIN_ITERS iterations at b32 with the held flags and scene-0
    imagery every iteration; then, side by side, it resumes with
    --continue_logging for one more and tests one iteration with
    --load_snapshot (a copy of the training run's snapshot, which the
    resume rewrites) on the held-out catalog. The run tree is checked after
    each, and K1-K4's launches summed over the three runs (cli.smoke runs
    in the perception path)."""
    import shutil
    import tempfile

    main_mod = "smg_tpu_torch.cli.main"
    outs, counts, seconds = {}, {}, {}

    def cli(tag, module, args):
        """The run as a function of no arguments (for side_by_side)."""
        def run():
            outs[tag], counts[tag], seconds[tag] = run_cli(module, args, tmp, tag)
        return run

    with tempfile.TemporaryDirectory(prefix="smg_cli_") as td:
        tmp = Path(td)
        cli("train", main_mod, [*CLI_FLAGS, "--max_iterations", str(CLI_TRAIN_ITERS),
                                "--imagery_every", "1",
                                "--logging_directory", str(tmp / "train")])()
        (run_dir,) = (tmp / "train").iterdir()
        tree = check_run_tree(run_dir, CLI_TRAIN_ITERS)
        snap = tmp / "snapshot"
        shutil.copyfile(run_dir / "models" / "snapshot", snap)

        n = CLI_TRAIN_ITERS + 1
        side_by_side({
            "resume": cli("resume", main_mod, [
                *CLI_FLAGS, "--continue_logging", "--logging_directory", str(run_dir),
                "--max_iterations", str(n), "--imagery_every", "0"]),
            "test": cli("test", main_mod, [
                *CLI_FLAGS, "--is_testing", "--load_snapshot", "--snapshot_file", str(snap),
                "--obj_mesh_dir", "datasets/testing", "--max_iterations", "1",
                "--imagery_every", "0", "--logging_directory", str(tmp / "test")])})
        check(f"Resumed trainer state from checkpoint step {n - 1} (iteration {n - 1})"
              in outs["resume"], "the resumed run restored no checkpoint")
        check(f"Training iteration: {n} |" in outs["resume"],
              "the resumed run does not continue from the checkpoint's iteration")
        iters = _log_rows(run_dir, "training_loss")[:, 0].tolist()
        check(iters == list(range(1, n + 1)), f"training_loss iterations {iters}")
        ckpts = sorted(p.name for p in (run_dir / "models" / "ckpt").glob("*.pt"))
        check(ckpts == [f"{n - 1}.pt", f"{n}.pt"], f"checkpoints after resume {ckpts}")

        check("Pre-trained model snapshot loaded from" in outs["test"]
              and "Testing iteration: 1 |" in outs["test"], "the testing run")
        (test_dir,) = (tmp / "test").iterdir()
        check(_log_rows(test_dir, "reward-value").shape[0] == B_MAIN, "testing run rows")
    total = sum_counts(counts.values())
    print("launches in the CLI path: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in total.items()))
    for k in kernels:
        k["launches_cli"] = total[k["name"]]
        if k["name"].split()[0] in CLI_KERNELS:
            check(total[k["name"]] > 0, f"{k['name']} was not launched by the CLI path")
    DETAIL["cli_path"] = {
        "launches": total, "seconds": seconds, "tree": tree,
        "train_report": outs["train"].split("phase timings:")[-1].strip().splitlines()}

# ---------------------------------------------------------------------------
# The perception path: mesh ingest, the learned segmenter, the tiny trunk
# ---------------------------------------------------------------------------

PERCEPTION_KERNELS = ("K1", "K2", "K3", "K4")
SEG_STEPS = 40
SEG_BATCH = 16
SEG_EVAL_SCENES = 8


def write_obj(path: Path, kind: str) -> None:
    """A small .obj mesh: a box, a z-axis cylinder or a sphere (points)."""
    import numpy as np

    if kind == "box":
        v = [(sx * 0.03, sy * 0.02, sz * 0.015)
             for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    elif kind == "cylinder":
        v = [(0.02 * math.cos(a), 0.02 * math.sin(a), z) for z in (-0.035, 0.035)
             for a in np.arange(24) * (2 * math.pi / 24)]
    else:
        u = np.random.RandomState(0).randn(80, 3)
        v = (0.02 * u / np.linalg.norm(u, axis=1, keepdims=True)).tolist()
    path.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v) + "f 1 2 3\n")


def write_mesh_dir(root: Path) -> dict:
    """enveloping/ + sucking/ of .obj meshes -> {file: expected shape type}."""
    from smg_tpu_torch.utils import native

    want = {}
    for sub, kinds in (("enveloping", ("box", "cylinder", "sphere")),
                       ("sucking", ("box", "sphere"))):
        (root / sub).mkdir(parents=True)
        for kind in kinds:
            write_obj(root / sub / f"{kind}.obj", kind)
            want[f"{sub}/{kind}.obj"] = {"box": native.BOX, "cylinder": native.CYLINDER,
                                         "sphere": native.SPHERE}[kind]
    return want


def _json_line(out: str) -> dict:
    return json.loads(next(l for l in reversed(out.splitlines()) if l.startswith("{")))


def phase_segmenter(dev) -> dict:
    """The SlotSegmenter's forward at the loop's batch (b32, bf16) and one
    training step at cli.train_segmenter's (b16); the batched NMS of
    predict_segmentation at b32. Each as the median CUDA-event ms of an
    eager call (the host's issue time inside the window) and as the device
    time of its kernels (torch.profiler, summed over kernel names)."""
    from smg_tpu_torch.perception import learned, nms

    model = learned.init_segmenter(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.rand(B_MAIN, 4, 224, 224, generator=g, device=dev)
    opt = learned.new_optimizer(model)
    xb = x[:SEG_BATCH]
    ids = torch.randint(-1, 12, (SEG_BATCH, 224, 224), generator=g, device=dev)
    boxes = torch.randint(0, 200, (B_MAIN, 12, 2, 2), generator=g, device=dev).float()
    boxes = torch.sort(boxes, dim=2).values
    valid = torch.ones(B_MAIN, 12, dtype=torch.bool, device=dev)

    def forward():
        with torch.no_grad():
            return model(x)

    calls = {"forward_b32": forward,
             "train_step_b16": lambda: learned.train_step_segmenter(model, opt, xb, ids),
             "nms_b32": lambda: nms.nms(boxes, valid, 0.40, 16.0, 224 * 224 / 5.0)}
    out = {}
    for name, fn in calls.items():
        out[f"{name}_ms"] = cuda_ms(fn)
        out[f"{name}_device_ms"] = sum(_profile_by_kernel(fn, 5).values())
    print("segmenter (bf16, 224): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def drive_perception_path(kernels):
    """The perception slice through its entry points, each in a subprocess
    with its real argv (the segmenter's in-process timings are
    phase_segmenter's). The .obj meshes written here are fitted first
    (native, the right shape types); then side by side: python -m
    smg_tpu_torch.cli.main at b32 on that --obj_mesh_dir,
    cli.train_segmenter SEG_STEPS steps at b16 on cluttered scenes (the
    last loss below the first), cli.main --trunk tiny and cli.smoke (tiny
    trunk); then, side by side on the segmenter's checkpoint,
    cli.eval_segmenter on 8 held-out scenes, base and --perspective, and
    cli.main with the held flags and --segmentation learned (a scene acts
    on a learned mask). K1-K4's launches summed over the runs."""
    import tempfile

    from smg_tpu_torch.utils import meshes, native

    main_mod = "smg_tpu_torch.cli.main"
    outs, counts, seconds = {}, {}, {}

    def cli(tag, module, args):
        """The run as a function of no arguments (for side_by_side)."""
        def run():
            outs[tag], counts[tag], seconds[tag] = run_cli(module, args, tmp, tag)
        return run

    detail = {}
    with tempfile.TemporaryDirectory(prefix="smg_perception_") as td:
        tmp = Path(td)
        mesh_root = tmp / "meshes"
        want = write_mesh_dir(mesh_root)
        fits = {f: native.fit_obj(str(mesh_root / f)) for f in want}
        check(all(fit.native for fit in fits.values()), "fit_obj did not run natively")
        check({f: fit.shape_type for f, fit in fits.items()} == want,
              f"fitted shape types {[(f, fit.shape_type) for f, fit in fits.items()]}")
        (g_types, _), (s_types, _) = meshes.load_object_sets(str(mesh_root))
        print(f"mesh ingest: native fits, enveloping types {g_types.tolist()}, "
              f"sucking types {s_types.tolist()}")

        ckpt = str(tmp / "segmenter.pt")
        side_by_side({
            "mesh": cli("mesh", main_mod, [*CLI_FLAGS, "--obj_mesh_dir", str(mesh_root),
                                           "--max_iterations", "1", "--imagery_every", "0",
                                           "--logging_directory", str(tmp / "mesh")]),
            "train_segmenter": cli("train_segmenter", "smg_tpu_torch.cli.train_segmenter",
                                   ["--steps", str(SEG_STEPS), "--batch_size", str(SEG_BATCH),
                                    "--is_cluttered", "--out", ckpt]),
            "tiny": cli("tiny", main_mod, [*CLI_FLAGS, "--trunk", "tiny", "--max_iterations",
                                           "1", "--imagery_every", "0",
                                           "--logging_directory", str(tmp / "tiny")]),
            "smoke": cli("smoke", "smg_tpu_torch.cli.smoke", ["--batch", "4"])})
        check("Training iteration: 1 |" in outs["mesh"], "the mesh-catalog run")
        check("Training iteration: 1 |" in outs["tiny"], "the tiny-trunk run")
        check("smoke ok" in outs["smoke"], "cli.smoke")
        seg_losses = [float(l.split("| loss ")[1].split(" |")[0])
                      for l in outs["train_segmenter"].splitlines()
                      if l.startswith("segmenter step")]
        print(f"segmenter losses: {seg_losses}")
        check(len(seg_losses) >= 2 and seg_losses[-1] < seg_losses[0],
              f"segmenter loss did not fall: {seg_losses}")
        detail["segmenter_losses"] = seg_losses

        arms = {"base": [], "perspective": ["--perspective"]}
        side_by_side({
            **{f"eval_{arm}": cli(f"eval_{arm}", "smg_tpu_torch.cli.eval_segmenter",
                                  ["--checkpoint", ckpt, "--scenes", str(SEG_EVAL_SCENES),
                                   "--cluttered", "--testing", *extra])
               for arm, extra in arms.items()},
            "learned": cli("learned", main_mod, [
                *CLI_FLAGS, "--segmentation", "learned", "--segmenter_checkpoint", ckpt,
                "--max_iterations", "1", "--imagery_every", "0",
                "--logging_directory", str(tmp / "learned")])})
        evals = {}
        for arm in arms:
            evals[arm] = _json_line(outs[f"eval_{arm}"])
            print(f"eval_segmenter {arm}: {json.dumps(evals[arm])}")
            check(evals[arm]["visible_objects"] > 0 and 0.0 <= evals[arm]["miou"] <= 1.0,
                  f"eval_segmenter {arm}")
        detail["eval"] = evals
        check("segmenter loaded from" in outs["learned"], "the learned-mask run")
        (run_dir,) = (tmp / "learned").iterdir()
        pred = _log_rows(run_dir, "predicted-value")
        # A scene whose action has a target scored on a valid learned mask
        # (no valid mask: -1e9, or -100 for an ETS pair).
        check(pred.shape[0] == B_MAIN and bool((pred > -99).any()),
              "no scene acted on a valid learned mask")
        detail["learned_scenes_with_a_mask"] = int((pred > -99).sum())
    total = sum_counts(counts.values())
    print("launches in the perception path: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in total.items()))
    for k in kernels:
        k["launches_perception"] = total[k["name"]]
        if k["name"].split()[0] in PERCEPTION_KERNELS:
            check(total[k["name"]] > 0, f"{k['name']} was not launched by the perception path")
    DETAIL["perception_path"] = {"launches": total, "seconds": seconds, **detail}


# ---------------------------------------------------------------------------
# Trunk pretraining, the per-scene executor, the sharded step
# ---------------------------------------------------------------------------

PRETRAIN_STEPS = 20
PRETRAIN_BATCH = 16
PRETRAIN_KERNELS = ("K1", "K2", "K3", "K4")
VMAP_KERNELS = ("K1", "K2", "K3", "K4")
SHARDED_KERNELS = ("K1", "K2", "K3", "K4", "K6a", "K6b")
FORCE_TOL = 1e-5


def _trunk_state(net, part: str) -> dict:
    return {k: v.detach().cpu() for k, v in getattr(net, part).state_dict().items()}


def phase_pretrain_step(dev) -> dict:
    """One reconstruction step at b16 (DenseNet-121, 224, bf16): its batch
    (16 scenes spawned, a 50-step settle, rendered, masked) and its
    train-mode forward, backward and Adam step, each by CUDA events around
    an eager call and by device time (torch.profiler, kernels summed)."""
    from smg_tpu_torch.models.affordance import ModelConfig
    from smg_tpu_torch.train import pretrain

    cfg = pretrain.PretrainConfig(model=ModelConfig(input_size=224))
    model = pretrain.ReconstructionModel(cfg).to(dev)
    pretrain.init_reconstruction(model, torch.Generator(device=dev).manual_seed(SEED))
    opt = pretrain.new_optimizer(model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    batch_fn = pretrain.make_batch_fn(cfg)
    batch = batch_fn(gen, PRETRAIN_BATCH)
    calls = {"batch": lambda: batch_fn(gen, PRETRAIN_BATCH),
             "step": lambda: pretrain.pretrain_step(model, opt, *batch)}
    out = {}
    for name, fn in calls.items():
        out[f"{name}_ms"] = cuda_ms(fn, reps=5, warmup=1)
        out[f"{name}_device_ms"] = sum(_profile_by_kernel(fn, 3).values())
    print("pretrain at b16 (224, bf16): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def drive_pretrain_path(dev, kernels):
    """python -m smg_tpu_torch.cli.pretrain_trunks (DenseNet-121, 224) for
    PRETRAIN_STEPS steps at b16 in a subprocess, its loss falling (the
    mean of the last 5 below the first 5's, tests/test_pretrain.py:39-62;
    one step's in-process timings are phase_pretrain_step's); then side by
    side: the checkpoint into a fresh b32 trainer's six trunks (online and
    target), equal, and that trainer's update at the warm weights after
    two training steps: compare_update_modes, 'pk' no farther from float32
    than TRUTH_RATIO x 'conv' per part on the b32 batch, as on the
    training path's random weights (whose run alone reports K6 against
    its plain versions on the CPU); and cli.main with the held flags and
    --pretrained_trunks for two training iterations: its target trunks
    equal the checkpoint's and its online trunks sit within one Adam step
    of them (the first update is on the blank previous step, a zero
    gradient)."""
    import tempfile

    from smg_tpu_torch.train import checkpoints, loop
    from smg_tpu_torch.train.pretrain import TRUNK_PARTS
    from smg_tpu_torch.train.prod_config import make_prod_loop_cfg, make_prod_trainer

    detail, counts = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smg_pretrain_") as td:
        tmp = Path(td)
        ckpt = str(tmp / "trunk.pt")
        out, counts["pretrain"], detail["pretrain_seconds"] = run_cli(
            "smg_tpu_torch.cli.pretrain_trunks",
            ["--steps", str(PRETRAIN_STEPS), "--batch_size", str(PRETRAIN_BATCH),
             "--out", ckpt], tmp, "pretrain")
        res = _json_line(out)
        losses, step_ms = res["losses"], res["step_ms"]
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        print(f"pretrain losses: {', '.join(f'{x:.4f}' for x in losses)}")
        print(f"pretrain ms per step (CUDA events): median {statistics.median(step_ms[1:]):.1f}"
              f" [{', '.join(f'{x:.1f}' for x in step_ms)}]")
        check(all(math.isfinite(x) for x in losses), "pretrain: non-finite loss")
        check(last < first, f"pretrain: the loss did not fall ({first:.4f} -> {last:.4f})")
        detail.update(losses=losses, step_ms=step_ms, first5=first, last5=last)
        pre = {k[len("trunk."):]: v for k, v in checkpoints.load_params(ckpt).items()
               if k.startswith("trunk.")}

        def warm_update():
            trainer = make_prod_trainer(B_MAIN, device=dev, fast_train_conv2="pk")
            cfg = make_prod_loop_cfg(B_MAIN, is_testing=False)
            state = loop.init_loop(SEED + 1, trainer, cfg)
            checkpoints.load_pretrained(trainer, ckpt)
            for net in (trainer.model, trainer.target):
                for part in TRUNK_PARTS:
                    got = _trunk_state(net, part)
                    check(all(torch.equal(got[k], pre[k]) for k in pre),
                          f"load_pretrained: {part} differs from the checkpoint")
            for _ in range(2):
                state, _ = loop.train_step(trainer, cfg, state)
            with wall_clock("compare_update_modes"):
                detail["warm_update_modes"] = compare_update_modes(
                    trainer, state, "warm weights", cpu_plain=False)

        def warm_cli():
            run_out, counts["warm"], detail["warm_cli_seconds"] = run_cli(
                "smg_tpu_torch.cli.main",
                [*CLI_FLAGS, "--pretrained_trunks", ckpt, "--max_iterations", "2",
                 "--imagery_every", "0", "--logging_directory", str(tmp / "warm")], tmp, "warm")
            check(f"pretrained trunks loaded from: {ckpt}" in run_out, "the warm run")
            (run_dir,) = (tmp / "warm").iterdir()
            saved = torch.load(run_dir / "models" / "ckpt" / "2.pt", map_location="cpu",
                               weights_only=True)
            lr = 1e-4
            steps = {}
            for part in TRUNK_PARTS:
                for k, v in pre.items():
                    t = saved["target"][f"{part}.{k}"]
                    check(torch.equal(t, v),
                          f"warm run: target {part}.{k} is not the checkpoint's")
                    if "running" in k or "num_batches" in k:
                        continue
                    o = saved["model"][f"{part}.{k}"]
                    steps[part] = max(steps.get(part, 0.0), float((o - v).abs().max()))
            print(f"warm run: target trunks equal the checkpoint's; online trunks' largest "
                  f"move after one Adam step: {steps}")
            # A style absent from the first step's experience leaves its trunk.
            check(max(steps.values()) > 0 and all(d <= 1.001 * lr for d in steps.values()),
                  f"warm run: online trunks moved {steps}, want at most lr, one of them > 0")
            detail["online_move"] = steps

        side_by_side({"warm_update": warm_update, "warm_cli": warm_cli})
    torch.cuda.empty_cache()
    detail["seconds"] = time.perf_counter() - t0
    total = sum_counts(counts.values())
    print("launches in the pretraining path: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in total.items()))
    for k in kernels:
        k["launches_pretrain"] = total[k["name"]]
        if k["name"].split()[0] in PRETRAIN_KERNELS:
            check(total[k["name"]] > 0, f"{k['name']} was not launched by the pretraining path")
    DETAIL["pretrain_path"] = {"launches": total, **detail}


def _fork_state(state):
    """A LoopState with its own generator at the same position."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return dataclasses.replace(state, generator=gen)


def drive_vmap_path(kernels, trainer, cfg, state):
    """The per-scene executor: from the act path's trainer and last state
    (b32, the production testing config), one act step with
    executor="vmap" (the dense per-scene contacts, no K1) and one with
    "batched" (K1); their
    times and every scene's success, the agreement reported, not gated
    (K1 sums in another order, and 755 steps of contact are chaotic). Then
    one physics step's contact force of each formulation from the same
    state, the gripper lowered into each scene's first object, held to
    FORCE_TOL of the largest force."""
    from smg_tpu_torch.physics import stepper
    from smg_tpu_torch.physics.state import Gripper
    from smg_tpu_torch.train import loop

    check(cfg.env.is_testing and cfg.batch_size == B_MAIN, "config")
    zero_counts()
    detail = {}
    per_step = {}
    succ = {}
    for ex in ("vmap", "batched"):
        c = dataclasses.replace(cfg, executor=ex)
        before = read_counts()
        phases, last = {}, [time.perf_counter()]
        t0 = last[0]
        _, m = loop.train_step(trainer, c, _fork_state(state), timer=step_timer(phases, last))
        seconds = time.perf_counter() - t0
        after = read_counts()
        per_step[ex] = {n: after[n] - before[n] for n in after}
        succ[ex] = ((m.grasp_success > 0) | (m.suction_success > 0)
                    | (m.gs_success > 0)).cpu()
        detail[ex] = {"seconds": seconds, "phases": {k: round(v, 6) for k, v in phases.items()},
                      "success": succ[ex].int().tolist(), "launches": per_step[ex]}
        print(f"act step, executor {ex}: {seconds:.3f} s  " + "  ".join(
            f"{k} {v:.3f}" for k, v in phases.items())
              + f"  successes {int(succ[ex].sum())}/{B_MAIN}: {succ[ex].int().tolist()}")
    agree = int((succ["vmap"] == succ["batched"]).sum())
    print(f"vmap against batched: {agree} of {B_MAIN} scenes' successes agree (reported)")
    detail["success_agreement"] = agree
    check(per_step["vmap"]["K1 contact sweep"] == 0, "the vmap act step launched K1")

    # One physics step's contact forces, both formulations, same state.
    sc = state.scenes
    g = sc.gripper
    low = Gripper(pos=torch.cat([sc.objects.pos[:, 0, :2], torch.full_like(g.pos[:, :1], 0.06)],
                                dim=1), yaw=g.yaw + 0.3, tilt=g.tilt, curl=g.curl)
    tgt = low.replace(pos=low.pos - low.pos.new_tensor([0.0, 0.0, 0.03]))
    sc = stepper.run_steps_batched(sc.replace(gripper=low), tgt, 3)
    g_new = stepper._servo_gripper(sc.gripper, tgt, stepper.DEFAULT)
    f_ref, t_ref = stepper.contact_forces(sc.objects, sc.gripper, g_new)
    f_k1, t_k1 = stepper.contact_forces_batched(sc.objects, sc.gripper, g_new)
    errs = {"force": rel_err(f_k1, f_ref), "torque": rel_err(t_k1, t_ref)}
    fmax = float(f_ref.abs().max())
    print(f"one physics step, K1 against the per-scene sweep: force err {errs['force']:.3e}, "
          f"torque err {errs['torque']:.3e} of the largest (force {fmax:.3f} N; "
          f"bound {FORCE_TOL})")
    check(fmax > 1.0, "the force check has no contacts")
    check(errs["force"] <= FORCE_TOL and errs["torque"] <= FORCE_TOL,
          f"the two contact formulations disagree: {errs}")
    detail["physics_step"] = {**errs, "largest_force": fmax}
    detail["physics_step_ms"] = {
        "per_scene": cuda_ms(lambda: stepper.physics_step(sc, tgt), reps=20),
        "batched": cuda_ms(lambda: stepper.physics_step_batched(sc, tgt), reps=20)}
    print("physics step at b32, eager ms (CUDA events): " + ", ".join(
        f"{k} {v:.3f}" for k, v in detail["physics_step_ms"].items()))
    torch.cuda.synchronize()
    total = read_counts()
    print("launches in the per-scene executor path: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in total.items()))
    for k in kernels:
        k["launches_vmap"] = total[k["name"]]
        if k["name"].split()[0] in VMAP_KERNELS:
            check(total[k["name"]] > 0, f"{k['name']} was not launched by the per-scene path")
    for name in ("K2 dense layer", "K3 transition", "K4 stem BN/ReLU/maxpool"):
        check(per_step["vmap"][name] > 0, f"the vmap act step did not launch {name}")
    DETAIL["vmap_path"] = {"launches": total, **detail}


SHARDED_RUNNER = "import sys, chip_smoke\nchip_smoke.sharded_child(sys.argv[1])\n"


def sharded_child(out: str) -> None:
    """In a process of its own (WORLD_SIZE 1, NCCL): TRAIN_STEPS training
    steps at b32 under fast_train_conv2="pk" through make_sharded_step,
    then the plain train_step from the same seed; their losses, times and
    the sharded run's launch counts to `out`. cuDNN runs its deterministic
    algorithms in both, so two runs of one function read the same bits."""
    from smg_tpu_torch.parallel import mesh, sharded
    from smg_tpu_torch.train import loop
    from smg_tpu_torch.train.prod_config import make_prod_loop_cfg, make_prod_trainer

    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.init_data_parallel(1, "cuda")
    res = {"world": mesh.world(), "backend": torch.distributed.get_backend()}
    try:
        for run in ("sharded", "plain"):
            trainer = make_prod_trainer(B_MAIN, device=dev, fast_train_conv2="pk")
            cfg = make_prod_loop_cfg(B_MAIN, is_testing=False)
            zero_counts()
            if run == "sharded":
                state = loop.init_loop(SEED + 3, trainer, cfg, mesh.scene_slice(B_MAIN))
                step = sharded.make_sharded_step(trainer, cfg)
            else:
                state = loop.init_loop(SEED + 3, trainer, cfg)
                step = lambda s: loop.train_step(trainer, cfg, s)  # noqa: E731
            losses, seconds = [], []
            for _ in range(TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                losses.append(float(m.loss))
                check(m.action.shape == (B_MAIN,), "metrics come back whole")
            res[run] = {"losses": losses, "loss_bits": [float.hex(x) for x in losses],
                        "seconds": seconds, "launches": read_counts()}
            del trainer, state
            torch.cuda.empty_cache()
    finally:
        mesh.shutdown()
    Path(out).write_text(json.dumps(res))


def drive_sharded_path(kernels):
    """The sharded training step at world 1 over NCCL, in a subprocess
    (sharded_child): its TRAIN_STEPS losses bit-equal to the plain step's
    from the same seed; K1-K4 and K6 launched."""
    import socket
    import tempfile

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    with tempfile.TemporaryDirectory(prefix="smg_sharded_") as td:
        out = Path(td) / "sharded.json"
        t0 = time.perf_counter()
        with wall_clock("child"):
            proc = subprocess.run([sys.executable, "-c", SHARDED_RUNNER, str(out)],
                                  capture_output=True, text=True, timeout=600, env=env,
                                  cwd=Path(__file__).resolve().parent)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:])
        check(proc.returncode == 0, f"the sharded child exited {proc.returncode}")
        res = json.loads(out.read_text())
    sh, pl = res["sharded"], res["plain"]
    print(f"sharded step (world {res['world']}, {res['backend']}, {seconds:.1f} s): losses "
          f"{sh['losses']} [{', '.join(f'{x:.3f}' for x in sh['seconds'])} s] against the "
          f"plain step's {pl['losses']} [{', '.join(f'{x:.3f}' for x in pl['seconds'])} s]")
    check(res["backend"] == "nccl" and res["world"] == 1, f"process group {res}")
    check(sh["loss_bits"] == pl["loss_bits"],
          f"sharded losses {sh['loss_bits']} differ from the plain step's {pl['loss_bits']}")
    check(sh["losses"][0] == 0.0 and all(x > 0 for x in sh["losses"][1:]), "sharded losses")
    counts = sh["launches"]
    print("launches in the sharded step: " + ", ".join(
        f"{name.split()[0]} {n}" for name, n in counts.items()))
    for k in kernels:
        k["launches_sharded"] = counts[k["name"]]
        if k["name"].split()[0] in SHARDED_KERNELS:
            check(counts[k["name"]] > 0, f"{k['name']} was not launched by the sharded step")
    DETAIL["sharded_path"] = {**res, "seconds": seconds}


# ---------------------------------------------------------------------------
# The rotations path: num_rotations 16, the ETS head untied
# ---------------------------------------------------------------------------

ROT_R = 16
ROT_KERNELS = ("K1", "K2", "K3", "K4", "K6a", "K6b")
ROT_TRAIN_STEPS = 2
ROT_CHECK_SCENES = 2   # scenes held to the module forward
ROT0_BOUND = 1e-3      # rotation 0 against R = 1, in units of the score spread
SCORE_BOUND = 0.05     # against the bf16 module forward, of the largest |score|


class TrunkCalls:
    """While active, records the images of every fast_trunk.trunk_features_eval
    call (the eval trunk: one K4, three K3 and 58 K2 launches each)."""

    def __enter__(self):
        from smg_tpu_torch.models import fast_trunk

        self.mod, self.orig, self.images = fast_trunk, fast_trunk.trunk_features_eval, []

        def counted(trunk, x, backend="xla_fl", tap=None):
            self.images.append(int(x.shape[0]))
            return self.orig(trunk, x, backend, tap)

        fast_trunk.trunk_features_eval = counted
        return self

    def __exit__(self, *exc):
        self.mod.trunk_features_eval = self.orig


def _module_gap(got, want, valid) -> float:
    """max |got - want| over valid entries, over the largest valid |want|."""
    g, w = got[valid].float(), want[valid].float()
    check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all()), "non-finite scores")
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-6))


def rotation_checks(trainer, one, state) -> dict:
    """On the initial observation: the R = 16 scores' shapes; rotation 0
    against `one` (R = 1, the same weights); two scenes' scores (every
    rotation, and the ETS pairs through gs_head) against the bf16 module
    forward; the score phase at R = 16 and R = 1 timed (CUDA events and
    profiler device time) with its trunk images per scene."""
    from smg_tpu_torch.envs import smg_env
    from smg_tpu_torch.train.trainer import _PI, _PJ

    obs = smg_env.observe(state.scenes)
    depth = smg_env.masked_scene_depth(obs)
    masks, valid = obs.seg.masks, obs.seg.valid
    out = {}
    with torch.no_grad():
        sc = trainer.score_scene_batch(state.trainer, depth, masks, valid)
        s1 = one.score_scene_batch(state.trainer, depth, masks, valid)
    for name in ("gra_conf", "suc_conf"):
        got = getattr(sc, name)
        check(tuple(got.shape) == (B_MAIN, 12, ROT_R), f"{name} shape {tuple(got.shape)}")
        g0, w = got[..., 0][valid], getattr(s1, name)[..., 0][valid]
        spread = float(w.max() - w.min())
        gap = float((g0 - w).abs().max()) / max(spread, 1e-9)
        out[f"{name}_rot0_gap_over_spread"] = gap
        out[f"{name}_rot0_bitwise"] = bool(torch.equal(g0, w))
        print(f"rotations: {name} {tuple(got.shape)}; rotation 0 against R = 1: max gap "
              f"{gap:.3e} of the spread {spread:.4f} (bound {ROT0_BOUND}), bitwise "
              f"{out[f'{name}_rot0_bitwise']}")
        check(gap <= ROT0_BOUND, f"{name}: rotation 0 differs from R = 1 by {gap:.3e}")
    pi = torch.as_tensor(_PI, device=masks.device)
    pj = torch.as_tensor(_PJ, device=masks.device)
    pair_ok = valid[:, pi] & valid[:, pj]
    ets_gap = (sc.gs_conf[:, pi, pj] - s1.gs_conf[:, pi, pj])[pair_ok].abs().max()
    out["gs_conf_rot0_gap"] = float(ets_gap)
    print(f"rotations: ETS scores (rotation 0) against R = 1: max gap {float(ets_gap):.3e}")
    check(float(ets_gap) <= ROT0_BOUND * float(s1.gs_conf[:, pi, pj][pair_ok].abs().max()),
          "ETS scores differ from R = 1")

    n = ROT_CHECK_SCENES
    scene_img = trainer._prep(depth[:n])
    obj_ins = trainer._prep(depth[:n, None] * masks[:n])
    rot = trainer._rotated_scenes(scene_img)
    for style, name in ((0, "gra_conf"), (1, "suc_conf")):
        ref = trainer.model.score(rot, obj_ins, style)[..., 0]          # (n, 12, R)
        v = valid[:n, :, None].expand_as(ref)
        out[f"{name}_vs_module"] = _module_gap(getattr(sc, name)[:n], ref, v)
    pair_ins = trainer._prep(depth[:n, None] * (masks[:n, pi] | masks[:n, pj]))
    ref = trainer.model.score(scene_img, pair_ins, 2)[..., 0]           # gs_head
    out["gs_conf_vs_module"] = _module_gap(sc.gs_conf[:n, pi, pj], ref, pair_ok[:n])
    print(f"rotations: {n} scenes against the bf16 module forward (AffordanceNet.score): "
          + ", ".join(f"{k} {out[k]:.4f}" for k in ("gra_conf_vs_module", "suc_conf_vs_module",
                                                    "gs_conf_vs_module"))
          + f" of the largest |score| (bound {SCORE_BOUND})")
    for k in ("gra_conf_vs_module", "suc_conf_vs_module", "gs_conf_vs_module"):
        check(out[k] < SCORE_BOUND, f"rotations: {k} {out[k]:.4f}")

    for tag, t in (("R16", trainer), ("R1", one)):
        fn = lambda t=t: t.score_scene_batch(state.trainer, depth, masks, valid)  # noqa: E731
        with torch.no_grad(), TrunkCalls() as calls:
            fn()
        with torch.no_grad():
            out[f"score_ms_{tag}"] = cuda_ms(fn, reps=3, warmup=1)
            out[f"score_device_ms_{tag}"] = sum(_profile_by_kernel(fn, 2).values())
        out[f"trunk_images_per_scene_{tag}"] = sum(calls.images) / B_MAIN
        out[f"trunk_calls_{tag}"] = calls.images
    print("rotations: the score phase (b32, ETS on) at R = 16 / R = 1: "
          f"{out['score_ms_R16']:.2f} / {out['score_ms_R1']:.2f} ms (events), "
          f"{out['score_device_ms_R16']:.2f} / {out['score_device_ms_R1']:.2f} ms device; "
          f"trunk images a scene {out['trunk_images_per_scene_R16']:g} / "
          f"{out['trunk_images_per_scene_R1']:g}; calls {out['trunk_calls_R16']}")
    return out


def _gs_head_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.gs_head.state_dict().items()}


def drive_rotations_path(dev, kernels):
    """The ninth path: the production trainer (make_prod_trainer(32,
    fast_train_conv2="pk")) with num_rotations 16 and the ETS head untied,
    ETS on: init_loop, the checks of rotation_checks, then with the counts
    at 0 one act step (testing) and ROT_TRAIN_STEPS training steps. Holds
    best_pix's rotation columns in [0, 16), finite losses, gs_head's
    parameters and running statistics moving in a step whose batch
    executed ETS, and K2 / K3 / K4's launches at 58 / 3 / 1 per eval
    trunk call."""
    from smg_tpu_torch.train import loop
    from smg_tpu_torch.train.prod_config import make_prod_loop_cfg, make_prod_trainer
    from smg_tpu_torch.train.trainer import Trainer

    prod = make_prod_trainer(B_MAIN, device=dev, fast_train_conv2="pk")
    rcfg = dataclasses.replace(prod.cfg, is_ets=True, model=dataclasses.replace(
        prod.cfg.model, num_rotations=ROT_R, tied_ets_head=False))
    del prod
    trainer = Trainer(rcfg, device=dev)
    one = Trainer(dataclasses.replace(rcfg, model=dataclasses.replace(rcfg.model,
                                                                      num_rotations=1)),
                  device=dev)
    cfg = make_prod_loop_cfg(B_MAIN, is_testing=False)
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, is_ets=True))
    act_cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, is_testing=True))
    check(trainer.model.head(2) is trainer.model.gs_head, "the untied head")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.init_loop(SEED + 4, trainer, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    one.model.load_state_dict(trainer.model.state_dict())
    with wall_clock("rotation_checks"):
        res = {"init_s": init_s, **rotation_checks(trainer, one, state)}
    del one
    torch.cuda.empty_cache()

    steps, ets_steps = [], 0
    zero_counts()
    with TrunkCalls() as calls:
        for i, step_cfg in enumerate([act_cfg] + [cfg] * ROT_TRAIN_STEPS):
            exp = state.prev.exp
            ets = bool(((exp.style == 2) & exp.valid).any()) and not step_cfg.env.is_testing
            before = _gs_head_state(trainer.model)
            phases = {}
            last = [time.perf_counter()]
            t0 = last[0]
            state, m = loop.train_step(trainer, step_cfg, state,
                                       timer=step_timer(phases, last))
            total = time.perf_counter() - t0
            loss = float(m.loss)
            rot_cols = m.best_pix[:, [0, 3]]
            check(bool(((rot_cols >= 0) & (rot_cols < ROT_R)).all()),
                  f"rotations step {i}: best_pix rotation columns {rot_cols.tolist()}")
            check(math.isfinite(loss), f"rotations step {i}: loss {loss}")
            for name, t in (("label_value", m.label_value),
                            ("predicted_value", m.predicted_value)):
                check(_finite(t), f"rotations step {i}: non-finite {name}")
            after = _gs_head_state(trainer.model)
            moved = {k: not torch.equal(v, after[k]) for k, v in before.items()}
            if ets:
                ets_steps += 1
                check(all(moved[k] for k in moved if not k.endswith("num_batches_tracked")),
                      f"rotations step {i}: an ETS batch left gs_head's "
                      f"{[k for k, v in moved.items() if not v]}")
            steps.append({"step": i, "testing": step_cfg.env.is_testing, "seconds": total,
                          "loss": loss, "phases": {k: round(v, 6) for k, v in phases.items()},
                          "actions": m.action.tolist(), "ets_batch": ets,
                          "rotations": rot_cols.tolist()})
            print(f"rotations {'act' if step_cfg.env.is_testing else 'train'} step {i}: "
                  f"{total:.3f} s  " + "  ".join(f"{k} {v:.3f}" for k, v in phases.items())
                  + f"  loss {loss:.5f}  ETS batch {ets}  rotations used "
                  f"{sorted(set(rot_cols.flatten().tolist()))}")
    torch.cuda.synchronize()
    counts = read_counts()
    check(ets_steps > 0, "rotations: no training step's batch executed an ETS action")
    n_calls = len(calls.images)
    short = {name.split()[0]: n for name, n in counts.items()}
    print(f"launches in the rotations path ({n_calls} eval trunk calls, "
          f"{sum(calls.images)} images): " + ", ".join(f"{k} {n}" for k, n in short.items()))
    blocks = sum(trainer.model.grasp_trunk.block_config)
    for name, want in (("K4", n_calls), ("K3", 3 * n_calls), ("K2", blocks * n_calls)):
        check(short[name] == want, f"rotations: {name} launched {short[name]}, the "
              f"{n_calls} trunk calls imply {want}")
    for k in kernels:
        k["launches_rotations"] = counts[k["name"]]
        if k["name"].split()[0] in ROT_KERNELS:
            check(counts[k["name"]] > 0, f"{k['name']} was not launched by the rotations path")
    act_r1 = DETAIL.get("act_path", {}).get("steps", [])
    print("rotations: the act step's phases at R = 16 "
          + "  ".join(f"{k} {v:.3f}" for k, v in steps[0]["phases"].items())
          + (" beside the act path's (R = 1, no ETS) " + "  ".join(
              f"{k} {v:.3f}" for k, v in act_r1[-1]["phases"].items()) if act_r1 else ""))
    DETAIL["rotations_path"] = {**res, "steps": steps, "launches": counts,
                                "trunk_calls": calls.images, "ets_steps": ets_steps}
    del trainer, state


def update_modes_on_snapshot(dev, path: str) -> dict:
    """compare_update_modes at a trained run's weights: the CLI's held
    training config (python -m smg_tpu_torch.cli.main --is_ets --is_pe
    --is_oo --batch_size 32) with the update through K6, the snapshot
    loaded into both nets, two training steps for an experience of the
    trained net's own choices, then the comparison."""
    from smg_tpu_torch.train import checkpoints, loop
    from smg_tpu_torch.train.trainer import Trainer
    from smg_tpu_torch.utils import config as cfg_mod

    cfg = cfg_mod.parse_args([*CLI_FLAGS])
    trainer = Trainer(dataclasses.replace(cfg.train, fast_train_conv2="pk"), device=dev)
    state = loop.init_loop(SEED + 1, trainer, cfg.loop)
    checkpoints.load_snapshot(trainer, path)
    for _ in range(2):
        state, _ = loop.train_step(trainer, cfg.loop, state)
    return compare_update_modes(trainer, state)


def _kernel_phase(fn):
    """A kernel phase as a step of main: its kernel rows go to the table."""
    def step(ctx):
        rows = fn(ctx["dev"])
        ctx["kernels"].extend(rows if isinstance(rows, list) else [rows] if rows else [])
    step.phase = fn
    return step


def _act(ctx):
    trainer, cfg, state, step_seconds = drive_act_path(ctx["dev"], ctx["kernels"])
    if ctx["profile"]:
        profile_act_step(trainer, cfg, state, step_seconds, ctx["out"])
    ctx["act"] = trainer, cfg, state


def _vmap(ctx):
    drive_vmap_path(ctx["kernels"], *ctx.pop("act"))


def _parity(ctx):
    runs, parity_failed = drive_decision_parity(ctx["dev"], ctx["kernels"])
    with wall_clock("trunk_passes"):
        phase_trunk_passes(runs)
    check(not parity_failed,
          f"decision parity failed for (input, backend, style) {parity_failed}")


def _detail(key, fn):
    """A measurement phase as a step of main: fn(dev) to DETAIL[key]."""
    def step(ctx):
        DETAIL[key] = fn(ctx["dev"])
    return step


# What main runs, in order: the kernel phases (each kernel against its
# plain version), then the nine paths, each driven with the launch counts
# set to 0 just before it and read just after (a subprocess's in it), and
# the in-process timings of the perception and pretraining paths.
PHASES = (
    ("phase_contact", _kernel_phase(phase_contact)),
    ("phase_dense_layer", _kernel_phase(phase_dense_layer)),
    ("phase_transition", _kernel_phase(phase_transition)),
    ("phase_stem", _kernel_phase(phase_stem)),
    ("phase_conv2", _kernel_phase(phase_conv2)),
    ("phase_dense_layer_train", _kernel_phase(phase_dense_layer_train)),
    ("phase_dense_block", _kernel_phase(phase_dense_block)),
    ("phase_dense_block_train", _kernel_phase(phase_dense_block_train)),
    ("phase_index_limits", _kernel_phase(phase_index_limits)),
    ("act", _act),
    ("vmap", _vmap),
    ("train", lambda ctx: drive_train_path(ctx["dev"], ctx["kernels"])),
    ("parity", _parity),
    ("rotations", lambda ctx: drive_rotations_path(ctx["dev"], ctx["kernels"])),
    ("phase_segmenter", _detail("segmenter", phase_segmenter)),
    ("phase_pretrain_step", _detail("pretrain_step", phase_pretrain_step)),
    ("cli", lambda ctx: drive_cli_path(ctx["kernels"])),
    ("perception", lambda ctx: drive_perception_path(ctx["kernels"])),
    ("pretrain", lambda ctx: drive_pretrain_path(ctx["dev"], ctx["kernels"])),
    ("sharded", lambda ctx: drive_sharded_path(ctx["kernels"])),
)
PATHS = ("act", "train", "parity", "cli", "perception", "pretrain", "vmap", "sharded",
         "rotations")
# Paths whose device work runs in subprocesses and in no other in-process
# phase's time or counts: main runs them side by side, one thread each (the
# pretraining path's in-process update sees their load). Their subprocess
# step times are not one run's alone.
SIDE_BY_SIDE = ("cli", "perception", "pretrain", "sharded")


def run_phases(ctx) -> None:
    """PHASES in order, SIDE_BY_SIDE's run together; each phase's wall
    seconds to SECONDS (those run together overlap: their group's own wall
    time is under the names joined by "+")."""
    def run(name, step):
        _PHASE.name = name
        t0 = time.perf_counter()
        try:
            step(ctx)
            torch.cuda.synchronize()
        finally:
            SECONDS[name] = time.perf_counter() - t0
            _PHASE.name = ""
        print(f"phase {name}: {SECONDS[name]:.1f} s", flush=True)

    group = [(n, st) for n, st in PHASES if n in SIDE_BY_SIDE]
    for name, step in PHASES:
        if name not in SIDE_BY_SIDE:
            run(name, step)
        elif name == group[0][0]:
            t0 = time.perf_counter()
            side_by_side({n: (lambda n=n, st=st: run(n, st)) for n, st in group})
            SECONDS["+".join(n for n, _ in group)] = time.perf_counter() - t0
        torch.cuda.empty_cache()


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the details (JSON, profiler table)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more act step, time the physics step")
    ap.add_argument("--update_snapshot", default="",
                    help="only compare the update's modes at this run snapshot's "
                         "weights (update_modes_on_snapshot), after the build")
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
    build_s = SECONDS["build"] = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s (nvcc: "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    DETAIL["build_seconds"] = build_s
    DETAIL["build_log"] = _build.build_log
    if args.update_snapshot:
        res = update_modes_on_snapshot(dev, args.update_snapshot)
        print(json.dumps({"update_modes_snapshot": res, "card": card}, default=str))
        return

    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    ctx = {"dev": dev, "kernels": [], "profile": args.profile, "out": args.out}
    run_phases(ctx)
    kernels = ctx["kernels"]

    SECONDS["total"] = time.perf_counter() - T_START
    DETAIL["card"] = card
    DETAIL["kernels"] = kernels
    DETAIL["phase_seconds"] = SECONDS
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(DETAIL, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_b1024",
            "bound_ms_b1024")
    print(json.dumps({"phase_seconds": SECONDS}))
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in keys if k in kern},
         "launches_by_path": {p: kern[f"launches_{p}"] for p in PATHS}}
        for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
