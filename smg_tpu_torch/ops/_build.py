"""Build and load the port's CUDA kernels.

Each source under smg_tpu_torch/csrc/ compiles with its own nvcc process
for sm_90a, all started together; the objects link into one shared
library with a plain C interface, loaded through ctypes. The
library is named by a digest of the sources, so an edited kernel rebuilds
and an unchanged one is reused. The build directory (smg_tpu_torch/_build/)
is ignored by git. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None
build_seconds = None   # wall time of the build in this process (None: reused)
build_log = ""         # nvcc's output, ptxas register/smem report included

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry points: name -> argument types. Every entry returns the
# cudaGetLastError() code right after its launches (0 = success).
SIGNATURES = {
    # rows (9,S,B), cols (9,T,B), out (3,S,B); S, T, B, K; 8 gains; the
    # plan's scenes, rows, chunks, slab, smem bytes; stream
    "smg_contact_forces": [P, P, P, I, I, I, I] + [F] * 8 + [I] * 5 + [P],
    # y, a, b, out; N, H, W, C, out_ld; stream
    "smg_stem_pool": [P, P, P, P, I, I, I, I, I, P],
    # x, a, b, wt, out; N, H, W, C, x_ld, C_out, out_ld; the tile plan (5
    # ints, transition.TransitionPlan.args); stream
    "smg_transition": [P] * 5 + [I] * 7 + [I] * 5 + [P],
    # buf, a1, b1, w1, a2, b2, w2, h2 scratch; N, H, W, ld, C_in; the
    # GEMM's tile rows; the 3x3 plan (5 ints, conv2.Conv3x3Plan.args); stream
    "smg_dense_layer": [P] * 8 + [I] * 6 + [I] * 5 + [P],
    # h1, a, b, w2, out; N, H, W, out_ld; the tile plan (5 ints,
    # conv2.conv2_plan); stream
    "smg_conv2_bn_relu": [P] * 5 + [I] * 4 + [I] * 5 + [P],
    # buf, a1, b1, w1, a2, b2, w2, at, bt, wt, out; N, H, W, C0, L, C_out,
    # out_ld, epilogue, taps_packed; the fused layer's tile plan (5 ints,
    # dense_block.dense_plan); the transition's plan (zeros for final_bn);
    # stream
    "smg_dense_block": [P] * 11 + [I] * 9 + [I] * 5 + [I] * 5 + [P],
    # buf, w1, s1, bi1, w2, s2, bi2, h1, block moments, st2, h1 sums
    # scratch; N, H, W, ld, C_in, the moments' row stride, channels with
    # moments already; the GEMM's tile rows and image slots; the h1
    # moments' splits and chunk; the 3x3 plan; stream
    "smg_dense_layer_train_fwd": [P] * 11 + [I] * 9 + [I] * 2 + [I] * 5 + [P],
    # buf, dbuf, h1, w1, w2, s1, bi1, mean1, var1; mean1's row stride; s2,
    # bi2, mean2, var2, aff1, aff2, dc, du2, dh1, part_dy2, part_dy1, sums1,
    # sums2, part_w1, part_w2, grads; N, H, W, ld, C_in; the dy2 and dw2
    # plans (4 ints each, dense_layer_train.TilePlan.args); dw1's splits,
    # chunk; dy1's tile rows and image slots; stream
    "smg_dense_layer_train_bwd": [P] * 9 + [I] + [P] * 16 + [I] * 5 + [I] * 8 + [I] * 4 + [P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        cand.append(which)
    for c in cand:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for s in _sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile_and_link(so: Path) -> str:
    """One nvcc per source, all started together, then one link into `so`.
    Returns the compilers' output (ptxas register/smem report included)."""
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-lineinfo", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(cmd[-1])
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append("link")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    (BUILD_DIR / "build.log").write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{text}")
    os.replace(tmp, so)
    return text


def library() -> ctypes.CDLL:
    """The loaded kernel library; builds it first if this digest is new."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libsmg_kernels_{_digest()}.so"
    if not so.exists():
        t0 = time.perf_counter()
        build_log = _compile_and_link(so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def launch(name: str, *args) -> None:
    """Call a C entry point on the current stream; raise on a launch error."""
    fn = getattr(library(), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_nhwc_view(out: torch.Tensor, name: str, dtype, shape) -> int:
    """A CUDA (N, H, W, C) tensor that may be a channel slice [..., :C] of
    a wider NHWC buffer; returns its pixel stride (16-byte aligned)."""
    check_cuda(out, name, dtype, shape, contiguous=False)
    N, H, W, C = shape
    ld = out.stride(2)
    if (out.stride(3) != 1 or out.stride(1) != W * ld
            or out.stride(0) != H * W * ld or ld % 8 or out.data_ptr() % 16):
        raise ValueError(f"{name}: expected an NHWC channel slice with a "
                         f"pixel stride divisible by 8, got {out.stride()}")
    return ld


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the tile plans' target)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_aligned(**tensors) -> None:
    """Operands that the kernels copy 16 bytes at a time (cp.async) must
    start on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def check_int32(name: str, count: int) -> None:
    """The kernels index elements with 32-bit ints: an operand's extent in
    elements must stay below 2^31."""
    if count >= 2 ** 31:
        raise ValueError(f"{name}: {count} elements; the kernels take fewer than 2^31")


def check_cuda(t: torch.Tensor, name: str, dtype, shape=None,
               contiguous: bool = True) -> None:
    """Wrapper-side argument check for a kernel operand."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
