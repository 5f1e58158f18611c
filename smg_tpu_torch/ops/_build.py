"""Build and load the port's CUDA kernels.

All sources under smg_tpu_torch/csrc/ compile with nvcc for sm_90a into
one shared library with a plain C interface, loaded through ctypes. The
library is named by a digest of the sources, so an edited kernel rebuilds
and an unchanged one is reused. The build directory (smg_tpu_torch/_build/)
is ignored by git. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
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
    # rows (9,S,B), cols (9,T,B), out (3,S,B); S, T, B, K; 8 gains; stream
    "smg_contact_forces": [P, P, P, I, I, I, I] + [F] * 8 + [P],
    # y, a, b, out; N, H, W, C, out_ld; stream
    "smg_stem_pool": [P, P, P, P, I, I, I, I, I, P],
    # x, a, b, wt, out; N, H, W, C, x_ld, C_out, out_ld; stream
    "smg_transition": [P, P, P, P, P, I, I, I, I, I, I, I, P],
    # buf, a1, b1, w1, a2, b2, w2, h2 scratch; N, H, W, ld, C_in; stream
    "smg_dense_layer": [P] * 8 + [I, I, I, I, I, P],
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
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
            "-o", str(tmp), *[str(s) for s in sorted(CSRC.glob("*.cu"))],
        ]
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + build_log)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)
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
