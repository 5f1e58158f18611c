"""ctypes bindings for the native host library's binary row log (port of
the loader and AsyncBinaryLog of smg_tpu/utils/native.py).

The library is built from the repository's native/ sources (`make -C
native`, libsmg_host.so) on first use where a C++ toolchain is present;
the build goes to a private directory and is moved into place in one
step, so a process never loads a half-written library. `load_library`
returns None when it cannot build or load, and callers then skip the
binary mirror.

- `AsyncBinaryLog`   background-thread logger of length-prefixed float32
                     rows (the C++ writer thread of native/smg_host)
- `read_binary_log`  reads such a file back

The mesh fitter and the sphere compound of the same library wait for mesh
ingest (ROADMAP.md section 1, item 2).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
LIB_PATH = os.path.join(NATIVE_DIR, "build", "libsmg_host.so")

_lib = None


def _try_build() -> bool:
    """make -C native into a private directory, then move the library to
    LIB_PATH; False when there is no toolchain or the build fails."""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-", dir=os.path.dirname(LIB_PATH))
    try:
        subprocess.run(["make", "-C", NATIVE_DIR, f"BUILD={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(os.path.join(tmp, "libsmg_host.so"), LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library():
    """Load (and on first use build) libsmg_host.so; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(LIB_PATH) and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.smg_log_open.argtypes = [ctypes.c_char_p]
    lib.smg_log_open.restype = ctypes.c_void_p
    lib.smg_log_append.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int32
    ]
    lib.smg_log_append.restype = ctypes.c_int
    lib.smg_log_close.argtypes = [ctypes.c_void_p]
    lib.smg_log_close.restype = ctypes.c_int
    _lib = lib
    return lib


class AsyncBinaryLog:
    """Background-thread binary row logger backed by the native library:
    length-prefixed float32 records. Raises if the library is unavailable."""

    def __init__(self, path: str):
        lib = load_library()
        if lib is None:
            raise RuntimeError("libsmg_host.so unavailable")
        self._lib = lib
        self._handle = lib.smg_log_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open {path}")

    def append(self, row) -> None:
        arr = np.ascontiguousarray(row, np.float32).ravel()
        self._lib.smg_log_append(
            self._handle,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            arr.size,
        )

    def close(self) -> None:
        """Drain the writer thread and close the file."""
        if self._handle:
            self._lib.smg_log_close(self._handle)
            self._handle = None


def read_binary_log(path: str) -> list[np.ndarray]:
    """Read back an AsyncBinaryLog file as a list of float32 arrays."""
    rows = []
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            n = int(np.frombuffer(head, np.uint32)[0])
            rows.append(np.frombuffer(f.read(4 * n), np.float32).copy())
    return rows
