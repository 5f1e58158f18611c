"""ctypes bindings for the native host library (port of
smg_tpu/utils/native.py).

The library is built from the repository's native/ sources (`make -C
native`, libsmg_host.so) on first use where a C++ toolchain is present;
the build goes to a private directory and is moved into place in one
step, so a process never loads a half-written library. `load_library`
returns None when it cannot build or load; the mesh fitter then takes its
pure-Python twin, and the logger's callers skip the binary mirror.

- `fit_obj`          .obj mesh -> fitted primitive, mass and inertia
                     (`smg_fit_obj`; `_fit_obj_python` without the library,
                     with the same fitting rules)
- `sphere_compound_native`  the 9-sphere collision proxy of a primitive
                     (`smg_sphere_compound`); None without the library
- `AsyncBinaryLog`   background-thread logger of length-prefixed float32
                     rows (the C++ writer thread of native/smg_host)
- `read_binary_log`  reads such a file back
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from dataclasses import dataclass

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
LIB_PATH = os.path.join(NATIVE_DIR, "build", "libsmg_host.so")

BOX, CYLINDER, SPHERE = 0, 1, 2


class _FitResult(ctypes.Structure):
    """native/smg_host/smg_host.cpp's FitResult, field for field."""

    _fields_ = [
        ("shape_type", ctypes.c_int32),
        ("half_extents", ctypes.c_float * 3),
        ("centroid", ctypes.c_float * 3),
        ("mass", ctypes.c_float),
        ("inertia", ctypes.c_float * 3),
        ("n_vertices", ctypes.c_int32),
        ("n_faces", ctypes.c_int32),
    ]


_lib = None


# Run in a child process on the freshly built library, with numpy loaded
# as in the loader's own process: fit an 8-vertex box. A toolchain can link
# a library that loads but crashes in its iostream code (seen with a
# relocated GCC behind $CXX, which is why the build names g++), and that
# would take the caller's process down.
_SELF_TEST = """
import ctypes, os, sys
import numpy
lib = ctypes.CDLL(sys.argv[1])
obj = os.path.join(os.path.dirname(sys.argv[1]), "box.obj")
with open(obj, "w") as f:
    f.write("".join(f"v {x} {y} {z}\\n" for x in (-1, 1) for y in (-1, 2) for z in (-3, 3)))
out = (ctypes.c_byte * 64)()
sys.exit(lib.smg_fit_obj(obj.encode(), ctypes.c_float(1.0), out))
"""


def _try_build() -> bool:
    """make -C native with g++ from PATH (the host compiler nvcc takes too)
    into a private directory, and move the library to LIB_PATH if it
    passes _SELF_TEST. False when there is no toolchain, the build fails or
    the library does not pass."""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-", dir=os.path.dirname(LIB_PATH))
    try:
        subprocess.run(["make", "-C", NATIVE_DIR, f"BUILD={tmp}", "CXX=g++"],
                       check=True, capture_output=True, timeout=120)
        lib = os.path.join(tmp, "libsmg_host.so")
        subprocess.run([sys.executable, "-c", _SELF_TEST, lib],
                       check=True, capture_output=True, timeout=60)
        os.replace(lib, LIB_PATH)
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
    lib.smg_fit_obj.argtypes = [
        ctypes.c_char_p, ctypes.c_float, ctypes.POINTER(_FitResult)
    ]
    lib.smg_fit_obj.restype = ctypes.c_int
    lib.smg_sphere_compound.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.smg_sphere_compound.restype = ctypes.c_int
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


@dataclass
class ObjFit:
    shape_type: int
    half_extents: np.ndarray  # (3,)
    centroid: np.ndarray      # (3,)
    mass: float
    inertia: np.ndarray       # (3,)
    n_vertices: int
    n_faces: int
    native: bool


def _fit_obj_python(path: str, density: float) -> ObjFit:
    """The fitter without the library, by the native fitter's rules
    (native.py:110-161): sphere for near-isotropic extents with a full
    radial fill, z-axis cylinder for a round, filled cross-section seen
    at >= 6 of 16 angle bins, box otherwise."""
    verts = []
    n_faces = 0
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                n_faces += 1
    v = np.asarray(verts)
    c = v.mean(axis=0)
    he = np.abs(v - c).max(axis=0)
    r_xy = np.linalg.norm(v[:, :2] - c[:2], axis=1)
    r_3d = np.linalg.norm(v - c, axis=1)
    iso = he.min() / max(he.max(), 1e-9)
    xy_iso = min(he[0], he[1]) / max(he[0], he[1])
    ang = np.arctan2(v[:, 1] - c[1], v[:, 0] - c[0])[r_xy > 1e-9]
    n_angle_bins = len(np.unique(((ang + np.pi) / (2 * np.pi) * 16)
                                 .astype(int).clip(0, 15)))
    if iso > 0.9 and r_3d.mean() > 0.8 * r_3d.max():
        st, he = SPHERE, np.full(3, r_3d.max())
    elif xy_iso > 0.9 and r_xy.mean() > 0.8 * r_xy.max() and n_angle_bins >= 6:
        st = CYLINDER
        he = np.array([r_xy.max(), r_xy.max(), he[2]])
    else:
        st = BOX
    hx, hy, hz = he
    if st == BOX:
        m = density * 8 * hx * hy * hz
        inertia = m / 3.0 * np.array(
            [hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy])
    elif st == CYLINDER:
        m = density * np.pi * hx * hx * 2 * hz
        ixy = m * (3 * hx * hx + 4 * hz * hz) / 12.0
        inertia = np.array([ixy, ixy, 0.5 * m * hx * hx])
    else:
        m = density * 4 / 3 * np.pi * hx ** 3
        inertia = np.full(3, 0.4 * m * hx * hx)
    return ObjFit(st, he.astype(np.float32), c.astype(np.float32), float(m),
                  inertia.astype(np.float32), len(v), n_faces, native=False)


def fit_obj(path: str, density: float = 300.0) -> ObjFit:
    """Fit a primitive to a .obj mesh: natively when the library loads,
    else by _fit_obj_python."""
    lib = load_library()
    if lib is None:
        return _fit_obj_python(path, density)
    res = _FitResult()
    if lib.smg_fit_obj(path.encode(), ctypes.c_float(density), ctypes.byref(res)) != 0:
        raise FileNotFoundError(f"smg_fit_obj failed for {path}")
    return ObjFit(
        shape_type=int(res.shape_type),
        half_extents=np.asarray(res.half_extents, np.float32).copy(),
        centroid=np.asarray(res.centroid, np.float32).copy(),
        mass=float(res.mass),
        inertia=np.asarray(res.inertia, np.float32).copy(),
        n_vertices=int(res.n_vertices),
        n_faces=int(res.n_faces),
        native=True,
    )


def sphere_compound_native(shape_type: int, half_extents: np.ndarray):
    """The native 9-sphere compound, (offsets (9, 3), radii (9,)); None
    without the library."""
    lib = load_library()
    if lib is None:
        return None
    he = np.ascontiguousarray(half_extents, np.float32)
    offs = np.zeros(27, np.float32)
    radii = np.zeros(9, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
    lib.smg_sphere_compound(shape_type, ptr(he), ptr(offs), ptr(radii))
    return offs.reshape(9, 3), radii


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
