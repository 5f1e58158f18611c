"""Mesh-directory ingest: the --obj_mesh_dir path (port of
smg_tpu/utils/meshes.py).

The reference scans datasets/<set>/{enveloping,sucking} for .obj meshes
(reference robot.py:36-49). Here a mesh directory is read once on the
host: each mesh is fitted to an analytic primitive by the native library
(utils/native.py, with its pure-Python twin), giving the same catalog
arrays as the procedural catalogs of physics/shapes.py, which the scene
sampler takes either way.
"""

from __future__ import annotations

import os

import numpy as np

from smg_tpu_torch.utils import native


def load_catalog(directory: str, density: float = 300.0):
    """Fit every .obj under `directory`, in sorted order -> (types (M,)
    int32, half_extents (M, 3) float32)."""
    files = sorted(
        f for f in os.listdir(directory)
        if os.path.splitext(f)[1] == ".obj"  # robot.py:44-49 filter
    )
    if not files:
        raise FileNotFoundError(f"no .obj meshes under {directory}")
    fits = [native.fit_obj(os.path.join(directory, f), density) for f in files]
    return (np.asarray([f.shape_type for f in fits], np.int32),
            np.asarray([f.half_extents for f in fits], np.float32))


def load_object_sets(obj_mesh_dir: str):
    """The enveloping / sucking split of the reference (robot.py:36-37):
    ((types_g, he_g), (types_s, he_s))."""
    return (load_catalog(os.path.join(obj_mesh_dir, "enveloping")),
            load_catalog(os.path.join(obj_mesh_dir, "sucking")))
