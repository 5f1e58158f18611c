"""Heightmap geometry constants (the parts of smg_tpu/core/camera.py that
the action geometry reads: camera.py:51-55)."""

from __future__ import annotations

import numpy as np

HEIGHTMAP_SIZE = 224

# Workspace limits, reference code/main.py:31.
WORKSPACE_LIMITS = np.array(
    [[-0.724, -0.276], [-0.224, 0.224], [-0.0001, 0.4]], dtype=np.float32
)
HEIGHTMAP_RESOLUTION = 0.002  # m / px, reference main.py:433
