"""Scene state: small dataclasses of batched tensors.

Port of smg_tpu/physics/state.py. Every field carries a leading scene
axis B (JAX added it with vmap): Objects fields are (B, N, ...), Gripper
fields (B, ...), Scene.t is (B,).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from smg_tpu_torch.physics import shapes

N_SLOTS = 12

KIND_ENVELOPING = 0
KIND_SUCKING = 1

FREE = 0
ATTACHED_GRASP = 1
ATTACHED_SUCTION = 2

WORKSPACE = np.array([[-0.724, -0.276], [-0.224, 0.224], [-0.0001, 0.4]])
LIFT_SUCCESS_Z = 0.11
DROP_Z = 0.08
PARK_POS = np.array([-0.5, 0.5, 0.1])


class SceneSlice(NamedTuple):
    """The scenes [lo, hi) that one process holds of a batch of `total`
    (parallel/mesh.py::scene_slice). Random draws shaped by the batch are
    made for all `total` scenes and then cut, so each process holds the
    draws of its scenes in the one-process run."""

    lo: int
    hi: int
    total: int

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.lo:self.hi]


class _Batched:
    """Field-wise helpers shared by the state dataclasses."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn, *others):
        """New instance with fn(field, *others' fields) per field."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            ov = [getattr(o, f.name) for o in others]
            out[f.name] = v.map(fn, *ov) if isinstance(v, _Batched) else fn(v, *ov)
        return type(self)(**out)

    def where(self, cond: torch.Tensor, other):
        """Per-scene select: cond (B,) True takes `other`'s fields."""
        def sel(a, b):
            c = cond.reshape(cond.shape + (1,) * (a.dim() - 1))
            return torch.where(c, b, a)
        return self.map(sel, other)


@dataclass
class Objects(_Batched):
    pos: torch.Tensor          # (B, N, 3)
    quat: torch.Tensor         # (B, N, 4)
    vel: torch.Tensor          # (B, N, 3)
    omega: torch.Tensor        # (B, N, 3)
    shape_type: torch.Tensor   # (B, N) int32
    half_extents: torch.Tensor  # (B, N, 3)
    color: torch.Tensor        # (B, N, 3)
    kind: torch.Tensor         # (B, N) int32
    active: torch.Tensor       # (B, N) bool
    removed: torch.Tensor      # (B, N) bool
    attached: torch.Tensor     # (B, N) int32
    attach_pos: torch.Tensor   # (B, N, 3)
    attach_quat: torch.Tensor  # (B, N, 4)
    mass: torch.Tensor         # (B, N)
    inertia: torch.Tensor      # (B, N, 3)
    sph_offsets: torch.Tensor  # (B, N, K, 3)
    sph_radii: torch.Tensor    # (B, N, K)

    @staticmethod
    def empty(B: int, device, n: int = N_SLOTS) -> "Objects":
        K = shapes.SPHERES_PER_OBJECT
        f = dict(dtype=torch.float32, device=device)
        i = dict(dtype=torch.int32, device=device)
        pos = torch.zeros(B, n, 3, **f)
        pos[..., 2] = -10.0
        quat = torch.zeros(B, n, 4, **f)
        quat[..., 0] = 1.0
        return Objects(
            pos=pos, quat=quat,
            vel=torch.zeros(B, n, 3, **f), omega=torch.zeros(B, n, 3, **f),
            shape_type=torch.zeros(B, n, **i),
            half_extents=torch.full((B, n, 3), 0.01, **f),
            color=torch.full((B, n, 3), 0.5, **f),
            kind=torch.zeros(B, n, **i),
            active=torch.zeros(B, n, dtype=torch.bool, device=device),
            removed=torch.zeros(B, n, dtype=torch.bool, device=device),
            attached=torch.zeros(B, n, **i),
            attach_pos=torch.zeros(B, n, 3, **f), attach_quat=quat.clone(),
            mass=torch.ones(B, n, **f),
            inertia=torch.full((B, n, 3), 1e-4, **f),
            sph_offsets=torch.zeros(B, n, K, 3, **f),
            sph_radii=torch.full((B, n, K), 0.01, **f),
        )

    @property
    def on_table(self) -> torch.Tensor:
        return self.active & ~self.removed


@dataclass
class Gripper(_Batched):
    pos: torch.Tensor   # (B, 3)
    yaw: torch.Tensor   # (B,)
    tilt: torch.Tensor  # (B, 2)
    curl: torch.Tensor  # (B,)

    @staticmethod
    def home(B: int, device) -> "Gripper":
        f = dict(dtype=torch.float32, device=device)
        return Gripper(
            pos=torch.tensor([-0.5, 0.0, 0.3], **f).expand(B, 3).clone(),
            yaw=torch.zeros(B, **f), tilt=torch.zeros(B, 2, **f),
            curl=torch.zeros(B, **f),
        )

    def tool_rotm(self) -> torch.Tensor:
        """(B, 3, 3) = Rz(yaw) @ Rx(tilt0) @ Ry(tilt1) (state.py:143-147)."""
        from smg_tpu_torch.core import rotation as rot

        Rz = rot.angle_axis2rotm(self.yaw, [0.0, 0.0, 1.0])
        Rx = rot.angle_axis2rotm(self.tilt[:, 0], [1.0, 0.0, 0.0])
        Ry = rot.angle_axis2rotm(self.tilt[:, 1], [0.0, 1.0, 0.0])
        return Rz @ Rx @ Ry


@dataclass
class Scene(_Batched):
    objects: Objects
    gripper: Gripper
    t: torch.Tensor  # (B,) int32

    @property
    def batch_size(self) -> int:
        return self.t.shape[0]

    @property
    def device(self):
        return self.t.device
