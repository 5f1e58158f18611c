"""Move state between the JAX package and the port, through numpy.

The JAX side hands over nested dicts of numpy arrays (the caller does the
`jax.device_get` and dataclass-to-dict conversion); this module imports
neither jax nor flax.

- `scene_from_numpy` / `scene_to_numpy`: a batched `Scene` pytree
  ({"objects": {...}, "gripper": {...}, "t": ...}) to the port's Scene and
  back.
- `load_affordance_params`: Flax AffordanceNet `params` + `batch_stats`
  into the port's AffordanceNet. Flax conv kernels are HWIO and become
  OIHW; BatchNorm scale/bias/mean/var map to weight/bias/running_mean/
  running_var. The tied ETS head (affordance.py:54) is carried over as it
  is: gs_head gets its own (unused) weights, and the model reads
  suction_head for style 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smg_tpu_torch.physics.state import Gripper, Objects, Scene

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.array(a, copy=True)
    return torch.as_tensor(a, device=device).to(_DTYPES[a.dtype])


def scene_from_numpy(tree: dict, device="cpu") -> Scene:
    """A batched JAX Scene, as nested dicts of numpy arrays -> Scene."""
    objs = {f.name: to_tensor(tree["objects"][f.name], device)
            for f in dataclasses.fields(Objects)}
    grip = {f.name: to_tensor(tree["gripper"][f.name], device)
            for f in dataclasses.fields(Gripper)}
    return Scene(objects=Objects(**objs), gripper=Gripper(**grip),
                 t=to_tensor(tree["t"], device))


def scene_to_numpy(scene: Scene) -> dict:
    """The port's Scene -> nested dicts of numpy arrays (JAX field names)."""
    def dump(dc):
        return {f.name: getattr(dc, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(dc)}
    return {"objects": dump(scene.objects), "gripper": dump(scene.gripper),
            "t": scene.t.detach().cpu().numpy()}


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.as_tensor(np.array(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} -> {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dst.device))


def _load_conv(conv: torch.nn.Conv2d, p: dict) -> None:
    _copy(conv.weight, np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))


def _load_bn(bn: torch.nn.BatchNorm2d, p: dict, s: dict) -> None:
    _copy(bn.weight, p["scale"])
    _copy(bn.bias, p["bias"])
    _copy(bn.running_mean, s["mean"])
    _copy(bn.running_var, s["var"])


def load_module(module: torch.nn.Module, params: dict, stats: dict) -> None:
    """Copy a Flax subtree into a port module whose children carry the
    Flax names (conv*, norm*, denseblock*/denselayer*, transition*)."""
    for name, child in module.named_children():
        if name not in params:
            raise KeyError(f"missing Flax subtree {name!r}")
        if isinstance(child, torch.nn.Conv2d):
            _load_conv(child, params[name])
        elif isinstance(child, torch.nn.BatchNorm2d):
            _load_bn(child, params[name], stats[name])
        else:
            load_module(child, params[name], stats.get(name, {}))


def load_affordance_params(model, params: dict, batch_stats: dict) -> None:
    """Flax AffordanceNet params + batch_stats -> the port's AffordanceNet."""
    for name in ("grasp_trunk", "suction_trunk", "gs_trunk",
                 "grasp_head", "suction_head", "gs_head"):
        load_module(getattr(model, name), params[name], batch_stats[name])
