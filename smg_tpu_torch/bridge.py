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
  running_var. All three heads are carried, gs_head included: the model
  reads it for style 2 when ModelConfig.tied_ets_head is False, and
  suction_head when it is True (affordance.py:54, :126-130).
  `dump_affordance_params` goes back.
  The tiny trunk's children carry the Flax names too (conv0-4, norm0-4,
  proj), so the same functions carry a tiny-trunk AffordanceNet.
- `load_segmenter_params` / `dump_segmenter_params`: Flax SlotSegmenter
  `params` (Conv_k kernel + bias, GroupNorm_k scale + bias) to the port's
  SlotSegmenter, whose children carry the same auto names, and back.
- `load_reconstruction_params` / `dump_reconstruction_params`: a Flax
  ReconstructionModel's `params` + `batch_stats` (trunk, dec0-dec4 and
  out, whose convs carry biases) into the port's module, by name, and
  back.
- `load_trainer_state` / `trainer_state_to_numpy`: a JAX TrainerState
  (online and target params + batch_stats, optax's ScaleByAdamState
  count/mu/nu, the iteration) into a port Trainer's two nets and
  torch.optim.Adam state (step, exp_avg, exp_avg_sq per parameter, with
  the same HWIO -> OIHW transposes), and back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smg_tpu_torch.physics.state import Gripper, Objects, Scene

AFFORDANCE_PARTS = ("grasp_trunk", "suction_trunk", "gs_trunk",
                    "grasp_head", "suction_head", "gs_head")

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
    for name in AFFORDANCE_PARTS:
        load_module(getattr(model, name), params[name], batch_stats[name])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def param_slots(model, prefix=()):
    """(Flax path, torch parameter, is_conv_kernel) for every parameter of
    the AffordanceNet (or of a module whose children carry Flax names)."""
    children = ([(n, getattr(model, n)) for n in AFFORDANCE_PARTS] if not prefix
                else model.named_children())
    for name, child in children:
        path = prefix + (name,)
        if isinstance(child, torch.nn.Conv2d):
            yield path + ("kernel",), child.weight, True
        elif isinstance(child, torch.nn.BatchNorm2d):
            yield path + ("scale",), child.weight, False
            yield path + ("bias",), child.bias, False
        else:
            yield from param_slots(child, path)


def to_flax(t: torch.Tensor, conv: bool) -> np.ndarray:
    a = _np(t)
    return np.transpose(a, (2, 3, 1, 0)) if conv else a


def from_flax(a, conv: bool) -> torch.Tensor:
    a = np.array(a, np.float32)
    return torch.as_tensor(np.transpose(a, (3, 2, 0, 1)) if conv else a)


def dump_affordance_params(model) -> tuple[dict, dict]:
    """The port's AffordanceNet -> Flax-layout (params, batch_stats) numpy trees."""
    params, stats = {}, {}
    for path, p, conv in param_slots(model):
        _set(params, path, to_flax(p, conv))
    for name in AFFORDANCE_PARTS:
        for mod_name, m in getattr(model, name).named_modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                path = (name, *mod_name.split("."))
                _set(stats, path + ("mean",), _np(m.running_mean))
                _set(stats, path + ("var",), _np(m.running_var))
    return params, stats


def load_segmenter_params(model, params: dict) -> None:
    """Flax SlotSegmenter params -> the port's SlotSegmenter."""
    for name, child in model.named_children():
        p = params[name]
        if isinstance(child, torch.nn.Conv2d):
            _load_conv(child, p)
            _copy(child.bias, p["bias"])
        else:
            _copy(child.weight, p["scale"])
            _copy(child.bias, p["bias"])


def dump_segmenter_params(model) -> dict:
    """The port's SlotSegmenter -> Flax-layout params (numpy)."""
    out = {}
    for name, child in model.named_children():
        if isinstance(child, torch.nn.Conv2d):
            out[name] = {"kernel": to_flax(child.weight, True), "bias": _np(child.bias)}
        else:
            out[name] = {"scale": _np(child.weight), "bias": _np(child.bias)}
    return out


def load_reconstruction_params(model, params: dict, batch_stats: dict) -> None:
    """Flax ReconstructionModel params + batch_stats -> the port's
    ReconstructionModel (train/pretrain.py)."""
    load_module(model.trunk, params["trunk"], batch_stats.get("trunk", {}))
    for name, child in model.named_children():
        if isinstance(child, torch.nn.Conv2d):
            _load_conv(child, params[name])
            _copy(child.bias, params[name]["bias"])


def dump_reconstruction_params(model) -> tuple[dict, dict]:
    """The port's ReconstructionModel -> Flax-layout (params, batch_stats)."""
    params, stats = {}, {}
    for path, p, conv in param_slots(model.trunk, ("trunk",)):
        _set(params, path, to_flax(p, conv))
    for mod_name, m in model.trunk.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            path = ("trunk", *mod_name.split("."))
            _set(stats, path + ("mean",), _np(m.running_mean))
            _set(stats, path + ("var",), _np(m.running_var))
    for name, child in model.named_children():
        if isinstance(child, torch.nn.Conv2d):
            params[name] = {"kernel": to_flax(child.weight, True), "bias": _np(child.bias)}
    return params, stats


def load_trainer_state(trainer, tree: dict):
    """A JAX TrainerState as numpy trees -> the port's Trainer; returns the
    port's TrainerState. tree = {"params", "batch_stats", "target_params",
    "target_stats", "adam": {"count", "mu", "nu"}, "iteration"}, where
    adam holds optax ScaleByAdamState's fields (mu, nu shaped as params)."""
    from smg_tpu_torch.train.trainer import TrainerState

    load_affordance_params(trainer.model, tree["params"], tree["batch_stats"])
    load_affordance_params(trainer.target, tree["target_params"], tree["target_stats"])
    opt = trainer.new_optimizer()
    adam = tree["adam"]
    for path, p, conv in param_slots(trainer.model):
        opt.state[p] = {
            "step": torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32),
            "exp_avg": from_flax(_get(adam["mu"], path), conv).to(p.device),
            "exp_avg_sq": from_flax(_get(adam["nu"], path), conv).to(p.device),
        }
    trainer.opt = opt
    return TrainerState(iteration=int(np.asarray(tree["iteration"])))


def trainer_state_to_numpy(trainer, state) -> dict:
    """The port's Trainer + TrainerState -> load_trainer_state's tree."""
    params, stats = dump_affordance_params(trainer.model)
    tparams, tstats = dump_affordance_params(trainer.target)
    mu, nu, count = {}, {}, 0
    for path, p, conv in param_slots(trainer.model):
        st = trainer.opt.state.get(p, {})
        if st:
            count = int(st["step"])
        _set(mu, path, to_flax(st["exp_avg"], conv) if st else np.zeros_like(to_flax(p, conv)))
        _set(nu, path, to_flax(st["exp_avg_sq"], conv) if st else np.zeros_like(to_flax(p, conv)))
    return {"params": params, "batch_stats": stats, "target_params": tparams,
            "target_stats": tstats, "adam": {"count": np.int32(count), "mu": mu, "nu": nu},
            "iteration": np.int32(state.iteration)}
