"""Self-supervised trunk warm-start: masked-depth reconstruction (port of
smg_tpu/train/pretrain.py).

The reference initialized its DenseNet-121 trunks from ImageNet
(reference models.py:22,308, `pretrained=True`); no such weights are
available offline (PARITY.md deviation 4). The substitute is
self-supervision from the simulator: render scenes, hide random patches
of the depth heightmap, and train the trunk and a light decoder to
reconstruct the whole map. `load_pretrained_trunks` then puts the trained
trunk into all three affordance trunks, where the reference loaded
ImageNet weights.

- `ReconstructionModel`: the trunk (train-mode BatchNorm over the batch,
  models/densenet.py), five x2 nearest upsamplings each followed by a 3x3
  conv and ReLU, and a 1x1 conv to depth, in the model's dtype. Its
  children carry the Flax module's names (trunk, dec0-dec4, out), so
  bridge.load_reconstruction_params maps one onto the other.
- `init_reconstruction`: Flax's default init (lecun-normal kernels
  truncated at two standard deviations, zero biases, identity BatchNorm).
- `random_patch_mask`, `make_batch_fn` (spawn, a 50-step settle through
  the batched stepper, render, hide, preprocess) and `pretrain_step` (the
  MSE on the hidden patches in normalised depth, one Adam step).

Entry point: `python -m smg_tpu_torch.cli.pretrain_trunks`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from smg_tpu_torch.models.affordance import (
    DEPTH_MEAN,
    DEPTH_STD,
    ModelConfig,
    preprocess_depth,
)
from smg_tpu_torch.models.densenet import flax_init_, make_trunk, no_tf32

DECODER_WIDTHS = (256, 128, 64, 32, 16)
TRUNK_PARTS = ("grasp_trunk", "suction_trunk", "gs_trunk")


@dataclass(frozen=True)
class PretrainConfig:
    model: ModelConfig = field(default_factory=lambda: ModelConfig(input_size=224))
    patch: int = 32          # mask patch size (pixels)
    mask_ratio: float = 0.5  # share of patches hidden
    lr: float = 1e-3


class ReconstructionModel(nn.Module):
    """trunk -> stride-32 features -> light decoder -> depth map."""

    def __init__(self, cfg: PretrainConfig):
        super().__init__()
        self.cfg = cfg
        m = cfg.model
        self.trunk = make_trunk(m.trunk, m.tdtype, m.block_config)
        c = self.trunk.num_features
        for i, w in enumerate(DECODER_WIDTHS):
            self.add_module(f"dec{i}", nn.Conv2d(c, w, 3, padding=1))
            c = w
        self.out = nn.Conv2d(c, 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, S, S, 3) -> (B, S, S) f32 predicted normalised depth; with
        train=True the trunk's BatchNorm takes the batch's moments and
        updates its running statistics."""
        dt = self.cfg.model.tdtype
        h = self.trunk(x, train).permute(0, 3, 1, 2)
        with no_tf32():
            for i in range(len(DECODER_WIDTHS)):
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = torch.relu(conv_bias(h, getattr(self, f"dec{i}"), dt, padding=1))
            h = conv_bias(h, self.out, dt)
        return h[:, 0].float()


def conv_bias(h: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype, padding: int = 0):
    """Flax's nn.Conv(dtype=dt) with a bias on NCHW h: the convolution
    rounded to dt, then the bias (in dt) added and rounded again. A bias
    fused into the convolution would round once."""
    return F.conv2d(h, conv.weight.to(dt), padding=padding) + conv.bias.to(dt)[:, None, None]


def init_reconstruction(model: ReconstructionModel, generator: torch.Generator) -> None:
    """Flax's default init (densenet.flax_init_: lecun-normal kernels, zero
    biases, identity BatchNorm), from `generator`."""
    flax_init_(model, generator)


def random_patch_mask(gen: torch.Generator, size: int, patch: int, ratio: float,
                      batch: int | None = None) -> torch.Tensor:
    """(size, size) bool, or (batch, size, size): True where the input is
    HIDDEN, constant on each patch x patch block."""
    g = size // patch
    shape = (g, g) if batch is None else (batch, g, g)
    hide = torch.rand(shape, generator=gen, device=gen.device) < ratio
    return hide.repeat_interleave(patch, dim=-2).repeat_interleave(patch, dim=-1)


def make_batch_fn(cfg: PretrainConfig, env_cfg=None):
    """(gen, B) -> (masked inputs (B, S, S, 3), target depth (B, 224, 224),
    hidden (B, 224, 224)), on gen's device: B fresh scenes settled through
    the batched stepper, rendered, a patch mask each."""
    from smg_tpu_torch.envs.smg_env import EnvConfig
    from smg_tpu_torch.physics import scene as scene_mod
    from smg_tpu_torch.render import ortho

    env_cfg = env_cfg or EnvConfig(settle_steps=50)

    def batch(gen: torch.Generator, B: int):
        scenes = scene_mod.reset_scene(gen, B, gen.device, env_cfg.is_cluttered,
                                       env_cfg.is_testing, env_cfg.settle_steps)
        depth, _, _ = ortho.render_heightmap(scenes.objects)
        hidden = random_patch_mask(gen, depth.shape[-1], cfg.patch, cfg.mask_ratio, B)
        inp = preprocess_depth(torch.where(hidden, torch.zeros_like(depth), depth),
                               cfg.model)
        return inp, depth, hidden

    return batch


def new_optimizer(model: ReconstructionModel) -> torch.optim.Adam:
    """optax.adam(cfg.lr) (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=model.cfg.lr)


def reconstruction_loss(pred, target, hidden) -> torch.Tensor:
    """MSE on the hidden pixels, in normalised depth units."""
    err = (pred - (target - DEPTH_MEAN) / DEPTH_STD) ** 2
    w = hidden.float()
    return (err * w).sum() / w.sum().clamp(min=1.0)


def pretrain_step(model: ReconstructionModel, opt: torch.optim.Optimizer,
                  inputs, target, hidden) -> torch.Tensor:
    """One reconstruction step (pretrain.py:97-120): the train-mode
    forward (its BatchNorm statistics updated from this batch), the loss,
    one Adam step. Returns the loss."""
    opt.zero_grad(set_to_none=True)
    loss = reconstruction_loss(model(inputs, train=True), target, hidden)
    loss.backward()
    opt.step()
    return loss.detach()


def load_pretrained_trunks(model, pretrained: dict) -> None:
    """Copy a pretrained trunk's parameters and BatchNorm statistics (the
    `trunk.*` entries of a ReconstructionModel state_dict) into all three
    trunks of an AffordanceNet (pretrain.py:123-141); its heads stay."""
    trunk = {k[len("trunk."):]: v for k, v in pretrained.items()
             if k.startswith("trunk.")}
    if not trunk:
        raise ValueError("no trunk.* entries: not a ReconstructionModel state_dict")
    for name in TRUNK_PARTS:
        getattr(model, name).load_state_dict(trunk)
