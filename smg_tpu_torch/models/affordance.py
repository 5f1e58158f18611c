"""Two-stream affordance networks (port of smg_tpu/models/affordance.py).

Three trunks (grasp / suction / grasp-then-suction), DenseNet-121 or with
ModelConfig.trunk = "tiny" the tiny trunk, and three heads. Style 2 reads
the suction head, as the reference does (models.py:144), while
ModelConfig.tied_ets_head is True (the default); with False it reads its
own gs_head. DenseNet-121 eval scoring runs through
models/fast_trunk.py::score_eval, the update's train-mode forward
through ::score_train; `AffordanceNet.score` is the module eval forward,
the oracle they are held to, and the tiny trunk's eval scoring (as in the
JAX trainer, whose fast paths are DenseNet-only).

ModelConfig.num_rotations R > 1 scores R in-network rotations of the scene
stream (the reference's affine_grid + grid_sample, models.py:85-93):
`rotate_image_nearest` turns each scene image, in plain torch as the JAX
package computes it outside any kernel, and the eval scores take a
(B, R, S, S, 3) scene stream. Eval BatchNorm works per image, so each
mask stream's features are computed once and paired with every
rotation's scene features in the head: B (R + M) trunk images, where the
JAX package recomputes the masks for every rotation (B R (1 + M)) for the
same scores.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from smg_tpu_torch.models import fast_trunk
from smg_tpu_torch.models.densenet import (
    BLOCK_CONFIG,
    BN_EPS,
    BN_MOMENTUM,
    bn_eval,
    flax_init_,
    make_trunk,
    no_tf32,
)

DEPTH_MEAN = 0.02
DEPTH_STD = 0.03

STYLE_GRASP = 0
STYLE_SUCTION = 1
STYLE_ETS = 2


@dataclass(frozen=True)
class ModelConfig:
    method: str = "reinforcement"   # 'reactive' | 'reinforcement'
    trunk: str = "densenet121"      # 'densenet121' | 'tiny'
    input_size: int = 640
    num_rotations: int = 1          # reference gnum/snum_rotations = 1
    tied_ets_head: bool = True      # reference models.py:144
    dtype: str = "bfloat16"
    block_config: Sequence[int] = BLOCK_CONFIG

    @property
    def num_out(self) -> int:
        return 3 if self.method == "reactive" else 1

    @property
    def feature_hw(self) -> int:
        return self.input_size // 32

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


class AffordanceHead(nn.Module):
    """BN -> ReLU -> 1x1 conv(64) -> BN -> ReLU -> global conv(num_out)."""

    def __init__(self, c_in: int, num_out: int, feature_hw: int):
        super().__init__()
        self.norm0 = nn.BatchNorm2d(c_in, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.conv0 = nn.Conv2d(c_in, 64, 1, bias=False)
        self.norm1 = nn.BatchNorm2d(64, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.conv1 = nn.Conv2d(64, num_out, feature_hw, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The module eval forward (affordance.py:83-99): (B, h, w, C) NHWC
        in the working dtype -> (B, num_out) f32."""
        dt = x.dtype
        with no_tf32():
            h = torch.relu(bn_eval(x.permute(0, 3, 1, 2), self.norm0, dt))
            h = F.conv2d(h, self.conv0.weight.to(dt))
            h = torch.relu(bn_eval(h, self.norm1, dt))
            h = F.conv2d(h, self.conv1.weight.to(dt))
        return h.reshape(h.shape[0], -1).float()


class AffordanceNet(nn.Module):
    """The three-style two-stream affordance model."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.tdtype
        mk = lambda: make_trunk(cfg.trunk, dt, cfg.block_config)  # noqa: E731
        self.suction_trunk = mk()
        self.grasp_trunk = mk()
        self.gs_trunk = mk()
        c2 = 2 * self.grasp_trunk.num_features
        self.suction_head = AffordanceHead(c2, cfg.num_out, cfg.feature_hw)
        self.grasp_head = AffordanceHead(c2, cfg.num_out, cfg.feature_hw)
        self.gs_head = AffordanceHead(c2, cfg.num_out, cfg.feature_hw)

    def trunk(self, style: int):
        return (self.grasp_trunk, self.suction_trunk, self.gs_trunk)[style]

    def head(self, style: int):
        if style == STYLE_ETS and self.cfg.tied_ets_head:
            return self.suction_head  # the reference's tied ETS head
        return (self.grasp_head, self.suction_head, self.gs_head)[style]

    @torch.no_grad()
    def score_eval(self, scene_img, mask_imgs, style: int,
                   backend: str = "xla_fl") -> torch.Tensor:
        """Eval scores (B, M, num_out) f32 of DenseNet-121 trunks; scene
        features shared across the M object slots (affordance.py:132-165).
        A (B, R, S, S, 3) scene stream, R rotations of each scene, gives
        (B, M, R, num_out). backend: see fast_trunk.trunk_features_eval."""
        return fast_trunk.score_eval(self.trunk(style), self.head(style),
                                     scene_img, mask_imgs, self.cfg.num_out, backend)

    @torch.no_grad()
    def score(self, scene_img, mask_imgs, style: int) -> torch.Tensor:
        """The module eval forward of the scores, the oracle of score_eval:
        Flax `model.apply(..., train=False, method=AffordanceNet.score)`
        (affordance.py:132-165) through DenseNetTrunk.forward and
        AffordanceHead.forward. (B, S, S, 3), (B, M, S, S, 3) -> (B, M,
        num_out) f32; (B, R, S, S, 3) scenes -> (B, M, R, num_out), as
        score_eval."""
        scenes = scene_img if scene_img.dim() == 5 else scene_img[:, None]
        B, R = scenes.shape[:2]
        M = mask_imgs.shape[1]
        mask_flat = mask_imgs.reshape((B * M,) + mask_imgs.shape[2:])
        feats = self.trunk(style)(torch.cat([scenes.flatten(0, 1), mask_flat]))
        h, w, c = feats.shape[1:]
        scene_feat = feats[:B * R].reshape(B, R, h, w, c)
        mask_feat = feats[B * R:]
        outs = []
        for r in range(R):
            scene_rep = scene_feat[:, r, None].expand(B, M, h, w, c).reshape(B * M, h, w, c)
            out = self.head(style)(torch.cat([scene_rep, mask_feat], dim=-1))
            outs.append(out.reshape(B, M, -1))
        return torch.stack(outs, dim=2) if scene_img.dim() == 5 else outs[0]

    @torch.no_grad()
    def score_eval_rows(self, x, scene_rows, mask_rows, style: int,
                        backend: str = "xla_fl") -> torch.Tensor:
        """Eval scores (Q, num_out) f32 of one packed trunk call of
        DenseNet-121 trunks: images x (N, S, S, 3), head row q pairing image
        scene_rows[q]'s features with image mask_rows[q]'s
        (fast_trunk.score_eval_rows)."""
        return fast_trunk.score_eval_rows(self.trunk(style), self.head(style), x,
                                          scene_rows, mask_rows, self.cfg.num_out, backend)

    @torch.no_grad()
    def score_rows(self, x, scene_rows, mask_rows, style: int) -> torch.Tensor:
        """The module eval forward of score_eval_rows, its oracle and the
        tiny trunk's: DenseNetTrunk.forward (or TinyTrunk's) and
        AffordanceHead.forward."""
        feats = self.trunk(style)(x)
        return self.head(style)(fast_trunk.head_rows(feats, scene_rows, mask_rows))

    def score_train(self, scene_img, mask_img, style: int, conv2: str = "conv"):
        """Train-mode scores of n scenes with one exec mask each, per-image
        BatchNorm (the update's batch-1 passes, affordance.py:141-149):
        (out (n, num_out) f32, {bn_module: per-scene running (mean, var)})."""
        return fast_trunk.score_train(self.trunk(style), self.head(style),
                                      scene_img, mask_img, self.cfg.num_out, conv2)


def init_params(model: AffordanceNet, generator: torch.Generator) -> None:
    """Seeded init of every trunk and head: Flax's default, as the JAX
    package's init_params (affordance.py:244-256; no pretrained weights
    are available offline, PARITY dev 4)."""
    flax_init_(model, generator)


def rotate_image_nearest(img: torch.Tensor, theta) -> torch.Tensor:
    """Rotate (..., S, S, C) images about their centers by theta, one angle
    per image (shape img.shape[:-3], or a scalar), nearest sampling, zero
    outside (affordance.py:226-243).

    The sample coordinates are float32 as XLA computes them in the JAX
    package's compiled programs, so round() picks the same source pixel
    where a coordinate lies on a half: sin and cos of the float32 angle
    rounded once to float32, and each coordinate as one fused multiply-add,
    xs = fma(x - c, cos, (y - c) sin) + c (emulated in float64)."""
    S = img.shape[-3]
    lead = img.shape[:-3]
    c = (S - 1) / 2.0
    theta = torch.as_tensor(theta, dtype=torch.float32, device=img.device)
    theta = theta.expand(lead).reshape(-1, 1, 1).double()
    cos, sin = torch.cos(theta).float(), torch.sin(theta).float()
    d = torch.arange(S, device=img.device, dtype=torch.float32) - c
    dx, dy = d[None, None, :], d[None, :, None]

    def fma(a, b, addend):
        return (a.double() * b.double() + addend.double()).float()

    xs = fma(dx, cos, dy * sin) + c                      # (n, S, S)
    ys = fma(-dx, sin, dy * cos) + c
    xi = torch.round(xs).to(torch.int64).clamp(0, S - 1)
    yi = torch.round(ys).to(torch.int64).clamp(0, S - 1)
    valid = (xs >= 0) & (xs <= S - 1) & (ys >= 0) & (ys <= S - 1)
    flat = img.reshape(-1, S * S, img.shape[-1])
    idx = (yi * S + xi).reshape(flat.shape[0], S * S, 1).expand(-1, -1, flat.shape[-1])
    out = torch.gather(flat, 1, idx).reshape(img.shape)
    return torch.where(valid.reshape(lead + (S, S, 1)), out, torch.zeros_like(out))


def rotation_angles(rot_idx: torch.Tensor, num_rotations: int) -> torch.Tensor:
    """float32 angles idx * 2 pi / R of rotation indices, computed as the
    JAX package's labels do (trainer.py:597): the index and 2 pi / R
    rounded to float32 first, then one float32 product."""
    step = torch.tensor(2.0 * math.pi / num_rotations, dtype=torch.float32,
                        device=rot_idx.device)
    return rot_idx.to(torch.float32) * step


def preprocess_depth(depth_hm: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., 224, 224) depth -> (..., S, S, 3) normalized trunk input
    (affordance.py:202-223)."""
    if cfg.input_size >= 448:
        x = depth_hm.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        pad = (cfg.input_size - x.shape[-1]) // 2
        if pad > 0:
            x = F.pad(x, (pad, pad, pad, pad))
    else:
        if cfg.input_size != depth_hm.shape[-1]:
            raise ValueError(f"input_size {cfg.input_size} vs heightmap "
                             f"{tuple(depth_hm.shape)}")
        x = depth_hm
    x = (x - DEPTH_MEAN) / DEPTH_STD
    return torch.stack([x, x, x], dim=-1)
