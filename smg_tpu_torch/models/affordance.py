"""Two-stream affordance networks (port of smg_tpu/models/affordance.py).

Three DenseNet-121 trunks (grasp / suction / grasp-then-suction) and three
heads; style 2 reads the suction head, as the reference does
(models.py:144; the JAX package's default tied_ets_head=True). Eval scoring
runs through models/fast_trunk.py::score_eval, the update's train-mode
forward through ::score_train; `AffordanceNet.score` is the module eval
forward, the oracle they are held to. The JAX options no caller
sets (the tiny trunk, num_rotations > 1, an untied ETS head) are not
ported.
"""

from __future__ import annotations

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
    DenseNetTrunk,
    bn_eval,
    he_init_,
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
    input_size: int = 640
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
        mk = lambda: DenseNetTrunk(cfg.block_config, dt)  # noqa: E731
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
        if style == STYLE_ETS:
            return self.suction_head  # the reference's tied ETS head
        return (self.grasp_head, self.suction_head, self.gs_head)[style]

    @torch.no_grad()
    def score_eval(self, scene_img, mask_imgs, style: int,
                   backend: str = "xla_fl") -> torch.Tensor:
        """Eval scores (B, M, num_out) f32; scene features shared across
        the M object slots (affordance.py:132-165). backend: see
        fast_trunk.trunk_features_eval."""
        return fast_trunk.score_eval(self.trunk(style), self.head(style),
                                     scene_img, mask_imgs, self.cfg.num_out, backend)

    @torch.no_grad()
    def score(self, scene_img, mask_imgs, style: int) -> torch.Tensor:
        """The module eval forward of the scores, the oracle of score_eval:
        Flax `model.apply(..., train=False, method=AffordanceNet.score)`
        (affordance.py:132-165) through DenseNetTrunk.forward and
        AffordanceHead.forward. (B, S, S, 3), (B, M, S, S, 3) -> (B, M,
        num_out) f32."""
        B, M = mask_imgs.shape[:2]
        mask_flat = mask_imgs.reshape((B * M,) + mask_imgs.shape[2:])
        feats = self.trunk(style)(torch.cat([scene_img, mask_flat]))
        scene_feat, mask_feat = feats[:B], feats[B:]
        h, w, c = scene_feat.shape[1:]
        scene_rep = scene_feat[:, None].expand(B, M, h, w, c).reshape(B * M, h, w, c)
        out = self.head(style)(torch.cat([scene_rep, mask_feat], dim=-1))
        return out.reshape(B, M, -1)

    def score_train(self, scene_img, mask_img, style: int, conv2: str = "conv"):
        """Train-mode scores of n scenes with one exec mask each, per-image
        BatchNorm (the update's batch-1 passes, affordance.py:141-149):
        (out (n, num_out) f32, {bn_module: per-scene running (mean, var)})."""
        return fast_trunk.score_train(self.trunk(style), self.head(style),
                                      scene_img, mask_img, self.cfg.num_out, conv2)


def init_params(model: AffordanceNet, generator: torch.Generator) -> None:
    """Seeded He init of every trunk and head (PARITY dev 4)."""
    he_init_(model, generator)


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
