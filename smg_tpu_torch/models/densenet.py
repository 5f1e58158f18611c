"""DenseNet-121 feature trunk as an nn.Module (port of smg_tpu/models/densenet.py).

The module holds torch-layout parameters (OIHW convs, BatchNorm2d with
running statistics) under the Flax module's names, so the bridge maps one
tree onto the other by name. Its eval forward is
models/fast_trunk.py::trunk_features_eval (kernels K4, K2, K3); the
train-mode forward arrives with the training-step port.

`block_config` is an argument, as in the Flax DenseNetTrunk
(densenet.py:99), so that tests can build a shallow trunk.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

GROWTH_RATE = 32
BLOCK_CONFIG = (6, 12, 24, 16)
NUM_INIT_FEATURES = 64
BN_SIZE = 4
BN_EPS = 1e-5
# Flax momentum 0.9 is the retention factor; torch's momentum is the
# update speed (densenet.py:24-28).
BN_MOMENTUM = 0.1


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class DenseLayer(nn.Module):
    def __init__(self, c_in: int, growth_rate: int = GROWTH_RATE,
                 bn_size: int = BN_SIZE):
        super().__init__()
        self.norm1 = _bn(c_in)
        self.conv1 = nn.Conv2d(c_in, bn_size * growth_rate, 1, bias=False)
        self.norm2 = _bn(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias=False)


class DenseBlock(nn.Module):
    def __init__(self, num_layers: int, c_in: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(c_in + i * GROWTH_RATE))


class Transition(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm = _bn(c_in)
        self.conv = nn.Conv2d(c_in, c_out, 1, bias=False)


class DenseNetTrunk(nn.Module):
    """`densenet121().features`: image -> (H/32, W/32, C_final) features."""

    def __init__(self, block_config: Sequence[int] = BLOCK_CONFIG,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.block_config = tuple(block_config)
        self.dtype = dtype
        self.conv0 = nn.Conv2d(3, NUM_INIT_FEATURES, 7, stride=2, padding=3,
                               bias=False)
        self.norm0 = _bn(NUM_INIT_FEATURES)
        c = NUM_INIT_FEATURES
        for i, L in enumerate(self.block_config):
            self.add_module(f"denseblock{i + 1}", DenseBlock(L, c))
            c += L * GROWTH_RATE
            if i != len(self.block_config) - 1:
                self.add_module(f"transition{i + 1}", Transition(c, c // 2))
                c //= 2
        self.norm5 = _bn(c)
        self.num_features = c


def he_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded He-normal conv weights, identity BatchNorm (PARITY dev 4:
    no pretrained weights are available offline)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                    nonlinearity="relu", generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
