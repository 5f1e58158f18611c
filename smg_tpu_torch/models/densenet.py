"""DenseNet-121 feature trunk as an nn.Module (port of smg_tpu/models/densenet.py).

The module holds torch-layout parameters (OIHW convs, BatchNorm2d with
running statistics) under the Flax module's names, so the bridge maps one
tree onto the other by name. Its fast eval forward is
models/fast_trunk.py::trunk_features_eval (kernels K2-K5, K7); its
train-mode forward, with per-image batch statistics, is
::trunk_features_train (kernel K6 under conv2='pk').

`DenseNetTrunk.forward` is the module eval forward, the counterpart of
Flax's `DenseNetTrunk.apply(..., train=False)` (densenet.py:104-132):
unfused BatchNorm (f32 math, rounded to the dtype), convolutions and
concatenations, on no kernel of the port. It is the oracle that the fast
eval backends are held to, never on the main path.

`block_config` is an argument, as in the Flax DenseNetTrunk
(densenet.py:99), so that tests can build a shallow trunk.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
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


def bn_eval(x: torch.Tensor, bn: nn.BatchNorm2d, dt: torch.dtype) -> torch.Tensor:
    """Flax BatchNorm with running averages on NCHW x:
    (x - mean) * (rsqrt(var + eps) * scale) + bias in f32, rounded to dt
    (flax.linen.normalization._normalize)."""
    mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
    y = ((x.float() - bn.running_mean[:, None, None]) * mul[:, None, None]
         + bn.bias[:, None, None])
    return y.to(dt)


@contextlib.contextmanager
def backend_flag(holder, name: str, value):
    """holder.name = value inside, restored after: a torch.backends flag."""
    old = getattr(holder, name)
    setattr(holder, name, value)
    try:
        yield
    finally:
        setattr(holder, name, old)


def no_tf32():
    """cuDNN convolutions in full float32 inside (PyTorch lets them use
    TF32 by default); bf16 convolutions are unaffected."""
    return backend_flag(torch.backends.cudnn, "allow_tf32", False)


class DenseLayer(nn.Module):
    def __init__(self, c_in: int, growth_rate: int = GROWTH_RATE,
                 bn_size: int = BN_SIZE):
        super().__init__()
        self.norm1 = _bn(c_in)
        self.conv1 = nn.Conv2d(c_in, bn_size * growth_rate, 1, bias=False)
        self.norm2 = _bn(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval: NCHW x in the working dtype -> x with 32 channels appended."""
        dt = x.dtype
        h = torch.relu(bn_eval(x, self.norm1, dt))
        h = F.conv2d(h, self.conv1.weight.to(dt))
        h = torch.relu(bn_eval(h, self.norm2, dt))
        h = F.conv2d(h, self.conv2.weight.to(dt), padding=1)
        return torch.cat([x, h], dim=1)


class DenseBlock(nn.Module):
    def __init__(self, num_layers: int, c_in: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(c_in + i * GROWTH_RATE))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class Transition(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm = _bn(c_in)
        self.conv = nn.Conv2d(c_in, c_out, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval: BN, ReLU, 1x1, then the 2x2 average pool (densenet.py:77-92)."""
        dt = x.dtype
        h = torch.relu(bn_eval(x, self.norm, dt))
        return F.avg_pool2d(F.conv2d(h, self.conv.weight.to(dt)), 2)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The module eval forward: (N, S, S, 3) -> (N, S/32, S/32, C) NHWC
        in self.dtype (the oracle; see the module docstring)."""
        dt = self.dtype
        with no_tf32():
            h = x.to(dt).permute(0, 3, 1, 2)
            h = F.conv2d(h, self.conv0.weight.to(dt), stride=2, padding=3)
            h = F.max_pool2d(torch.relu(bn_eval(h, self.norm0, dt)), 3, 2, padding=1)
            n = len(self.block_config)
            for i in range(n):
                h = getattr(self, f"denseblock{i + 1}")(h)
                if i < n - 1:
                    h = getattr(self, f"transition{i + 1}")(h)
            h = bn_eval(h, self.norm5, dt)
        return h.permute(0, 2, 3, 1)


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
