"""DenseNet-121 feature trunk and the tiny trunk as nn.Modules (port of
smg_tpu/models/densenet.py).

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

`forward(x, train=True)` (both trunks) is the counterpart of Flax's
`apply(..., train=True, mutable=["batch_stats"])`: BatchNorm with the
moments of the whole batch, in f32 with the fast variance
E[x^2] - E[x]^2 clipped at 0, and each running statistic updated in place
as 0.9 running + 0.1 batch with the *biased* variance (Flax's
_compute_stats; nn.BatchNorm2d would update with the unbiased one). Trunk
pretraining (train/pretrain.py) runs it; the affordance update does not
(it has per-image statistics, models/fast_trunk.py).

`block_config` is an argument, as in the Flax DenseNetTrunk
(densenet.py:99), so that tests can build a shallow trunk.

`TinyTrunk` (densenet.py:135-162) is the small stride-32 convnet with the
same 1024-channel output, selected by ModelConfig.trunk = "tiny"; it runs
on no kernel of the port (the JAX package computes it outside any Pallas
kernel too): its eval forward is `TinyTrunk.forward`, its train forward
models/fast_trunk.py::tiny_features_train. `make_trunk` builds either.
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


def _bn_apply(x: torch.Tensor, mean, var, bn: nn.BatchNorm2d,
              dt: torch.dtype) -> torch.Tensor:
    """(x - mean) * (rsqrt(var + eps) * scale) + bias in f32 on NCHW x,
    rounded to dt (flax.linen.normalization._normalize)."""
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    y = (x.float() - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(dt)


def bn_eval(x: torch.Tensor, bn: nn.BatchNorm2d, dt: torch.dtype) -> torch.Tensor:
    """Flax BatchNorm with running averages on NCHW x."""
    return _bn_apply(x, bn.running_mean, bn.running_var, bn, dt)


def bn_train(x: torch.Tensor, bn: nn.BatchNorm2d, dt: torch.dtype) -> torch.Tensor:
    """Flax BatchNorm with the batch's moments on NCHW x (differentiable
    through them); updates bn's running statistics in place with the
    biased variance (see the module docstring)."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        keep = 1.0 - BN_MOMENTUM
        bn.running_mean.copy_(keep * bn.running_mean + BN_MOMENTUM * mean)
        bn.running_var.copy_(keep * bn.running_var + BN_MOMENTUM * var)
    return _bn_apply(xf, mean, var, bn, dt)


def _norm(train: bool):
    return bn_train if train else bn_eval


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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NCHW x in the working dtype -> x with 32 channels appended."""
        dt, bn = x.dtype, _norm(train)
        h = torch.relu(bn(x, self.norm1, dt))
        h = F.conv2d(h, self.conv1.weight.to(dt))
        h = torch.relu(bn(h, self.norm2, dt))
        h = F.conv2d(h, self.conv2.weight.to(dt), padding=1)
        return torch.cat([x, h], dim=1)


class DenseBlock(nn.Module):
    def __init__(self, num_layers: int, c_in: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(c_in + i * GROWTH_RATE))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self.children():
            x = layer(x, train)
        return x


class Transition(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm = _bn(c_in)
        self.conv = nn.Conv2d(c_in, c_out, 1, bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """BN, ReLU, 1x1, then the 2x2 average pool (densenet.py:77-92)."""
        dt = x.dtype
        h = torch.relu(_norm(train)(x, self.norm, dt))
        return avg_pool2(F.conv2d(h, self.conv.weight.to(dt)))


def avg_pool2(y: torch.Tensor) -> torch.Tensor:
    """flax.linen.avg_pool((2, 2), strides=(2, 2)) of NCHW y: the window's
    sum in y's dtype, rounded after each add in row-major order as XLA
    reduces a window, then divided by 4."""
    s = y[..., 0::2, 0::2] + y[..., 0::2, 1::2]
    s = s + y[..., 1::2, 0::2]
    return (s + y[..., 1::2, 1::2]) / 4


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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The module forward: (N, S, S, 3) -> (N, S/32, S/32, C) NHWC in
        self.dtype; eval (the oracle) or train (see the module docstring)."""
        dt, bn = self.dtype, _norm(train)
        with no_tf32():
            h = x.to(dt).permute(0, 3, 1, 2)
            h = F.conv2d(h, self.conv0.weight.to(dt), stride=2, padding=3)
            h = F.max_pool2d(torch.relu(bn(h, self.norm0, dt)), 3, 2, padding=1)
            n = len(self.block_config)
            for i in range(n):
                h = getattr(self, f"denseblock{i + 1}")(h, train)
                if i < n - 1:
                    h = getattr(self, f"transition{i + 1}")(h, train)
            h = bn(h, self.norm5, dt)
        return h.permute(0, 2, 3, 1)


TINY_WIDTHS = (32, 64, 128, 256, 512)
TINY_FEATURES = 1024


class TinyTrunk(nn.Module):
    """Five stride-2 3x3 convs (32-512) with BatchNorm and ReLU, then a 1x1
    to 1024: (N, S, S, 3) -> (N, S/32, S/32, 1024), as DenseNetTrunk."""

    num_features = TINY_FEATURES

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        c = 3
        for i, w in enumerate(TINY_WIDTHS):
            self.add_module(f"conv{i}", nn.Conv2d(c, w, 3, stride=2, padding=1, bias=False))
            self.add_module(f"norm{i}", _bn(w))
            c = w
        self.proj = nn.Conv2d(c, TINY_FEATURES, 1, bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The module forward: NHWC in self.dtype, as Flax's
        TinyTrunk.apply(..., train=train)."""
        dt, bn = self.dtype, _norm(train)
        with no_tf32():
            h = x.to(dt).permute(0, 3, 1, 2)
            for i in range(len(TINY_WIDTHS)):
                h = F.conv2d(h, getattr(self, f"conv{i}").weight.to(dt), stride=2, padding=1)
                h = torch.relu(bn(h, getattr(self, f"norm{i}"), dt))
            h = F.conv2d(h, self.proj.weight.to(dt))
        return h.permute(0, 2, 3, 1)


def make_trunk(kind: str, dtype: torch.dtype = torch.bfloat16,
               block_config: Sequence[int] = BLOCK_CONFIG) -> nn.Module:
    """The trunk of ModelConfig.trunk: "densenet121" (of block_config) or "tiny"."""
    if kind == "densenet121":
        return DenseNetTrunk(block_config, dtype)
    if kind == "tiny":
        return TinyTrunk(dtype)
    raise ValueError(f"unknown trunk '{kind}'")


# The standard deviation of a unit normal truncated at +-2 (Flax's
# variance_scaling divides by it).
_TRUNC_STD = 0.87962566103423978


def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default init, as the JAX package's init_params draws it
    (flax.linen's Conv and BatchNorm without kernel_init): every conv kernel
    lecun_normal (variance 1 / fan_in, a normal truncated at two standard
    deviations), conv biases zero, BatchNorm scale 1 and bias 0, running
    statistics 0 / 1; from `generator`."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
