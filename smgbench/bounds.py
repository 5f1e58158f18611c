"""Operation and byte counts: the yardstick of the roofline and MFU metrics.

A kernel's bound is the larger of its operations over the card's peak for
their type and its bytes over the memory's rate, where each input byte is
counted read once and each output byte written once (the arithmetic of
chip_smoke.py, frozen here). The useful FLOPs of a decision count only
the images the inputs need: each trunk's scene image where that trunk
scores something, each valid object's image in the grasp and suction
trunks, each valid pair's image in the envelop-then-suck trunk, and a head
pass for each of those objects and pairs.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds for work of `flops` bf16 operations moving `nbytes`."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def k2_work(N: int, H: int, W: int, c_in: int):
    """(flops, bytes) of one eval dense layer on N x H x W pixels: BN-ReLU
    and the 1x1 to 128 channels, BN-ReLU and the 3x3 to 32; the prefix read
    and the 32 new channels written in bf16, the bf16 kernels and the f32
    folded BatchNorms read once."""
    P = N * H * W
    flops = 2.0 * P * c_in * 128 + 2.0 * P * 1152 * 32
    nbytes = 2.0 * P * (c_in + 32) + 2.0 * (c_in * 128 + 1152 * 32) + 8.0 * (c_in + 128)
    return flops, nbytes


def k3_work(N: int, H: int, W: int, C: int, C_out: int):
    """(flops, bytes) of one transition: BN-ReLU, the 2 x 2 mean and the 1x1
    on the pooled pixels; its input read once, its output written once, the
    kernel and the folded BatchNorm read once."""
    P, Q = N * H * W, N * H * W / 4
    return (2.0 * Q * C * C_out,
            2.0 * P * C + 2.0 * Q * C_out + 2.0 * C * C_out + 8.0 * C)


def trunk_flops(arch: dict, size: int) -> float:
    """Multiply-add FLOPs of one DenseNet trunk image at input `size`: the
    stem over all input channels, every dense layer, each transition's 1x1
    on its pooled pixels (5.20 GFLOP at 224, 42.5 at 640 for DenseNet-121)."""
    g, bn = arch["growth_rate"], arch["bn_size"] * arch["growth_rate"]
    k = arch["stem_kernel"]
    H = size // 2
    f = 2.0 * H * H * k * k * arch["input_channels"] * arch["num_init_features"]
    H //= 2
    c = arch["num_init_features"]
    blocks = arch["block_config"]
    for i, L in enumerate(blocks):
        for l in range(L):
            f += 2.0 * H * H * (c + g * l) * bn + 2.0 * H * H * 9 * bn * g
        c += g * L
        if i < len(blocks) - 1:
            c_out = int(c * arch["compression"])
            H //= 2
            f += 2.0 * H * H * c * c_out
            c = c_out
    return f


def head_flops(arch: dict, size: int, trunk_out: int, num_out: int = 1) -> float:
    """FLOPs of one head pass on a (scene, mask) feature pair."""
    hw = (size // 32) ** 2
    return 2.0 * hw * 2 * trunk_out * arch["head_width"] + 2.0 * hw * arch["head_width"] * num_out


def decision_flops(arch: dict, size: int, trunk_out: int, objects) -> float:
    """Useful FLOPs of one decision over scenes with `objects` valid objects
    each (an iterable of counts)."""
    t, h = trunk_flops(arch, size), head_flops(arch, size, trunk_out)
    total = 0.0
    for n in objects:
        pairs = n * (n - 1) // 2
        scenes = (2 if n else 0) + (1 if pairs else 0)
        total += (scenes + 2 * n + pairs) * t + (2 * n + pairs) * h
    return total
