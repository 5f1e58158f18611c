"""Weights of the affordance nets, made by the benchmark from a seed.

The layout is the architecture's, under the port's module names (the
torchvision DenseNet names, which the SMG reference's models use too):
three trunks (`grasp_trunk`, `suction_trunk`, `gs_trunk`) and three heads.
Both the program and the reference are handed the same tensors: the
program loads them by name with a strict `load_state_dict`, the reference
reads them by the same names.

Every conv kernel is normal with std `conv_std / sqrt(fan_in)`, every
BatchNorm tensor uniform in its range (the configuration's `weights`),
drawn on the device from one torch.Generator in two calls, float32.
"""

from __future__ import annotations

import math

import torch

TRUNKS = ("grasp_trunk", "suction_trunk", "gs_trunk")
HEADS = ("grasp_head", "suction_head", "gs_head")
BN_FIELDS = ("weight", "bias", "running_mean", "running_var")


def trunk_channels(arch: dict) -> int:
    """Channels of a trunk's output (1024 for DenseNet-121)."""
    c = arch["num_init_features"]
    blocks = arch["block_config"]
    for i, L in enumerate(blocks):
        c += arch["growth_rate"] * L
        if i < len(blocks) - 1:
            c = int(c * arch["compression"])
    return c


def layout(arch: dict, input_size: int, num_out: int):
    """[(name, shape, kind)], kind "conv" or "bn", in a fixed order."""
    g, bn_size = arch["growth_rate"], arch["bn_size"]
    k = arch["stem_kernel"]
    convs, bns = [], []
    for t in TRUNKS:
        convs.append((f"{t}.conv0.weight", (arch["num_init_features"], arch["input_channels"], k, k)))
        bns.append((f"{t}.norm0", arch["num_init_features"]))
        c = arch["num_init_features"]
        blocks = arch["block_config"]
        for i, L in enumerate(blocks):
            for l in range(L):
                p = f"{t}.denseblock{i + 1}.denselayer{l + 1}"
                c_in = c + g * l
                bns.append((f"{p}.norm1", c_in))
                convs.append((f"{p}.conv1.weight", (bn_size * g, c_in, 1, 1)))
                bns.append((f"{p}.norm2", bn_size * g))
                convs.append((f"{p}.conv2.weight", (g, bn_size * g, 3, 3)))
            c += g * L
            if i < len(blocks) - 1:
                c_out = int(c * arch["compression"])
                bns.append((f"{t}.transition{i + 1}.norm", c))
                convs.append((f"{t}.transition{i + 1}.conv.weight", (c_out, c, 1, 1)))
                c = c_out
        bns.append((f"{t}.norm5", c))
    c2 = 2 * trunk_channels(arch)
    fh = input_size // 32
    for h in HEADS:
        bns.append((f"{h}.norm0", c2))
        convs.append((f"{h}.conv0.weight", (arch["head_width"], c2, 1, 1)))
        bns.append((f"{h}.norm1", arch["head_width"]))
        convs.append((f"{h}.conv1.weight", (num_out, arch["head_width"], fh, fh)))
    return convs, bns


def make(config: dict, seed: int, device) -> dict:
    """name -> float32 tensor on `device`, the BatchNorm tensors with their
    `num_batches_tracked` counters (0) as a state dict needs them."""
    arch, spec = config["architecture"], config["weights"]
    num_out = 3 if config["model"]["method"] == "reactive" else 1
    convs, bns = layout(arch, config["model"]["input_size"], num_out)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_conv = sum(math.prod(s) for _, s in convs)
    n_bn = sum(c for _, c in bns)
    z = torch.randn(n_conv, generator=gen, device=device)
    u = torch.rand(len(BN_FIELDS), n_bn, generator=gen, device=device)
    out, o = {}, 0
    for name, shape in convs:
        n = math.prod(shape)
        fan_in = math.prod(shape[1:])
        out[name] = (z[o:o + n] * (spec["conv_std"] / math.sqrt(fan_in))).reshape(shape)
        o += n
    lo = torch.tensor([spec["bn_uniform"][f][0] for f in BN_FIELDS], device=device)
    hi = torch.tensor([spec["bn_uniform"][f][1] for f in BN_FIELDS], device=device)
    u = lo[:, None] + (hi - lo)[:, None] * u
    o = 0
    for name, c in bns:
        for k, f in enumerate(BN_FIELDS):
            out[f"{name}.{f}"] = u[k, o:o + c]
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
        o += c
    return out
