"""Eval-mode trunk and head forward over the port's kernels.

Port of the eval half of smg_tpu/models/fast_trunk.py (trunk_features_eval
on the `xla_fl` path, head_eval, score_eval). Per trunk call:

- stem: conv0 as one gray tap (the input is a triplicated depth map, so
  conv(x, W) == conv(x[..., :1], W.sum(in)) — fast_trunk.py:39-40), then
  K4 writes the pooled stem straight into block 1's buffer;
- dense blocks: one preallocated NHWC buffer per block, channels at their
  final offsets; each K2 call reads the prefix and writes its 32 channels
  in place;
- transitions: K3 writes into the next block's buffer;
- norm5 and the head's two matmuls stay plain torch, as they were XLA in
  the JAX package (fast_trunk.py:372-381, :966-983).

Eval BatchNorm folds to an f32 affine a = scale * rsqrt(var + 1e-5),
b = bias - mean * a (dense_block_pallas.py:147-151). Compute runs in the
trunk's dtype: bf16 with f32 accumulation and f32 affines (PARITY dev 12),
or float32 for the CPU parity tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smg_tpu_torch.models.densenet import BN_EPS, GROWTH_RATE, DenseNetTrunk
from smg_tpu_torch.ops import dense_layer as k2
from smg_tpu_torch.ops import stem_pool as k4
from smg_tpu_torch.ops import transition as k3


def fold_bn(bn: torch.nn.BatchNorm2d):
    a = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    b = bn.bias - bn.running_mean * a
    return a.detach().float().contiguous(), b.detach().float().contiguous()


def _param_key(module: torch.nn.Module):
    return tuple((t.data_ptr(), t._version)
                 for t in list(module.parameters()) + list(module.buffers()))


def trunk_operands(trunk: DenseNetTrunk) -> dict:
    """Kernel-layout operands of a trunk, cached until a parameter or
    buffer changes (in place or by reassignment)."""
    key = _param_key(trunk)
    cache = getattr(trunk, "_eval_operands", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    dt = trunk.dtype
    with torch.no_grad():
        ops = {"kg": trunk.conv0.weight.sum(dim=1, keepdim=True).to(dt),
               "stem": fold_bn(trunk.norm0), "norm5": fold_bn(trunk.norm5),
               "blocks": [], "transitions": []}
        for i, L in enumerate(trunk.block_config):
            block = getattr(trunk, f"denseblock{i + 1}")
            layers = []
            for l in range(L):
                lay = getattr(block, f"denselayer{l + 1}")
                c_in = lay.conv1.in_channels
                a1, b1 = fold_bn(lay.norm1)
                a2, b2 = fold_bn(lay.norm2)
                w1 = lay.conv1.weight.reshape(-1, c_in).t().contiguous().to(dt)
                w2 = (lay.conv2.weight.permute(2, 3, 1, 0)
                      .reshape(9, lay.conv2.in_channels, -1).contiguous().to(dt))
                layers.append((c_in, a1, b1, w1, a2, b2, w2))
            ops["blocks"].append(layers)
            if i < len(trunk.block_config) - 1:
                tr = getattr(trunk, f"transition{i + 1}")
                a, b = fold_bn(tr.norm)
                wt = tr.conv.weight.reshape(tr.conv.out_channels, -1).t()
                ops["transitions"].append((a, b, wt.contiguous().to(dt)))
    trunk._eval_operands = (key, ops)
    return ops


def _stem_conv(x: torch.Tensor, kg: torch.Tensor) -> torch.Tensor:
    """conv0 7x7 / stride 2 / pad 3 on the gray tap: (N, S, S, C>=1) ->
    (N, S/2, S/2, 64) NHWC in kg's dtype."""
    x1 = x[..., :1].to(kg.dtype).permute(0, 3, 1, 2)
    x1 = x1.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x1, kg, stride=2, padding=3)
    return y.permute(0, 2, 3, 1).contiguous()


def trunk_features_eval(trunk: DenseNetTrunk, x: torch.Tensor) -> torch.Tensor:
    """(N, S, S, 3) preprocessed input -> (N, S/32, S/32, C_final)."""
    ops = trunk_operands(trunk)
    dt = trunk.dtype
    y = _stem_conv(x, ops["kg"])
    N, Hc, Wc, C = y.shape
    H, W = k4.out_hw(Hc), k4.out_hw(Wc)
    cfg = trunk.block_config
    buf = torch.empty((N, H, W, C + GROWTH_RATE * cfg[0]), dtype=dt,
                      device=x.device)
    k4.bn_relu_maxpool(y, *ops["stem"], out=buf[..., :C])
    for i, layers in enumerate(ops["blocks"]):
        for c_in, a1, b1, w1, a2, b2, w2 in layers:
            k2.dense_layer(buf, c_in, a1, b1, w1, a2, b2, w2)
        if i < len(cfg) - 1:
            a, b, wt = ops["transitions"][i]
            c_out = wt.shape[1]
            H, W = H // 2, W // 2
            nxt = torch.empty((N, H, W, c_out + GROWTH_RATE * cfg[i + 1]),
                              dtype=dt, device=x.device)
            k3.transition(buf, a, b, wt, out=nxt[..., :c_out])
            buf = nxt
    a5, b5 = ops["norm5"]
    return (buf.float() * a5 + b5).to(dt)


def head_eval(head, x: torch.Tensor, num_out: int) -> torch.Tensor:
    """AffordanceHead eval forward (fast_trunk.py:966-983):
    (B, h, w, C) -> (B, num_out) f32. f32 accumulation of the working-dtype
    operands (an f32 product of bf16 values is exact)."""
    dt = x.dtype
    a0, b0 = fold_bn(head.norm0)
    h = torch.relu(x.float() * a0 + b0).to(dt)
    k0 = head.conv0.weight.detach().reshape(head.conv0.out_channels, -1)
    h = h.reshape(-1, k0.shape[1]).float() @ k0.t().to(dt).float()
    a1, b1 = fold_bn(head.norm1)
    h = torch.relu(h * a1 + b1).to(dt)
    k1 = head.conv1.weight.detach().permute(2, 3, 1, 0).reshape(-1, num_out)
    return h.reshape(x.shape[0], -1).float() @ k1.to(dt).float()


def score_eval(trunk, head, scene_img: torch.Tensor, mask_imgs: torch.Tensor,
               num_out: int) -> torch.Tensor:
    """Eval AffordanceNet.score (fast_trunk.py:986-1014): one trunk call
    over the scene + masked streams, scene features broadcast across the
    M object slots, head on the concatenated features. -> (B, M, num_out)."""
    B, M = mask_imgs.shape[:2]
    mask_flat = mask_imgs.reshape((B * M,) + mask_imgs.shape[2:])
    feats = trunk_features_eval(trunk, torch.cat([scene_img, mask_flat], 0))
    scene_feat, mask_feat = feats[:B], feats[B:]
    h, w, c = scene_feat.shape[1:]
    scene_rep = scene_feat[:, None].expand(B, M, h, w, c).reshape(B * M, h, w, c)
    both = torch.cat([scene_rep, mask_feat], dim=-1)
    return head_eval(head, both, num_out).reshape(B, M, num_out)
