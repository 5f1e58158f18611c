"""Plain float32 reference of the two-stream affordance scores.

DenseNet-121 (Huang et al. 2017, arXiv:1608.06993) as torchvision's
`densenet121().features` computes it in eval mode: a 7x7 / 2 stem conv,
BatchNorm, ReLU and a 3x3 / 2 max pool; dense layers BN-ReLU-1x1
(bn_size x growth) -BN-ReLU-3x3 (growth), each appending its channels;
transitions BN-ReLU-1x1 then a 2 x 2 average pool; a final BatchNorm.
The head is the SMG reference's (models.py): BN-ReLU-1x1 (64)-BN-ReLU and
a conv over the whole feature map to one value, on the scene's features
beside the masked image's. Inputs are normalized depth, zoomed 2x and
padded for an input size of 448 or more, as the SMG reference's
trainer.py prepares them.

It imports nothing of the program: plain torch in NCHW and float32, with
TF32 off. `rnd`, when given, rounds every conv's input, kernel and
output, as a network stored in a lower precision and accumulated in
float32 computes it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

DEPTH_MEAN = 0.02
DEPTH_STD = 0.03


@contextlib.contextmanager
def full_f32():
    """Float32 convolutions and products without TF32 inside."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def prepare(depth: torch.Tensor, input_size: int) -> torch.Tensor:
    """(n, 224, 224) depth -> (n, 3, S, S) normalized network input."""
    x = depth
    if input_size >= 2 * depth.shape[-1]:
        x = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        pad = (input_size - x.shape[-1]) // 2
        x = F.pad(x, (pad, pad, pad, pad))
    elif input_size != depth.shape[-1]:
        raise ValueError(f"input size {input_size} for a {depth.shape[-1]}-pixel heightmap")
    x = (x - DEPTH_MEAN) / DEPTH_STD
    return x[:, None].expand(-1, 3, -1, -1)


def _bn(w: dict, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    scale = w[f"{name}.weight"] * torch.rsqrt(w[f"{name}.running_var"] + eps)
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _conv(x, k, rnd, **kw):
    if rnd is None:
        return F.conv2d(x, k, **kw)
    return rnd(F.conv2d(rnd(x), rnd(k), **kw))


def trunk(w: dict, t: str, x: torch.Tensor, arch: dict, rnd=None) -> torch.Tensor:
    """(n, 3, S, S) -> (n, C, S/32, S/32) features of trunk `t`."""
    eps = arch["bn_eps"]
    g = arch["growth_rate"]
    h = _conv(x, w[f"{t}.conv0.weight"], rnd, stride=2, padding=arch["stem_kernel"] // 2)
    h = torch.relu(_bn(w, f"{t}.norm0", h, eps))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    blocks = arch["block_config"]
    for i, L in enumerate(blocks):
        c0 = h.shape[1]
        buf = h.new_empty((h.shape[0], c0 + g * L) + h.shape[2:])
        buf[:, :c0] = h
        for l in range(L):
            p = f"{t}.denseblock{i + 1}.denselayer{l + 1}"
            c = c0 + g * l
            y = torch.relu(_bn(w, f"{p}.norm1", buf[:, :c], eps))
            y = _conv(y, w[f"{p}.conv1.weight"], rnd)
            y = torch.relu(_bn(w, f"{p}.norm2", y, eps))
            buf[:, c:c + g] = _conv(y, w[f"{p}.conv2.weight"], rnd, padding=1)
        h = buf
        if i < len(blocks) - 1:
            p = f"{t}.transition{i + 1}"
            y = torch.relu(_bn(w, f"{p}.norm", h, eps))
            h = F.avg_pool2d(_conv(y, w[f"{p}.conv.weight"], rnd), 2)
    return _bn(w, f"{t}.norm5", h, eps)


def head(w: dict, name: str, scene_feat: torch.Tensor, mask_feat: torch.Tensor,
         arch: dict, rnd=None) -> torch.Tensor:
    """Scene features beside mask features (n, 2C, h, w) -> (n, num_out)."""
    eps = arch["bn_eps"]
    x = torch.cat([scene_feat, mask_feat], dim=1)
    y = torch.relu(_bn(w, f"{name}.norm0", x, eps))
    y = _conv(y, w[f"{name}.conv0.weight"], rnd)
    y = torch.relu(_bn(w, f"{name}.norm1", y, eps))
    return _conv(y, w[f"{name}.conv1.weight"], rnd).flatten(1)


def features(w: dict, t: str, depth: torch.Tensor, arch: dict, input_size: int,
             chunk: int, rnd=None) -> torch.Tensor:
    """Trunk features of (n, 224, 224) depth images, `chunk` images at a time."""
    parts = [trunk(w, t, prepare(depth[i:i + chunk], input_size), arch, rnd)
             for i in range(0, depth.shape[0], chunk)]
    return torch.cat(parts)


def bf16_rounding(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (nearest even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def fp8_rounding(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to e4m3's largest value (448), as fp8 inference does."""
    amax = t.detach().abs().amax().clamp(min=1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
