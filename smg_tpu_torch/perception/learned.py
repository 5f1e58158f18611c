"""Learned instance segmentation: the Mask-R-CNN-parity front end (port of
smg_tpu/perception/learned.py).

The reference segments its color frame with a COCO-pretrained Mask-R-CNN
(reference code/masks.py:15,31-85). Here the learned front end is a
fully-convolutional fixed-slot segmenter: per-pixel logits over
N_SLOTS + background, trained from the exact renderer's id buffers
(cli/train_segmenter.py). Its output becomes the same `Segmentation` as
the exact path (masks, boxes, min-area rects, centers), with the
reference's NMS and area gate applied to the predicted masks.

Dtype: with SegmenterConfig.dtype "bfloat16" the convolutions run in
bf16 on f32 master weights, GroupNorm in f32 (Flax's fast variance
E[x^2] - E[x]^2, epsilon 1e-6), and the logits come back in f32, with
explicit casts at the same points as the JAX module (no autocast).
Tensors are NCHW; every function takes B scenes at once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from smg_tpu_torch.perception import minrect, nms
from smg_tpu_torch.perception.segment import MIN_VISIBLE_PIXELS, Segmentation
from smg_tpu_torch.physics.state import N_SLOTS

GN_GROUPS = 8
GN_EPS = 1e-6   # Flax GroupNorm's default (torch's is 1e-5)


@dataclass(frozen=True)
class SegmenterConfig:
    width: int = 32
    depth: int = 3           # down / up levels
    num_slots: int = N_SLOTS
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


class GroupNorm(nn.Module):
    """GroupNorm's parameters; the normalization is `group_norm`."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


def group_norm(x: torch.Tensor, gn: GroupNorm) -> torch.Tensor:
    """Flax GroupNorm(num_groups=8, dtype=float32) on NCHW x of any dtype:
    moments in f32 per (image, group), E[x^2] - E[x]^2 clipped at 0, then
    (x - mean) * (rsqrt(var + eps) * scale) + bias in f32."""
    B, C, H, W = x.shape
    xf = x.float()
    g = xf.reshape(B, GN_GROUPS, -1)
    mean = g.mean(dim=2)
    var = torch.clamp((g * g).mean(dim=2) - mean * mean, min=0.0)
    rep = lambda t: t.repeat_interleave(C // GN_GROUPS, dim=1)[:, :, None, None]  # noqa: E731
    mul = torch.rsqrt(rep(var) + GN_EPS) * gn.weight[:, None, None]
    return (xf - rep(mean)) * mul + gn.bias[:, None, None]


class SlotSegmenter(nn.Module):
    """Small UNet: (B, C_in, H, W) -> logits (B, num_slots + 1, H, W) f32.

    Channel 0 is background; channel 1 + i claims object slot i (slots are
    rendered with a stable color per slot, so slot identity is learnable).
    The children carry the Flax module's auto names (Conv_k, GroupNorm_k,
    in call order) so that smg_tpu_torch.bridge maps one tree onto the
    other by name. H and W must be multiples of 2^depth.
    """

    def __init__(self, cfg: SegmenterConfig = SegmenterConfig(), in_channels: int = 4):
        super().__init__()
        self.cfg = cfg
        w, d = cfg.width, cfg.depth
        convs = []           # (c_in, c_out, k) in the Flax call order
        c = in_channels
        for i in range(d):
            convs.append((c, w * 2 ** i, 3))
            c = w * 2 ** i
        convs.append((c, w * 2 ** d, 3))
        c = w * 2 ** d
        for i in reversed(range(d)):
            convs.append((c + w * 2 ** i, w * 2 ** i, 3))
            c = w * 2 ** i
        convs.append((c, cfg.num_slots + 1, 1))
        for k, (ci, co, ks) in enumerate(convs):
            self.add_module(f"Conv_{k}", nn.Conv2d(ci, co, ks, padding=ks // 2))
        widths = [w * 2 ** i for i in range(d)] + [w * 2 ** i for i in reversed(range(d))]
        for k, co in enumerate(widths):
            self.add_module(f"GroupNorm_{k}", GroupNorm(co))

    def _conv(self, k: int, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"Conv_{k}")
        dt = x.dtype
        return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                        padding=conv.padding)

    def _conv_gn_relu(self, conv_k: int, gn_k: int, x: torch.Tensor) -> torch.Tensor:
        gn = getattr(self, f"GroupNorm_{gn_k}")
        return torch.relu(group_norm(self._conv(conv_k, x), gn)).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.cfg.depth
        x = x.to(self.cfg.tdtype)
        skips = []
        for i in range(d):
            x = self._conv_gn_relu(i, i, x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = torch.relu(self._conv(d, x))
        for j, i in enumerate(reversed(range(d))):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = self._conv_gn_relu(d + 1 + j, d + j, torch.cat([x, skips[i]], dim=1))
        return self._conv(2 * d + 1, x).float()


def init_segmenter(generator: torch.Generator, cfg: SegmenterConfig = SegmenterConfig(),
                   in_channels: int = 4, device="cuda") -> SlotSegmenter:
    """A seeded SlotSegmenter on `device`: Flax's default Conv init
    (LeCun-normal kernels, truncated at 2 sigma; zero biases) and identity
    GroupNorms. The draws come from torch's generator, so a seed gives
    other weights than JAX's PRNG."""
    model = SlotSegmenter(cfg, in_channels).to(device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # variance_scaling(1, fan_in, truncated_normal): the std of
                # a unit normal truncated to [-2, 2] is 0.8796...
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                m.bias.zero_()
    return model


def segmenter_inputs(color_hm: torch.Tensor, depth_hm: torch.Tensor) -> torch.Tensor:
    """RGB (B, H, W, 3) + depth (B, H, W) -> the (B, 4, H, W) input."""
    return torch.cat([color_hm, depth_hm[..., None]], dim=-1).permute(0, 3, 1, 2).contiguous()


def train_step_segmenter(model: SlotSegmenter, opt: torch.optim.Optimizer,
                         batch_inputs: torch.Tensor, batch_ids: torch.Tensor,
                         obj_weight: float = 10.0) -> torch.Tensor:
    """One supervised step against the exact renderer's id buffers
    (learned.py:84-112): batch_inputs (B, 4, H, W), batch_ids (B, H, W) in
    [-1, N). The per-pixel cross-entropy weighs object pixels obj_weight
    against background 1 (so it does not collapse to all-background early)
    and is summed over the summed weights. Returns the loss (before the
    step)."""
    opt.zero_grad(set_to_none=True)
    labels = (batch_ids + 1).long()
    logp = torch.log_softmax(model(batch_inputs), dim=1)
    picked = torch.gather(logp, 1, labels[:, None])[:, 0]
    w = torch.where(labels > 0, obj_weight, 1.0)
    loss = -(w * picked).sum() / w.sum()
    loss.backward()
    opt.step()
    return loss.detach()


def new_optimizer(model: SlotSegmenter, lr: float = 1e-3) -> torch.optim.Adam:
    """optax.adam(lr)'s update: b1 0.9, b2 0.999, eps 1e-8, no decay."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def predict_segmentation(model, color_hm: torch.Tensor,
                         depth_hm: torch.Tensor) -> Segmentation:
    """Predicted masks of B scenes -> the exact path's Segmentation, with
    the reference's NMS and area gate (masks.py:69-83). `model` is any
    callable (B, 4, H, W) -> logits (B, N_SLOTS + 1, H, W); one forward
    for all B scenes."""
    with torch.no_grad():
        logits = model(segmenter_inputs(color_hm, depth_hm))
    pred = torch.argmax(logits, dim=1) - 1                      # (B, H, W), -1 = bg
    B, H, W = pred.shape
    n = N_SLOTS
    dev = pred.device
    masks = pred[:, None] == torch.arange(n, device=dev)[None, :, None, None]
    pix = masks.sum(dim=(2, 3))
    valid = pix >= MIN_VISIBLE_PIXELS

    corners, _, sizes, angles = minrect.min_area_rects(masks.reshape(B * n, H, W))
    corners = corners.reshape(B, n, 4, 2)
    sizes = sizes.reshape(B, n, 2)
    angles = angles.reshape(B, n)

    cols = torch.arange(W, dtype=torch.float32, device=dev)
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    big = torch.tensor(1e9, device=dev)
    x1 = torch.where(masks, cols, big).amin(dim=(2, 3))
    x2 = torch.where(masks, cols, -big).amax(dim=(2, 3))
    y1 = torch.where(masks, rows[:, None], big).amin(dim=(2, 3))
    y2 = torch.where(masks, rows[:, None], -big).amax(dim=(2, 3))
    boxes = torch.stack([torch.stack([x1, y1], -1), torch.stack([x2, y2], -1)], dim=2)
    boxes = torch.where(valid[..., None, None], boxes, torch.zeros_like(boxes))

    # NMS + area gate over predicted boxes — overlap threshold 0.40 and
    # the max-area gate (area/5) from masks.py:73. The reference's MIN
    # area gate (area/60 = 836 px at 224) is NOT kept: it was sized for
    # Mask-R-CNN's spurious proposals on COCO-scale objects, and this
    # catalog's true objects are 19-45 px boxes (361-825 px areas) — the
    # unmodified gate rejected pixel-perfect masks for ENTIRE scenes
    # (the `--segmentation learned` loop then trained at 27.6% success on
    # near-empty segmentations, PARITY dev 17). The noise floor for this
    # fixed-slot argmax net is the exact path's visibility gate instead
    # (MIN_VISIBLE_PIXELS, already applied to the pixel counts above).
    area = float(H * W)
    keep = nms.nms(boxes, valid, 0.40, float(MIN_VISIBLE_PIXELS), area / 5.0)
    valid = valid & keep

    v2 = valid[..., None]
    centers = torch.where(v2, corners.mean(dim=2), torch.zeros_like(corners[:, :, 0]))
    centers = centers.to(torch.int32).to(torch.float32)
    return Segmentation(
        masks=masks & valid[..., None, None],
        valid=valid,
        number=valid.sum(dim=1).to(torch.int32),
        boxes=boxes,
        centers=centers,
        box_corners=torch.where(v2[..., None], corners, torch.zeros_like(corners)),
        rect_sizes=torch.where(v2, sizes, torch.zeros_like(sizes)),
        rect_angles=torch.where(valid, angles, torch.zeros_like(angles)),
    )


def load_segmenter(path: str, device="cuda",
                   cfg: SegmenterConfig = SegmenterConfig()) -> SlotSegmenter:
    """A SlotSegmenter from a cli/train_segmenter.py checkpoint (a
    train/checkpoints.py::save_params file). A JAX package checkpoint is an
    orbax directory, which cannot be read without JAX: carry such
    parameters through smg_tpu_torch.bridge.load_segmenter_params."""
    import os

    from smg_tpu_torch.train import checkpoints

    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: a JAX (orbax) segmenter checkpoint cannot "
            "be read without JAX; train one with python -m "
            "smg_tpu_torch.cli.train_segmenter, or carry JAX parameters through "
            "smg_tpu_torch.bridge.load_segmenter_params")
    model = SlotSegmenter(cfg).to(device)
    model.load_state_dict(checkpoints.load_params(path))
    return model.eval()
