"""Trunk and head forward over the port's kernels: eval and train mode.

Port of smg_tpu/models/fast_trunk.py. The eval half (trunk_features_eval,
head_eval, score_eval) has three backends, under the JAX package's names.
`xla_fl`, the default and the trainer's, per trunk call:

- stem: conv0 as one gray tap (the input is a triplicated depth map, so
  conv(x, W) == conv(x[..., :1], W.sum(in)) — fast_trunk.py:39-40), then
  K4 writes the pooled stem straight into block 1's buffer;
- dense blocks: one preallocated NHWC buffer per block, channels at their
  final offsets; each K2 call reads the prefix and writes its 32 channels
  in place;
- transitions: K3 writes into the next block's buffer;
- norm5 and the head's two matmuls stay plain torch, as they were XLA in
  the JAX package (fast_trunk.py:372-381, :966-983).

`xla_pk` differs in the dense layers: a plain grouped bottleneck, then K5
(BN2, ReLU, 3x3) writes the 32 channels. `pallas` runs the stem in its XLA
form and each dense block, with its transition or norm5, as one K7 call.

Eval BatchNorm folds to an f32 affine a = scale * rsqrt(var + 1e-5),
b = bias - mean * a (dense_block_pallas.py:147-151). Compute runs in the
trunk's dtype: bf16 with f32 accumulation and f32 affines (PARITY dev 12),
or float32 for the CPU parity tests.

The train half (trunk_features_train, head_train, score_train;
fast_trunk.py:420-963) is the update's differentiable forward. BatchNorm
takes **per-image** moments over (H, W), E[x^2] - E[x]^2 in f32: the JAX
update runs every scene's scene and mask streams as separate batch-1
passes, so one call here may carry any number of images. (nn.BatchNorm2d's
train mode would pool the batch and update the running variance
unbiased; it is not used.) The dense layers dispatch on `conv2`: 'pk'
runs K6 forward and backward (ops/dense_layer_train.py, one autograd
Function per dense block); 'conv' is autograd of the conv form
(_dense_layer_train(conv2='conv'), fast_trunk.py:438-495), as XLA
differentiated it. The stem, transitions, norm5 and head are plain
PyTorch with autograd, as they were XLA outside any kernel in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smg_tpu_torch.models.densenet import (BN_EPS, BN_MOMENTUM, GROWTH_RATE, TINY_WIDTHS,
                                          DenseNetTrunk, TinyTrunk, backend_flag, no_tf32)
from smg_tpu_torch.ops import conv2 as k5
from smg_tpu_torch.ops import dense_block as k7
from smg_tpu_torch.ops import dense_layer as k2
from smg_tpu_torch.ops import dense_layer_train as k6
from smg_tpu_torch.ops import stem_pool as k4
from smg_tpu_torch.ops import transition as k3

BACKENDS = ("xla_fl", "xla_pk", "pallas")
GROUP = 128   # the bottleneck's contraction groups under `xla_pk`
TRAIN_CONV2 = ("conv", "pk")
_KEEP = 1.0 - BN_MOMENTUM   # Flax's running-average retention, 0.9


def fold_bn(bn: torch.nn.BatchNorm2d):
    a = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    b = bn.bias - bn.running_mean * a
    return a.detach().float().contiguous(), b.detach().float().contiguous()


def _param_key(module: torch.nn.Module):
    return tuple((t.data_ptr(), t._version)
                 for t in list(module.parameters()) + list(module.buffers()))


def _cached(trunk: DenseNetTrunk, attr: str, build):
    """build(trunk), cached on the trunk under `attr` until a parameter or
    buffer changes (in place or by reassignment)."""
    key = _param_key(trunk)
    cache = getattr(trunk, attr, None)
    if cache is not None and cache[0] == key:
        return cache[1]
    with torch.no_grad():
        value = build(trunk)
    setattr(trunk, attr, (key, value))
    return value


def _build_operands(trunk: DenseNetTrunk) -> dict:
    dt = trunk.dtype
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
    return ops


def trunk_operands(trunk: DenseNetTrunk) -> dict:
    """Kernel-layout operands of a trunk (cached)."""
    return _cached(trunk, "_eval_operands", _build_operands)


def _build_block_operands(trunk: DenseNetTrunk) -> list:
    ops = trunk_operands(trunk)
    blocks = []
    for i, layers in enumerate(ops["blocks"]):
        if i < len(ops["blocks"]) - 1:
            ep, epilogue = k7.pack_transition(*ops["transitions"][i]), "transition"
        else:
            ep, epilogue = k7.pack_final_bn(*ops["norm5"]), "final_bn"
        blocks.append((k7.pack_dense_block(layers), ep, epilogue))
    return blocks


def block_operands(trunk: DenseNetTrunk) -> list:
    """K7's operands of a trunk, (packed block, epilogue operands,
    epilogue) per dense block (cached)."""
    return _cached(trunk, "_block_operands", _build_block_operands)


def _stem_conv(x: torch.Tensor, kg: torch.Tensor) -> torch.Tensor:
    """conv0 7x7 / stride 2 / pad 3 on the gray tap: (N, S, S, C>=1) ->
    (N, S/2, S/2, 64) NHWC in kg's dtype."""
    x1 = x[..., :1].to(kg.dtype).permute(0, 3, 1, 2)
    x1 = x1.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x1, kg, stride=2, padding=3)
    return y.permute(0, 2, 3, 1).contiguous()


def _product(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y @ w with f32 accumulation, rounded once to y's dtype. On the card
    this is cuBLAS, whose bf16 reduction stays f32 only inside
    _f32_reduction()."""
    if y.device.type == "cpu":
        return (y.float() @ w.float()).to(y.dtype)
    return y @ w


def _f32_reduction():
    """allow_bf16_reduced_precision_reduction = False inside (PyTorch's
    default is True: cuBLAS may then reduce split-K partials in bf16)."""
    return backend_flag(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)


def _bottleneck(buf: torch.Tensor, c_in: int, a1, b1, w1) -> torch.Tensor:
    """BN -> ReLU -> 1x1(128) of the prefix [0, c_in) of buf (N, H, W, ld),
    plain PyTorch as it was XLA outside any kernel (_dense_bottleneck,
    fast_trunk.py:164-201): one product per 128-channel group from channel
    0; when there is more than one group, each product is rounded to the
    working dtype and they are summed in f32. Returns h1 rounded to the
    working dtype, (N, H, W, 128)."""
    dt = buf.dtype
    x = buf[..., :c_in].reshape(-1, c_in)
    h1 = None
    for g in range(0, c_in, GROUP):
        e = min(g + GROUP, c_in)
        y = torch.relu(x[:, g:e].float() * a1[g:e] + b1[g:e]).to(dt)
        t = _product(y, w1[g:e]).float()
        h1 = t if h1 is None else h1 + t
    return h1.to(dt).reshape(buf.shape[:3] + (-1,))


def _dense_block_pk(buf: torch.Tensor, layers, tap=None, name: str = "") -> None:
    """The `xla_pk` dense block, in place: per layer the bottleneck, then K5
    writes the 32 channels at the layer's offset (the merge variant where
    the TPU's width allowed it, _dense_block_pk_merge, fast_trunk.py:204-236;
    the plain variant elsewhere, :106-115: one kernel here)."""
    for l, (c_in, a1, b1, w1, a2, b2, w2) in enumerate(layers):
        h1 = _bottleneck(buf, c_in, a1, b1, w1)
        k5.conv2_bn_relu(h1, a2, b2, w2, out=buf[..., c_in:c_in + GROWTH_RATE])
        if tap:
            tap(f"{name}.layer{l + 1}", buf[..., c_in:c_in + GROWTH_RATE])


def _stem_xla(x: torch.Tensor, ops: dict) -> torch.Tensor:
    """The stem in its XLA form (fast_trunk.py:50-59), for the `pallas`
    backend: gray-tap conv0, f32 affine, ReLU, rounding, then a 3x3 / s2
    max pool with -inf padding."""
    y = _stem_conv(x, ops["kg"])
    a0, b0 = ops["stem"]
    y = torch.relu(y.float() * a0 + b0).to(y.dtype)
    return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)


def _trunk_pallas(trunk: DenseNetTrunk, x: torch.Tensor, tap=None):
    """The `pallas` backend (fast_trunk.py:382-401): the XLA-form stem, then
    one K7 call per dense block; blocks 1-3 end in the transition
    epilogue, written into the next block's buffer, block 4 in norm5. A
    block's own output stays inside K7: `tap` sees the stem, the
    transitions and norm5."""
    dt = trunk.dtype
    cfg = trunk.block_config
    y = _stem_xla(x, trunk_operands(trunk))
    if tap:
        tap("stem", y)
    N, H, W, C = y.shape
    buf = torch.empty((N, H, W, C + GROWTH_RATE * cfg[0]), dtype=dt, device=x.device)
    buf[..., :C] = y
    for i, (packed, ep, epilogue) in enumerate(block_operands(trunk)):
        out = None
        if epilogue == "transition":
            c_out = ep["wt"].shape[1]
            H, W = H // 2, W // 2
            nxt = torch.empty((N, H, W, c_out + GROWTH_RATE * cfg[i + 1]), dtype=dt,
                              device=x.device)
            out = nxt[..., :c_out]
        res = k7.dense_block_apply(buf, packed, ep, epilogue, out=out)
        if out is not None:
            buf = nxt
            if tap:
                tap(f"transition{i + 1}", out)
    if tap:
        tap("norm5", res)
    return res


def trunk_features_eval(trunk: DenseNetTrunk, x: torch.Tensor,
                        backend: str = "xla_fl", tap=None) -> torch.Tensor:
    """(N, S, S, 3) preprocessed input -> (N, S/32, S/32, C_final).

    backend (the JAX package's names, fast_trunk.py:337-401):
      "xla_fl"  K4 stem, K2 per dense layer, K3 transitions (the trainer's);
      "xla_pk"  K4 stem, per dense layer the plain bottleneck then K5, K3
                transitions;
      "pallas"  the XLA-form stem, then K7 per dense block with its
                transition or norm5 epilogue.
    norm5 stays plain on the xla backends. The JAX-only lowerings ("xla",
    "xla_conv", "xla_s2d") have no kernel and are not ported.

    tap(name, tensor), when given, sees each stage's output as it is made,
    NHWC in the working dtype: "stem" (block 1's input), "block{i}" and
    its layers' new channels "block{i}.layer{l}", "transition{i}",
    "norm5" (stage_parity.py reads them; `pallas` shows no block or layer).
    """
    if not isinstance(trunk, DenseNetTrunk):
        raise TypeError("the eval backends run DenseNet-121 trunks only; the tiny "
                        "trunk scores through AffordanceNet.score")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "pallas":
        return _trunk_pallas(trunk, x, tap)
    ops = trunk_operands(trunk)
    dt = trunk.dtype
    y = _stem_conv(x, ops["kg"])
    N, Hc, Wc, C = y.shape
    H, W = k4.out_hw(Hc), k4.out_hw(Wc)
    cfg = trunk.block_config
    buf = torch.empty((N, H, W, C + GROWTH_RATE * cfg[0]), dtype=dt,
                      device=x.device)
    k4.bn_relu_maxpool(y, *ops["stem"], out=buf[..., :C])
    if tap:
        tap("stem", buf[..., :C])
    for i, layers in enumerate(ops["blocks"]):
        name = f"block{i + 1}"
        if backend == "xla_fl":
            for l, (c_in, a1, b1, w1, a2, b2, w2) in enumerate(layers):
                k2.dense_layer(buf, c_in, a1, b1, w1, a2, b2, w2)
                if tap:
                    tap(f"{name}.layer{l + 1}", buf[..., c_in:c_in + GROWTH_RATE])
        else:
            with _f32_reduction():
                _dense_block_pk(buf, layers, tap, name)
        if tap:
            tap(name, buf)
        if i < len(cfg) - 1:
            a, b, wt = ops["transitions"][i]
            c_out = wt.shape[1]
            H, W = H // 2, W // 2
            nxt = torch.empty((N, H, W, c_out + GROWTH_RATE * cfg[i + 1]),
                              dtype=dt, device=x.device)
            k3.transition(buf, a, b, wt, out=nxt[..., :c_out])
            buf = nxt
            if tap:
                tap(f"transition{i + 1}", buf[..., :c_out])
    a5, b5 = ops["norm5"]
    out = (buf.float() * a5 + b5).to(dt)
    if tap:
        tap("norm5", out)
    return out


def head_eval(head, x: torch.Tensor, num_out: int, tap=None) -> torch.Tensor:
    """AffordanceHead eval forward (fast_trunk.py:966-983):
    (B, h, w, C) -> (B, num_out) f32. f32 accumulation of the working-dtype
    operands (an f32 product of bf16 values is exact). tap as in
    trunk_features_eval: "head.norm0" (after its ReLU), "head.conv0",
    "head.norm1" (after its ReLU), (B, h, w, c)."""
    dt = x.dtype
    a0, b0 = fold_bn(head.norm0)
    h = torch.relu(x.float() * a0 + b0).to(dt)
    if tap:
        tap("head.norm0", h)
    k0 = head.conv0.weight.detach().reshape(head.conv0.out_channels, -1)
    h = h.reshape(-1, k0.shape[1]).float() @ k0.t().to(dt).float()
    if tap:
        tap("head.conv0", h.reshape(x.shape[:3] + (-1,)))
    a1, b1 = fold_bn(head.norm1)
    h = torch.relu(h * a1 + b1).to(dt)
    if tap:
        tap("head.norm1", h.reshape(x.shape[:3] + (-1,)))
    k1 = head.conv1.weight.detach().permute(2, 3, 1, 0).reshape(-1, num_out)
    return h.reshape(x.shape[0], -1).float() @ k1.to(dt).float()


def trunk_input(scene_img: torch.Tensor, mask_imgs: torch.Tensor):
    """One trunk batch of the two streams: (x, B, R) with x the B * R scene
    images, then the B * M masks. Scenes (B, S, S, 3) are R = 1; (B, R, S,
    S, 3) are R rotations of each scene, which share the mask streams."""
    scenes = scene_img if scene_img.dim() == 5 else scene_img[:, None]
    B, R = scenes.shape[:2]
    M = mask_imgs.shape[1]
    x = torch.cat([scenes.reshape((B * R,) + scenes.shape[2:]),
                   mask_imgs.reshape((B * M,) + mask_imgs.shape[2:])], 0)
    return x, B, R


def pair_features(feats: torch.Tensor, B: int, R: int) -> torch.Tensor:
    """Trunk features of a trunk_input batch -> the head's input (B * M *
    R, h, w, 2C): each object slot's mask features beside each rotation's
    scene features, scene first (affordance.py:150-163), ordered (scene,
    slot, rotation)."""
    h, w, c = feats.shape[1:]
    scene = feats[:B * R].reshape(B, 1, R, h, w, c)
    mask = feats[B * R:].reshape(B, -1, 1, h, w, c)
    M = mask.shape[1]
    both = torch.cat([scene.expand(B, M, R, h, w, c), mask.expand(B, M, R, h, w, c)], -1)
    return both.reshape(B * M * R, h, w, 2 * c)


def head_rows(feats: torch.Tensor, scene_rows: torch.Tensor,
              mask_rows: torch.Tensor) -> torch.Tensor:
    """Trunk features of a packed call -> the head's input (Q, h, w, 2C):
    row q is image mask_rows[q]'s features beside image scene_rows[q]'s,
    scene first, as pair_features lays them out."""
    return torch.cat([feats[scene_rows], feats[mask_rows]], -1)


def score_eval_rows(trunk, head, x: torch.Tensor, scene_rows: torch.Tensor,
                    mask_rows: torch.Tensor, num_out: int,
                    backend: str = "xla_fl") -> torch.Tensor:
    """score_eval of a packed trunk call: one trunk call over any scene and
    mask images x (N, S, S, 3), then the head on the Q rows that
    head_rows pairs by index -> (Q, num_out) f32."""
    feats = trunk_features_eval(trunk, x, backend)
    return head_eval(head, head_rows(feats, scene_rows, mask_rows), num_out)


def score_eval(trunk, head, scene_img: torch.Tensor, mask_imgs: torch.Tensor,
               num_out: int, backend: str = "xla_fl", tap=None) -> torch.Tensor:
    """Eval AffordanceNet.score (fast_trunk.py:986-1014): one trunk call
    over the scene + masked streams, scene features broadcast across the
    M object slots, head on the concatenated features. Scenes (B, S, S, 3)
    -> (B, M, num_out); R rotations of each scene (B, R, S, S, 3) -> (B, M,
    R, num_out), each mask stream computed once for all R. tap: see
    trunk_features_eval and head_eval."""
    x, B, R = trunk_input(scene_img, mask_imgs)
    feats = trunk_features_eval(trunk, x, backend, tap)
    out = head_eval(head, pair_features(feats, B, R), num_out,
                    tap).reshape(B, -1, R, num_out)
    return out if scene_img.dim() == 5 else out[:, :, 0]


# ---------------------------------------------------------------------------
# Train mode (the update's forward; autograd gives the backward)
# ---------------------------------------------------------------------------


def _bn_train(xf: torch.Tensor, bn: torch.nn.BatchNorm2d, moments: list):
    """Per-image batch BN of f32 (N, ..., C): the affine (a, b), each
    (N, 1, 1, C), differentiable through the moments. Appends
    (bn, mean, var) with detached (N, C) moments to `moments`."""
    dims = tuple(range(1, xf.dim() - 1))
    mean = xf.mean(dim=dims)
    var = (xf * xf).mean(dim=dims) - mean * mean
    a = bn.weight * torch.rsqrt(var + BN_EPS)
    b = bn.bias - mean * a
    moments.append((bn, mean.detach(), var.detach()))
    return a[:, None, None, :], b[:, None, None, :]


def _dense_layer_conv(x: torch.Tensor, lay, moments: list) -> torch.Tensor:
    """conv2='conv': one dense layer as the JAX conv form
    (_dense_layer_train, fast_trunk.py:438-495); h1 stays f32."""
    dt = x.dtype
    N, H, W, C = x.shape
    xf = x.float()
    a1, b1 = _bn_train(xf, lay.norm1, moments)
    y1 = torch.relu(xf * a1 + b1).to(dt)
    w1 = lay.conv1.weight.reshape(-1, C).t().to(dt)
    h1 = (y1.float().reshape(-1, C) @ w1.float()).reshape(N, H, W, -1)
    a2, b2 = _bn_train(h1, lay.norm2, moments)
    h2 = torch.relu(h1 * a2 + b2).to(dt).permute(0, 3, 1, 2)
    new = F.conv2d(h2, lay.conv2.weight.to(dt), padding=1)
    return new.permute(0, 2, 3, 1).to(dt)


def _dense_block_train(block, x0: torch.Tensor, conv2: str, moments: list):
    layers = list(block.children())
    if conv2 == "pk":
        ops = [(lay.conv1.weight.reshape(lay.conv1.out_channels, -1).t(),
                lay.norm1.weight, lay.norm1.bias,
                lay.conv2.weight.permute(2, 3, 1, 0).reshape(9, lay.conv2.in_channels, -1),
                lay.norm2.weight, lay.norm2.bias) for lay in layers]
        buf, moms = k6.dense_block_train(x0, ops)
        for lay, (m1, v1, m2, v2) in zip(layers, moms):
            moments += [(lay.norm1, m1, v1), (lay.norm2, m2, v2)]
        return buf
    feats = [x0]
    for lay in layers:
        x = feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)
        feats.append(_dense_layer_conv(x, lay, moments))
    return torch.cat(feats, dim=-1)


def _transition_train(tr, x: torch.Tensor, moments: list) -> torch.Tensor:
    """BN, ReLU, 2x2 mean (f32, rounded), 1x1 conv (fast_trunk.py:866-896)."""
    dt = x.dtype
    N, H, W, C = x.shape
    xf = x.float()
    a, b = _bn_train(xf, tr.norm, moments)
    h = torch.relu(xf * a + b).to(dt)
    h = h.float().reshape(N, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4)).to(dt)
    kf = tr.conv.weight.reshape(tr.conv.out_channels, C).t().to(dt)
    out = h.float().reshape(-1, C) @ kf.float()
    return out.to(dt).reshape(N, H // 2, W // 2, -1)


def trunk_features_train(trunk: DenseNetTrunk, x: torch.Tensor, conv2: str = "conv"):
    """Train-mode DenseNet features with per-image BN (fast_trunk.py:828-906):
    (N, S, S, 3) -> ((N, S/32, S/32, C_final), moments), where moments is a
    list of (bn_module, mean (N, C), var (N, C)) in forward order."""
    if conv2 not in TRAIN_CONV2:
        raise ValueError(f"conv2 must be one of {TRAIN_CONV2}, got {conv2!r}")
    dt = trunk.dtype
    moments: list = []
    # Gray-tap stem conv0: the input channels are equal, so the kernel's
    # sum over them gives the same conv, and its gradient reaches all three.
    kg = trunk.conv0.weight.sum(dim=1, keepdim=True).to(dt)
    y = F.conv2d(x[..., :1].to(dt).permute(0, 3, 1, 2), kg, stride=2, padding=3)
    yf = y.permute(0, 2, 3, 1).float()
    a0, b0 = _bn_train(yf, trunk.norm0, moments)
    y = torch.relu(yf * a0 + b0).to(dt).permute(0, 3, 1, 2)
    x = F.max_pool2d(y, 3, stride=2, padding=1).permute(0, 2, 3, 1)
    n_blocks = len(trunk.block_config)
    for i in range(n_blocks):
        x = _dense_block_train(getattr(trunk, f"denseblock{i + 1}"), x, conv2, moments)
        if i < n_blocks - 1:
            x = _transition_train(getattr(trunk, f"transition{i + 1}"), x, moments)
    xf = x.float()
    a5, b5 = _bn_train(xf, trunk.norm5, moments)
    return (xf * a5 + b5).to(dt), moments


def tiny_features_train(trunk: TinyTrunk, x: torch.Tensor):
    """Train-mode tiny trunk with per-image BN (Flax TinyTrunk under
    train=True at batch 1 per stream, densenet.py:146-163): (N, S, S, 3) ->
    ((N, S/32, S/32, 1024), moments)."""
    dt = trunk.dtype
    moments: list = []
    with no_tf32():
        h = x.to(dt).permute(0, 3, 1, 2)
        for i in range(len(TINY_WIDTHS)):
            y = F.conv2d(h, getattr(trunk, f"conv{i}").weight.to(dt), stride=2, padding=1)
            yf = y.permute(0, 2, 3, 1).float()
            a, b = _bn_train(yf, getattr(trunk, f"norm{i}"), moments)
            h = torch.relu(yf * a + b).to(dt).permute(0, 3, 1, 2)
        out = F.conv2d(h, trunk.proj.weight.to(dt))
    return out.permute(0, 2, 3, 1), moments


def head_train(head, x: torch.Tensor, num_out: int):
    """AffordanceHead train forward with per-image BN (fast_trunk.py:909-928):
    (N, h, w, C) -> ((N, num_out) f32, moments)."""
    dt = x.dtype
    moments: list = []
    xf = x.float()
    a0, b0 = _bn_train(xf, head.norm0, moments)
    h = torch.relu(xf * a0 + b0).to(dt)
    k0 = head.conv0.weight.reshape(head.conv0.out_channels, -1).t().to(dt)
    h = (h.float().reshape(-1, k0.shape[0]) @ k0.float()).reshape(x.shape[:3] + (-1,))
    a1, b1 = _bn_train(h, head.norm1, moments)
    h = torch.relu(h * a1 + b1).to(dt)
    k1 = head.conv1.weight.permute(2, 3, 1, 0).reshape(-1, num_out).to(dt)
    return h.float().reshape(x.shape[0], -1) @ k1.float(), moments


def _running(old: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
    return _KEEP * old + (1.0 - _KEEP) * stat


def score_train(trunk, head, scene_img: torch.Tensor, mask_img: torch.Tensor,
                num_out: int, conv2: str = "conv"):
    """Train-mode AffordanceNet.score of n scenes, one exec mask each
    (fast_trunk.py:931-963 per scene, as the update calls it with batch 1);
    a tiny trunk goes through tiny_features_train.

    scene_img, mask_img (n, S, S, 3). The 2n streams go through one trunk
    call (per-image BN keeps them independent); the head reads the
    concatenated features. Returns (out (n, num_out) f32, new_stats), where
    new_stats maps each BatchNorm module of the trunk and head to its
    per-scene running (mean, var), each (n, C): the scene pass's update
    feeds the mask pass's, as the two sequential Flax calls do.
    """
    n = scene_img.shape[0]
    both = torch.cat([scene_img, mask_img])
    if isinstance(trunk, TinyTrunk):
        if conv2 != "conv":
            raise ValueError(f"fast_train_conv2={conv2!r}: the tiny trunk has no dense "
                             "layers; it trains through its module form ('conv')")
        feats, moments = tiny_features_train(trunk, both)
    else:
        feats, moments = trunk_features_train(trunk, both, conv2)
    out, head_moments = head_train(head, torch.cat([feats[:n], feats[n:]], dim=-1),
                                   num_out)
    new = {}
    with torch.no_grad():
        for bn, m, v in moments:
            new[bn] = (_running(_running(bn.running_mean, m[:n]), m[n:]),
                       _running(_running(bn.running_var, v[:n]), v[n:]))
        for bn, m, v in head_moments:
            new[bn] = (_running(bn.running_mean, m), _running(bn.running_var, v))
    return out, new
