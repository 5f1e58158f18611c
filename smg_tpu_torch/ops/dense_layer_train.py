"""K6: the train-mode dense layer, forward and backward (csrc/dense_layer_train.cu).

Port of smg_tpu/ops/dense_layer_train_pallas.py::layer_train_fwd (K6a) and
::layer_train_bwd (K6b), the kernels of the JAX update under
fast_train_conv2='pk'. There each scene ran its layer as a batch-1 call;
here one call covers N images of a dense block's NHWC buffer, each with
its own BatchNorm moments over (H, W), which is what vmap over batch-1
calls computed. For the prefix x = buf[..., :C_in]:

  forward   m1, v1 = E[x], E[x^2] - E[x]^2 per image;  a1 = s1 rsqrt(v1 + eps)
            h1 = bf16( sum_c bf16(relu(x a1 + b1)) w1 )          (the residual)
            m2, v2 of h1;  y2 = bf16(relu(h1 a2 + b2)), zero off the image
            out = bf16( sum_tap bf16(y2[pixel + tap] w2[tap]) )   -> buf[C_in:+32]
  backward  from dout = bf16(dbuf[..., C_in:C_in+32]) (an f32 cotangent
            buffer): dw1, dw2 and the BN scale/bias gradients, summed over
            images, and dbuf[..., :C_in] += bf16(dx).

The rounding points are the TPU kernel's; in float32 (the CPU tests) they
vanish and the layer is _layer_vjp's. The plain versions below repeat the
arithmetic in PyTorch; the wrappers take them only for CPU tensors.

`dense_block_train` wraps a whole dense block in one autograd Function:
the eval path's in-place block buffer breaks a per-layer autograd graph.
Its forward runs K6a layer by layer into the buffer and saves the final
buffer (layer l's input is its first C_in(l) channels), each h1 and the
moments; its backward walks the layers in reverse through K6b, summing
each prefix's cotangent in an f32 block buffer. The JAX package summed
those cotangents in bf16 (autodiff of its segment list); the port sums in
f32, so in bf16 its input gradients carry less rounding than JAX's, and
the two agree only to bf16 tolerance. In float32 they agree to rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smg_tpu_torch.ops import _build
from smg_tpu_torch.ops.conv2 import conv3x3_plan

fwd_launches = 0
bwd_launches = 0

BOTTLENECK = 128
GROWTH = 32
N_TAPS = 9
BN_EPS = 1e-5


def _img(t: torch.Tensor) -> torch.Tensor:
    """(N, C) per-image values -> broadcastable over (N, H, W, C)."""
    return t[:, None, None, :]


def _moments(x: torch.Tensor):
    """Per-image mean and E[x^2] - E[x]^2 over (H, W) of f32 (N, H, W, C)."""
    m = x.mean(dim=(1, 2))
    return m, (x * x).mean(dim=(1, 2)) - m * m


def _affine(mean, var, scale, bias):
    a = scale * torch.rsqrt(var + BN_EPS)
    return a, bias - mean * a


def _shifted(d: torch.Tensor, tap: int) -> torch.Tensor:
    """d[pixel + (1 - dy, 1 - dx)] with zeros off the image, tap = 3 dy + dx."""
    dy, dx = divmod(tap, 3)
    H, W = d.shape[1:3]
    dp = F.pad(d, (0, 0, 1, 1, 1, 1))
    return dp[:, 2 - dy:2 - dy + H, 2 - dx:2 - dx + W]


def layer_fwd_plain(buf, c_in, w1, s1, bi1, w2, s2, bi2):
    """Plain K6a. buf (N, H, W, ld) in the compute dtype; writes the 32 new
    channels at [c_in, c_in + 32). Returns (h1, mean1, var1, mean2, var2)."""
    dt = buf.dtype
    N, H, W, _ = buf.shape
    x = buf[..., :c_in].float()
    m1, v1 = _moments(x)
    a1, b1 = _affine(m1, v1, s1, bi1)
    y1 = torch.relu(x * _img(a1) + _img(b1)).to(dt).float()
    h1 = (y1.reshape(-1, c_in) @ w1.float()).to(dt).reshape(N, H, W, BOTTLENECK)
    h1f = h1.float()
    m2, v2 = _moments(h1f)
    a2, b2 = _affine(m2, v2, s2, bi2)
    y2 = torch.relu(h1f * _img(a2) + _img(b2)).to(dt).float()
    yp = F.pad(y2, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((N, H, W, GROWTH), dtype=torch.float32, device=buf.device)
    for tap in range(N_TAPS):
        dy, dx = divmod(tap, 3)
        acc = acc + (yp[:, dy:dy + H, dx:dx + W] @ w2[tap].float()).to(dt).float()
    buf[..., c_in:c_in + GROWTH] = acc.to(dt)
    return h1, m1, v1, m2, v2


def layer_bwd_plain(buf, dbuf, c_in, h1, w1, w2, s1, bi1, s2, bi2, m1, v1, m2, v2):
    """Plain K6b. dbuf (N, H, W, ld) f32: reads the layer's cotangent at
    [c_in, c_in + 32), adds bf16(dx) to [0, c_in). Returns
    (dw1 (C_in, 128), dw2 (9, 128, 32), dscale1, dbias1, dscale2, dbias2)."""
    dt = buf.dtype
    N, H, W, _ = buf.shape
    n = float(H * W)
    dout = dbuf[..., c_in:c_in + GROWTH].to(dt).float()
    shifted = [_shifted(dout, tap) for tap in range(N_TAPS)]
    h1f = h1.float()
    r2 = torch.rsqrt(v2 + BN_EPS)
    a2, b2 = _affine(m2, v2, s2, bi2)
    u2 = h1f * _img(a2) + _img(b2)
    dy2 = sum(shifted[t] @ w2[t].float().t() for t in range(N_TAPS))
    du2 = torch.where(u2 > 0, dy2, torch.zeros_like(dy2))
    xh2 = (h1f - _img(m2)) * _img(r2)
    sdu2, sduh2 = du2.sum(dim=(1, 2)), (du2 * xh2).sum(dim=(1, 2))
    dh1 = (_img(a2) * (du2 - _img(sdu2 / n) - xh2 * _img(sduh2 / n))).to(dt).float()
    y2 = torch.relu(u2).to(dt).float().reshape(-1, BOTTLENECK)
    dw2 = torch.stack([y2.t() @ shifted[t].reshape(-1, GROWTH)
                       for t in range(N_TAPS)])
    x = buf[..., :c_in].float()
    r1 = torch.rsqrt(v1 + BN_EPS)
    a1, b1 = _affine(m1, v1, s1, bi1)
    u1 = x * _img(a1) + _img(b1)
    y1 = torch.relu(u1).to(dt).float().reshape(-1, c_in)
    dh1_2d = dh1.reshape(-1, BOTTLENECK)
    dw1 = y1.t() @ dh1_2d
    dy1 = (dh1_2d @ w1.float().t()).reshape(u1.shape)
    du1 = torch.where(u1 > 0, dy1, torch.zeros_like(dy1))
    xh1 = (x - _img(m1)) * _img(r1)
    sdu1, sduh1 = du1.sum(dim=(1, 2)), (du1 * xh1).sum(dim=(1, 2))
    dx = _img(a1) * (du1 - _img(sdu1 / n) - xh1 * _img(sduh1 / n))
    dbuf[..., :c_in] += dx.to(dt).float()
    return (dw1, dw2, sduh1.sum(0), sdu1.sum(0), sduh2.sum(0), sdu2.sum(0))


def _check_layer(buf, c_in, w1, s1, bi1, w2, s2, bi2):
    ld = buf.shape[-1]
    _build.check_cuda(buf, "buf", torch.bfloat16)
    _build.check_cuda(w1, "w1", torch.bfloat16, (c_in, BOTTLENECK))
    _build.check_cuda(s1, "s1", torch.float32, (c_in,))
    _build.check_cuda(bi1, "bi1", torch.float32, (c_in,))
    _build.check_cuda(w2, "w2", torch.bfloat16, (N_TAPS, BOTTLENECK, GROWTH))
    _build.check_cuda(s2, "s2", torch.float32, (BOTTLENECK,))
    _build.check_cuda(bi2, "bi2", torch.float32, (BOTTLENECK,))
    if c_in % 32 or c_in + GROWTH > ld or ld % 8 or buf.dim() != 4:
        raise ValueError(f"unsupported layer: C_in {c_in}, buffer {tuple(buf.shape)}")


def layer_fwd(buf, c_in: int, w1, s1, bi1, w2, s2, bi2):
    """K6a, in place in the block buffer buf (N, H, W, ld).

    w1 (C_in, 128), w2 (9, 128, 32) in buf's dtype (tap = 3 dy + dx);
    s1, bi1 (C_in,), s2, bi2 (128,) f32: norm1's and norm2's scale and bias.
    Returns h1 (N, H, W, 128) in buf's dtype and the per-image moments
    mean1, var1 (N, C_in), mean2, var2 (N, 128) f32.
    On the card buf and the weights are bf16 and C_in is a multiple of 32.
    """
    global fwd_launches
    if buf.device.type == "cpu":
        return layer_fwd_plain(buf, c_in, w1, s1, bi1, w2, s2, bi2)
    _check_layer(buf, c_in, w1, s1, bi1, w2, s2, bi2)
    N, H, W, ld = buf.shape
    dev = buf.device
    h1 = torch.empty((N, H, W, BOTTLENECK), dtype=torch.bfloat16, device=dev)
    st1 = torch.empty((4, N, c_in), dtype=torch.float32, device=dev)
    st2 = torch.empty((4, N, BOTTLENECK), dtype=torch.float32, device=dev)
    _build.check_aligned(w2=w2)
    _build.launch("smg_dense_layer_train_fwd", buf.data_ptr(), w1.data_ptr(),
                  s1.data_ptr(), bi1.data_ptr(), w2.data_ptr(), s2.data_ptr(),
                  bi2.data_ptr(), h1.data_ptr(), st1.data_ptr(), st2.data_ptr(),
                  N, H, W, ld, c_in, *conv3x3_plan(N, H, W, _build.sm_count(dev)).args())
    fwd_launches += 1
    return h1, st1[0], st1[1], st2[0], st2[1]


def _splits(P: int, m: int, n: int, sms: int):
    """(splits, chunk) of the pixel axis for an m x n weight gradient: about
    two waves of 64 x 64 tiles on `sms` multiprocessors, chunks a multiple
    of 32 pixels."""
    tiles = -(-m // 64) * -(-n // 64)
    target = max(1, -(-2 * sms // tiles))
    chunk = -(-max(32, -(-P // target)) // 32) * 32
    return -(-P // chunk), chunk


def layer_bwd(buf, dbuf, c_in: int, h1, w1, w2, s1, bi1, s2, bi2, m1, v1, m2, v2):
    """K6b: the backward of layer_fwd, accumulating into dbuf.

    dbuf (N, H, W, ld) f32 holds the block's cotangent: the layer reads its
    32 channels' cotangent at [c_in, c_in + 32) and adds bf16(dx) to
    [0, c_in). The other operands are layer_fwd's inputs and outputs.
    Returns (dw1 (C_in, 128), dw2 (9, 128, 32), dscale1, dbias1 (C_in,),
    dscale2, dbias2 (128,)), all f32 and summed over the N images; the
    weight gradients reduce in a fixed order (deterministic).
    """
    global bwd_launches
    if buf.device.type == "cpu":
        return layer_bwd_plain(buf, dbuf, c_in, h1, w1, w2, s1, bi1, s2, bi2,
                               m1, v1, m2, v2)
    _check_layer(buf, c_in, w1, s1, bi1, w2, s2, bi2)
    N, H, W, ld = buf.shape
    _build.check_cuda(dbuf, "dbuf", torch.float32, (N, H, W, ld))
    _build.check_cuda(h1, "h1", torch.bfloat16, (N, H, W, BOTTLENECK))
    for t, name, c in ((m1, "mean1", c_in), (v1, "var1", c_in),
                       (m2, "mean2", BOTTLENECK), (v2, "var2", BOTTLENECK)):
        _build.check_cuda(t, name, torch.float32, (N, c))
    dev, P = buf.device, N * H * W
    f32 = dict(dtype=torch.float32, device=dev)
    ldw1 = -(-c_in // 128) * 128
    w1t = torch.zeros((BOTTLENECK, ldw1), dtype=torch.bfloat16, device=dev)
    w1t[:, :c_in] = w1.t()
    w2t = w2.permute(0, 2, 1).reshape(N_TAPS * GROWTH, BOTTLENECK).contiguous()
    aff1 = torch.empty((2, N, c_in), **f32)
    aff2 = torch.empty((2, N, BOTTLENECK), **f32)
    du2 = torch.empty((P, BOTTLENECK), **f32)
    dh1 = torch.empty((P, BOTTLENECK), dtype=torch.bfloat16, device=dev)
    du1 = torch.empty((P, c_in), **f32)
    sums1 = torch.empty((2, N, c_in), **f32)
    sums2 = torch.empty((2, N, BOTTLENECK), **f32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split1, chunk1 = _splits(P, c_in, BOTTLENECK, sms)
    split2, chunk2 = _splits(P, BOTTLENECK, N_TAPS * GROWTH, sms)
    part1 = torch.empty((split1, c_in, BOTTLENECK), **f32)
    part2 = torch.empty((split2, BOTTLENECK, N_TAPS * GROWTH), **f32)
    _build.launch("smg_dense_layer_train_bwd", buf.data_ptr(), dbuf.data_ptr(),
                  h1.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), s1.data_ptr(),
                  bi1.data_ptr(), m1.data_ptr(), v1.data_ptr(), s2.data_ptr(),
                  bi2.data_ptr(), m2.data_ptr(), v2.data_ptr(), aff1.data_ptr(),
                  aff2.data_ptr(), du2.data_ptr(), dh1.data_ptr(), du1.data_ptr(),
                  sums1.data_ptr(), sums2.data_ptr(), part1.data_ptr(),
                  part2.data_ptr(), N, H, W, ld, c_in, ldw1, split1, chunk1,
                  split2, chunk2)
    bwd_launches += 1
    dw2 = part2.sum(0).reshape(BOTTLENECK, N_TAPS, GROWTH).permute(1, 0, 2)
    return (part1.sum(0), dw2.contiguous(), sums1[1].sum(0), sums1[0].sum(0),
            sums2[1].sum(0), sums2[0].sum(0))


class _DenseBlockTrain(torch.autograd.Function):
    """A dense block through K6: see the module docstring."""

    @staticmethod
    def forward(ctx, x0, *flat):
        L = len(flat) // 6
        N, H, W, C0 = x0.shape
        dt = x0.dtype
        buf = torch.empty((N, H, W, C0 + GROWTH * L), dtype=dt, device=x0.device)
        buf[..., :C0] = x0
        saved, moments = [], []
        for l in range(L):
            w1f, s1, bi1, w2f, s2, bi2 = flat[6 * l:6 * l + 6]
            out = layer_fwd(buf, C0 + GROWTH * l, w1f.to(dt).contiguous(), s1,
                            bi1, w2f.to(dt).contiguous(), s2, bi2)
            saved += out
            moments += out[1:]
        ctx.save_for_backward(buf, *flat, *saved)
        ctx.layers, ctx.c0 = L, C0
        ctx.mark_non_differentiable(*moments)
        return (buf, *moments)

    @staticmethod
    def backward(ctx, dout, *_):
        buf, *rest = ctx.saved_tensors
        L, C0 = ctx.layers, ctx.c0
        flat, saved = rest[:6 * L], rest[6 * L:]
        dt = buf.dtype
        dbuf = torch.empty(buf.shape, dtype=torch.float32, device=buf.device)
        dbuf.copy_(dout)
        grads = [None] * (6 * L)
        for l in reversed(range(L)):
            w1f, s1, bi1, w2f, s2, bi2 = flat[6 * l:6 * l + 6]
            h1, m1, v1, m2, v2 = saved[5 * l:5 * l + 5]
            dw1, dw2, ds1, db1, ds2, db2 = layer_bwd(
                buf, dbuf, C0 + GROWTH * l, h1, w1f.to(dt).contiguous(),
                w2f.to(dt).contiguous(), s1, bi1, s2, bi2, m1, v1, m2, v2)
            grads[6 * l:6 * l + 6] = [dw1, ds1, db1, dw2, ds2, db2]
        return (dbuf[..., :C0].to(dt), *grads)


def dense_block_train(x0: torch.Tensor, layers) -> tuple:
    """A train-mode dense block through K6 with autograd.

    x0 (N, H, W, C0) in the compute dtype; `layers` a sequence of
    (w1 (C_in, 128), s1, bi1, w2 (9, 128, 32), s2, bi2) f32 tensors (views
    of the module's parameters, so that the gradients reach them).
    Returns (buf (N, H, W, C0 + 32 L), [(mean1, var1, mean2, var2)] * L)
    with per-image moments (N, C) that carry no gradient.
    """
    flat = [t for layer in layers for t in layer]
    out = _DenseBlockTrain.apply(x0, *flat)
    buf, moments = out[0], out[1:]
    return buf, [tuple(moments[4 * l:4 * l + 4]) for l in range(len(layers))]
