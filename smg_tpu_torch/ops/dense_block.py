"""K7: a whole eval dense block and its fused epilogue (csrc/dense_block.cu).

Port of smg_tpu/ops/dense_block_pallas.py::dense_block_apply (with
pack_dense_block, pack_transition, pack_final_bn), the `pallas` eval
backend (fast_trunk.py:382-401). The block's NHWC buffer holds the block
input in channels [0, C0); layer l (C = C0 + 32 l) computes

  y1  = bf16( relu(x[..., :C] * a1 + b1) )
  t   = y1 @ w1                            one f32 accumulation, not rounded
  h2  = bf16( relu(t * a2 + b2) ), zero outside the image
  new = bf16( sum_tap p_tap )              p_tap = bf16(tap product) when
                                           taps_packed, else the f32 product

and writes `new` at channels [C, C + 32) in place. The epilogue then reads
the whole buffer (dense_block_pallas.py:374-403):

  transition  hs = bf16(relu(feat * at + bt)); a 2x2 pool in bf16
              arithmetic (row-pair sum, column-pair sum, x 0.25); out =
              bf16(pooled @ wt), f32 accumulation -> (N, H/2, W/2, C_out)
  final_bn    out = bf16(feat * at + bt), no ReLU  -> (N, H, W, Cf)

One wrapper call runs the whole block and its epilogue and counts one
launch. The TPU's BlockGeom (B_tile, row bands with an L-row halo, width
and channel padding, the selection-matrix append) existed for 16 MB of
VMEM and has no counterpart: any N, H, W.
"""

from __future__ import annotations

import torch

from smg_tpu_torch.ops import _build
from smg_tpu_torch.ops.conv2 import BOTTLENECK, GROWTH, N_TAPS, conv3x3_plain, conv3x3_plan
from smg_tpu_torch.ops.dense_layer import gemm_rows
from smg_tpu_torch.ops.transition import transition_plan

launches = 0

EPILOGUES = ("transition", "final_bn")


def pack_dense_block(layers) -> dict:
    """Kernel operands of one block from its layers' (c_in, a1, b1, w1
    (c_in, 128), a2, b2, w2 (9, 128, 32)) tuples, as
    models/fast_trunk.py::trunk_operands builds them: a1, b1 concatenated
    over the layers, w1 stacked row-wise (sum of C_l, 128); a2, b2 (L, 128);
    w2 (L, 9, 128, 32)."""
    return {"c0": layers[0][0], "L": len(layers),
            "a1": torch.cat([l[1] for l in layers]).contiguous(),
            "b1": torch.cat([l[2] for l in layers]).contiguous(),
            "w1": torch.cat([l[3] for l in layers]).contiguous(),
            "a2": torch.stack([l[4] for l in layers]).contiguous(),
            "b2": torch.stack([l[5] for l in layers]).contiguous(),
            "w2": torch.stack([l[6] for l in layers]).contiguous()}


def pack_transition(a, b, wt) -> dict:
    """The transition epilogue: folded BN (Cf,) f32 and the 1x1 (Cf, C_out)."""
    return {"at": a, "bt": b, "wt": wt}


def pack_final_bn(a, b) -> dict:
    """The final_bn epilogue: norm5 folded to (Cf,) f32."""
    return {"at": a, "bt": b, "wt": None}


def _layers(packed):
    off = 0
    for l in range(packed["L"]):
        c = packed["c0"] + GROWTH * l
        yield (c, packed["a1"][off:off + c], packed["b1"][off:off + c],
               packed["w1"][off:off + c], packed["a2"][l], packed["b2"][l],
               packed["w2"][l])
        off += c


def dense_block_apply_plain(buf, packed, ep, epilogue: str, taps_packed: bool = True):
    """Plain version, in place in buf (N, H, W, Cf); returns the epilogue's
    output in buf's dtype."""
    dt = buf.dtype
    N, H, W, Cf = buf.shape
    for c, a1, b1, w1, a2, b2, w2 in _layers(packed):
        y1 = torch.relu(buf[..., :c].float() * a1 + b1).to(dt).float()
        t = y1.reshape(-1, c) @ w1.float()
        h2 = torch.relu(t * a2 + b2).to(dt).float().reshape(N, H, W, BOTTLENECK)
        buf[..., c:c + GROWTH] = conv3x3_plain(h2, w2, dt, taps_packed).to(dt)
    if epilogue == "final_bn":
        return (buf.float() * ep["at"] + ep["bt"]).to(dt)
    hs = torch.relu(buf.float() * ep["at"] + ep["bt"]).to(dt)
    rows = hs[:, 0::2] + hs[:, 1::2]                      # in dt arithmetic
    pooled = (rows[:, :, 0::2] + rows[:, :, 1::2]) * 0.25
    out = pooled.float().reshape(-1, Cf) @ ep["wt"].float()
    return out.reshape(N, H // 2, W // 2, -1).to(dt)


def dense_block_apply(buf, packed, ep, epilogue: str, *, taps_packed: bool = True,
                      out=None):
    """Run one dense block in place in buf (N, H, W, Cf) bf16, whose
    channels [0, C0) hold the block input, then its epilogue.

    Returns the epilogue's output: (N, H/2, W/2, C_out) for "transition",
    (N, H, W, Cf) for "final_bn". `out` may be a channel slice of a wider
    NHWC buffer (the next dense block's), which the epilogue writes in place.
    """
    global launches
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if buf.device.type == "cpu":
        res = dense_block_apply_plain(buf, packed, ep, epilogue, taps_packed)
        if out is None:
            return res
        out.copy_(res)
        return out
    N, H, W, Cf = buf.shape
    c0, L = packed["c0"], packed["L"]
    n1 = L * c0 + GROWTH * L * (L - 1) // 2
    _build.check_cuda(buf, "buf", torch.bfloat16)
    if Cf != c0 + GROWTH * L or c0 % 32:
        raise ValueError(f"unsupported block: C0 {c0}, {L} layers, buffer {Cf}")
    for name, dtype, shape in (("a1", torch.float32, (n1,)), ("b1", torch.float32, (n1,)),
                               ("w1", torch.bfloat16, (n1, BOTTLENECK)),
                               ("a2", torch.float32, (L, BOTTLENECK)),
                               ("b2", torch.float32, (L, BOTTLENECK)),
                               ("w2", torch.bfloat16, (L, N_TAPS, BOTTLENECK, GROWTH))):
        _build.check_cuda(packed[name], name, dtype, shape)
    _build.check_cuda(ep["at"], "at", torch.float32, (Cf,))
    _build.check_cuda(ep["bt"], "bt", torch.float32, (Cf,))
    if epilogue == "transition":
        C_out = ep["wt"].shape[1]
        _build.check_cuda(ep["wt"], "wt", torch.bfloat16, (Cf, C_out))
        if H % 2 or W % 2 or C_out % 128:
            raise ValueError(f"unsupported transition {tuple(buf.shape)} -> {C_out}")
        out_shape, wt_ptr, code = (N, H // 2, W // 2, C_out), ep["wt"].data_ptr(), 0
        tr = transition_plan(N * (H // 2) * (W // 2), Cf, C_out,
                             _build.sm_count(buf.device)).args()
    else:
        C_out = Cf
        out_shape, wt_ptr, code, tr = (N, H, W, Cf), 0, 1, (0,) * 5
    if out is None:
        out = torch.empty(out_shape, dtype=torch.bfloat16, device=buf.device)
    out_ld = _build.check_nhwc_view(out, "out", torch.bfloat16, out_shape)
    _build.check_aligned(buf=buf, at=ep["at"], bt=ep["bt"],
                         **{k: packed[k] for k in ("a1", "b1", "w1", "w2")})
    h2 = torch.empty((N * H * W, BOTTLENECK), dtype=torch.bfloat16, device=buf.device)
    sms = _build.sm_count(buf.device)
    _build.launch("smg_dense_block", buf.data_ptr(), packed["a1"].data_ptr(),
                  packed["b1"].data_ptr(), packed["w1"].data_ptr(),
                  packed["a2"].data_ptr(), packed["b2"].data_ptr(),
                  packed["w2"].data_ptr(), ep["at"].data_ptr(), ep["bt"].data_ptr(),
                  wt_ptr, h2.data_ptr(), out.data_ptr(), N, H, W, c0, L, C_out,
                  out_ld, code, int(taps_packed), gemm_rows(N * H * W, sms),
                  *conv3x3_plan(N, H, W, sms).args(), *tr)
    launches += 1
    return out
