"""Parity: K7 (a whole eval dense block and its fused epilogue) against
dense_block_pallas.dense_block_apply(interpret=True), on the CPU.

The port's plain version on the JAX kernel's own cases
(tests/test_fast_trunk.py:97-147) and a final_bn block: the whole image
resident (16x16, 128 -> 256, transition), each tap's product kept in f32
(taps_packed=False, 8x8, 64 -> 128), two row bands with an L-row halo
(BlockGeom TY=2, 16x8), an unaligned width (12x12, which the TPU pads to 16
and masks) and block 4's shape with the norm5 epilogue (7x7, 512 -> 640).
The TPU's banded result equals its whole-image one, so the port, which has
no bands, must equal both. Bound: KERNEL_TOL (2^-6 of the largest |value|;
test_torch_parity_helpers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.ops import dense_block_pallas as dbp
from smg_tpu_torch.ops import dense_block as k7

from test_torch_parity_helpers import (
    assert_kernel_close,
    bf16_np,
    block_layers,
    bn_np,
    flax_block,
    fold_np,
)

CASES = {  # name: (H, W, C0, L, epilogue, taps_packed, banded)
    "whole_image": (16, 16, 128, 4, "transition", True, False),
    "taps_separate": (8, 8, 64, 2, "transition", False, False),
    "row_bands": (16, 8, 64, 2, "transition", True, True),
    "unaligned_width": (12, 12, 128, 4, "transition", True, False),
    "final_bn": (7, 7, 512, 4, "final_bn", True, False),
}


def _case(name, B=2):
    H, W, C0, L, epilogue, taps_packed, banded = CASES[name]
    rng = np.random.RandomState(H * 1000 + W * 10 + C0 + L)
    bp, bs = flax_block(rng, C0, L)
    Cf = C0 + 32 * L
    ep_p, ep_s = bn_np(rng, Cf)
    C_out = Cf // 2 if epilogue == "transition" else Cf
    wt = (rng.randn(Cf, C_out) * Cf ** -0.5).astype(np.float32)
    x = bf16_np(rng.randn(B, H, W, C0))
    return (H, W, C0, L, epilogue, taps_packed, banded), bp, bs, (ep_p, ep_s, wt), x


@pytest.mark.parametrize("name", list(CASES))
def test_dense_block_matches_pallas(name):
    (H, W, C0, L, epilogue, taps_packed, banded), bp, bs, (ep_p, ep_s, wt), x = _case(name)
    B, Cf = x.shape[0], C0 + 32 * L
    jp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    packed = dbp.pack_dense_block(jp(bp), jp(bs))
    if epilogue == "transition":
        jep = dbp.pack_transition({"norm": jp(ep_p), "conv": {"kernel": jnp.asarray(
            wt.reshape(1, 1, Cf, -1))}}, {"norm": jp(ep_s)})
    else:
        jep = dbp.pack_final_bn(jp(ep_p), jp(ep_s))
    C_out = wt.shape[1]
    if banded:
        geom = dbp.BlockGeom(H=H, W=W, C0=C0, L=L, B_tile=1, TY=2, chunk=4,
                             epilogue=epilogue, C_out=C_out)
    else:
        geom = dbp.choose_geom(H, W, C0, L, epilogue, C_out, B)
    assert (geom.TY > 1) == banded and (geom.W != W) == (W % 8 != 0)
    want = dbp.dense_block_apply(jnp.asarray(x, jnp.bfloat16), packed, jep, geom,
                                 taps_packed=taps_packed, interpret=True)

    at, bt = fold_np(ep_p, ep_s)
    ep = (k7.pack_transition(at, bt, torch.tensor(wt).to(torch.bfloat16))
          if epilogue == "transition" else k7.pack_final_bn(at, bt))
    buf = torch.zeros((B, H, W, Cf), dtype=torch.bfloat16)
    buf[..., :C0] = torch.tensor(x).to(torch.bfloat16)
    got = k7.dense_block_apply(buf, k7.pack_dense_block(block_layers(bp, bs)), ep,
                               epilogue, taps_packed=taps_packed)
    assert got.dtype == torch.bfloat16
    assert_kernel_close(got.float(), want, f"dense block {name}")


def test_dense_block_writes_out_view():
    """The epilogue lands in a channel slice of the next block's buffer;
    the buffer's other channels and the block input stay as they were."""
    (H, W, C0, L, epilogue, taps_packed, _), bp, bs, (ep_p, ep_s, wt), x = _case(
        "taps_separate", B=1)
    at, bt = fold_np(ep_p, ep_s)
    ep = k7.pack_transition(at, bt, torch.tensor(wt).to(torch.bfloat16))
    packed = k7.pack_dense_block(block_layers(bp, bs))
    buf = torch.zeros((1, H, W, C0 + 32 * L), dtype=torch.bfloat16)
    buf[..., :C0] = torch.tensor(x).to(torch.bfloat16)
    ref = k7.dense_block_apply_plain(buf.clone(), packed, ep, epilogue, taps_packed)
    nxt = torch.full((1, H // 2, W // 2, wt.shape[1] + 64), 7.0, dtype=torch.bfloat16)
    out = k7.dense_block_apply(buf, packed, ep, epilogue, taps_packed=taps_packed,
                               out=nxt[..., :wt.shape[1]])
    assert out.data_ptr() == nxt.data_ptr()
    assert torch.equal(nxt[..., :wt.shape[1]], ref)
    assert bool((nxt[..., wt.shape[1]:] == 7.0).all())
    assert torch.equal(buf[..., :C0], torch.tensor(x).to(torch.bfloat16))


def test_dense_block_rejects_unknown_epilogue():
    with pytest.raises(ValueError):
        k7.dense_block_apply(torch.zeros((1, 2, 2, 96)), {}, {}, "norm5")
