"""Reference scores of the three styles for a batch of scenes.

For each scene: the depth heightmap zeroed off the union of its object
masks (the scene stream), each valid object's mask of it (grasp and
suction), and each valid pair's union mask of it (envelop-then-suck), as
the SMG reference scores them. Only valid objects and valid pairs are
computed; the other entries are NaN.
"""

from __future__ import annotations

import torch

from smgbench.reference import densenet as dn

TRUNK = ("grasp_trunk", "suction_trunk", "gs_trunk")


def head_of(style: int, tied_ets_head: bool) -> str:
    """The head a style reads: the ETS style reads the suction head while it
    is tied (the SMG reference's models.py)."""
    if style == 2 and tied_ets_head:
        return "suction_head"
    return ("grasp_head", "suction_head", "gs_head")[style]


def _values(out: torch.Tensor, method: str) -> torch.Tensor:
    if method == "reactive":
        return torch.softmax(out, dim=-1)[:, 0]
    return out[:, 0]


@torch.no_grad()
def scores(w: dict, config: dict, depth, masks, valid, chunk: int, rnd=None):
    """(gra (B, N), suc (B, N), gs (B, N, N)) float32 on depth's device."""
    arch, model = config["architecture"], config["model"]
    S, method = model["input_size"], model["method"]
    B, N = valid.shape
    dev = depth.device
    scene = torch.where(masks.any(dim=1), depth, torch.zeros_like(depth))
    nan = float("nan")
    gra = torch.full((B, N), nan, device=dev)
    suc = torch.full((B, N), nan, device=dev)
    gs = torch.full((B, N, N), nan, device=dev)
    ob, oi = torch.nonzero(valid, as_tuple=True)
    ii, jj = torch.triu_indices(N, N, offset=1, device=dev)
    pair_ok = valid[:, ii] & valid[:, jj]
    pb, pk = torch.nonzero(pair_ok, as_tuple=True)
    pi, pj = ii[pk], jj[pk]
    with dn.full_f32():
        for style, out in ((0, gra), (1, suc)):
            feats = dn.features(w, TRUNK[style],
                                torch.cat([scene, scene[ob] * masks[ob, oi]]),
                                arch, S, chunk, rnd)
            v = torch.cat([dn.head(w, head_of(style, model["tied_ets_head"]),
                                   feats[ob[k:k + chunk]], feats[B + k:B + k + chunk],
                                   arch, rnd)
                           for k in range(0, ob.numel(), chunk)])
            out[ob, oi] = _values(v, method)
        if pb.numel():
            with_pairs = torch.unique(pb)
            row = torch.full((B,), -1, dtype=torch.long, device=dev)
            row[with_pairs] = torch.arange(with_pairs.numel(), device=dev)
            union = masks[pb, pi] | masks[pb, pj]
            feats = dn.features(w, TRUNK[2], torch.cat([scene[with_pairs], scene[pb] * union]),
                                arch, S, chunk, rnd)
            m = with_pairs.numel()
            v = torch.cat([dn.head(w, head_of(2, model["tied_ets_head"]),
                                   feats[row[pb[k:k + chunk]]], feats[m + k:m + k + chunk],
                                   arch, rnd)
                           for k in range(0, pb.numel(), chunk)])
            gs[pb, pi, pj] = _values(v, method)
    return gra, suc, gs
