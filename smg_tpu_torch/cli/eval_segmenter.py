"""Learned-segmenter quality against the exact id buffer (port of
scripts/eval_segmenter.py).

On held-out scenes (fresh seeds, optionally the testing object catalog)
it reports how close the SlotSegmenter's masks come to the ground-truth
id buffer:

- per-slot IoU of predicted against exact masks, matched by slot id (the
  segmenter is trained with stable slot ordering); mIoU over the slots
  the ground truth shows (MIN_VISIBLE_PIXELS or more);
- detection rate: the share of visible objects recovered at IoU >= 0.5;
- false positives: predicted slots (MIN_VISIBLE_PIXELS or more) with no
  visible object;
- fg/bg pixel accuracy.

Hardening arms, on the segmenter's input only (the ground truth stays
exact): `--depth_noise s` adds Gaussian depth noise of s meters;
`--perspective` feeds heightmaps made by the perspective raycaster at
the reference camera, then the point cloud and homography of
core/camera.py::get_heightmap (the reference's camera path,
utils.py:38-68), instead of the exact orthographic render.

Usage (on the card; --cpu runs on the CPU):

    python -m smg_tpu_torch.cli.eval_segmenter --checkpoint logs/segmenter/ckpt.pt \
        [--scenes 32] [--cluttered] [--testing] [--depth_noise 0.005] [--perspective]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from smg_tpu_torch.core import camera as cam
from smg_tpu_torch.envs import smg_env
from smg_tpu_torch.perception import learned
from smg_tpu_torch.perception.segment import MIN_VISIBLE_PIXELS
from smg_tpu_torch.render import ortho, persp


def perspective_heightmaps(objects, camera: cam.Camera):
    """(color_hm (B, 224, 224, 3), depth_hm (B, 224, 224)) of B scenes
    through the reference camera's fliplr'd RGB-D frames and get_heightmap."""
    frames = [persp.render_reference_rgbd(objects.map(lambda x, b=b: x[b]), camera)[:2]
              for b in range(objects.pos.shape[0])]
    color = torch.stack([c for c, _ in frames])
    depth = torch.stack([d for _, d in frames])
    c_hm, d_hm, _, _, _ = cam.get_heightmap(color, depth, camera.intrinsics, camera.pose)
    return c_hm, d_hm


def metrics(ids: np.ndarray, pred: np.ndarray, n_slots: int) -> dict:
    """Matched-slot IoU, detection, false positives and fg/bg accuracy of
    predicted slot ids against exact ones, (B, H, W) each, -1 = background."""
    ious, detected, visible, false_pos = [], 0, 0, 0
    for b in range(ids.shape[0]):
        for s in range(n_slots):
            gt = ids[b] == s
            pd = pred[b] == s
            if gt.sum() >= MIN_VISIBLE_PIXELS:
                visible += 1
                iou = (gt & pd).sum() / max((gt | pd).sum(), 1)
                ious.append(float(iou))
                detected += int(iou >= 0.5)
            elif pd.sum() >= MIN_VISIBLE_PIXELS:
                false_pos += 1
    return {
        "visible_objects": visible,
        "miou": round(float(np.mean(ious)) if ious else 0.0, 4),
        "detection_rate_iou50": round(detected / max(visible, 1), 4),
        "false_positive_slots": false_pos,
        "fg_bg_pixel_acc": round(float(((ids < 0) == (pred < 0)).mean()), 4),
    }


def evaluate(model, scenes: int, cluttered: bool, testing: bool, seed: int,
             depth_noise: float, perspective: bool, device) -> dict:
    dev = torch.device(device)
    ecfg = smg_env.EnvConfig(is_cluttered=cluttered, is_testing=testing)
    batch = smg_env.reset(torch.Generator(device=dev).manual_seed(seed), scenes, ecfg, dev)
    depth, ids, color = ortho.render_heightmap(batch.objects)
    in_color, in_depth = color, depth
    if perspective:
        in_color, in_depth = perspective_heightmaps(
            batch.objects, cam.Camera.reference_overhead())
    if depth_noise > 0.0:
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        in_depth = in_depth + depth_noise * torch.randn(
            in_depth.shape, generator=gen, device=dev)
    with torch.no_grad():
        logits = model(learned.segmenter_inputs(in_color, in_depth))
    pred = (torch.argmax(logits, dim=1) - 1).cpu().numpy()
    return metrics(ids.cpu().numpy(), pred, int(batch.objects.pos.shape[1]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="segmenter quality vs the exact id buffer")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--scenes", type=int, default=32)
    ap.add_argument("--cluttered", action="store_true")
    ap.add_argument("--testing", action="store_true",
                    help="evaluate on the held-out testing catalog")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--depth_noise", type=float, default=0.0,
                    help="additive Gaussian depth noise sigma (m) on the "
                         "segmenter input only")
    ap.add_argument("--perspective", action="store_true",
                    help="feed heightmaps from the perspective raycaster + "
                         "point cloud + homography pipeline instead of the "
                         "exact ortho render")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from smg_tpu_torch.cli.main import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    model = learned.load_segmenter(args.checkpoint, dev)
    res = evaluate(model, args.scenes, args.cluttered, args.testing, args.seed,
                   args.depth_noise, args.perspective, dev)
    print(json.dumps({
        "checkpoint": args.checkpoint,
        "scenes": args.scenes,
        "catalog": "testing" if args.testing else "training",
        "cluttered": bool(args.cluttered),
        "depth_noise": args.depth_noise,
        "perspective": bool(args.perspective),
        **res,
    }))


if __name__ == "__main__":
    main()
