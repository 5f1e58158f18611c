"""Train the learned segmentation front end against the exact renderer
(port of smg_tpu/cli/train_segmenter.py).

The simulator's renderer gives pixel-perfect instance id buffers, so the
fixed-slot segmenter (perception/learned.py::SlotSegmenter) trains
self-supervised: each step resets a fresh batch of scenes (a 100-step
settle through the batched stepper), renders their heightmaps, and takes
one Adam step of the weighted per-pixel CE on the id buffers. The
checkpoint (train/checkpoints.py::save_params) is read by

    python -m smg_tpu_torch.cli.main --segmentation learned \
        --segmenter_checkpoint P

Usage (on the card; --cpu runs on the CPU):

    python -m smg_tpu_torch.cli.train_segmenter --steps 600 --batch_size 16 \
        --is_cluttered --out logs/segmenter/ckpt.pt
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from smg_tpu_torch.perception import learned
from smg_tpu_torch.physics import scene as scene_mod
from smg_tpu_torch.render import ortho
from smg_tpu_torch.train import checkpoints


def make_batch(gen: torch.Generator, B: int, device, is_cluttered: bool = False,
               settle_steps: int = 100):
    """B fresh settled scenes -> (inputs (B, 4, H, W), ids (B, H, W) int32
    slot ids, -1 = background)."""
    scenes = scene_mod.reset_scene(gen, B, device, is_cluttered, False, settle_steps)
    depth, ids, color = ortho.render_heightmap(scenes.objects)
    return learned.segmenter_inputs(color, depth), ids


def train(steps: int, batch_size: int, out: str, seed: int = 0,
          is_cluttered: bool = False, lr: float = 1e-3, settle_steps: int = 100,
          log_every: int = 20, device="cuda",
          cfg: learned.SegmenterConfig = learned.SegmenterConfig()) -> list[float]:
    """Train `steps` steps and save the segmenter to `out`; returns the
    losses of the logged steps (step 1 and every log_every-th)."""
    dev = torch.device(device)
    model = learned.init_segmenter(torch.Generator(device=dev).manual_seed(seed), cfg,
                                   device=dev).train()
    opt = learned.new_optimizer(model, lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    logged = []
    t0 = time.time()
    for i in range(steps):
        inputs, ids = make_batch(gen, batch_size, dev, is_cluttered, settle_steps)
        loss = learned.train_step_segmenter(model, opt, inputs, ids)
        if (i + 1) % log_every == 0 or i == 0 or i + 1 == steps:
            logged.append(float(loss))
            print(f"segmenter step {i + 1}/{steps} | loss {logged[-1]:.4f} | "
                  f"{time.time() - t0:.1f}s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    checkpoints.save_params(out, model)
    print(f"segmenter checkpoint: {out}")
    return logged


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="train the slot segmenter")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--out", default="logs/segmenter")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--is_cluttered", action="store_true", default=False)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    from smg_tpu_torch.cli.main import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {dev}")
    train(args.steps, args.batch_size, args.out, args.seed, args.is_cluttered,
          args.lr, device=dev)


if __name__ == "__main__":
    main()
