"""Self-supervised trunk warm-start (port of smg_tpu/cli/pretrain_trunks.py).

Renders fresh scenes every step and trains a trunk and a decoder to
reconstruct patch-masked depth heightmaps (train/pretrain.py). The saved
checkpoint (the ReconstructionModel's state_dict) initializes all three
affordance trunks and the target net through
`python -m smg_tpu_torch.cli.main --pretrained_trunks <path>`.

Usage (on the card unless --cpu):

    python -m smg_tpu_torch.cli.pretrain_trunks --steps 1000 --batch_size 16 \\
        --out logs/trunk_pretrain.pt

After the reference's log lines it prints one JSON line, {"losses": [...],
"step_ms": [...]}: every step's loss and its host time (CUDA events
around the step on the card, the wall clock on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.train import checkpoints, pretrain


def _step_timer(dev: torch.device):
    """() -> stop(): milliseconds of the work issued in between."""
    if dev.type == "cuda":
        def start():
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()

            def stop():
                b.record()
                b.synchronize()
                return a.elapsed_time(b)
            return stop
        return start

    def start_cpu():
        t0 = time.perf_counter()
        return lambda: 1e3 * (time.perf_counter() - t0)
    return start_cpu


def train(steps: int, batch_size: int, out: str, seed: int = 0,
          trunk: str = "densenet121", is_cluttered: bool = False,
          lr: float = 1e-3, log_every: int = 20, device="cuda") -> dict:
    """Pretrain `trunk` at input 224 for `steps` steps and save to `out`;
    returns the losses and step times."""
    from smg_tpu_torch.envs.smg_env import EnvConfig

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (--cpu runs on the CPU)")
    cfg = pretrain.PretrainConfig(model=ModelConfig(trunk=trunk, input_size=224), lr=lr)
    model = pretrain.ReconstructionModel(cfg).to(dev)
    pretrain.init_reconstruction(model, torch.Generator(device=dev).manual_seed(seed))
    opt = pretrain.new_optimizer(model)
    batch_fn = pretrain.make_batch_fn(
        cfg, EnvConfig(is_cluttered=is_cluttered, settle_steps=50))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    timer = _step_timer(dev)
    losses, step_ms = [], []
    t0 = time.time()
    for i in range(steps):
        stop = timer()
        inputs, target, hidden = batch_fn(gen, batch_size)
        loss = pretrain.pretrain_step(model, opt, inputs, target, hidden)
        step_ms.append(stop())
        losses.append(float(loss))
        if (i + 1) % log_every == 0 or i == 0:
            print(f"pretrain step {i + 1}/{steps} | recon loss "
                  f"{losses[-1]:.4f} | {time.time() - t0:.1f}s", flush=True)
    if os.path.dirname(os.path.abspath(out)):
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    checkpoints.save_params(out, model)
    print(f"trunk-pretrain checkpoint: {out}")
    print(json.dumps({"losses": losses, "step_ms": step_ms}))
    return {"losses": losses, "step_ms": step_ms, "out": out}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="self-supervised trunk warm-start")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--out", default="logs/trunk_pretrain.pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trunk", default="densenet121", choices=["densenet121", "tiny"])
    p.add_argument("--is_cluttered", action="store_true", default=False)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", dest="force_cpu", action="store_true", default=False,
                   help="run on the CPU")
    args = p.parse_args(argv)
    train(args.steps, args.batch_size, args.out, args.seed, args.trunk,
          args.is_cluttered, args.lr, device="cpu" if args.force_cpu else "cuda")


if __name__ == "__main__":
    main()
