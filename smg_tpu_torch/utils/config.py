"""Experiment configuration: flag-compatible with the reference CLI (port
of smg_tpu/utils/config.py).

`build_parser` has every flag of the JAX package's parser, with the same
names, defaults and choices, so the reference's command lines parse
unchanged, e.g.

    --is_sim --method reinforcement --is_ets --is_pe --is_oo
    --is_testing --load_snapshot --snapshot_file X --is_cluttered

`--cpu` runs on the CPU; without it the run is on the card (cuda) and
raises when there is none. `--obj_mesh_dir` takes a directory with
enveloping/ and sucking/ .obj meshes (fitted by utils/meshes.py) or the
reference's datasets/{training,testing} names; `--trunk tiny` selects the
small trunk; `--segmentation learned` reads `--segmenter_checkpoint`;
`--pretrained_trunks` takes a cli.pretrain_trunks checkpoint;
`--data_parallel N` shards the scenes over N processes launched by
torchrun (one card each).

ModelConfig.num_rotations and tied_ets_head have no flag, as in the JAX
parser: set them with dataclasses.replace on `train.model`;
info/config.json records both.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import asdict, dataclass, replace

from smg_tpu_torch.envs.smg_env import EnvConfig
from smg_tpu_torch.models.affordance import ModelConfig
from smg_tpu_torch.train.loop import LoopConfig
from smg_tpu_torch.train.trainer import TrainConfig


@dataclass(frozen=True)
class ExperimentConfig:
    env: EnvConfig
    train: TrainConfig
    loop: LoopConfig
    # Run control (main.py:446-449).
    training_episode: int = 800
    testing_episode: int = 300
    # Persistence (main.py:453-456).
    load_snapshot: bool = False
    snapshot_file: str = ""
    continue_logging: bool = False
    logging_directory: str = "logs"
    seed: int = 0
    max_iterations: int = 0  # 0 = run until the episode target
    data_parallel: int = 1
    segmenter_checkpoint: str = ""
    pretrained_trunks: str = ""
    imagery_every: int = 1   # scene-0 imagery every K iterations (0: never)
    device: str = "cuda"     # "cpu" with --cpu

    def to_dict(self) -> dict:
        """info/config.json: the JAX package's keys where the port has the
        field (tests/test_torch_cli.py lists those only one side has); the
        segmenter module is left out (segmenter_checkpoint says where it
        came from)."""
        return asdict(replace(self, loop=replace(self.loop, segmenter=None)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="SMG multimodal grasping on PyTorch / CUDA"
    )
    # --------------- Setup options (main.py:430-435) ---------------
    p.add_argument("--is_sim", action="store_true", default=True,
                   help="run in simulation (always true: the sim is on-device)")
    p.add_argument("--obj_mesh_dir", default="datasets/training",
                   help="object set: a dir with enveloping/ + sucking/ .obj "
                        "subdirs (native mesh-fitter ingest), or the "
                        "reference's datasets/{training,testing} names -> the "
                        "matching procedural catalog")
    p.add_argument("--num_obj", type=int, default=10,
                   help="accepted for command-line parity; the reference "
                        "stores but never uses it")
    p.add_argument("--heightmap_resolution", type=float, default=0.002)
    p.add_argument("--cpu", dest="force_cpu", action="store_true",
                   default=False, help="run on the CPU (reference --cpu)")
    p.add_argument("--is_cluttered", action="store_true", default=False)
    # ------------- Algorithm options (main.py:438-443) -------------
    p.add_argument("--method", default="reinforcement",
                   choices=["reactive", "reinforcement"])
    p.add_argument("--is_ets", action="store_true", default=False)
    p.add_argument("--is_pe", action="store_true", default=False)
    p.add_argument("--is_oo", action="store_true", default=False)
    p.add_argument("--future_reward_discount", type=float, default=0.5)
    p.add_argument("--explore_rate_decay", action="store_true",
                   default=False)
    # ---------- Training / testing options (main.py:446-450) ----------
    p.add_argument("--is_testing", action="store_true", default=False)
    p.add_argument("--training_episode", type=int, default=800)
    p.add_argument("--testing_episode", type=int, default=300)
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--target_update_freq", type=int, default=10)
    # ------ Pre-loading and logging (main.py:453-456) ------
    p.add_argument("--load_snapshot", action="store_true", default=False)
    p.add_argument("--snapshot_file", default="")
    p.add_argument("--continue_logging", action="store_true", default=False)
    p.add_argument("--logging_directory", default="logs")
    # ---------------- Batched-run knobs ----------------
    p.add_argument("--batch_size", type=int, default=8,
                   help="parallel scenes per step")
    p.add_argument("--trunk", default="densenet121",
                   choices=["densenet121", "tiny"])
    p.add_argument("--input_size", type=int, default=224,
                   help="model input: 224, or 640 (the reference's zoom+pad)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_iterations", type=int, default=0,
                   help="stop after this many steps (0 = episode-based)")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="processes (one card each, launched by torchrun "
                        "--nproc_per_node N) to shard the scenes over")
    p.add_argument("--segmentation", default="exact",
                   choices=["exact", "learned"],
                   help="instance segmentation: the renderer's exact "
                        "id-buffers, or the trained SlotSegmenter on the "
                        "color + depth heightmaps")
    p.add_argument("--segmenter_checkpoint", default="",
                   help="segmenter params (cli.train_segmenter) for "
                        "--segmentation learned")
    p.add_argument("--pretrained_trunks", default="",
                   help="pretrained trunk checkpoint (cli.pretrain_trunks) for "
                        "the three trunks of both nets")
    p.add_argument("--imagery_every", type=int, default=1,
                   help="save scene-0 heightmaps, action overlays and the "
                        "RGB-D frame every K iterations (0 = never)")
    return p


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    if abs(args.heightmap_resolution - 0.002) > 1e-12:
        # The 224 x 0.002 m heightmap grid is built into the renderer, the
        # model and the action geometry.
        raise SystemExit(
            "--heightmap_resolution: only the reference default 0.002 is "
            f"supported (got {args.heightmap_resolution})"
        )
    if args.data_parallel < 1 or args.batch_size % args.data_parallel:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible by "
                         f"--data_parallel {args.data_parallel}")
    if os.path.isdir(os.path.join(args.obj_mesh_dir, "enveloping")):
        for sub in ("enveloping", "sucking"):
            d = os.path.join(args.obj_mesh_dir, sub)
            if not (os.path.isdir(d) and any(f.endswith(".obj") for f in os.listdir(d))):
                raise SystemExit(f"--obj_mesh_dir: no .obj meshes under {d}")
    env = EnvConfig(
        is_cluttered=args.is_cluttered,
        is_testing=args.is_testing,
        is_ets=args.is_ets,
        is_pe=args.is_pe,
        is_oo=args.is_oo,
        method=args.method,
        step_limit=args.step,
        segmentation=args.segmentation,
        obj_mesh_dir=args.obj_mesh_dir,
    )
    model = ModelConfig(method=args.method, trunk=args.trunk,
                        input_size=args.input_size)
    train = TrainConfig(
        model=model,
        method=args.method,
        future_reward_discount=args.future_reward_discount,
        target_update_freq=args.target_update_freq,
        is_ets=args.is_ets,
    )
    loop = LoopConfig(
        env=env,
        batch_size=args.batch_size,
        explore_rate_decay=args.explore_rate_decay,
    )
    return ExperimentConfig(
        env=env, train=train, loop=loop,
        training_episode=args.training_episode,
        testing_episode=args.testing_episode,
        load_snapshot=args.load_snapshot,
        snapshot_file=args.snapshot_file,
        continue_logging=args.continue_logging,
        logging_directory=args.logging_directory,
        seed=args.seed,
        max_iterations=args.max_iterations,
        data_parallel=args.data_parallel,
        segmenter_checkpoint=args.segmenter_checkpoint,
        pretrained_trunks=args.pretrained_trunks,
        imagery_every=args.imagery_every,
        device="cpu" if args.force_cpu else "cuda",
    )


def parse_args(argv=None) -> ExperimentConfig:
    return config_from_args(build_parser().parse_args(argv))
