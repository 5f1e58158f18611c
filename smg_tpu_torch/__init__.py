"""smg_tpu_torch — the PyTorch / CUDA port of smg_tpu, for one NVIDIA H100.

The JAX package `smg_tpu` is the reference; this package mirrors its
directory and module names so that each module's counterpart is easy to
find. It imports torch and never jax. Plain tensor code is PyTorch; every
Pallas kernel on the ported path is a hand-written CUDA C++ kernel for
sm_90a (csrc/), built at first use and bound through ctypes (ops/).

Port state: the act step and the training step (train/loop.py), the eval
trunk's three kernel backends, the experiment runner
(`python -m smg_tpu_torch.cli.main`, the reference's flags): the run tree,
checkpoints, resume and the snapshot for testing; the perception slice:
mesh ingest, the learned segmenter, the perspective heightmap path and the
tiny trunk; trunk pretraining (`python -m smg_tpu_torch.cli.pretrain_trunks`,
`--pretrained_trunks`), the per-scene physics executor
(LoopConfig.executor="vmap") and data parallelism over torch.distributed
(`--data_parallel N` under torchrun).

Subpackages
-----------
core        rotations/quaternions, tendon model, camera and the perspective
            heightmap path, homographies
physics     rigid-body stepper: the batched path (contact sweep: CUDA
            kernel K1) and the per-scene path (dense contacts)
render      orthographic heightmap/instance rasterizer, perspective RGB-D
perception  exact instance segmentation, min-area rects, NMS, the learned
            slot segmenter
models      two-stream affordance nets on DenseNet-121 (eval trunk: K2-K5,
            K7; train trunk: K6) or the tiny trunk
policy      action arbitration, PE / OO action geometry
envs        scripted primitives, the per-scene and the batched executor
train       trainer, the loop, checkpoints, trunk pretraining
parallel    data parallelism: process groups, the sharded step, the
            multi-process CPU dryrun
utils       CLI config, run logger, native host library (mesh fitter,
            binary log), mesh ingest, phase timer, the span and counter
            recorder
cli         main (the experiment runner), smoke, decision_parity,
            train_segmenter, eval_segmenter, pretrain_trunks
ops         kernel wrappers: plain PyTorch versions, launch counters

Spans and counters (utils/profiling.py): the trainer, the policy and the
environment's geometry record spans at their layer boundaries, and the
trainer counts the trunk images it computes and those it needs:

  score_scene_batch > score_eval (style), one a packed trunk call
                                                    train/trainer.py
  counter trunk_images (the images each call gets)  Trainer._score_rows,
                                                    Trainer._score_eval
  counter trunk_images_useful (once a call)         Trainer.score_scene_batch
  update > update.forward (style), update.backward,
           update.adam, update.bn_stats             Trainer.update
  select_action                                     policy/arbitrate.py
  compute_geometry > pe, oo                         envs/smg_env.py,
                                                    policy/action_geom.py

The recorder is off unless code calls profiling.enable() (the benchmark's
per-layer readers do, in a traced run): off, each span is one shared no-op
context. On, it reads two host clocks at each edge and never synchronizes
with the card.
"""

__version__ = "0.1.0"
