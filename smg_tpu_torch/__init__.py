"""smg_tpu_torch — the PyTorch / CUDA port of smg_tpu, for one NVIDIA H100.

The JAX package `smg_tpu` is the reference; this package mirrors its
directory and module names so that each module's counterpart is easy to
find. It imports torch and never jax. Plain tensor code is PyTorch; every
Pallas kernel on the ported path is a hand-written CUDA C++ kernel for
sm_90a (csrc/), built at first use and bound through ctypes (ops/).

Port state: the act step and the training step (train/loop.py), the eval
trunk's three kernel backends, and the experiment runner
(`python -m smg_tpu_torch.cli.main`, the reference's flags): the run tree,
checkpoints, resume and the snapshot for testing.

Subpackages
-----------
core        rotations/quaternions, tendon model, camera constants, Camera
physics     batched rigid-body stepper (contact sweep: CUDA kernel K1)
render      orthographic heightmap/instance rasterizer, perspective RGB-D
perception  exact instance segmentation, min-area rects
models      DenseNet-121 two-stream affordance nets (eval trunk: K2-K5,
            K7; train trunk: K6)
policy      action arbitration, PE / OO action geometry
envs        scripted primitives + the batched executor
train       trainer, the loop, checkpoints
utils       CLI config, run logger, native host library, phase timer
cli         main (the experiment runner), smoke, decision_parity
ops         kernel wrappers: plain PyTorch versions, launch counters
"""

__version__ = "0.1.0"
