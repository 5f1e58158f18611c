"""smg_tpu_torch — the PyTorch / CUDA port of smg_tpu, for one NVIDIA H100.

The JAX package `smg_tpu` is the reference; this package mirrors its
directory and module names so that each module's counterpart is easy to
find. It imports torch and never jax. Plain tensor code is PyTorch; every
Pallas kernel on the ported path is a hand-written CUDA C++ kernel for
sm_90a (csrc/), built at first use and bound through ctypes (ops/).

Port state: the testing-mode act step (train/loop.py::train_step with
env.is_testing=True) — observe, score, arbitrate, PE/OO geometry, batched
primitive execution, counters, auto-reset.

Subpackages
-----------
core        rotations/quaternions, tendon model, camera constants
physics     batched rigid-body stepper (contact sweep: CUDA kernel K1)
render      orthographic heightmap/instance rasterizer
perception  exact instance segmentation, min-area rects
models      DenseNet-121 two-stream affordance nets (eval trunk: K2-K4)
policy      action arbitration, PE / OO action geometry
envs        scripted primitives + the batched executor
train       scoring trainer + the testing-mode loop
ops         kernel wrappers: plain PyTorch versions, launch counters
"""

__version__ = "0.1.0"
