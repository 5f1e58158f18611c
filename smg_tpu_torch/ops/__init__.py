"""Hand-written Hopper kernels of the port and their PyTorch wrappers.

Each module holds three things: the plain PyTorch version of its function
(which the CPU tests use and nothing on the CUDA path calls), the kernel
wrapper (checks device, dtype, shape and contiguity, allocates outputs with
torch.empty, launches on the current stream), and an integer `launches`
counter that the wrapper bumps once per kernel launch. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.

  contact      K1  penalty contact sweep      <- ops/contact_pallas.py
  stem_pool    K4  stem BN/ReLU/maxpool       <- ops/stem_pool_pallas.py
  transition   K3  BN/ReLU/avgpool/1x1        <- ops/transition_pallas.py
  dense_layer  K2  fused eval dense layer     <- ops/dense_layer_pallas.py

The CUDA C++ sources live in smg_tpu_torch/csrc/ and are compiled once per
source digest by `_build.library()`.
"""
