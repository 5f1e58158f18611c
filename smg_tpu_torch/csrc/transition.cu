// K3: the DenseNet transition — eval BN affine, ReLU, 2x2 mean, then the
// 1x1 conv C -> C_out with f32 accumulation.
//
// Replaces smg_tpu/ops/transition_pallas.py::transition (Pallas _kernel,
// transition_pallas.py:29-59). As there, the pool is commuted ahead of the
// linear 1x1 (a quarter of the matmul rows), and the pooled value is
// rounded to bf16 before the product: pooled = bf16(((h00 + h10) +
// (h01 + h11)) * 0.25), h = relu(x * a + b) in f32.
//
// What bounds it on the H100: bytes. At 224 with 104 images the three
// transitions (256 -> 128 at 56 x 56, 512 -> 256 at 28, 1024 -> 512 at 14)
// must read 293 MB of input and write 37 MB: ~0.1 ms at 3.35 TB/s, against
// ~5 GFLOP of products (~0.005 ms at the bf16 tensor peak). The design is
// common.cuh's transition_kernel: each block pools its pooled pixels once
// for all C channels into shared memory (the raw input staged by a
// cp.async ring, each input byte read once), then runs the 1x1 on mma.sync
// from that resident tile with the weight's k-slices streamed through the
// same ring, and writes bf16 straight into the next dense block's buffer
// (pixel stride out_ld) with 16-byte stores. The tile plan is
// ops/transition.py::transition_plan.

#include "common.cuh"

using smg::bf16;

// x (N, H, W, x_ld) bf16; a, b (C,) f32; wt (C, C_out) bf16; out (Q, out_ld)
// bf16, columns [0, C_out); tr_*: the tile plan (rows, cols, kc, grid, smem).
extern "C" int smg_transition(const bf16* x, const float* a, const float* b,
                              const bf16* wt, bf16* out, int N, int H, int W,
                              int C, int x_ld, int C_out, int out_ld, int tr_rows,
                              int tr_cols, int tr_kc, int tr_grid, int tr_smem,
                              cudaStream_t stream) {
  const smg::TransitionPlan plan{tr_rows, tr_cols, tr_kc, tr_grid, tr_smem};
  return (int)smg::transition<smg::TransitionPool>(x, N, H, W, x_ld, a, b, wt, C, C_out, out,
                                                   out_ld, plan, stream);
}
