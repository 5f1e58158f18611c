// K2: one eval-mode DenseNet dense layer, in place in the block buffer.
//
// Replaces smg_tpu/ops/dense_layer_pallas.py::dense_layer_fused (Pallas
// _kernel, :75-161) and ::dense_layers_fused (_kernel_multi, :164-303);
// the K-layer grouping there was a TPU VMEM choice, the math is the same.
// For a block buffer of P = N*H*W pixels and `ld` channels the layer reads
// channels [0, C_in) and writes its 32 new channels at [C_in, C_in + 32):
//
//   h1  = bf16( sum_c bf16(relu(x_c a1_c + b1_c)) w1[c, :] )   f32 sums
//   h2  = bf16( relu(h1 a2 + b2) )
//   out = bf16( sum_tap bf16( sum_c h2[pixel + tap, c] w2[tap, c, :] ) )
//
// The 3x3 zero padding applies to h2 (dense_layer_pallas.py:105-106):
// out-of-image taps contribute exactly 0 — padding x before the BN would
// give relu(b1) != 0 at the borders. Each tap's partial is rounded to bf16
// before the f32 tap sum, as the TPU kernel's packed-taps product is
// (dense_layer_pallas.py:147-155).
//
// What bounds it on the H100: at 224 the 58 layers are GEMMs of M = P
// pixels (3136 per image in block 1 down to 49 in block 4) with K = C_in
// (64..992) into 128 bottleneck channels, then K = 9 x 128 into 32: about
// 4.8 GFLOP per image in all (2 P K N summed; 2.08 + 1.43 + 1.10 + 0.21 by
// block), ~0.50 TFLOP per 104-image pass, 0.51 ms at the bf16 tensor peak,
// against 0.64 ms for the bytes it must move: bytes by a little. What holds
// this design back instead: mma.sync's issue rate on the busiest of an SM's
// four sub-partitions (the 3x3), the prologue's arithmetic on every A
// fragment beside the MMAs (the GEMM), and each launch's fixed cost at the
// small layers of blocks 3-4; wgmma is the step after. Two launches per
// layer:
//   1. the bottleneck: common.cuh's pipelined gemm_bnrelu_kernel. Raw x
//      and w1 tiles stream through a 3-stage cp.async ring, norm1 + ReLU
//      is applied to the A fragments in registers (a1/b1 of the k-slice
//      staged beside them), and the epilogue applies the bf16 rounding,
//      norm2 and ReLU, writing h2 (P x 128 bf16). 64-row tiles where 128
//      would give less than one wave (block 4 at 224).
//   2. conv2: common.cuh's conv3x3_kernel on h2 (a raw source: the patch
//      goes straight from device memory to shared memory), tap weights
//      resident, each tile's halo patch staged once, the 32 channels
//      written at their offset in the buffer.
// Why two launches and not the TPU kernel's h1 tile with a halo in VMEM:
// h2 is 128 channels per pixel while the bottleneck reads C_in (up to 992),
// so the round trip through device memory (mostly L2-resident: 0.8 MB per
// image at block 1) adds well under a quarter of the layer's bytes, whereas
// a fused tile must recompute (or exchange) the halo rows of the GEMM, and
// the measured split per pass (PERF.md) has the GEMM as the larger
// part: a fused kernel would recompute the larger part to save the smaller
// one's input.

#include "common.cuh"

using smg::bf16;

// gemm_bm: the GEMM's tile rows (128 or 64); c3_*: the 3x3's tile plan
// (ops/conv2.py::conv3x3_plan).
extern "C" int smg_dense_layer(bf16* buf, const float* a1, const float* b1,
                               const bf16* w1, const float* a2, const float* b2,
                               const bf16* w2, bf16* h2, int N, int H, int W,
                               int ld, int c_in, int gemm_bm, int c3_images, int c3_rows,
                               int c3_cols, int c3_grid, int c3_smem, cudaStream_t stream) {
  const int P = N * H * W;
  if (P == 0) return (int)cudaGetLastError();
  cudaError_t err = smg::gemm_bnrelu(gemm_bm, buf, ld, a1, b1, w1, P, c_in,
                                     smg::Bn2Epilogue{h2, a2, b2}, stream);
  if (err != cudaSuccess) return (int)err;
  const smg::Conv3x3Plan plan{c3_images, c3_rows, c3_cols, c3_grid, c3_smem};
  return (int)smg::conv3x3(smg::RawRows{h2}, w2, buf, N, H, W, ld, c_in, plan, stream);
}
