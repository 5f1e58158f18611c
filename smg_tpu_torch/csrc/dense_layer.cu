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
// block), far above the ops:byte ridge, so tensor cores and their feed are
// the limit. Two launches per layer:
//   1. the bottleneck: the shared tiled GEMM (common.cuh) whose A loader
//      applies norm1 + ReLU while staging the prefix, and whose epilogue
//      applies the bf16 rounding, norm2 and ReLU, writing h2 (P x 128 bf16);
//   2. conv2 (common.cuh's conv3x3_kernel): 64-pixel tiles; per tap the
//      shifted h2 rows (zeros off the image) are staged in shared memory
//      and contracted with that tap's 128 x 32 weights on tensor cores,
//      each tap's partial rounded before the sum; the 32 channels land at
//      their offset in the buffer.
// Why two launches and not the TPU kernel's h1 tile with a halo in VMEM:
// h2 is 128 channels per pixel while the bottleneck reads C_in (up to 992),
// so the round trip through device memory (mostly L2-resident: 0.8 MB per
// image at block 1) adds well under a quarter of the layer's bytes, whereas
// a fused tile must recompute (or exchange) its halo rows of the dominant
// bottleneck GEMM. Fusing is left to the PR that makes the kernel fast.

#include "common.cuh"

namespace {

using smg::bf16;

constexpr int BOTTLENECK = 128;

struct BnReluLoader {
  const bf16* x;   // block buffer (P, ld)
  const float* a;
  const float* b;
  int ld;
  __device__ void load8(int p, int k, float* v) const {
    float xv[8];
    smg::unpack8(*reinterpret_cast<const uint4*>(x + (size_t)p * ld + k), xv);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = smg::bn_relu(xv[c], a[k + c], b[k + c]);
  }
};

struct Bn2Epilogue {
  bf16* h2;        // (P, 128)
  const float* a2;
  const float* b2;
  __device__ void store8(int p, int col, const float* v) const {
    float o[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      o[c] = smg::bn_relu(smg::round_bf16(v[c]), a2[col + c], b2[col + c]);
    *reinterpret_cast<uint4*>(h2 + (size_t)p * BOTTLENECK + col) = smg::pack8(o);
  }
};

// conv2's source: h2 as it is (norm2 + ReLU were applied by the GEMM).
struct H2Rows {
  const bf16* h2;  // (P, 128)
  __device__ uint4 load8(int p, int c8) const {
    return *reinterpret_cast<const uint4*>(h2 + (size_t)p * BOTTLENECK + c8);
  }
};

}  // namespace

extern "C" int smg_dense_layer(bf16* buf, const float* a1, const float* b1,
                               const bf16* w1, const float* a2, const float* b2,
                               const bf16* w2, bf16* h2, int N, int H, int W,
                               int ld, int c_in, cudaStream_t stream) {
  const int P = N * H * W;
  if (P == 0) return (int)cudaGetLastError();
  BnReluLoader loader{buf, a1, b1, ld};
  Bn2Epilogue epi{h2, a2, b2};
  dim3 grid1((P + smg::GEMM_BM - 1) / smg::GEMM_BM, BOTTLENECK / smg::GEMM_BN);
  smg::gemm_bf16_kernel<<<grid1, smg::GEMM_THREADS, 0, stream>>>(
      loader, w1, BOTTLENECK, P, c_in, epi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smg::conv3x3_kernel<<<(P + smg::C3_BM - 1) / smg::C3_BM, smg::C3_THREADS, 0, stream>>>(
      H2Rows{h2}, w2, buf, N, H, W, ld, c_in);
  return (int)cudaGetLastError();
}
