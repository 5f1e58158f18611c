// K7: a whole eval-mode DenseNet dense block and its fused epilogue.
//
// Replaces smg_tpu/ops/dense_block_pallas.py::dense_block_apply (Pallas
// _block_kernel, dense_block_pallas.py:229-403), the `pallas` eval
// backend. The block's NHWC buffer (P = N*H*W pixels, Cf = C0 + 32 L
// channels) holds the block input in channels [0, C0); layer l reads the
// prefix [0, C) with C = C0 + 32 l and writes its 32 channels at [C, C + 32):
//
//   y1  = bf16( relu(x a1 + b1) )
//   t   = y1 @ w1                  one f32 accumulation over all C channels;
//                                  t is NOT rounded (unlike K2's h1)
//   h2  = bf16( relu(t a2 + b2) ), zero outside the image
//   new = bf16( sum_tap p_tap ),  p_tap = bf16(h2-shift @ w2[tap]) when
//         taps_packed (:323-339), the f32 product otherwise (:340-351)
//
// then the epilogue over the full buffer (:374-403):
//   transition: hs = bf16(relu(feat at + bt)); a 2x2 pool in bf16
//     arithmetic (row-pair sum, rounded; column-pair sum, rounded; x 0.25);
//     out = bf16(pooled @ wt) with f32 accumulation, written at pixel
//     stride out_ld (a channel slice of the next block's buffer);
//   final_bn: out = bf16(feat at + bt), no ReLU (norm5).
//
// What bounds it on the H100: the function reads the block input and
// writes the epilogue output (~125 MB per 104-image pass at 224 for the
// four blocks) but does the whole trunk's dense-layer and transition
// products, ~4.95 GFLOP per image: operations, ~0.52 ms per pass at the
// bf16 tensor peak. The TPU kernel kept each image's block buffer in VMEM
// (with row bands and an L-row halo where it did not fit). On Hopper one
// image's buffer at 224 is 1.6 / 0.8 / 0.4 / 0.1 MB for blocks 1-4 and
// 13 MB for block 1 at 640, and only block 4 at 224 fits one SM's 227 KB
// of shared memory. So this first design keeps the buffer in device memory
// (L2 holds 50 MB) and runs the layers inside the one call as 2 L + 1
// launches on the caller's stream: per layer K2's pipelined bottleneck
// GEMM (common.cuh's gemm_bnrelu_kernel: norm1 + ReLU on the A fragments)
// with norm2 + ReLU on the unrounded f32 sum in its epilogue (h2 to a bf16
// scratch), then K2's 3x3 (common.cuh's conv3x3_kernel: resident tap
// weights, halo patches staged once) writing the 32 channels in place;
// then one epilogue kernel: K3's transition_kernel (common.cuh: the pool
// once per pooled pixel for all channels into shared memory, the 1x1 from
// there) with K7's bf16-arithmetic pool (TransitionPoolBf16), or an
// elementwise norm5. The TPU's B_tile, row bands, halo, width and channel
// padding and selection-matrix append have no counterpart: every launch
// masks its own edges, for any N, H, W. Per-image residency in shared
// memory (clusters' distributed shared memory for blocks 2-3), wgmma and
// TMA are later work.

#include "common.cuh"

namespace {

using smg::bf16;

constexpr int BOTTLENECK = 128;
constexpr int GROWTH = 32;
constexpr int EPILOGUE_TRANSITION = 0;
constexpr int EPILOGUE_FINAL_BN = 1;

// norm5: out = bf16(x a + b), 8 channels per thread.
__global__ void final_bn_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                                const float* __restrict__ b, bf16* __restrict__ out,
                                long long P, int C, int ld, int out_ld) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int groups = C / 8;
  if (i >= P * groups) return;
  const long long p = i / groups;
  const int c = (int)(i % groups) * 8;
  float v[8];
  smg::unpack8(*reinterpret_cast<const uint4*>(x + p * ld + c), v);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = smg::affine(v[q], a[c + q], b[c + q]);
  *reinterpret_cast<uint4*>(out + p * out_ld + c) = smg::pack8(v);
}

}  // namespace

// a1, b1: the L layers' norm1 affines concatenated (sum_l C_l); w1: their
// (C_l, 128) bottleneck weights stacked row-wise; a2, b2 (L, 128); w2
// (L, 9, 128, 32); at, bt (Cf,); wt (Cf, C_out) for the transition (unused
// by final_bn); h2 scratch (P, 128); gemm_bm: the bottleneck GEMM's tile
// rows (128 or 64); c3_*: the 3x3's tile plan (ops/conv2.py::conv3x3_plan);
// tr_*: the transition's (ops/transition.py::transition_plan; unused by
// final_bn).
extern "C" int smg_dense_block(bf16* buf, const float* a1, const float* b1,
                               const bf16* w1, const float* a2, const float* b2,
                               const bf16* w2, const float* at, const float* bt,
                               const bf16* wt, bf16* h2, bf16* out, int N, int H,
                               int W, int C0, int L, int C_out, int out_ld,
                               int epilogue, int taps_packed, int gemm_bm, int c3_images,
                               int c3_rows, int c3_cols, int c3_grid, int c3_smem,
                               int tr_rows, int tr_cols, int tr_kc, int tr_grid, int tr_smem,
                               cudaStream_t stream) {
  const int P = N * H * W;
  const smg::Conv3x3Plan plan{c3_images, c3_rows, c3_cols, c3_grid, c3_smem};
  const int Cf = C0 + GROWTH * L;
  if (P == 0) return (int)cudaGetLastError();
  size_t off = 0;
  for (int l = 0; l < L; ++l) {
    const int c_in = C0 + GROWTH * l;
    cudaError_t err = smg::gemm_bnrelu(
        gemm_bm, buf, Cf, a1 + off, b1 + off, w1 + off * BOTTLENECK, P, c_in,
        smg::Bn2Epilogue<false>{h2, a2 + (size_t)l * BOTTLENECK, b2 + (size_t)l * BOTTLENECK},
        stream);
    if (err != cudaSuccess) return (int)err;
    const bf16* w2l = w2 + (size_t)l * 9 * BOTTLENECK * GROWTH;
    const smg::RawRows src{h2};
    err = taps_packed ? smg::conv3x3<smg::RawRows, true>(src, w2l, buf, N, H, W, Cf, c_in,
                                                         plan, stream)
                      : smg::conv3x3<smg::RawRows, false>(src, w2l, buf, N, H, W, Cf, c_in,
                                                          plan, stream);
    if (err != cudaSuccess) return (int)err;
    off += c_in;
  }
  if (epilogue == EPILOGUE_TRANSITION) {
    const smg::TransitionPlan tp{tr_rows, tr_cols, tr_kc, tr_grid, tr_smem};
    return (int)smg::transition<smg::TransitionPoolBf16>(buf, N, H, W, Cf, at, bt, wt, Cf, C_out,
                                                         out, out_ld, tp, stream);
  } else if (epilogue == EPILOGUE_FINAL_BN) {
    const long long n = (long long)P * (Cf / 8);
    final_bn_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(buf, at, bt, out, P, Cf,
                                                                     Cf, out_ld);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
