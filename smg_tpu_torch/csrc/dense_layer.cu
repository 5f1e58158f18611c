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
// 2.3 GFLOP per image in all, far above the ops:byte ridge, so tensor
// cores and their feed are the limit. Two launches per layer:
//   1. the bottleneck: the shared tiled GEMM (common.cuh) whose A loader
//      applies norm1 + ReLU while staging the prefix, and whose epilogue
//      applies the bf16 rounding, norm2 and ReLU, writing h2 (P x 128 bf16);
//   2. conv2: 64-pixel tiles; per tap the shifted h2 rows (zeros off the
//      image) are staged in shared memory and contracted with that tap's
//      128 x 32 weights on tensor cores, each tap's partial rounded before
//      the sum; the 32 channels land at their offset in the buffer.
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
constexpr int GROWTH = 32;

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

constexpr int C2_BM = 64;                  // pixels per block
constexpr int C2_THREADS = 128;            // 4 warps x 16 pixels
constexpr int C2_LDA = BOTTLENECK + 8;     // rows 272 B apart
constexpr int C2_LDB = GROWTH + 8;         // rows 80 B apart

__global__ void __launch_bounds__(C2_THREADS)
conv2_kernel(const bf16* __restrict__ h2, const bf16* __restrict__ w2,
             bf16* __restrict__ buf, int N, int H, int W, int ld, int c_off) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[C2_BM * C2_LDA];
  __shared__ __align__(128) bf16 Bs[BOTTLENECK * C2_LDB];
  __shared__ __align__(128) float stage[4][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int P = N * H * W;
  const int p0 = blockIdx.x * C2_BM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> total[2], part[2];
  wmma::fill_fragment(total[0], 0.0f);
  wmma::fill_fragment(total[1], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    // A: 64 pixels x 128 channels of shifted h2 = 1024 chunks; 8 per thread.
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int e = tid + it * C2_THREADS;
      const int r = e >> 4;
      const int c8 = (e & 15) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      const int p = p0 + r;
      if (p < P) {
        const int x = p % W;
        const int t = p / W;
        const int y = t % H;
        const int yy = y + dy, xx = x + dx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          val = *reinterpret_cast<const uint4*>(
              h2 + (size_t)(p + dy * W + dx) * BOTTLENECK + c8);
      }
      *reinterpret_cast<uint4*>(&As[r * C2_LDA + c8]) = val;
    }
    // B: this tap's 128 x 32 weights = 512 chunks; 4 per thread.
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = tid + it * C2_THREADS;
      const int r = e >> 2;
      const int c8 = (e & 3) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * C2_LDB + c8]) = *reinterpret_cast<const uint4*>(
          w2 + ((size_t)tap * BOTTLENECK + r) * GROWTH + c8);
    }
    __syncthreads();
    wmma::fill_fragment(part[0], 0.0f);
    wmma::fill_fragment(part[1], 0.0f);
#pragma unroll
    for (int k = 0; k < BOTTLENECK; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
      wmma::load_matrix_sync(af, &As[(warp * 16) * C2_LDA + k], C2_LDA);
      wmma::load_matrix_sync(b0, &Bs[k * C2_LDB], C2_LDB);
      wmma::load_matrix_sync(b1, &Bs[k * C2_LDB + 16], C2_LDB);
      wmma::mma_sync(part[0], af, b0, part[0]);
      wmma::mma_sync(part[1], af, b1, part[1]);
    }
    // Accumulator fragments of one shape share their element layout, so
    // the per-tap rounding is elementwise.
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int q = 0; q < part[f].num_elements; ++q)
        total[f].x[q] += smg::round_bf16(part[f].x[q]);
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(st, total[f], 16, wmma::mem_row_major);
    __syncwarp();
    const int r = lane >> 1;
    const int c = (lane & 1) * 8;
    const int p = p0 + warp * 16 + r;
    if (p < P)
      *reinterpret_cast<uint4*>(buf + (size_t)p * ld + c_off + f * 16 + c) =
          smg::pack8(st + r * 16 + c);
    __syncwarp();
  }
}

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
  conv2_kernel<<<(P + C2_BM - 1) / C2_BM, C2_THREADS, 0, stream>>>(h2, w2, buf, N, H,
                                                                   W, ld, c_in);
  return (int)cudaGetLastError();
}
