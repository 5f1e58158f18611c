// Shared device helpers of the port's kernels: bf16 packing, an affine
// without FMA contraction (so the kernels round where the plain PyTorch
// versions do), and a tiled bf16 tensor-core GEMM with a fused prologue
// (the A operand is computed while it is loaded) and a fused epilogue.
//
// The GEMM is deliberately simple: 128x128x32 block tiles, 8 warps of
// 32x64 (WMMA m16n16k16 bf16 -> f32), one shared-memory stage, no
// software pipelining. wgmma / TMA / multi-stage rings are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace smg {

using bf16 = __nv_bfloat16;

union Pack8 {
  uint4 u;
  __nv_bfloat162 h[4];
};

__device__ __forceinline__ void unpack8(const uint4 u, float* f) {
  Pack8 p;
  p.u = u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(p.h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  Pack8 p;
#pragma unroll
  for (int i = 0; i < 4; ++i) p.h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return p.u;
}

// Round an f32 to bf16 and back (round to nearest even, like torch's .to()).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// relu(x * a + b) with two roundings, as the plain versions compute it.
__device__ __forceinline__ float bn_relu(float x, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.0f);
}

// ---------------------------------------------------------------------------
// Tiled GEMM: C[M, Ncols] = A[M, K] @ B[K, Ncols], bf16 operands, f32 sums.
//   A rows come from `loader.load8(row, k, out8)` (8 consecutive k, any
//   prologue math); B is a row-major bf16 matrix with leading dim ldb;
//   the f32 result goes through `epi.store8(row, col, v8)` (8 consecutive
//   columns). K must be a multiple of 32; M and Ncols are masked / tiled.
// ---------------------------------------------------------------------------

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_LDA = GEMM_BK + 8;   // bf16 elements; rows 80 B apart
constexpr int GEMM_LDB = GEMM_BN + 8;   // rows 272 B apart

template <class Loader, class Epilogue>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(Loader loader, const bf16* __restrict__ Bm, int ldb, int M,
                 int K, Epilogue epi) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[GEMM_BM * GEMM_LDA];
  __shared__ __align__(128) bf16 Bs[GEMM_BK * GEMM_LDB];
  __shared__ __align__(128) float stage[8][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 3;    // 4 warps along M: rows wm*32 .. +32
  const int wn = warp >> 2;   // 2 warps along N: cols wn*64 .. +64
  const int m0 = blockIdx.x * GEMM_BM;
  const int n0 = blockIdx.y * GEMM_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    // A tile: 128 rows x 32 k = 512 chunks of 8; two per thread.
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = tid + it * GEMM_THREADS;
      const int r = e >> 2;
      const int c8 = (e & 3) * 8;
      float v[8];
      if (m0 + r < M) {
        loader.load8(m0 + r, k0 + c8, v);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = 0.0f;
      }
      *reinterpret_cast<uint4*>(&As[r * GEMM_LDA + c8]) = pack8(v);
    }
    // B tile: 32 k x 128 cols = 512 chunks of 8; two per thread.
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = tid + it * GEMM_THREADS;
      const int r = e >> 4;
      const int c8 = (e & 15) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * GEMM_LDB + c8]) =
          *reinterpret_cast<const uint4*>(Bm + (size_t)(k0 + r) * ldb + n0 + c8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfg[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[(wm * 32 + i * 16) * GEMM_LDA + kk], GEMM_LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bfg[j], &Bs[kk * GEMM_LDB + wn * 64 + j * 16], GEMM_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], af[i], bfg[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: each 16x16 fragment through a per-warp staging tile; lane l
  // takes row l/2, columns (l%2)*8 .. +8.
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1;
      const int c = (lane & 1) * 8;
      const int row = m0 + wm * 32 + i * 16 + r;
      if (row < M) epi.store8(row, n0 + wn * 64 + j * 16 + c, st + r * 16 + c);
      __syncwarp();
    }
  }
}

}  // namespace smg
