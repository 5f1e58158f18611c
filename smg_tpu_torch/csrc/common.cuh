// Shared device helpers of the port's kernels: bf16 packing, an affine
// without FMA contraction (so the kernels round where the plain PyTorch
// versions do), and three tensor-core building blocks shared by the dense
// layer kernels (K2, K5, K7 eval; K6 train): a tiled bf16 GEMM with a fused
// prologue (the A operand is computed while it is loaded) and a fused
// epilogue; a 3x3 128 -> 32 convolution over a computed source; and a
// split-K A^T B product for weight gradients.
//
// All are deliberately simple: WMMA m16n16k16 bf16 -> f32 tiles, one
// shared-memory stage, no software pipelining. wgmma / TMA / multi-stage
// rings are later work.
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

// x * a + b with two roundings, as the plain versions compute it.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// relu(x * a + b) with two roundings, as the plain versions compute it.
__device__ __forceinline__ float bn_relu(float x, float a, float b) {
  return fmaxf(affine(x, a, b), 0.0f);
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

// ---------------------------------------------------------------------------
// 3x3 / pad-1 convolution, 128 -> 32 channels, over NHWC pixels (N, H, W),
// written at channel offset c_off of an NHWC buffer with pixel stride ld.
//   The source rows come from `src.load8(pixel, c8)` (8 packed bf16
//   channels, any prologue math); pixels off the image contribute exact
//   zeros. With RoundTaps (the default) each tap's 128-channel partial is
//   rounded to bf16 before the f32 tap sum, as the TPU kernels'
//   packed-taps products are; without it each tap's f32 partial is summed
//   as it is (K7's taps_packed=False).
//   64-pixel tiles, 4 warps of 16 pixels, WMMA m16n16k16 bf16 -> f32.
// ---------------------------------------------------------------------------

constexpr int C3_CIN = 128;
constexpr int C3_COUT = 32;
constexpr int C3_BM = 64;                 // pixels per block
constexpr int C3_THREADS = 128;           // 4 warps x 16 pixels
constexpr int C3_LDA = C3_CIN + 8;        // rows 272 B apart
constexpr int C3_LDB = C3_COUT + 8;       // rows 80 B apart

template <class Src, bool RoundTaps = true>
__global__ void __launch_bounds__(C3_THREADS)
conv3x3_kernel(Src src, const bf16* __restrict__ w2, bf16* __restrict__ out,
               int N, int H, int W, int ld, int c_off) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[C3_BM * C3_LDA];
  __shared__ __align__(128) bf16 Bs[C3_CIN * C3_LDB];
  __shared__ __align__(128) float stage[4][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int P = N * H * W;
  const int p0 = blockIdx.x * C3_BM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> total[2], part[2];
  wmma::fill_fragment(total[0], 0.0f);
  wmma::fill_fragment(total[1], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    // A: 64 pixels x 128 channels of shifted source = 1024 chunks; 8 per thread.
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int e = tid + it * C3_THREADS;
      const int r = e >> 4;
      const int c8 = (e & 15) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      const int p = p0 + r;
      if (p < P) {
        const int x = p % W;
        const int t = p / W;
        const int y = t % H;
        const int yy = y + dy, xx = x + dx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) val = src.load8(p + dy * W + dx, c8);
      }
      *reinterpret_cast<uint4*>(&As[r * C3_LDA + c8]) = val;
    }
    // B: this tap's 128 x 32 weights = 512 chunks; 4 per thread.
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = tid + it * C3_THREADS;
      const int r = e >> 2;
      const int c8 = (e & 3) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * C3_LDB + c8]) = *reinterpret_cast<const uint4*>(
          w2 + ((size_t)tap * C3_CIN + r) * C3_COUT + c8);
    }
    __syncthreads();
    wmma::fill_fragment(part[0], 0.0f);
    wmma::fill_fragment(part[1], 0.0f);
#pragma unroll
    for (int k = 0; k < C3_CIN; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
      wmma::load_matrix_sync(af, &As[(warp * 16) * C3_LDA + k], C3_LDA);
      wmma::load_matrix_sync(b0, &Bs[k * C3_LDB], C3_LDB);
      wmma::load_matrix_sync(b1, &Bs[k * C3_LDB + 16], C3_LDB);
      wmma::mma_sync(part[0], af, b0, part[0]);
      wmma::mma_sync(part[1], af, b1, part[1]);
    }
    // Accumulator fragments of one shape share their element layout, so
    // the per-tap rounding is elementwise.
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int q = 0; q < part[f].num_elements; ++q)
        total[f].x[q] += RoundTaps ? round_bf16(part[f].x[q]) : part[f].x[q];
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
      *reinterpret_cast<uint4*>(out + (size_t)p * ld + c_off + f * 16 + c) =
          pack8(st + r * 16 + c);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Split-K transposed GEMM for weight gradients:
//   part[s, m, n] = sum over pixels p of split s of A[p, m] * B[p, n]
//   A rows from `la.load8(p, m, v8)`, B rows from `lb.load8(p, n, v8)`
//   (8 consecutive columns, any prologue math), both rounded to bf16 when
//   staged; f32 sums. M and N must be multiples of 32. Split s covers
//   pixels [s * chunk, min(P, (s + 1) * chunk)). Every block writes its
//   own partial tile (no atomics); the caller reduces over s in a fixed
//   order, so a repeated run gives the same bits.
//   64x64 block tiles over 32 pixels per stage, 4 warps of 32x32.
// ---------------------------------------------------------------------------

constexpr int ATB_BM = 64;
constexpr int ATB_BN = 64;
constexpr int ATB_BK = 32;
constexpr int ATB_THREADS = 128;
constexpr int ATB_LD = 64 + 8;            // bf16 elements; rows 144 B apart

template <class LoaderA, class LoaderB>
__global__ void __launch_bounds__(ATB_THREADS)
gemm_atb_kernel(LoaderA la, LoaderB lb, int M, int N, int P, int chunk,
                float* __restrict__ part) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[ATB_BK * ATB_LD];
  __shared__ __align__(128) bf16 Bs[ATB_BK * ATB_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 1;    // rows wm*32 .. +32 of the 64-row tile
  const int wn = warp >> 1;   // cols wn*32 .. +32
  const int m0 = blockIdx.x * ATB_BM;
  const int n0 = blockIdx.y * ATB_BN;
  const int s = blockIdx.z;
  const int p_begin = s * chunk;
  const int p_end = min(P, p_begin + chunk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int pk = p_begin; pk < p_end; pk += ATB_BK) {
    // Each tile: 32 pixels x 64 columns = 256 chunks of 8; two per thread.
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = tid + it * ATB_THREADS;
      const int r = e >> 3;
      const int c8 = (e & 7) * 8;
      const int p = pk + r;
      float v[8];
      if (p < p_end && m0 + c8 < M) {
        la.load8(p, m0 + c8, v);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = 0.0f;
      }
      *reinterpret_cast<uint4*>(&As[r * ATB_LD + c8]) = pack8(v);
      if (p < p_end && n0 + c8 < N) {
        lb.load8(p, n0 + c8, v);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = 0.0f;
      }
      *reinterpret_cast<uint4*>(&Bs[r * ATB_LD + c8]) = pack8(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ATB_BK; kk += 16) {
      // A^T: the (m, k) element sits at As[k * LD + m], a column-major
      // 16x16 operand.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[kk * ATB_LD + wm * 32 + i * 16], ATB_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfg[j], &Bs[kk * ATB_LD + wn * 32 + j * 16], ATB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfg[j], acc[i][j]);
    }
    __syncthreads();
  }

  // M and N are multiples of 32, so a warp's 32x32 tile is all in or all out.
  if (m0 + wm * 32 < M && n0 + wn * 32 < N) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            part + ((size_t)s * M + m0 + wm * 32 + i * 16) * N + n0 + wn * 32 + j * 16,
            acc[i][j], N, wmma::mem_row_major);
  }
}

}  // namespace smg
