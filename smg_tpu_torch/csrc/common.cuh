// Shared device helpers of the port's kernels: bf16 packing, an affine
// without FMA contraction (so the kernels round where the plain PyTorch
// versions do), Hopper's cp.async / ldmatrix / mma.sync wrappers, and the
// tensor-core building blocks of the DenseNet kernels (K2, K3, K5, K7
// eval; K6 train):
//   - gemm_bnrelu_kernel: the bottleneck GEMM of K2, K7 and K6a, pipelined:
//     a 3-stage cp.async ring of raw x / B tiles, the norm + ReLU applied to
//     the A fragments in registers (K2, K7: one affine per column) or once
//     per staged tile (K6a: one per column and image), mma.sync m16n8k16;
//     128- or 64-row tiles.
//   - conv3x3_kernel: THE 3x3 / pad-1 convolution 128 -> 32 of every dense
//     layer (K2, K5, K6a's forward, K7): a persistent grid, tap weights
//     resident in shared memory, each tile's halo patch staged once by a
//     double-buffered cp.async, nine shifted ldmatrix views of the patch.
//   - transition_kernel: the DenseNet transition (K3, and K7's transition
//     epilogue): BN, ReLU and the 2x2 mean of a tile of pooled pixels over
//     all C channels into shared memory once (the raw pixels through a
//     per-thread cp.async ring), then the 1x1 C -> C_out on mma.sync with
//     A resident and the weight k-slices streamed through a cp.async ring;
//     the pool's roundings a functor (K3's f32 sums, K7's bf16 arithmetic).
// K6b's kernels (the transposed 3x3, the weight gradients, the BN1
// backward) are K6's alone and live in dense_layer_train.cu.
// What bounds each is stated above it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// Hopper building blocks: cp.async, ldmatrix, mma.sync m16n8k16 bf16 -> f32.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is then
// not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// bf16(relu(x a + b)) on a packed pair, with the plain versions' roundings.
__device__ __forceinline__ uint32_t bn_relu2(uint32_t x, float2 a, float2 b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack2(bn_relu(v.x, a.x, b.x), bn_relu(v.y, a.y, b.y));
}

// ---------------------------------------------------------------------------
// Pipelined GEMM with a norm + ReLU prologue: C[M, 128] = bf16(relu(x a + b))
// @ B, x a row-major bf16 matrix with leading dim ldx (its first K columns
// are read), B (K, 128) bf16, f32 sums; the result goes through
// `epi.store2(row, col, v0, v1)` (2 consecutive columns).
//   The affine (a, b) comes from `aff`: one per column for every row
//   (ColumnAffine: K2, K7), applied to each A fragment in registers between
//   ldmatrix and the MMA; or one per column and image, rows being the
//   pixels of consecutive images (K6a's per-image BatchNorm, kInSmem):
//   aff.stage() puts a k-slice's (a, b) for each of the tile's images
//   (kSlots at most) into the stage, and the staged x tile is transformed
//   once in shared memory, each row with its image's (a, b), before the
//   MMAs (a pass and a barrier per stage, but no per-fragment row lookup).
//   A ring of GEMMN_STAGES shared-memory stages, each holding the raw x and
//   B tiles of one 64-deep k-slice and that slice's a and b, filled with
//   cp.async while the tensor cores work on an earlier stage. The prologue
//   is applied to each A fragment in registers, between ldmatrix and the
//   MMA. BM rows per block (128 or 64: the smaller tile where M is small),
//   warps of 32 x 64, mma.sync m16n8k16. K must be a multiple of 32 (a
//   last half k-slice reads zeros); rows past M read zeros and are not
//   stored. Tiles are swizzled (16-byte chunk c of row r at c ^ f(r)) so
//   that ldmatrix reads no bank twice.
//   What bounds it: not its loads (the ring covers them) but issue slots,
//   which the prologue's arithmetic on every A fragment (done by both
//   N-warps) shares with the MMAs; applying the prologue once per stage in
//   shared memory instead cost more (an extra pass and barrier). wgmma,
//   which frees the issue slots, is the next step.
// ---------------------------------------------------------------------------

constexpr int GEMMN_BK = 64;
constexpr int GEMMN_N = 128;
constexpr int GEMMN_STAGES = 3;

template <int BM, int SLOTS>
__host__ __device__ constexpr int gemmn_stage_bytes() {
  return BM * GEMMN_BK * 2 + GEMMN_BK * GEMMN_N * 2 + SLOTS * 2 * GEMMN_BK * 4;
}

template <int BM, int SLOTS>
__host__ __device__ constexpr int gemmn_smem_bytes() {
  return GEMMN_STAGES * gemmn_stage_bytes<BM, SLOTS>();
}

// One (a, b) per column, the same for every row. stage() fills
// ab[0, 64) = a[k0..] and ab[64, 128) = b[k0..] by cp.async.
struct ColumnAffine {
  static constexpr int kSlots = 1;
  static constexpr bool kInSmem = false;
  const float* a;
  const float* b;
  __device__ void stage(float* ab, int, int, int k0, int K, int tid, int) const {
    if (tid < 32) {
      const int c = tid & 15;
      const bool ok = k0 + c * 4 < K;
      cp_async16(smem_addr(ab + c * 4 + (tid >> 4) * GEMMN_BK),
                 ok ? (tid < 16 ? a : b) + k0 + c * 4 : a, ok);
    }
  }
  __device__ int slot(int, int) const { return 0; }
};

template <int BM, class Affine, class Epilogue>
__global__ void __launch_bounds__(2 * BM, 512 / (2 * BM))
gemm_bnrelu_kernel(const bf16* __restrict__ x, int ldx, Affine aff,
                   const bf16* __restrict__ Bm, int M, int K, Epilogue epi) {
  constexpr int THREADS = 2 * BM;
  constexpr int SLOTS = Affine::kSlots;
  constexpr int A_BYTES = BM * GEMMN_BK * 2;     // rows of 128 B
  constexpr int B_BYTES = GEMMN_BK * GEMMN_N * 2;  // rows of 256 B
  extern __shared__ __align__(128) unsigned char gsm[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;   // BM / 32 warps along M
  const int wn = warp & 1;    // 2 warps along N: columns wn * 64 .. + 64
  const int m0 = blockIdx.x * BM;
  const int KT = (K + GEMMN_BK - 1) / GEMMN_BK;

  auto stage_base = [&](int s) { return gsm + s * gemmn_stage_bytes<BM, SLOTS>(); };
  auto load = [&](int kt, int s) {
    unsigned char* A = stage_base(s);
    unsigned char* Bs = A + A_BYTES;
    float* ab = reinterpret_cast<float*>(Bs + B_BYTES);
    // Columns k0 + .. past K (the tail of a K = 32 mod 64) read zeros: zero
    // weights, so they add nothing.
    const int k0 = kt * GEMMN_BK;
    for (int e = tid; e < BM * 8; e += THREADS) {
      const int r = e >> 3, c = e & 7;
      const bool ok = m0 + r < M && k0 + c * 8 < K;
      cp_async16(smem_addr(A + r * 128 + ((c ^ (r & 7)) << 4)),
                 ok ? x + (size_t)(m0 + r) * ldx + k0 + c * 8 : x, ok);
    }
    for (int e = tid; e < GEMMN_BK * 16; e += THREADS) {
      const int r = e >> 4, c = e & 15;
      const bool ok = k0 + r < K;
      cp_async16(smem_addr(Bs + r * 256 + ((c ^ (r & 7)) << 4)),
                 ok ? Bm + (size_t)(k0 + r) * GEMMN_N + c * 8 : Bm, ok);
    }
    aff.stage(ab, m0, min(BM, M - m0), k0, K, tid, THREADS);
  };

  float acc[2][8][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][n][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < GEMMN_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  const int g = lane >> 2, t = lane & 3;
  // kInSmem: the (a, b) slot of the staged rows this thread transforms
  // (rows tid / 8 + i THREADS / 8), once per tile.
  int tslot[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    tslot[i] = Affine::kInSmem
                   ? aff.slot(m0, min(m0 + (tid >> 3) + i * (THREADS >> 3), M - 1)) * 2 * GEMMN_BK
                   : 0;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GEMMN_STAGES - 2>();
    __syncthreads();
    const int nk = kt + GEMMN_STAGES - 1;
    if (nk < KT) load(nk, nk % GEMMN_STAGES);
    cp_async_commit();
    unsigned char* A = stage_base(kt % GEMMN_STAGES);
    const unsigned char* Bs = A + A_BYTES;
    const float* ab = reinterpret_cast<const float*>(Bs + B_BYTES);
    if constexpr (Affine::kInSmem) {
      // bf16(relu(x a + b)) in place, each row with its image's (a, b); rows
      // past M and columns past K stay zero.
      const int k0 = kt * GEMMN_BK, c = tid & 7;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (tid >> 3) + i * (THREADS >> 3);
        if (m0 + r >= M || k0 + c * 8 >= K) continue;
        uint4* v = reinterpret_cast<uint4*>(A + r * 128 + ((c ^ (r & 7)) << 4));
        const float* sa = ab + tslot[i] + c * 8;
        float xv[8];
        unpack8(*v, xv);
#pragma unroll
        for (int k = 0; k < 8; ++k) xv[k] = bn_relu(xv[k], sa[k], sa[GEMMN_BK + k]);
        *v = pack8(xv);
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < GEMMN_BK; kk += 16) {
      // All of this k-step's fragments first, then the prologue, then the
      // MMAs: one load latency per k-step.
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int r = wm * 32 + f * 16 + (lane & 15);
        const int c = (kk >> 3) + (lane >> 4);
        ldmatrix_x4(smem_addr(A + r * 128 + ((c ^ (r & 7)) << 4)), af[f]);
      }
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn * 8 + n2 * 2 + (lane >> 4);
        ldmatrix_x4_trans(smem_addr(Bs + r * 256 + ((c ^ (r & 7)) << 4)), bfr[n2]);
      }
      if constexpr (!Affine::kInSmem) {
        // This thread's k columns: kk + 2t, +1 (a0, a1) and kk + 2t + 8, +9
        // (a2, a3).
        const float2 alo = *reinterpret_cast<const float2*>(ab + kk + 2 * t);
        const float2 ahi = *reinterpret_cast<const float2*>(ab + kk + 2 * t + 8);
        const float2 blo = *reinterpret_cast<const float2*>(ab + GEMMN_BK + kk + 2 * t);
        const float2 bhi = *reinterpret_cast<const float2*>(ab + GEMMN_BK + kk + 2 * t + 8);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          af[f][0] = bn_relu2(af[f][0], alo, blo);
          af[f][1] = bn_relu2(af[f][1], alo, blo);
          af[f][2] = bn_relu2(af[f][2], ahi, bhi);
          af[f][3] = bn_relu2(af[f][3], ahi, bhi);
        }
      }
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          mma_16816(acc[f][2 * n2], af[f], bfr[n2][0], bfr[n2][1]);
          mma_16816(acc[f][2 * n2 + 1], af[f], bfr[n2][2], bfr[n2][3]);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int row = m0 + wm * 32 + f * 16 + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = wn * 64 + n * 8 + 2 * t;
      if (row < M) epi.store2(row, col, acc[f][n][0], acc[f][n][1]);
      if (row + 8 < M) epi.store2(row + 8, col, acc[f][n][2], acc[f][n][3]);
    }
  }
}

// The bottleneck's epilogue (K2, K7): h2 = bf16(relu(t a2 + b2)) into a
// (P, 128) scratch, from the f32 sum t rounded to bf16 first (RoundT, K2's
// h1) or as it is (K7).
template <bool RoundT>
struct Bn2Epilogue {
  bf16* h2;
  const float* a2;
  const float* b2;
  __device__ void store2(int p, int col, float v0, float v1) const {
    if (RoundT) {
      v0 = round_bf16(v0);
      v1 = round_bf16(v1);
    }
    *reinterpret_cast<uint32_t*>(h2 + (size_t)p * GEMMN_N + col) =
        pack2(bn_relu(v0, a2[col], b2[col]), bn_relu(v1, a2[col + 1], b2[col + 1]));
  }
};

// Launch the GEMM above with BM = bm (128 or 64) on `stream`.
template <class Affine, class Epilogue>
cudaError_t gemm_affine(int bm, const bf16* x, int ldx, Affine aff, const bf16* Bm, int M,
                        int K, Epilogue epi, cudaStream_t stream) {
  constexpr int S = Affine::kSlots;
  if (bm == 128) {
    static const cudaError_t set = cudaFuncSetAttribute(
        gemm_bnrelu_kernel<128, Affine, Epilogue>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, gemmn_smem_bytes<128, S>());
    if (set != cudaSuccess) return set;
    gemm_bnrelu_kernel<128, Affine, Epilogue><<<(M + 127) / 128, 256,
                                                gemmn_smem_bytes<128, S>(), stream>>>(
        x, ldx, aff, Bm, M, K, epi);
  } else if (bm == 64) {
    static const cudaError_t set = cudaFuncSetAttribute(
        gemm_bnrelu_kernel<64, Affine, Epilogue>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, gemmn_smem_bytes<64, S>());
    if (set != cudaSuccess) return set;
    gemm_bnrelu_kernel<64, Affine, Epilogue><<<(M + 63) / 64, 128, gemmn_smem_bytes<64, S>(),
                                               stream>>>(x, ldx, aff, Bm, M, K, epi);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The GEMM with one affine per column (K2, K7): a, b (K,) f32.
template <class Epilogue>
cudaError_t gemm_bnrelu(int bm, const bf16* x, int ldx, const float* a, const float* b,
                        const bf16* Bm, int M, int K, Epilogue epi, cudaStream_t stream) {
  return gemm_affine(bm, x, ldx, ColumnAffine{a, b}, Bm, M, K, epi, stream);
}

// ---------------------------------------------------------------------------
// 3x3 / pad-1 convolution, 128 -> 32 channels, over NHWC pixels (N, H, W),
// written at channel offset c_off of an NHWC buffer with pixel stride ld.
//
// The source: `src.row(p)` points at pixel p's 128 bf16 values in device
// memory; `src.apply(p, c8, raw)` computes the conv's input from 8 of them
// (the prologue: BN + ReLU, or nothing when Src::kIdentity). Pixels off the
// image contribute exact zeros (the zero padding applies to the computed
// input, so relu(b) never leaks in). With RoundTaps (the default) each
// tap's 128-channel partial is rounded to bf16 before the f32 tap sum, as
// the TPU kernels' packed-taps products are; without it each tap's f32
// partial is summed as it is (K7's taps_packed=False). Taps are summed in
// order 0..8.
//
// The design. The output is cut into tiles of `images` whole images or of
// `rows` x `cols` of one image (ops/conv2.py::conv3x3_plan chooses by a cost
// model: the halo patch must fit, the card must get enough tiles, and the
// tile's 32-pixel warp tasks should spread evenly over an SM's four
// sub-partitions). A persistent grid (about one block per SM) walks the
// tiles. Each block
//   - loads the 9 x 128 x 32 tap weights into shared memory once and keeps
//     them there (72 KB);
//   - stages each tile's (rows + 2) x (cols + 2) x 128 source patch once,
//     with zeros off the image, by cp.async into one of two buffers while
//     it computes the tile before (then applies the prologue in place);
//   - computes the nine taps as nine shifted views of the patch: each warp
//     takes 32 output pixels, whose A fragments ldmatrix reads from the
//     shifted patch rows (any pixel offset), against the resident weights,
//     with mma.sync m16n8k16 (bf16 -> f32).
// Shared memory is swizzled: 16-byte chunk c of patch pixel q sits at
// chunk c ^ (q & 7), of weight row r at c ^ ((r >> 1) & 3).
// What bounds it: per 104-image pass at 224 the 58 calls do 259 GFLOP and
// must move ~1.1 GB (0.26 / 0.34 ms on the H100); this design is held to
// mma.sync's issue rate on the busiest sub-partition of each SM, then the
// patches' staging, and at the small layers of blocks 3-4 each launch's
// fixed cost (the weights' load, one tile per block). wgmma (twice the
// tensor rate, A from these registers, B from the resident weights) is the
// next step.
// ---------------------------------------------------------------------------

constexpr int C3_CIN = 128;
constexpr int C3_COUT = 32;
constexpr int C3_THREADS = 256;                          // 8 warps
constexpr int C3_UNIT = 32;                              // output pixels per warp task
constexpr int C3_WEIGHT_BYTES = 9 * C3_CIN * C3_COUT * 2;  // 73,728
constexpr int C3_PIXEL_BYTES = C3_CIN * 2;               // 256
constexpr int C3_SMEM_MAX = 232448;                      // 227 KB, a block's most

// The tile plan (ops/conv2.py::conv3x3_plan): tile extents, the grid and
// the dynamic shared memory (weights + two patches).
struct Conv3x3Plan {
  int images, rows, cols, grid, smem_bytes;
};

// The fragments of step (tap, ks), ks = a 16-channel slice: A (two 16-pixel
// fragments) from the patch shifted by the tap, B (the tap's 16 x 32
// weights) from the resident weights.
__device__ __forceinline__ void c3_load(int tap, int ks, const int (&qc)[2], int pw, int hi,
                                        uint32_t pbase, uint32_t wbase, const uint32_t (&bsw)[2],
                                        uint32_t (&af)[2][4], uint32_t (&bfr)[2][4]) {
  const int off = (tap / 3 - 1) * pw + (tap % 3 - 1);
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int q = qc[f] + off;
    ldmatrix_x4(pbase + q * C3_PIXEL_BYTES + (((2 * ks + hi) ^ (q & 7)) << 4), af[f]);
  }
#pragma unroll
  for (int n2 = 0; n2 < 2; ++n2)
    ldmatrix_x4_trans(wbase + (tap * C3_CIN + ks * 16) * 64 + bsw[n2], bfr[n2]);
}

template <class Src, bool RoundTaps>
__global__ void __launch_bounds__(C3_THREADS, 1)
conv3x3_kernel(Src src, const bf16* __restrict__ w2, bf16* __restrict__ out, int N, int H,
               int W, int ld, int c_off, Conv3x3Plan plan) {
  extern __shared__ __align__(128) unsigned char csm[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pw = plan.cols + 2;
  const int img_px = (plan.rows + 2) * pw;
  const int patch_px = plan.images * img_px;
  const int tiles_x = (W + plan.cols - 1) / plan.cols;
  const int tiles_y = (H + plan.rows - 1) / plan.rows;
  const int n_tiles = (N + plan.images - 1) / plan.images * tiles_y * tiles_x;
  unsigned char* wsm = csm;
  auto patch = [&](int buf) {
    return csm + C3_WEIGHT_BYTES + buf * patch_px * C3_PIXEL_BYTES;
  };

  // A tile's origin (first image, row, column).
  auto origin = [&](int tile, int& n0, int& y0, int& x0) {
    const int tx = tile % tiles_x;
    const int ty = (tile / tiles_x) % tiles_y;
    n0 = tile / (tiles_x * tiles_y) * plan.images;
    y0 = ty * plan.rows;
    x0 = tx * plan.cols;
  };
  // This thread's 16-byte chunks of a tile's patch: chunk c = tid % 16 of
  // the patch pixels q = tid / 16, + 16, ...; fn(q, p) gets each with its
  // source pixel p (-1 off the image). The patch coordinates (image, row,
  // column) advance incrementally: no division per pixel.
  const int c16 = tid & 15;
  auto walk = [&](int tile, auto&& fn) {
    int n0, y0, x0;
    origin(tile, n0, y0, x0);
    int q = tid >> 4;
    int gi = q / img_px, py = (q - gi * img_px) / pw;
    int px = q - gi * img_px - py * pw;
    for (; q < patch_px; q += C3_THREADS / 16) {
      const int n = n0 + gi, y = y0 + py - 1, x = x0 + px - 1;
      fn(q, (n < N && y >= 0 && y < H && x >= 0 && x < W) ? (n * H + y) * W + x : -1);
      px += C3_THREADS / 16;
      while (px >= pw) {
        px -= pw;
        if (++py == plan.rows + 2) {
          py = 0;
          ++gi;
        }
      }
    }
  };
  auto stage = [&](int tile, int buf) {
    const uint32_t base = smem_addr(patch(buf));
    walk(tile, [&](int q, int p) {
      cp_async16(base + q * C3_PIXEL_BYTES + ((c16 ^ (q & 7)) << 4),
                 p >= 0 ? src.row(p) + c16 * 8 : w2, p >= 0);
    });
  };

  for (int e = tid; e < 9 * C3_CIN * 4; e += C3_THREADS) {
    const int r = e >> 2, c = e & 3;
    cp_async16(smem_addr(wsm + r * 64 + ((c ^ ((r >> 1) & 3)) << 4)), w2 + r * C3_COUT + c * 8,
               true);
  }
  int buf = 0;
  if (blockIdx.x < n_tiles) stage(blockIdx.x, 0);
  cp_async_commit();

  const int g = lane >> 2, t = lane & 3;
  // Per-lane ldmatrix constants: the 8-channel half of an A fragment row
  // (hi), and a B row's weight address within a tap's 16-row slice with its
  // swizzled 8-column chunk for each pair of 8-column n-blocks (bsw).
  const int hi = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t wbase = smem_addr(wsm) + brow * 64;
  uint32_t bsw[2];
#pragma unroll
  for (int n2 = 0; n2 < 2; ++n2) bsw[n2] = ((n2 * 2 + hi) ^ ((brow >> 1) & 3)) << 4;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < n_tiles) stage(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    int n0, y0, x0;
    origin(tile, n0, y0, x0);
    unsigned char* pb = patch(buf);
    if (!Src::kIdentity) {
      walk(tile, [&](int q, int p) {
        if (p < 0) return;
        uint4* v = reinterpret_cast<uint4*>(pb + q * C3_PIXEL_BYTES + ((c16 ^ (q & 7)) << 4));
        *v = src.apply(p, c16 * 8, *v);
      });
      __syncthreads();
    }
    const int gn = min(plan.images, N - n0);
    const int th = min(plan.rows, H - y0);
    const int tw = min(plan.cols, W - x0);
    const int per_img = th * tw;
    const int M = gn * per_img;
    const uint32_t pbase = smem_addr(pb);
    for (int u = warp * C3_UNIT; u < M; u += 8 * C3_UNIT) {
      // This lane's A row in each 16-pixel fragment: its patch pixel.
      int qc[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int m = min(u + f * 16 + (lane & 15), M - 1);
        const int gi = m / per_img;
        const int r = m - gi * per_img;
        const int yy = r / tw;
        qc[f] = gi * img_px + (yy + 1) * pw + (r - yy * tw) + 1;
      }
      // Two register stages of fragments: the next step's loads are issued
      // before this step's MMAs.
      uint32_t af[2][2][4], bfr[2][2][4];
      float total[2][4][4];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) total[f][n][q] = 0.0f;
      c3_load(0, 0, qc, pw, hi, pbase, wbase, bsw, af[0], bfr[0]);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        float part[2][4][4];
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) part[f][n][q] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < C3_CIN / 16; ++ks) {
          const int st = ks & 1;
          if (ks + 1 < C3_CIN / 16)
            c3_load(tap, ks + 1, qc, pw, hi, pbase, wbase, bsw, af[st ^ 1], bfr[st ^ 1]);
          else if (tap < 8)
            c3_load(tap + 1, 0, qc, pw, hi, pbase, wbase, bsw, af[st ^ 1], bfr[st ^ 1]);
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int n2 = 0; n2 < 2; ++n2) {
              mma_16816(part[f][2 * n2], af[st][f], bfr[st][n2][0], bfr[st][n2][1]);
              mma_16816(part[f][2 * n2 + 1], af[st][f], bfr[st][n2][2], bfr[st][n2][3]);
            }
        }
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              total[f][n][q] += RoundTaps ? round_bf16(part[f][n][q]) : part[f][n][q];
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = u + f * 16 + g + 8 * half;
          if (m >= M) continue;
          const int gi = m / per_img;
          const int r = m - gi * per_img;
          const int yy = r / tw;
          const size_t p = ((size_t)(n0 + gi) * H + y0 + yy) * W + x0 + (r - yy * tw);
          bf16* o = out + p * ld + c_off + 2 * t;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            *reinterpret_cast<uint32_t*>(o + n * 8) =
                pack2(total[f][n][2 * half], total[f][n][2 * half + 1]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// The 3x3's source where it lies in device memory as it is: K2's and
// K7's h2 scratch (P, 128).
struct RawRows {
  static constexpr bool kIdentity = true;
  const bf16* h2;
  __device__ const bf16* row(int p) const { return h2 + (size_t)p * C3_CIN; }
  __device__ uint4 apply(int, int, uint4 v) const { return v; }
};

// Launch the 3x3 above with `plan` on `stream`.
template <class Src, bool RoundTaps = true>
cudaError_t conv3x3(Src src, const bf16* w2, bf16* out, int N, int H, int W, int ld,
                    int c_off, Conv3x3Plan plan, cudaStream_t stream) {
  static const cudaError_t set =
      cudaFuncSetAttribute(conv3x3_kernel<Src, RoundTaps>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C3_SMEM_MAX);
  if (set != cudaSuccess) return set;
  if (N * H * W == 0) return cudaGetLastError();
  conv3x3_kernel<Src, RoundTaps><<<plan.grid, C3_THREADS, plan.smem_bytes, stream>>>(
      src, w2, out, N, H, W, ld, c_off, plan);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The DenseNet transition (K3; K7's transition epilogue): for pooled pixel
// q = (n, i, j) of x (N, H, W) with pixel stride ldx,
//   pooled[q, c] = bf16( mean of relu(x a + b) over (2i, 2j), (2i+1, 2j),
//                        (2i, 2j+1), (2i+1, 2j+1) )     the Pool functor's roundings
//   out[q, :]    = bf16( pooled[q, :] @ wt )            f32 sums, k in order
// written at pixel stride out_ld (a channel slice of the next block's
// buffer). wt (C, C_out) bf16.
//
// What bounds it on the H100: bytes. At 224 with 104 images the three
// transitions read 167 + 84 + 42 MB and write a quarter of that over 2,
// against ~0.05 GFLOP per image of products: the bound is the input read
// once, ~0.1 ms per pass. The design keeps every input byte to one read:
//   - a block owns BM pooled pixels (128, 64 or 32: BM x C is 64 KB at the
//     DenseNet shapes) and pools them once for ALL C channels into a
//     resident bf16 A tile in shared memory (C rounded up to 64 with zero
//     columns); no grid dimension over C_out recomputes the pool;
//   - the pool's raw input goes through a 3-stage ring of 16 KB stages by
//     cp.async, each thread staging and then pooling its own 8 channels of
//     four raw pixels (no barrier: a thread reads only what it staged), so
//     two stages of loads stay in flight while it computes;
//   - the product runs from the resident A tile with mma.sync m16n8k16,
//     8 warps of 32 rows x 64 columns, NB = 16384 / BM columns per pass (all
//     of C_out at the DenseNet shapes), the weight's 16 KB k-slices (L2-
//     resident, 64 KB to 1 MB) streamed through the same ring by cp.async;
//   - the epilogue stages each bf16 result tile in the ring and writes it
//     with 16-byte stores.
// 112 KB of shared memory at the DenseNet shapes: two blocks per SM, so one
// block's pool overlaps the other's product. The tile plan (rows, columns,
// the pool's channel chunk) is ops/transition.py::transition_plan.
// ---------------------------------------------------------------------------

constexpr int TR_THREADS = 256;
constexpr int TR_STAGES = 3;                  // the product's ring: weight k-slices
constexpr int TR_STAGE_BYTES = 16384;
constexpr int TR_RING_BYTES = TR_STAGES * TR_STAGE_BYTES;
constexpr int TR_POOL_STAGES = 3;             // the pool's ring, in the same bytes
constexpr int TR_POOL_STAGE_BYTES = TR_RING_BYTES / TR_POOL_STAGES;
constexpr int TR_POOL_VALUES = TR_POOL_STAGE_BYTES / 8;   // pooled values a stage feeds

// rows: pooled pixels per block (BM); cols: output columns per pass (NB);
// kc: channels per pool stage (256, 128, 64 or 32, dividing C); grid:
// cdiv(Q, rows); smem_bytes: rows x round_up(C, 64) x 2 + the ring.
struct TransitionPlan {
  int rows, cols, kc, grid, smem_bytes;
};

// K3's pool (transition_pallas.py:46-51): h = relu(x a + b) in f32,
// ((h00 + h10) + (h01 + h11)) * 0.25, rounded once (by the A tile's pack).
struct TransitionPool {
  __device__ static void pool8(const uint4 (&raw)[4], const float* a, const float* b,
                               float* v) {
    float h[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) unpack8(raw[k], h[k]);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float s0 = __fadd_rn(bn_relu(h[0][c], a[c], b[c]), bn_relu(h[1][c], a[c], b[c]));
      const float s1 = __fadd_rn(bn_relu(h[2][c], a[c], b[c]), bn_relu(h[3][c], a[c], b[c]));
      v[c] = __fmul_rn(__fadd_rn(s0, s1), 0.25f);
    }
  }
};

// K7's pool (dense_block_pallas.py:376-392): hs = bf16(relu(x a + b)); the
// row pairs summed and rounded, then the column pair, rounded, x 0.25.
struct TransitionPoolBf16 {
  __device__ static void pool8(const uint4 (&raw)[4], const float* a, const float* b,
                               float* v) {
    float h[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) unpack8(raw[k], h[k]);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float s0 = round_bf16(__fadd_rn(round_bf16(bn_relu(h[0][c], a[c], b[c])),
                                            round_bf16(bn_relu(h[1][c], a[c], b[c]))));
      const float s1 = round_bf16(__fadd_rn(round_bf16(bn_relu(h[2][c], a[c], b[c])),
                                            round_bf16(bn_relu(h[3][c], a[c], b[c]))));
      v[c] = __fmul_rn(round_bf16(__fadd_rn(s0, s1)), 0.25f);
    }
  }
};

template <int BM, class Pool>
__global__ void __launch_bounds__(TR_THREADS, 2)
transition_kernel(const bf16* __restrict__ x, int H, int W, int ldx, const float* __restrict__ a,
                  const float* __restrict__ b, const bf16* __restrict__ wt, int C, int C_out,
                  bf16* __restrict__ out, int out_ld, int Q, int kc) {
  constexpr int NB = 16384 / BM;        // columns per pass: 8 warps of 32 x 64
  constexpr int WM = BM / 32;           // warps along M
  constexpr int KB = 8192 / NB;         // weight k-rows per 16 KB stage: 64, 32, 16
  constexpr int ROWB = NB * 2;          // bytes of a weight / result row
  extern __shared__ __align__(128) unsigned char tsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Cp = (C + 63) & ~63;        // A's columns: C, zero-padded to 64
  const int ROWA = Cp * 2;
  unsigned char* A = tsm;
  unsigned char* ring = tsm + BM * ROWA;
  const int m0 = blockIdx.x * BM;

  // ---- the pool: A[r, c] for r < BM, c < C, once --------------------------
  for (int e = tid; e < BM * ((Cp - C) >> 3); e += TR_THREADS) {
    const int r = e / ((Cp - C) >> 3), c = (C >> 3) + e % ((Cp - C) >> 3);
    *reinterpret_cast<uint4*>(A + r * ROWA + ((c ^ (r & 7)) << 4)) = make_uint4(0, 0, 0, 0);
  }
  {
    const int chunks = kc >> 3;                     // 16-byte chunks of a pixel per stage
    const int pr = min(TR_POOL_VALUES / kc, BM);    // pooled pixels per stage
    const int kcs = C / kc;
    const int n_stages = (BM / pr) * kcs;
    const int p = tid / chunks, c = tid - p * chunks;
    const bool active = p < pr;
    const int Wo = W >> 1, HWo = (H >> 1) * Wo;
    auto load = [&](int st, int slot) {
      if (!active) return;
      const int r = (st / kcs) * pr + p, q = m0 + r;
      const int k = (st % kcs) * kc + c * 8;
      const uint32_t dst = smem_addr(ring + slot * TR_POOL_STAGE_BYTES) + (p * 4 * chunks + c) * 16;
      const bool ok = q < Q;
      const bf16* src = x;
      if (ok) {
        const int n = q / HWo, rem = q - n * HWo;
        const int i = rem / Wo, j = rem - i * Wo;
        src = x + (((size_t)n * H + 2 * i) * W + 2 * j) * ldx + k;
      }
      const size_t down = (size_t)W * ldx;
      cp_async16(dst, src, ok);                                          // (2i, 2j)
      cp_async16(dst + chunks * 16, ok ? src + down : x, ok);            // (2i+1, 2j)
      cp_async16(dst + 2 * chunks * 16, ok ? src + ldx : x, ok);         // (2i, 2j+1)
      cp_async16(dst + 3 * chunks * 16, ok ? src + down + ldx : x, ok);  // (2i+1, 2j+1)
    };
#pragma unroll
    for (int s = 0; s < TR_POOL_STAGES - 1; ++s) {
      if (s < n_stages) load(s, s);
      cp_async_commit();
    }
    for (int st = 0; st < n_stages; ++st) {
      cp_async_wait<TR_POOL_STAGES - 2>();
      // The slot of stage st + S - 1 is the one this thread pooled at st - 1.
      const int nst = st + TR_POOL_STAGES - 1;
      if (nst < n_stages) load(nst, nst % TR_POOL_STAGES);
      cp_async_commit();
      if (!active) continue;
      const int r = (st / kcs) * pr + p;
      const int k = (st % kcs) * kc + c * 8;
      const unsigned char* src =
          ring + (st % TR_POOL_STAGES) * TR_POOL_STAGE_BYTES + (p * 4 * chunks + c) * 16;
      uint4 raw[4];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4)
        raw[q4] = *reinterpret_cast<const uint4*>(src + q4 * chunks * 16);
      float av[8], bv[8], v[8];
      *reinterpret_cast<float4*>(av) = __ldg(reinterpret_cast<const float4*>(a + k));
      *reinterpret_cast<float4*>(av + 4) = __ldg(reinterpret_cast<const float4*>(a + k + 4));
      *reinterpret_cast<float4*>(bv) = __ldg(reinterpret_cast<const float4*>(b + k));
      *reinterpret_cast<float4*>(bv + 4) = __ldg(reinterpret_cast<const float4*>(b + k + 4));
      Pool::pool8(raw, av, bv, v);
      *reinterpret_cast<uint4*>(A + r * ROWA + (((k >> 3) ^ (r & 7)) << 4)) = pack8(v);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- the product: out[m0 .. m0 + BM, n0 .. n0 + NB) per pass ------------
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;
  const int KT = Cp / KB;
  for (int n0 = 0; n0 < C_out; n0 += NB) {
    auto load_w = [&](int kt, int slot) {
      const uint32_t Bs = smem_addr(ring + slot * TR_STAGE_BYTES);
      const int k0 = kt * KB;
#pragma unroll
      for (int e = tid; e < KB * (NB >> 3); e += TR_THREADS) {
        const int r = e / (NB >> 3), c = e % (NB >> 3);
        const bool ok = k0 + r < C && n0 + c * 8 < C_out;
        cp_async16(Bs + r * ROWB + ((c ^ (r & 7)) << 4),
                   ok ? wt + (size_t)(k0 + r) * C_out + n0 + c * 8 : wt, ok);
      }
    };
    float acc[2][8][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[f][n][q] = 0.0f;
#pragma unroll
    for (int s = 0; s < TR_STAGES - 1; ++s) {
      if (s < KT) load_w(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<TR_STAGES - 2>();
      __syncthreads();
      if (kt + TR_STAGES - 1 < KT) load_w(kt + TR_STAGES - 1, (kt + TR_STAGES - 1) % TR_STAGES);
      cp_async_commit();
      const unsigned char* Bs = ring + (kt % TR_STAGES) * TR_STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < KB; kk += 16) {
        uint32_t af[2][4], bfr[4][4];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int r = wm * 32 + f * 16 + (lane & 15);
          const int c = ((kt * KB + kk) >> 3) + (lane >> 4);
          ldmatrix_x4(smem_addr(A + r * ROWA + ((c ^ (r & 7)) << 4)), af[f]);
        }
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int c = wn * 8 + n2 * 2 + (lane >> 4);
          ldmatrix_x4_trans(smem_addr(Bs + r * ROWB + ((c ^ (r & 7)) << 4)), bfr[n2]);
        }
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            mma_16816(acc[f][2 * n2], af[f], bfr[n2][0], bfr[n2][1]);
            mma_16816(acc[f][2 * n2 + 1], af[f], bfr[n2][2], bfr[n2][3]);
          }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // The bf16 result tile into the ring (16-byte chunk c of row r at
    // c ^ (r & 7)), then out by 16-byte stores.
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + f * 16 + g + 8 * h;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<uint32_t*>(ring + r * ROWB + (((wn * 8 + n) ^ (r & 7)) << 4) + 4 * t) =
              pack2(acc[f][n][2 * h], acc[f][n][2 * h + 1]);
      }
    __syncthreads();
#pragma unroll
    for (int e = tid; e < BM * (NB >> 3); e += TR_THREADS) {
      const int r = e / (NB >> 3), c = e % (NB >> 3);
      if (m0 + r < Q && n0 + c * 8 < C_out)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * out_ld + n0 + c * 8) =
            *reinterpret_cast<const uint4*>(ring + r * ROWB + ((c ^ (r & 7)) << 4));
    }
    __syncthreads();
  }
}

template <int BM, class Pool>
cudaError_t launch_transition(const bf16* x, int H, int W, int ldx, const float* a,
                              const float* b, const bf16* wt, int C, int C_out, bf16* out,
                              int out_ld, int Q, TransitionPlan plan, cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      transition_kernel<BM, Pool>, cudaFuncAttributeMaxDynamicSharedMemorySize, C3_SMEM_MAX);
  if (set != cudaSuccess) return set;
  transition_kernel<BM, Pool><<<plan.grid, TR_THREADS, plan.smem_bytes, stream>>>(
      x, H, W, ldx, a, b, wt, C, C_out, out, out_ld, Q, plan.kc);
  return cudaGetLastError();
}

// Launch the transition above with `plan` (rows 128, 64 or 32) on `stream`.
template <class Pool>
cudaError_t transition(const bf16* x, int N, int H, int W, int ldx, const float* a,
                       const float* b, const bf16* wt, int C, int C_out, bf16* out, int out_ld,
                       TransitionPlan plan, cudaStream_t stream) {
  const int Q = N * (H / 2) * (W / 2);
  if (Q == 0) return cudaGetLastError();
  if (plan.rows == 128)
    return launch_transition<128, Pool>(x, H, W, ldx, a, b, wt, C, C_out, out, out_ld, Q, plan,
                                        stream);
  if (plan.rows == 64)
    return launch_transition<64, Pool>(x, H, W, ldx, a, b, wt, C, C_out, out, out_ld, Q, plan,
                                       stream);
  if (plan.rows == 32)
    return launch_transition<32, Pool>(x, H, W, ldx, a, b, wt, C, C_out, out, out_ld, Q, plan,
                                       stream);
  return cudaErrorInvalidValue;
}

}  // namespace smg
