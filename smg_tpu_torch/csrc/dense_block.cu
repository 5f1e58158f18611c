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
// four blocks, 8.2x that at 640) but does the whole trunk's dense-layer
// and transition products, ~4.95 GFLOP per image at 224: operations, ~0.52
// ms per pass at 224 and ~4.3 ms at 640 at the bf16 tensor peak. The TPU
// kernel kept each image's block buffer in VMEM; on Hopper one image's
// buffer (1.6 / 0.8 / 0.4 / 0.1 MB for blocks 1-4 at 224, 13 MB for block 1
// at 640) fits one SM's 227 KB only at block 4, so the buffer stays in
// device memory (L2 holds 50 MB) and each layer is one launch of
// dense_layer_sm90_kernel, which keeps the layer's intermediate h2 in
// shared memory (the two-launch design before it wrote h2, 128 channels a
// pixel, to a device scratch and read it back: ~1.8 GB a pass at 224, more
// than the function's whole bound). Per tile of output pixels (the plan,
// ops/dense_block.py::dense_plan: whole images, or rows x cols of one
// image), in a persistent grid of one 384-thread block per SM:
//   1. warpgroup 0 streams the bottleneck GEMM's operands by cp.async
//      through a DL_STAGES-deep mbarrier ring: 32-channel k-slices of the
//      block-buffer prefix for 128 pixel rows and the matching rows of w1
//      (wgmma's N-major B, 128-byte swizzle) with that slice's norm1 (a, b);
//   2. warpgroups 1 and 2 (64 rows each) apply norm1 + ReLU to the A
//      fragments in registers and run wgmma m64n128k16 (A from registers,
//      B by descriptor) into one f32 accumulator over all C; norm2 + ReLU on
//      that unrounded t, and h2 goes as bf16 into the tile's patch in shared
//      memory, zeros off the image;
//   3. the same warpgroups run K5's wgmma 3x3 (conv3x3_sm90.cuh) from that
//      patch and write the 32 new channels in place at [C, C + 32).
// Warpgroup 0 fills the ring for the next tile's GEMM while the 3x3 runs.
// The halo: a tile whose patch reaches into a neighbouring tile's pixels
// (row or column bands) computes their h2 itself; the GEMM runs on every
// in-image pixel of the patch (at most (rows + 2) / rows x (cols + 2) /
// cols the tile's own rows). Whole-image tiles (blocks 3-4 at 224, block 4
// at 640) have no such halo: it is the zero padding. A thread-block cluster
// that reads the neighbours' edge rows of h2 from their shared memory
// would save that recompute where bands are needed (blocks 1-2), but there
// the GEMM is the smaller part of a layer (C <= 480 against the 3x3's fixed
// 1152 x 32 per pixel) and a cluster ties its bands to one schedule and a
// barrier per tile; the plan's cost model counts the recompute and trades
// it against tile count instead. The TPU's B_tile, width and channel
// padding and selection-matrix append have no counterpart: every launch
// masks its own edges, for any N, H, W.
// The epilogue is one kernel: K3's transition_kernel (common.cuh) with
// K7's bf16-arithmetic pool (TransitionPoolBf16), or an elementwise norm5.
// Keeping the whole block buffer resident across layers is later work.

#include "conv3x3_sm90.cuh"

namespace {

using smg::bf16;

constexpr int BOTTLENECK = 128;
constexpr int GROWTH = 32;
constexpr int EPILOGUE_TRANSITION = 0;
constexpr int EPILOGUE_FINAL_BN = 1;

// The fused layer's GEMM ring: per stage a 32-channel k-slice of 128 pixel
// rows (A, rows of 64 bytes, chunk c at c ^ ((row >> 1) & 3)), w1's 32 rows
// (B: two 64-column atoms of 32 rows x 128 bytes, chunk c at c ^ (row & 7))
// and the slice's norm1 (a, b).
constexpr int DL_STAGES = 4;
constexpr int DL_BK = 32;
constexpr int DL_ROWS = 128;
constexpr int DL_B_BYTES = DL_BK * BOTTLENECK * 2;       // 8 KB
constexpr int DL_A_BYTES = DL_ROWS * DL_BK * 2;          // 8 KB
constexpr int DL_AB_BYTES = 2 * DL_BK * 4;               // 256 B
constexpr int DL_B_OFF = smg::C3_WEIGHT_BYTES;           // 1024-aligned
constexpr int DL_A_OFF = DL_B_OFF + DL_STAGES * DL_B_BYTES;
constexpr int DL_AB_OFF = DL_A_OFF + DL_STAGES * DL_A_BYTES;
constexpr int DL_H2_OFF = DL_AB_OFF + DL_STAGES * DL_AB_BYTES;   // 140,288
constexpr uint32_t DL_LBO = 4096;                        // B's second 64-column atom
constexpr uint32_t DL_SBO = 1024;                        // 8 k-rows of 128 bytes

// A tile's GEMM rows: the in-image pixels of its patch, image by image, row
// by row. Row m's pixel in the buffer and in the patch.
struct Region {
  int ry0, rx0, rh, rw, rows;
  __device__ Region(const smg::C3wTile& t, int H, int W) {
    ry0 = max(t.y0 - 1, 0);
    rx0 = max(t.x0 - 1, 0);
    rh = min(t.y0 + t.th + 1, H) - ry0;
    rw = min(t.x0 + t.tw + 1, W) - rx0;
    rows = t.gn * rh * rw;
  }
  __device__ void locate(int m, const smg::C3wTile& t, const smg::Conv3x3Plan& plan, int H, int W,
                         int& pixel, int& q) const {
    const int gi = m / (rh * rw), r = m - gi * rh * rw, yy = r / rw, xx = r - yy * rw;
    const int y = ry0 + yy, x = rx0 + xx;
    pixel = ((t.n0 + gi) * H + y) * W + x;
    q = (gi * (plan.rows + 2) + y - t.y0 + 1) * (plan.cols + 2) + x - t.x0 + 1;
  }
};

template <bool RoundTaps>
__global__ void __launch_bounds__(smg::C3W_THREADS, 1)
dense_layer_sm90_kernel(bf16* __restrict__ buf, int Cf, int C, const float* __restrict__ a1,
                        const float* __restrict__ b1, const bf16* __restrict__ w1,
                        const float* __restrict__ a2, const float* __restrict__ b2,
                        const bf16* __restrict__ w2, int N, int H, int W,
                        smg::Conv3x3Plan plan) {
  extern __shared__ __align__(1024) unsigned char sm[];
  const int tid = threadIdx.x;
  const int patch_px = plan.images * (plan.rows + 2) * (plan.cols + 2);
  unsigned char* wsm = sm;
  unsigned char* h2s = sm + DL_H2_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(h2s + patch_px * smg::C3_PIXEL_BYTES);
  uint64_t* empty = full + DL_STAGES;
  const int n_tiles = smg::c3w_tile_count(plan, N, H, W);
  const int KT = C / DL_BK;

  if (tid == 0) {
    for (int s = 0; s < DL_STAGES; ++s) {
      smg::mbar_init(&full[s], smg::C3W_PRODUCERS);
      smg::mbar_init(&empty[s], smg::C3W_CONSUMERS);
    }
    smg::fence_mbar_init();
  }
  __syncthreads();

  if (tid < smg::C3W_PRODUCERS) {
    // ---- warpgroup 0: the GEMM's k-slices through the ring ----------------
    // A: thread tid copies chunk tid % 4 of rows tid / 4 + 32 j; B: chunks
    // tid + 128 j of w1's 32 x 16 slice; (a, b): threads 0-15.
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const smg::C3wTile t = smg::c3w_tile(tile, plan, N, H, W);
      const Region reg(t, H, W);
      for (int r0 = 0; r0 < reg.rows; r0 += DL_ROWS) {
        const bf16* src[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = r0 + (tid >> 2) + 32 * j;
          int pixel = -1, q;
          if (m < reg.rows) reg.locate(m, t, plan, H, W, pixel, q);
          src[j] = pixel >= 0 ? buf + (size_t)pixel * Cf + (tid & 3) * 8 : nullptr;
        }
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % DL_STAGES;
          smg::mbar_wait(&empty[s], ((it / DL_STAGES) & 1) ^ 1);
          const int k0 = kt * DL_BK;
          const uint32_t As = smg::smem_addr(sm + DL_A_OFF + s * DL_A_BYTES);
          const uint32_t Bs = smg::smem_addr(sm + DL_B_OFF + s * DL_B_BYTES);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = (tid >> 2) + 32 * j, c = tid & 3;
            smg::cp_async16(As + r * 64 + ((c ^ ((r >> 1) & 3)) << 4),
                            src[j] ? src[j] + k0 : buf, src[j] != nullptr);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = tid + smg::C3W_PRODUCERS * j, r = e >> 4, c = e & 15;
            smg::cp_async16(Bs + (c >> 3) * (DL_BK * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                            w1 + (size_t)(k0 + r) * BOTTLENECK + c * 8, true);
          }
          if (tid < 16)
            smg::cp_async16(smg::smem_addr(sm + DL_AB_OFF + s * DL_AB_BYTES) + tid * 16,
                            (tid < 8 ? a1 : b1) + k0 + (tid & 7) * 4, true);
          smg::cp_async_mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- warpgroups 1, 2: GEMM -> h2 patch -> 3x3 ----------------------------
    const int ctid = tid - smg::C3W_PRODUCERS;
    const int wg = ctid >> 7, wq = (ctid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, q4 = lane & 3;
    const uint32_t wbase = smg::smem_addr(wsm);
    const uint32_t h2base = smg::smem_addr(h2s);
    const int arow = wg * 64 + wq * 16 + (lane & 15);   // this lane's A row in a stage
    // The tap weights load during the first tile's GEMM.
    smg::c3w_load_weights(wsm, w2, ctid);
    smg::cp_async_commit();
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const smg::C3wTile t = smg::c3w_tile(tile, plan, N, H, W);
      const Region reg(t, H, W);
      for (int r0 = 0; r0 < reg.rows; r0 += DL_ROWS) {
        // Both warpgroups run every pass: rows past the region read zeros
        // and are not stored (a branch around wgmma would serialise it).
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
        uint32_t a[2][2][4];
        // One k-slice into register set SL (the previous slice's set may
        // still be read by its wgmmas); the previous slice's stage is
        // released once its group has retired.
        auto slice = [&](auto sl, int kt) {
          constexpr int SL = decltype(sl)::value;
          const int s = it % DL_STAGES;
          smg::mbar_wait(&full[s], (it / DL_STAGES) & 1);
          smg::fence_proxy_async();
          const unsigned char* As = sm + DL_A_OFF + s * DL_A_BYTES;
          const float* ab = reinterpret_cast<const float*>(sm + DL_AB_OFF + s * DL_AB_BYTES);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int c = 2 * ks + (lane >> 4);
            smg::ldmatrix_x4(smg::smem_addr(As + arow * 64 + ((c ^ ((arow >> 1) & 3)) << 4)),
                             a[SL][ks]);
            const float2 alo = *reinterpret_cast<const float2*>(ab + ks * 16 + 2 * q4);
            const float2 ahi = *reinterpret_cast<const float2*>(ab + ks * 16 + 2 * q4 + 8);
            const float2 blo = *reinterpret_cast<const float2*>(ab + DL_BK + ks * 16 + 2 * q4);
            const float2 bhi =
                *reinterpret_cast<const float2*>(ab + DL_BK + ks * 16 + 2 * q4 + 8);
            a[SL][ks][0] = smg::bn_relu2(a[SL][ks][0], alo, blo);
            a[SL][ks][1] = smg::bn_relu2(a[SL][ks][1], alo, blo);
            a[SL][ks][2] = smg::bn_relu2(a[SL][ks][2], ahi, bhi);
            a[SL][ks][3] = smg::bn_relu2(a[SL][ks][3], ahi, bhi);
          }
          const uint64_t desc = smg::make_desc(
              smg::smem_addr(sm + DL_B_OFF + s * DL_B_BYTES), DL_LBO, DL_SBO, smg::SWIZZLE_128B);
          smg::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            smg::wgmma_m64n128k16(acc, a[SL][ks], desc + (uint64_t)(ks * 16 * 128 >> 4),
                                  (kt > 0 || ks > 0) ? 1 : 0);
          smg::wgmma_commit();
          smg::wgmma_wait<1>();
          if (kt > 0) smg::mbar_arrive(&empty[(it + DL_STAGES - 1) % DL_STAGES]);
          ++it;
        };
        for (int kt = 0; kt < KT; kt += 2) {
          slice(std::integral_constant<int, 0>{}, kt);
          if (kt + 1 < KT) slice(std::integral_constant<int, 1>{}, kt + 1);
        }
        smg::wgmma_wait<0>();
        smg::fence_acc(acc);
        smg::mbar_arrive(&empty[(it + DL_STAGES - 1) % DL_STAGES]);

        if (r0 == 0) {
          // The previous tile's 3x3 has read the patch: zero its off-image
          // pixels for this tile.
          smg::named_bar_sync(1, smg::C3W_CONSUMERS);
          const int c16 = ctid & 15;
          for (smg::PatchWalk w(ctid >> 4, plan); w.q < patch_px; w.advance(16))
            if (w.src(t, N, H, W) < 0)
              *reinterpret_cast<uint4*>(h2s + w.q * smg::C3_PIXEL_BYTES +
                                        ((c16 ^ (w.q & 7)) << 4)) = make_uint4(0, 0, 0, 0);
        }
        // h2 = bf16(relu(t a2 + b2)) of this thread's two rows into the patch.
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = r0 + wg * 64 + wq * 16 + g + 8 * half;
          if (m >= reg.rows) continue;
          int pixel, q;
          reg.locate(m, t, plan, H, W, pixel, q);
          unsigned char* row = h2s + q * smg::C3_PIXEL_BYTES + 4 * q4;
#pragma unroll
          for (int nb = 0; nb < 16; ++nb) {
            const int col = nb * 8 + 2 * q4;
            const float2 av = __ldg(reinterpret_cast<const float2*>(a2 + col));
            const float2 bv = __ldg(reinterpret_cast<const float2*>(b2 + col));
            *reinterpret_cast<uint32_t*>(row + ((nb ^ (q & 7)) << 4)) =
                smg::pack2(smg::bn_relu(acc[4 * nb + 2 * half], av.x, bv.x),
                           smg::bn_relu(acc[4 * nb + 2 * half + 1], av.y, bv.y));
          }
        }
      }
      smg::cp_async_wait<0>();   // the weights (first tile only)
      smg::fence_proxy_async();
      smg::named_bar_sync(2, smg::C3W_CONSUMERS);
      const int M = t.gn * t.th * t.tw;
      for (int u = wg * smg::C3W_TASK; u < M; u += 2 * smg::C3W_TASK) {
        float total[16];
        smg::c3w_task<RoundTaps>(h2base, wbase, plan, t, u, wq, lane, total);
        smg::c3w_store(total, buf, t, u, wq, lane, H, W, Cf, C);
      }
    }
  }
}

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

template <bool RoundTaps>
cudaError_t dense_layer(bf16* buf, int Cf, int C, const float* a1, const float* b1,
                        const bf16* w1, const float* a2, const float* b2, const bf16* w2, int N,
                        int H, int W, const smg::Conv3x3Plan& plan, cudaStream_t stream) {
  static const cudaError_t set =
      cudaFuncSetAttribute(dense_layer_sm90_kernel<RoundTaps>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smg::C3_SMEM_MAX);
  if (set != cudaSuccess) return set;
  dense_layer_sm90_kernel<RoundTaps><<<plan.grid, smg::C3W_THREADS, plan.smem_bytes, stream>>>(
      buf, Cf, C, a1, b1, w1, a2, b2, w2, N, H, W, plan);
  return cudaGetLastError();
}

}  // namespace

// a1, b1: the L layers' norm1 affines concatenated (sum_l C_l); w1: their
// (C_l, 128) bottleneck weights stacked row-wise; a2, b2 (L, 128); w2
// (L, 9, 128, 32); at, bt (Cf,); wt (Cf, C_out) for the transition (unused
// by final_bn); dl_*: the fused layer's tile plan (ops/dense_block.py::
// dense_plan); tr_*: the transition's (ops/transition.py::transition_plan;
// unused by final_bn).
extern "C" int smg_dense_block(bf16* buf, const float* a1, const float* b1,
                               const bf16* w1, const float* a2, const float* b2,
                               const bf16* w2, const float* at, const float* bt,
                               const bf16* wt, bf16* out, int N, int H,
                               int W, int C0, int L, int C_out, int out_ld,
                               int epilogue, int taps_packed, int dl_images,
                               int dl_rows, int dl_cols, int dl_grid, int dl_smem,
                               int tr_rows, int tr_cols, int tr_kc, int tr_grid, int tr_smem,
                               cudaStream_t stream) {
  const int P = N * H * W;
  const smg::Conv3x3Plan plan{dl_images, dl_rows, dl_cols, dl_grid, dl_smem};
  const int Cf = C0 + GROWTH * L;
  if (P == 0) return (int)cudaGetLastError();
  size_t off = 0;
  for (int l = 0; l < L; ++l) {
    const int c_in = C0 + GROWTH * l;
    const bf16* w2l = w2 + (size_t)l * 9 * BOTTLENECK * GROWTH;
    const float* a2l = a2 + (size_t)l * BOTTLENECK;
    const float* b2l = b2 + (size_t)l * BOTTLENECK;
    const cudaError_t err =
        taps_packed ? dense_layer<true>(buf, Cf, c_in, a1 + off, b1 + off, w1 + off * BOTTLENECK,
                                        a2l, b2l, w2l, N, H, W, plan, stream)
                    : dense_layer<false>(buf, Cf, c_in, a1 + off, b1 + off,
                                         w1 + off * BOTTLENECK, a2l, b2l, w2l, N, H, W, plan,
                                         stream);
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
