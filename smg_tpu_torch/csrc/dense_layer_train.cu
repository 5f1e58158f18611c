// K6: one train-mode DenseNet dense layer, forward (K6a) and backward
// (K6b), with per-image batch statistics, in a dense block's NHWC buffer.
//
// Replaces smg_tpu/ops/dense_layer_train_pallas.py::layer_train_fwd (:222,
// _fwd_kernel :91-186) and ::layer_train_bwd (:442, _bwd_kernel :251-407).
// There each scene's layer ran as one batch-1 call and vmap lifted the
// scenes onto the Pallas grid; here one launch sequence covers all N
// images of a call, each with its own BatchNorm moments (n = H*W per image).
//
// Forward, for the prefix x = buf[..., :C_in] of P = N*H*W pixels:
//   m1, v1 = E[x], E[x^2] - E[x]^2 per image (f32);  a1 = s1 / sqrt(v1 + eps)
//   h1 = bf16( sum_c bf16(relu(x a1 + b1)) w1 )    rounded once: the residual
//   m2, v2 of the rounded h1;  y2 = bf16(relu(h1 a2 + b2)), zero off the image
//   out = bf16( sum_tap bf16(y2[pixel + tap] w2[tap]) ) at channels C_in..+32
// Backward, with dout = bf16(dbuf[..., C_in:C_in+32]) (f32 cotangent buffer):
//   dy2 = sum_tap shift_(1-dy,1-dx)(dout) w2[tap]^T;  du2 = [u2 > 0] dy2
//   dh1 = bf16( a2 (du2 - mean(du2) - xhat2 mean(du2 xhat2)) )   per image
//   dw2[tap] = y2^T shift(dout);  dw1 = bf16(y1)^T dh1;  dy1 = dh1 w1^T
//   du1 = [u1 > 0] dy1;  dbuf[..., :C_in] += bf16( a1 (du1 - ... ) )
//   dscale/dbias = per-image sums of du xhat / du, summed over images.
// The rounding points are the TPU kernel's (:133, :145-152, :166, :180
// forward; :286, :315, :349, :371, :403-406 backward).
//
// What bounds it on the H100. At 224 one style group of the update is up
// to 64 images (32 scenes x scene + mask stream); over the 58 layers the
// prefix is sum_l C_in(l) H W = 9.09 M elements per image, 582 M per
// 64-image pass. The forward does ~0.31 TFLOP and must read each layer's
// prefix and write h1 and out (~1.9 GB in all, as chip_smoke.py reckons
// it): bytes bind, ~0.56 ms at 3.35 TB/s. The backward does twice the
// FLOPs and must read the prefix, h1 and a bf16 dout and write a bf16 dx
// (~3.0 GB): bytes bind again, ~0.92 ms. Per prefix element that bound is
// 4 B (x in, dx out).
//
// K6a, five launches per layer:
//   1. moments_kernel of the channels this layer adds to the block's
//      statistics (all C0 at the block's first layer, then the 32 the layer
//      before wrote) into a per-block (N, C_block) buffer: the moments of a
//      channel do not change once it is written, so each is computed once
//      per block, by the same per-channel reduction as a per-layer pass
//      (same bits). The per-layer pass read the whole prefix: O(L^2) bytes.
//   2. the bottleneck on common.cuh's pipelined gemm_bnrelu_kernel with a
//      per-image affine (ImageAffine<S>): each stage computes a1, b1 of its
//      k-slice for the tile's images (a 128-row tile spans up to 4 images
//      at H = 7, 128 at H = W = 1) and applies norm1 + ReLU to the staged x
//      once, each row with its image's; h1 rounded to bf16 in the
//      epilogue. S, the table's image slots, is 4, 16 or 64, and the tile
//      rows 128 or 64: ops/dense_layer_train.py::image_plan picks both so
//      that the table fits shared memory.
//   3-4. h1_sums_kernel / h1_moments_kernel: norm2's moments from 16-byte
//      loads of h1, per-chunk partials added in order, and the affine.
//   5. conv3x3_kernel (K2's) with the Y2Rows source.
//   Traffic per prefix element: x read once by the GEMM (2 B), plus the new
//   channels' moments pass (2 B a pixel for each of the 32 channels); per
//   pixel h1 written once and read twice (768 B).
//
// K6b, ten launches per layer, every GEMM on mma.sync m16n8k16 with
// cp.async staging and no integer division per element (pixels map to
// images once per tile, or by an incremental owner):
//   1. affine_kernel: a, b and 1/sqrt(var + eps) of both norms, (N, C).
//   2. compact_dout_kernel: dout = bf16(dbuf[..., C_in:+32]) once, (P, 32):
//      64 B per pixel that the dout consumers read instead of nine strided
//      f32 gathers each.
//   3. dy2_kernel: the transposed 3x3 (32 -> 128) built like conv3x3_kernel:
//      a persistent grid, the 9 x 128 x 32 tap weights resident in shared
//      memory in their stored layout, each tile's dout halo patch staged
//      once (double-buffered) and read as nine shifted ldmatrix views; tiles
//      lie within one image. The epilogue forms du2 = [u2 > 0] dy2 (f32,
//      kept: a second pass of the 3x3 that recomputes it, as the TPU kernel
//      did, measured slower than its round trip) and per-tile partial sums
//      of du2 and du2 xhat2 per channel.
//   4. dh1_kernel: those partials added in tile order, then
//      dh1 = bf16(a2 (du2 - ...)).
//   5. dw2_kernel: dw2[tap] = y2^T shift(dout), one warp per tap, y2
//      computed from h1 once per staged tile, the taps' B the shifted views
//      of the staged dout patch, ldmatrix.trans for y2^T; one f32 partial
//      per persistent block.
//   6. dw1_kernel: dw1 = y1^T dh1, split over pixels, a 3-stage cp.async
//      ring of raw x and dh1 tiles, norm1 + ReLU applied once per staged
//      tile; one partial per split.
//   7-9. BN1 backward by recompute, as the TPU kernel did: dy1 = dh1 w1^T
//      (K = 128; w1 read in its stored layout) twice, on tiles of up to 128
//      pixels with a table of 4 or 16 image slots (image_plan: fewer rows
//      per tile for images under 9 pixels). Pass 1 (dy1_kernel
//      <false>) reduces du1 and du1 xhat1 into per-(tile, image) partials,
//      reduce_dy1_kernel adds them in tile order, pass 2 (dy1_kernel<true>)
//      forms dx and does the one read-modify-write of the f32 prefix
//      cotangent: dbuf += bf16(dx). The f32 du1 scratch of a one-pass design
//      (12 B per prefix element) does not exist.
//   10. finish_kernel: the weight gradients' partials and the BN sums added
//      in a fixed order into one output.
//   Traffic per prefix element: x read three times (dw1, both dy1 passes:
//   6 B) and the f32 cotangent read and written (8 B): 14 B against the
//   bound's 4 B (the f32 block cotangent keeps the port's sum of each
//   prefix's cotangents exact to f32, see ops/dense_layer_train.py). Per
//   pixel: h1 read three times (768 B), du2 written and read (1 KB), dh1
//   written once and read by dw1 and both dy1 passes (per 128-channel tile
//   of the prefix).
// Every reduction is in a fixed order: per-tile partials reduced in tile
// order, no float atomics, so a repeated run gives the same bits.
//
// Dropped from the TPU kernel, as VMEM/lane devices with no job here: the
// width padding to 8 and its pad-column masks, the pltpu.roll column
// shifts, the 128-lane segment groups, and the VMEM gate `supported()`
// with its fallback to the 'conv' form: every layer runs here.

#include "common.cuh"

namespace {

using smg::bf16;
using smg::cp_async16;
using smg::ldmatrix_x4;
using smg::ldmatrix_x4_trans;
using smg::mma_16816;
using smg::smem_addr;

constexpr int BOTTLENECK = 128;
constexpr int GROWTH = 32;
constexpr float BN_EPS = 1e-5f;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float inv_std(float var) { return 1.0f / sqrtf(var + BN_EPS); }

__device__ __forceinline__ void bn_affine(float mean, float var, float scale,
                                          float bias, float* a, float* b) {
  *a = __fmul_rn(scale, inv_std(var));
  *b = __fsub_rn(bias, __fmul_rn(mean, *a));
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- moments and affines ----------------------------------------------

// Per-channel reductions over one image: 32 channels x 8 pixel lanes.
constexpr int RED_C = 32;
constexpr int RED_R = 8;

// Per-image moments of x[..., c_lo:c_hi] (bf16, pixel stride ldx; c_hi -
// c_lo a multiple of 32) into mean, var (N, ldm). Lane ty of channel c sums
// the pixels ty, ty + 8, ... in order, then the lanes are added in order: a
// channel's moments depend on that channel alone, whichever block and
// layer compute them.
__global__ void __launch_bounds__(RED_C * RED_R)
moments_kernel(const bf16* __restrict__ x, int ldx, int c_lo, int HW,
               float* __restrict__ mean, float* __restrict__ var, int ldm) {
  __shared__ float sh[2][RED_R][RED_C + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int img = blockIdx.x;
  const int c = c_lo + blockIdx.y * RED_C + tx;
  float s = 0.0f, s2 = 0.0f;
  const bf16* base = x + (size_t)img * HW * ldx + c;
  for (int p = ty; p < HW; p += RED_R) {
    const float v = __bfloat162float(base[(size_t)p * ldx]);
    s += v;
    s2 += v * v;
  }
  sh[0][ty][tx] = s;
  sh[1][ty][tx] = s2;
  __syncthreads();
  if (ty == 0) {
    s = 0.0f;
    s2 = 0.0f;
    for (int r = 0; r < RED_R; ++r) {
      s += sh[0][r][tx];
      s2 += sh[1][r][tx];
    }
    const float n = (float)HW;
    const float m = s / n;
    const size_t o = (size_t)img * ldm + c;
    mean[o] = m;
    var[o] = s2 / n - m * m;
  }
}

// The forward's affines again, for the backward: aff1 (3, N, C1) and aff2
// (3, N, 128) hold a, b and 1/sqrt(var + eps); mean1/var1 have row stride
// ldm1.
__global__ void affine_kernel(const float* __restrict__ mean1, const float* __restrict__ var1,
                              int ldm1, const float* __restrict__ s1,
                              const float* __restrict__ bi1, const float* __restrict__ mean2,
                              const float* __restrict__ var2, const float* __restrict__ s2,
                              const float* __restrict__ bi2, float* __restrict__ aff1,
                              float* __restrict__ aff2, int N, int C1) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nc1 = N * C1;
  if (i < nc1) {
    const int n = i / C1, c = i - n * C1;
    const size_t o = (size_t)n * ldm1 + c;
    const float var = var1[o];
    bn_affine(mean1[o], var, s1[c], bi1[c], &aff1[i], &aff1[nc1 + i]);
    aff1[2 * nc1 + i] = inv_std(var);
    return;
  }
  i -= nc1;
  if (i >= N * BOTTLENECK) return;
  const int c = i & (BOTTLENECK - 1);
  const int nc2 = N * BOTTLENECK;
  bn_affine(mean2[i], var2[i], s2[c], bi2[c], &aff2[i], &aff2[nc2 + i]);
  aff2[2 * nc2 + i] = inv_std(var2[i]);
}

// The per-image moments of h1 (P, 128), in an order of their own (only
// norm1's moments keep the per-layer kernel's order): h1_sums_kernel sums
// pixels [s chunk, (s + 1) chunk) of image n = blockIdx.x, s = blockIdx.y,
// with 16-byte loads (16 lanes of 8 channels x 16 pixel lanes, the lanes
// added in order) into part (N, S, 2, 128); h1_moments_kernel adds the S
// chunks in order and writes st2 (4, N, 128): mean, var, a, b.
constexpr int HS_LANES = 16;

__global__ void __launch_bounds__(256)
h1_sums_kernel(const bf16* __restrict__ h1, int HW, int chunk, float* __restrict__ part) {
  __shared__ float sh[2][HS_LANES][BOTTLENECK + 4];
  const int tid = threadIdx.x, c16 = tid & 15, lane = tid >> 4;
  const int n = blockIdx.x, S = gridDim.y, s = blockIdx.y;
  const int p1 = min(HW, (s + 1) * chunk);
  float a[8], b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = b[k] = 0.0f;
  const bf16* base = h1 + (size_t)n * HW * BOTTLENECK + c16 * 8;
#pragma unroll 4
  for (int p = s * chunk + lane; p < p1; p += HS_LANES) {
    float v[8];
    smg::unpack8(*reinterpret_cast<const uint4*>(base + (size_t)p * BOTTLENECK), v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] += v[k];
      b[k] += v[k] * v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    sh[0][lane][c16 * 8 + k] = a[k];
    sh[1][lane][c16 * 8 + k] = b[k];
  }
  __syncthreads();
  const int w = tid >> 7, c = tid & (BOTTLENECK - 1);
  float v = 0.0f;
  for (int l = 0; l < HS_LANES; ++l) v += sh[w][l][c];
  part[(((size_t)n * S + s) * 2 + w) * BOTTLENECK + c] = v;
}

__global__ void h1_moments_kernel(const float* __restrict__ part, int S, int HW,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ bias, float* __restrict__ st2,
                                  int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * BOTTLENECK) return;
  const int n = i / BOTTLENECK, c = i - n * BOTTLENECK;
  float s = 0.0f, s2 = 0.0f;
  for (int k = 0; k < S; ++k) {
    const float* q = part + ((size_t)n * S + k) * 2 * BOTTLENECK + c;
    s += q[0];
    s2 += q[BOTTLENECK];
  }
  const float m = s / (float)HW;
  const float v = s2 / (float)HW - m * m;
  const int NC = N * BOTTLENECK;
  st2[i] = m;
  st2[NC + i] = v;
  bn_affine(m, v, scale[c], bias[c], &st2[2 * NC + i], &st2[3 * NC + i]);
}

// ---- K6a's GEMM operands ------------------------------------------------

// norm1's per-image affine for gemm_bnrelu_kernel: rows are pixels of
// consecutive images of HW pixels; each stage computes (a, b) of its
// k-slice from the moments for each image its tile covers (at most S).
template <int S>
struct ImageAffine {
  static constexpr int kSlots = S;
  static constexpr bool kInSmem = true;
  const float* mean;
  const float* var;
  int ldm;
  const float* scale;
  const float* bias;
  int HW, N;
  __device__ void stage(float* ab, int m0, int rows, int k0, int K, int tid,
                        int threads) const {
    const int n0 = m0 / HW;
    const int n1 = min(N - 1, (m0 + rows - 1) / HW);
    for (int e = tid; e < (n1 - n0 + 1) * smg::GEMMN_BK; e += threads) {
      const int s = e / smg::GEMMN_BK, c = e % smg::GEMMN_BK;
      const int n = n0 + s, k = k0 + c;
      float a = 0.0f, b = 0.0f;
      if (k < K) {
        const size_t o = (size_t)n * ldm + k;
        bn_affine(mean[o], var[o], scale[k], bias[k], &a, &b);
      }
      ab[s * 2 * smg::GEMMN_BK + c] = a;
      ab[s * 2 * smg::GEMMN_BK + smg::GEMMN_BK + c] = b;
    }
  }
  __device__ int slot(int m0, int row) const { return row / HW - m0 / HW; }
};

struct H1Epilogue {  // h1 = bf16(sum): the residual
  bf16* h1;
  __device__ void store2(int p, int col, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(h1 + (size_t)p * BOTTLENECK + col) = smg::pack2(v0, v1);
  }
};

// conv2's source in the forward: y2 computed from the staged h1.
struct Y2Rows {
  static constexpr bool kIdentity = false;
  const bf16* h1;
  const float* a;  // (N, 128) per-image affine
  const float* b;
  int HW;
  __device__ const bf16* row(int p) const { return h1 + (size_t)p * BOTTLENECK; }
  __device__ uint4 apply(int p, int c8, uint4 raw) const {
    const size_t o = (size_t)(p / HW) * BOTTLENECK + c8;
    const float4 a0 = *reinterpret_cast<const float4*>(a + o);
    const float4 a1 = *reinterpret_cast<const float4*>(a + o + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + o);
    const float4 b1 = *reinterpret_cast<const float4*>(b + o + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float v[8];
    smg::unpack8(raw, v);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = smg::bn_relu(v[c], av[c], bv[c]);
    return smg::pack8(v);
  }
};

// ---- K6b ----------------------------------------------------------------

// dout = bf16(dbuf[p, c_off .. c_off + 32)) -> dc (P, 32).
__global__ void compact_dout_kernel(const float* __restrict__ dbuf, int ld, int c_off, int P,
                                    bf16* __restrict__ dc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = e >> 2, c8 = (e & 3) * 8;
  if (p >= P) return;
  const float* src = dbuf + (size_t)p * ld + c_off + c8;
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  *reinterpret_cast<uint4*>(dc + (size_t)p * GROWTH + c8) = smg::pack8(v);
}

// Tiles of `rows` x `cols` pixels of one image (ops/dense_layer_train.py's
// dgrad_plan and dw2_plan), walked by a persistent grid.
struct TilePlan {
  int rows, cols, grid, smem_bytes;
};

struct TileGeom {
  int tiles_x, tiles_y, per_img, n_tiles, pw, patch_px;
  __device__ TileGeom(const TilePlan& pl, int N, int H, int W) {
    tiles_x = (W + pl.cols - 1) / pl.cols;
    tiles_y = (H + pl.rows - 1) / pl.rows;
    per_img = tiles_x * tiles_y;
    n_tiles = N * per_img;
    pw = pl.cols + 2;
    patch_px = (pl.rows + 2) * pw;
  }
  __device__ void origin(const TilePlan& pl, int tile, int& n, int& y0, int& x0) const {
    n = tile / per_img;
    const int r = tile - n * per_img;
    const int ty = r / tiles_x;
    y0 = ty * pl.rows;
    x0 = (r - ty * tiles_x) * pl.cols;
  }
};

constexpr int DOUT_PX_BYTES = GROWTH * 2;                  // 64: 4 chunks of 16 B
constexpr int W2_BYTES = 9 * BOTTLENECK * GROWTH * 2;      // 73,728

// Offset of 16-byte chunk c of dout patch pixel q (swizzled: no bank twice
// for 8 consecutive pixels).
__device__ __forceinline__ int dout_off(int q, int c) {
  return q * DOUT_PX_BYTES + ((c ^ ((q >> 1) & 3)) << 4);
}

// Stage the (rows + 2) x (cols + 2) dout halo patch of tile `tile` at smem
// address `base` by cp.async, zeros off the image; `threads` threads, 4 per
// pixel; the patch coordinates advance incrementally.
__device__ __forceinline__ void stage_dout_patch(const bf16* dc, uint32_t base, const TilePlan& pl,
                                                 const TileGeom& tg, int tile, int H, int W,
                                                 int tid, int threads) {
  int n, y0, x0;
  tg.origin(pl, tile, n, y0, x0);
  const int c = tid & 3;
  const int step = threads >> 2;
  int q = tid >> 2;
  int py = q / tg.pw, px = q - py * tg.pw;
  for (; q < tg.patch_px; q += step) {
    const int y = y0 + py - 1, x = x0 + px - 1;
    const bool ok = y >= 0 && y < H && x >= 0 && x < W;
    cp_async16(base + dout_off(q, c), ok ? dc + ((size_t)(n * H + y) * W + x) * GROWTH + c * 8 : dc,
               ok);
    px += step;
    while (px >= tg.pw) {
      px -= tg.pw;
      ++py;
    }
  }
}

// The transposed 3x3, 32 -> 128: dy2[p] = sum_tap dout[p + (1 - dy, 1 - dx)]
// w2[tap]^T, with du2 = [h1 a2 + b2 > 0] dy2 written in f32 and, per tile,
// the partial sums of du2 and du2 xhat2 per channel into
// part (n_tiles, 2, 128) (a tile is rows x cols of one image).
// Warp task: 32 pixels x 64 channels. Shared memory: the tap weights
// (w2[tap][c][o], row c of tap t: 64 B, chunk k ^ ((row >> 1) & 3)), two
// dout patches, the tile's image's a2, b2, m2, r2, and the per-task sums.
constexpr int DG_THREADS = 256;

__global__ void __launch_bounds__(DG_THREADS, 1)
dy2_kernel(const bf16* __restrict__ dc, const bf16* __restrict__ w2, const bf16* __restrict__ h1,
           const float* __restrict__ aff2, const float* __restrict__ mean2,
           float* __restrict__ du2, float* __restrict__ part, int N, int H, int W, TilePlan pl) {
  extern __shared__ __align__(128) unsigned char dsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TileGeom tg(pl, N, H, W);
  const int patch_bytes = tg.patch_px * DOUT_PX_BYTES;
  float* tab = reinterpret_cast<float*>(dsm + W2_BYTES + 2 * patch_bytes);  // a, b, m, r
  float* red = tab + 4 * BOTTLENECK;                                       // [pg][2][128]
  const uint32_t wbase = smem_addr(dsm);
  auto patch = [&](int b) { return smem_addr(dsm + W2_BYTES + b * patch_bytes); };

  for (int e = tid; e < 9 * BOTTLENECK * 4; e += DG_THREADS) {
    const int r = e >> 2, c = e & 3;
    cp_async16(wbase + r * 64 + ((c ^ ((r >> 1) & 3)) << 4), w2 + r * GROWTH + c * 8, true);
  }
  if (blockIdx.x < tg.n_tiles)
    stage_dout_patch(dc, patch(0), pl, tg, blockIdx.x, H, W, tid, DG_THREADS);
  smg::cp_async_commit();

  const int g = lane >> 2, t = lane & 3;
  const int hi = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bchunk = (lane >> 3) & 1;
  const int NC = N * BOTTLENECK;
  int buf = 0;
  for (int tile = blockIdx.x; tile < tg.n_tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < tg.n_tiles)
      stage_dout_patch(dc, patch(buf ^ 1), pl, tg, tile + gridDim.x, H, W, tid, DG_THREADS);
    smg::cp_async_commit();
    int n, y0, x0;
    tg.origin(pl, tile, n, y0, x0);
    if (tid < BOTTLENECK) {
      const int o = n * BOTTLENECK + tid;
      tab[tid] = aff2[o];
      tab[BOTTLENECK + tid] = aff2[NC + o];
      tab[2 * BOTTLENECK + tid] = mean2[o];
      tab[3 * BOTTLENECK + tid] = aff2[2 * NC + o];
    }
    smg::cp_async_wait<1>();
    __syncthreads();
    const int th = min(pl.rows, H - y0), tw = min(pl.cols, W - x0);
    const int M = th * tw;
    const int npg = (M + 31) / 32;
    const uint32_t pbase = patch(buf);
    for (int u = warp; u < 2 * npg; u += DG_THREADS / 32) {
      const int pg = u >> 1, half = u & 1;
      int qc[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int m = min(pg * 32 + f * 16 + (lane & 15), M - 1);
        const int yy = m / tw;
        qc[f] = (yy + 1) * tg.pw + (m - yy * tw) + 1;
      }
      float acc[2][8][4];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.0f;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (1 - tap / 3) * tg.pw + (1 - tap % 3);
        const uint32_t wtap = wbase + (tap * BOTTLENECK + half * 64) * 64;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t af[2][4], bfr[4][4];
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int q = qc[f] + off;
            ldmatrix_x4(pbase + dout_off(q, 2 * ks + hi), af[f]);
          }
#pragma unroll
          for (int n2 = 0; n2 < 4; ++n2) {
            const int r = n2 * 16 + brow;   // row within the tap's 64-channel half
            const int rr = half * 64 + r;
            ldmatrix_x4(wtap + r * 64 + (((2 * ks + bchunk) ^ ((rr >> 1) & 3)) << 4), bfr[n2]);
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
      // Epilogue: du2 and this thread's sums over its four pixels.
      float sd[8][2], sx[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) sd[j][0] = sd[j][1] = sx[j][0] = sx[j][1] = 0.0f;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = pg * 32 + f * 16 + g + 8 * h;
          if (m >= M) continue;
          const int yy = m / tw;
          const size_t p = ((size_t)n * H + y0 + yy) * W + x0 + (m - yy * tw);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = half * 64 + j * 8 + 2 * t;
            const float2 hv = ld_bf2(h1 + p * BOTTLENECK + c);
            const float hx[2] = {hv.x, hv.y};
            float d[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float u2 = smg::affine(hx[k], tab[c + k], tab[BOTTLENECK + c + k]);
              d[k] = u2 > 0.0f ? acc[f][j][2 * h + k] : 0.0f;
              const float xh = __fmul_rn(hx[k] - tab[2 * BOTTLENECK + c + k],
                                         tab[3 * BOTTLENECK + c + k]);
              sd[j][k] += d[k];
              sx[j][k] += d[k] * xh;
            }
            *reinterpret_cast<float2*>(du2 + p * BOTTLENECK + c) = make_float2(d[0], d[1]);
          }
        }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int x = 4; x < 32; x <<= 1) {
            sd[j][k] += __shfl_xor_sync(0xffffffffu, sd[j][k], x);
            sx[j][k] += __shfl_xor_sync(0xffffffffu, sx[j][k], x);
          }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = half * 64 + j * 8 + 2 * t;
          *reinterpret_cast<float2*>(red + (pg * 2) * BOTTLENECK + c) = make_float2(sd[j][0], sd[j][1]);
          *reinterpret_cast<float2*>(red + (pg * 2 + 1) * BOTTLENECK + c) =
              make_float2(sx[j][0], sx[j][1]);
        }
      }
    }
    __syncthreads();
    {  // the tile's partials: the tasks' sums in pixel-group order
      const int s = tid >> 7, c = tid & (BOTTLENECK - 1);
      float v = 0.0f;
      for (int pg = 0; pg < npg; ++pg) v += red[(pg * 2 + s) * BOTTLENECK + c];
      part[((size_t)tile * 2 + s) * BOTTLENECK + c] = v;
    }
    __syncthreads();
  }
  smg::cp_async_wait<0>();
}

// BN2 backward's second half, one image per blockIdx.y: the per-tile
// partials of dy2_kernel summed in tile order into sums2 (2, N, 128), then
// dh1 = bf16(a2 (du2 - sum du2 / n - xhat2 sum(du2 xhat2) / n)).
__global__ void __launch_bounds__(256)
dh1_kernel(const float* __restrict__ du2, const bf16* __restrict__ h1,
           const float* __restrict__ aff2, const float* __restrict__ mean2,
           const float* __restrict__ part, int tiles_per_img, float* __restrict__ sums2,
           bf16* __restrict__ dh1, int N, int HW) {
  __shared__ float mu[2][BOTTLENECK];
  const int tid = threadIdx.x, n = blockIdx.y;
  {
    const int s = tid >> 7, c = tid & (BOTTLENECK - 1);
    float v = 0.0f;
    for (int t = 0; t < tiles_per_img; ++t)
      v += part[(((size_t)n * tiles_per_img + t) * 2 + s) * BOTTLENECK + c];
    if (blockIdx.x == 0) sums2[((size_t)s * N + n) * BOTTLENECK + c] = v;
    mu[s][c] = v / (float)HW;
  }
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + tid;
  const int pl = e >> 4, c8 = (e & 15) * 8;
  if (pl >= HW) return;
  const size_t p = (size_t)n * HW + pl;
  const size_t NC = (size_t)N * BOTTLENECK;
  const size_t o = (size_t)n * BOTTLENECK + c8;
  const float* d = du2 + p * BOTTLENECK + c8;
  const float4 dlo = *reinterpret_cast<const float4*>(d);
  const float4 dhi = *reinterpret_cast<const float4*>(d + 4);
  const float dv[8] = {dlo.x, dlo.y, dlo.z, dlo.w, dhi.x, dhi.y, dhi.z, dhi.w};
  float hv[8], out[8];
  smg::unpack8(*reinterpret_cast<const uint4*>(h1 + p * BOTTLENECK + c8), hv);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float xh = __fmul_rn(hv[c] - mean2[o + c], aff2[2 * NC + o + c]);
    out[c] = aff2[o + c] * (dv[c] - mu[0][c8 + c] - xh * mu[1][c8 + c]);
  }
  *reinterpret_cast<uint4*>(dh1 + p * BOTTLENECK + c8) = smg::pack8(out);
}

// dw2[tap] = y2^T shift_tap(dout), y2 = bf16(relu(h1 a2 + b2)): one f32
// partial (9, 128, 32) per persistent block into part, the caller sums
// them in block order. Per tile: the dout halo patch and the tile's h1
// rows (transformed to y2 in place) double-buffered by cp.async, and the
// patch pixel of each tile pixel (qtab). Nine warps, warp w tap w's whole
// 128 x 32 gradient: per 16-pixel step it reads its tap's shifted dout rows
// once (ldmatrix.trans, B) and the eight 16-channel blocks of y2^T
// (ldmatrix.trans, A), 32 MMAs; per SM 90 ldmatrix against 288 MMAs.
constexpr int DW_THREADS = 9 * 32;

__global__ void __launch_bounds__(DW_THREADS, 1)
dw2_kernel(const bf16* __restrict__ dc, const bf16* __restrict__ h1,
           const float* __restrict__ aff2, float* __restrict__ part, int N, int H, int W,
           TilePlan pl) {
  extern __shared__ __align__(128) unsigned char wsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TileGeom tg(pl, N, H, W);
  const int mmax = pl.rows * pl.cols;
  const int patch_bytes = tg.patch_px * DOUT_PX_BYTES;
  const int buf_bytes = patch_bytes + mmax * 256 + ((mmax * 4 + 15) & ~15);
  unsigned char* zero = wsm + 2 * buf_bytes;                 // one 256-byte row of zeros
  float* tab = reinterpret_cast<float*>(zero + 256);         // a2, b2 of the tile's image
  auto patch = [&](int b) { return wsm + b * buf_bytes; };
  auto y2s = [&](int b) { return wsm + b * buf_bytes + patch_bytes; };
  auto qtab = [&](int b) {
    return reinterpret_cast<int*>(wsm + b * buf_bytes + patch_bytes + mmax * 256);
  };
  if (tid < 16) reinterpret_cast<uint4*>(zero)[tid] = make_uint4(0, 0, 0, 0);

  // The tile's h1 rows (16 chunks a pixel) and its patch pixel table.
  auto stage = [&](int tile, int b) {
    stage_dout_patch(dc, smem_addr(patch(b)), pl, tg, tile, H, W, tid, DW_THREADS);
    int n, y0, x0;
    tg.origin(pl, tile, n, y0, x0);
    const int tw = min(pl.cols, W - x0);
    const int M = min(pl.rows, H - y0) * tw;
    const int c = tid & 15;
    int m = tid >> 4;
    int yy = m / tw, xx = m - yy * tw;
    const uint32_t ybase = smem_addr(y2s(b));
    int* qt = qtab(b);
    for (; m < M; m += DW_THREADS / 16) {
      const size_t p = ((size_t)n * H + y0 + yy) * W + x0 + xx;
      cp_async16(ybase + m * 256 + ((c ^ (m & 7)) << 4), h1 + p * BOTTLENECK + c * 8, true);
      if (c == 0) qt[m] = (yy + 1) * tg.pw + xx + 1;
      xx += DW_THREADS / 16;
      while (xx >= tw) {
        xx -= tw;
        ++yy;
      }
    }
  };

  float acc[8][4][4];
#pragma unroll
  for (int mb = 0; mb < 8; ++mb)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][j][q] = 0.0f;

  if (blockIdx.x < tg.n_tiles) stage(blockIdx.x, 0);
  smg::cp_async_commit();
  const int tap = warp;
  const int li = lane >> 3;
  const int NC = N * BOTTLENECK;
  int buf = 0;
  for (int tile = blockIdx.x; tile < tg.n_tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < tg.n_tiles) stage(tile + gridDim.x, buf ^ 1);
    smg::cp_async_commit();
    int n, y0, x0;
    tg.origin(pl, tile, n, y0, x0);
    if (tid < BOTTLENECK) {
      tab[tid] = aff2[n * BOTTLENECK + tid];
      tab[BOTTLENECK + tid] = aff2[NC + n * BOTTLENECK + tid];
    }
    smg::cp_async_wait<1>();
    __syncthreads();
    const int M = min(pl.rows, H - y0) * min(pl.cols, W - x0);
    unsigned char* ys = y2s(buf);
    for (int e = tid; e < M * 16; e += DW_THREADS) {   // h1 -> y2 in place
      const int m = e >> 4, c = e & 15;
      uint4* v = reinterpret_cast<uint4*>(ys + m * 256 + ((c ^ (m & 7)) << 4));
      float hv[8];
      smg::unpack8(*v, hv);
#pragma unroll
      for (int k = 0; k < 8; ++k) hv[k] = smg::bn_relu(hv[k], tab[c * 8 + k], tab[BOTTLENECK + c * 8 + k]);
      *v = smg::pack8(hv);
    }
    __syncthreads();
    const uint32_t yb = smem_addr(ys), zb = smem_addr(zero), pb = smem_addr(patch(buf));
    const int* qt = qtab(buf);
    const int off = (1 - tap / 3) * tg.pw + (1 - tap % 3);
    for (int k0 = 0; k0 < M; k0 += 16) {
      uint32_t bfr[2][4];
      {
        const int q = qt[min(k0 + (lane & 7) + ((li & 1) << 3), M - 1)] + off;
#pragma unroll
        for (int oh = 0; oh < 2; ++oh) ldmatrix_x4_trans(pb + dout_off(q, oh * 2 + (li >> 1)), bfr[oh]);
      }
      const int px = k0 + (lane & 7) + ((li >> 1) << 3);
      const uint32_t arow = px < M ? yb + px * 256 : zb;
      const int asw = px < M ? (px & 7) : 0;
#pragma unroll
      for (int mb = 0; mb < 8; ++mb) {
        uint32_t af[4];
        const int ch = mb * 2 + (li & 1);
        ldmatrix_x4_trans(arow + ((ch ^ asw) << 4), af);
#pragma unroll
        for (int oh = 0; oh < 2; ++oh) {
          mma_16816(acc[mb][2 * oh], af, bfr[oh][0], bfr[oh][1]);
          mma_16816(acc[mb][2 * oh + 1], af, bfr[oh][2], bfr[oh][3]);
        }
      }
    }
    __syncthreads();
  }
  smg::cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
  float* out = part + (size_t)blockIdx.x * 9 * BOTTLENECK * GROWTH;
#pragma unroll
  for (int mb = 0; mb < 8; ++mb)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = mb * 16 + g + 8 * h, o = j * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (tap * BOTTLENECK + c) * GROWTH + o) =
            make_float2(acc[mb][j][2 * h], acc[mb][j][2 * h + 1]);
      }
}

// dw1 = y1^T dh1 over the pixels [s chunk, (s + 1) chunk) of split s =
// blockIdx.y, for channels 128 blockIdx.x .. + 128 of the prefix: part
// (splits, C_in, 128), summed in split order by the caller. A 3-stage
// cp.async ring of 64-pixel stages (raw x and dh1 rows, 256 B each,
// swizzled), norm1 + ReLU applied to the staged x once, the image of each
// staged row advanced incrementally. Warps of 32 channels x 64 columns.
constexpr int W1_BK = 64;
constexpr int W1_STAGES = 3;
constexpr int W1_STAGE_BYTES = 2 * W1_BK * 256;

__global__ void __launch_bounds__(256)
dw1_kernel(const bf16* __restrict__ x, int ld, int C, const float* __restrict__ aff1,
           const bf16* __restrict__ dh1, float* __restrict__ part, int N, int HW, int P,
           int chunk) {
  extern __shared__ __align__(128) unsigned char w1sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * 128;
  const int pb = blockIdx.y * chunk;
  const int pe = min(P, pb + chunk);
  const int KT = (pe - pb + W1_BK - 1) / W1_BK;
  const int NC = N * C;
  // This thread's four staged chunks: rows r0 + 16 i, column chunk cc; the
  // image of each row and where the next image starts.
  const int r0 = tid >> 4, cc = tid & 15;
  int img[4], next[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    img[i] = (pb + r0 + 16 * i) / HW;
    next[i] = (img[i] + 1) * HW;
  }
  auto load = [&](int kt, int s) {
    const uint32_t xs = smem_addr(w1sm + s * W1_STAGE_BYTES);
    const uint32_t ds = xs + W1_BK * 256;
    const int p0 = pb + kt * W1_BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * i, p = p0 + r;
      const int so = r * 256 + ((cc ^ (r & 7)) << 4);
      const bool okx = p < pe && c0 + cc * 8 < C;
      cp_async16(xs + so, okx ? x + (size_t)p * ld + c0 + cc * 8 : x, okx);
      cp_async16(ds + so, p < pe ? dh1 + (size_t)p * BOTTLENECK + cc * 8 : dh1, p < pe);
    }
  };
  float acc[2][8][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.0f;
#pragma unroll
  for (int s = 0; s < W1_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    smg::cp_async_commit();
  }
  const int wm = warp >> 1, wn = warp & 1;
  const int li = lane >> 3;
  for (int kt = 0; kt < KT; ++kt) {
    smg::cp_async_wait<W1_STAGES - 2>();
    __syncthreads();
    const int nk = kt + W1_STAGES - 1;
    if (nk < KT) load(nk, nk % W1_STAGES);
    smg::cp_async_commit();
    unsigned char* xs = w1sm + (kt % W1_STAGES) * W1_STAGE_BYTES;
    const int p0 = pb + kt * W1_BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // y1 = bf16(relu(x a1 + b1)) in place
      const int r = r0 + 16 * i, p = p0 + r;
      while (p >= next[i]) {
        ++img[i];
        next[i] += HW;
      }
      if (p < pe && c0 + cc * 8 < C) {
        uint4* v = reinterpret_cast<uint4*>(xs + r * 256 + ((cc ^ (r & 7)) << 4));
        const float* a = aff1 + (size_t)img[i] * C + c0 + cc * 8;
        float xv[8];
        smg::unpack8(*v, xv);
#pragma unroll
        for (int k = 0; k < 8; ++k) xv[k] = smg::bn_relu(xv[k], a[k], a[NC + k]);
        *v = smg::pack8(xv);
      }
    }
    __syncthreads();
    const uint32_t xb = smem_addr(xs), db = xb + W1_BK * 256;
#pragma unroll
    for (int kk = 0; kk < W1_BK; kk += 16) {
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int px = kk + (lane & 7) + ((li >> 1) << 3);
        const int ch = ((wm * 32 + f * 16) >> 3) + (li & 1);
        ldmatrix_x4_trans(xb + px * 256 + ((ch ^ (px & 7)) << 4), af[f]);
      }
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn * 8 + n2 * 2 + (lane >> 4);
        ldmatrix_x4_trans(db + r * 256 + ((c ^ (r & 7)) << 4), bfr[n2]);
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
  smg::cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
  float* out = part + (size_t)blockIdx.y * C * BOTTLENECK;
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm * 32 + f * 16 + g + 8 * h;
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(out + (size_t)c * BOTTLENECK + wn * 64 + j * 8 + 2 * t) =
            make_float2(acc[f][j][2 * h], acc[f][j][2 * h + 1]);
    }
}

// dy1 = dh1 w1^T on a tile of TR <= 128 pixels (blockIdx.x; rows TR..127
// of the 128-row MMA tile read zeros and are not stored) x 128 prefix
// channels (blockIdx.y), K = 128, staged in two cp.async groups of 64 (the
// second with the tile's x), w1 read in its stored (C_in, 128) layout as
// the column-major B. du1 = [x a1 + b1 > 0] dy1. A tile spans at most S
// images (ops/dense_layer_train.py::image_plan).
//   Pass 1: du1 and du1 xhat1 summed per (tile, image, channel) in row
//   order into part (tiles, S, 2, C_in) (du1 goes through shared memory).
//   Pass 2: dx = a1 (du1 - sum du1 / n - xhat1 sum(du1 xhat1) / n) from
//   sums (2, N, C_in); dbuf[p, c] += bf16(dx).
// The per-(image, channel) a1, b1, m1, r1 (and the two means) of the
// tile's images are staged in shared memory once per tile.
constexpr int DY_BM = 128;
constexpr int DY_TILE_BYTES = DY_BM * 256;                   // 32 KB: 128 rows of 128 bf16
constexpr int DY_TAB = 6;                                    // a, b, m, r, mean du, mean du xh

template <int S>
constexpr int dy_smem() {
  return 3 * DY_TILE_BYTES + DY_TAB * S * 128 * 4;
}

template <bool PASS2, int S>
__global__ void __launch_bounds__(256, 2)
dy1_kernel(const bf16* __restrict__ dh1, const bf16* __restrict__ w1,
           const bf16* __restrict__ x, int ld, int C, const float* __restrict__ aff1,
           const float* __restrict__ mean1, int ldm, const float* __restrict__ sums,
           float* __restrict__ part, float* __restrict__ dbuf, int N, int HW, int P, int TR) {
  extern __shared__ __align__(128) unsigned char ysm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * TR;
  const int c0 = blockIdx.y * 128;
  const uint32_t ds = smem_addr(ysm), ws = ds + DY_TILE_BYTES, xsa = ws + DY_TILE_BYTES;
  const unsigned char* xs = ysm + 2 * DY_TILE_BYTES;
  float* tab = reinterpret_cast<float*>(ysm + 3 * DY_TILE_BYTES);   // [k][slot][128]
  const int rows = min(TR, P - m0);
  const int n_lo = m0 / HW;
  const int n_hi = min(N - 1, (m0 + rows - 1) / HW);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    for (int e = tid; e < DY_BM * 8; e += 256) {
      const int r = e >> 3, c = half * 8 + (e & 7);
      const int so = r * 256 + ((c ^ (r & 7)) << 4);
      const bool okd = r < rows;
      cp_async16(ds + so, okd ? dh1 + (size_t)(m0 + r) * BOTTLENECK + c * 8 : dh1, okd);
      const bool okw = c0 + r < C;
      cp_async16(ws + so, okw ? w1 + (size_t)(c0 + r) * BOTTLENECK + c * 8 : w1, okw);
    }
    if (half == 1) {
      for (int e = tid; e < DY_BM * 16; e += 256) {
        const int r = e >> 4, c = e & 15;
        const bool ok = r < rows && c0 + c * 8 < C;
        cp_async16(xsa + r * 256 + ((c ^ (r & 7)) << 4),
                   ok ? x + (size_t)(m0 + r) * ld + c0 + c * 8 : x, ok);
      }
    }
    smg::cp_async_commit();
  }
  {
    const int NC = N * C;
    for (int e = tid; e < S * 128; e += 256) {
      const int j = e >> 7, cl = e & 127, n = n_lo + j, c = c0 + cl;
      float v[DY_TAB] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (n <= n_hi && c < C) {
        const size_t o = (size_t)n * C + c;
        v[0] = aff1[o];
        v[1] = aff1[NC + o];
        v[2] = mean1[(size_t)n * ldm + c];
        v[3] = aff1[2 * NC + o];
        if (PASS2) {
          v[4] = sums[o] / (float)HW;
          v[5] = sums[NC + o] / (float)HW;
        }
      }
#pragma unroll
      for (int k = 0; k < DY_TAB; ++k) tab[(k * S + j) * 128 + cl] = v[k];
    }
  }
  float acc[2][8][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][j][q] = 0.0f;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half == 0) {
      smg::cp_async_wait<1>();
    } else {
      smg::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = half * 64; kk < half * 64 + 64; kk += 16) {
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int r = wm * 32 + f * 16 + (lane & 15);
        const int c = (kk >> 3) + (lane >> 4);
        ldmatrix_x4(ds + r * 256 + ((c ^ (r & 7)) << 4), af[f]);
      }
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        const int r = wn * 64 + n2 * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = (kk >> 3) + ((lane >> 3) & 1);
        ldmatrix_x4(ws + r * 256 + ((c ^ (r & 7)) << 4), bfr[n2]);
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
  const int g = lane >> 2, t = lane & 3;
  float* dus = reinterpret_cast<float*>(ysm);   // pass 1: du1 (128 x 128 f32) over dh1 and w1
  if (!PASS2) __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    // Pass 2 reads this fragment's 16 cotangent pairs first, all in flight
    // together, then adds and stores.
    float2 old[2][8];
    if (PASS2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * 32 + f * 16 + g + 8 * h;
        const int p = m0 + rl;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int cl = wn * 64 + jj * 8 + 2 * t;
          old[h][jj] = rl < rows && c0 + cl < C
                           ? *reinterpret_cast<const float2*>(dbuf + (size_t)p * ld + c0 + cl)
                           : make_float2(0.0f, 0.0f);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 32 + f * 16 + g + 8 * h;
      const int p = m0 + rl;
      const int j = rl < rows ? p / HW - n_lo : 0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int cl = wn * 64 + jj * 8 + 2 * t;
        const bool ok = rl < rows && c0 + cl < C;
        const float2 xv = ld_bf2(reinterpret_cast<const bf16*>(
            xs + rl * 256 + (((cl >> 3) ^ (rl & 7)) << 4) + (cl & 7) * 2));
        const float xx[2] = {xv.x, xv.y};
        float d[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float* tb = tab + j * 128 + cl + k;
          const float u1 = smg::affine(xx[k], tb[0], tb[S * 128]);
          d[k] = ok && u1 > 0.0f ? acc[f][jj][2 * h + k] : 0.0f;
        }
        if (!PASS2) {
          *reinterpret_cast<float2*>(dus + rl * 128 + (cl ^ ((rl & 7) << 3))) =
              make_float2(d[0], d[1]);
        } else if (ok) {
          float dx[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float* tb = tab + j * 128 + cl + k;
            const float xh = __fmul_rn(xx[k] - tb[2 * S * 128], tb[3 * S * 128]);
            dx[k] = smg::round_bf16(tb[0] * (d[k] - tb[4 * S * 128] - xh * tb[5 * S * 128]));
          }
          *reinterpret_cast<float2*>(dbuf + (size_t)p * ld + c0 + cl) =
              make_float2(old[h][jj].x + dx[0], old[h][jj].y + dx[1]);
        }
      }
    }
  }
  if (PASS2) return;
  __syncthreads();
  // Column sums in row order, one partial per image the tile covers: the
  // rows of each image a run of its own.
  const int s = tid >> 7, cl = tid & 127, c = c0 + cl;
  if (c >= C) return;
  float* out = part + (size_t)blockIdx.x * S * 2 * C + s * C + c;
  const unsigned char* xcol = xs + (cl & 7) * 2;
  for (int j = 0, r0 = 0; r0 < rows; ++j) {
    const int r1 = min(rows, (n_lo + j + 1) * HW - m0);
    const float* tb = tab + j * 128 + cl;
    const float m = tb[2 * S * 128], rs = tb[3 * S * 128];
    float v = 0.0f;
#pragma unroll 8
    for (int r = r0; r < r1; ++r) {
      const float d = dus[r * 128 + (cl ^ ((r & 7) << 3))];
      if (s == 0) {
        v += d;
      } else {
        const float xv = __bfloat162float(
            *reinterpret_cast<const bf16*>(xcol + r * 256 + (((cl >> 3) ^ (r & 7)) << 4)));
        v += d * __fmul_rn(xv - m, rs);
      }
    }
    out[j * 2 * C] = v;
    r0 = r1;
  }
}

// sums (2, N, C): pass 1's partials of image n (blockIdx.x) summed in tile
// order; tile t covers pixels [TR t, TR t + TR), image n is its slot
// n - (TR t) / HW of S.
__global__ void reduce_dy1_kernel(const float* __restrict__ part, float* __restrict__ sums,
                                  int N, int HW, int C, int TR, int S) {
  const int n = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= 2 * C) return;
  const int s = e / C, c = e - s * C;
  const int t_lo = n * HW / TR, t_hi = ((n + 1) * HW - 1) / TR;
  float v = 0.0f;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int j = n - t * TR / HW;
    v += part[(((size_t)t * S + j) * 2 + s) * C + c];
  }
  sums[((size_t)s * N + n) * C + c] = v;
}

// The layer's gradients from the partials, each summed in a fixed order,
// into out = [dw1 (C, 128) | dw2 (9, 128, 32) | dscale1, dbias1 (C) |
// dscale2, dbias2 (128)]: dw1 over the splits, dw2 over the blocks, the BN
// parameters' over the images of sums1 (2, N, C) and sums2 (2, N, 128).
constexpr int W2_ELEMS = 9 * BOTTLENECK * GROWTH;

__global__ void finish_kernel(const float* __restrict__ part_w1, int splits,
                              const float* __restrict__ part_w2, int blocks,
                              const float* __restrict__ sums1, const float* __restrict__ sums2,
                              float* __restrict__ out, int N, int C) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n1 = C * BOTTLENECK;
  float v = 0.0f;
  // Unrolled: the loads of many partials in flight, the sums in order.
  if (i < n1) {
#pragma unroll 16
    for (int s = 0; s < splits; ++s) v += part_w1[(size_t)s * n1 + i];
  } else if (i < n1 + W2_ELEMS) {
    const int j = i - n1;
#pragma unroll 16
    for (int b = 0; b < blocks; ++b) v += part_w2[(size_t)b * W2_ELEMS + j];
  } else if (i < n1 + W2_ELEMS + 2 * C + 2 * BOTTLENECK) {
    int j = i - n1 - W2_ELEMS;
    const float* sums = sums1;
    int c_n = C;
    if (j >= 2 * C) {
      j -= 2 * C;
      sums = sums2;
      c_n = BOTTLENECK;
    }
    // dscale = sum of du xhat (row 1), dbias = sum of du (row 0)
    const int which = j / c_n, c = j - which * c_n;
    const float* src = sums + (size_t)(1 - which) * N * c_n + c;
    for (int n = 0; n < N; ++n) v += src[(size_t)n * c_n];
  } else {
    return;
  }
  out[i] = v;
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// BN1's backward (steps 7-9): dy1 pass 1, the reduction of its partials,
// dy1 pass 2, on tiles of TR pixels with S image slots.
template <int S>
void dy1_passes(const bf16* dh1, const bf16* w1, const bf16* x, int ld, int C,
                const float* aff1, const float* mean1, int ldm, float* part, float* sums,
                float* dbuf, int N, int HW, int P, int TR, cudaStream_t stream) {
  const dim3 tiles(cdiv(P, TR), cdiv(C, 128));
  dy1_kernel<false, S><<<tiles, 256, dy_smem<S>(), stream>>>(dh1, w1, x, ld, C, aff1, mean1, ldm,
                                                              nullptr, part, nullptr, N, HW, P, TR);
  reduce_dy1_kernel<<<dim3(N, cdiv(2 * C, 256)), 256, 0, stream>>>(part, sums, N, HW, C, TR, S);
  dy1_kernel<true, S><<<tiles, 256, dy_smem<S>(), stream>>>(dh1, w1, x, ld, C, aff1, mean1, ldm,
                                                             sums, nullptr, dbuf, N, HW, P, TR);
}

}  // namespace

// K6a. buf (P, ld) bf16: reads [0, C_in), writes [C_in, C_in + 32).
// w1 (C_in, 128), w2 (9, 128, 32) bf16; s*, bi* f32. mom (2, N, ldm): the
// block's per-image mean and var, channels [0, c_known) already there; this
// call adds [c_known, C_in). Outputs h1 (P, 128) bf16 and st2 (4, N, 128)
// f32: mean2, var2, a2, b2; h1_part (N, h1_splits, 2, 128) is scratch.
// gemm_bm, gemm_slots: the GEMM's tile rows and its image slots (4, 16 or
// 64; ops/dense_layer_train.py::image_plan); h1_splits, h1_chunk: the h1
// moments' pixel chunks; c3_*: the 3x3's tile plan
// (ops/conv2.py::conv3x3_plan).
extern "C" int smg_dense_layer_train_fwd(bf16* buf, const bf16* w1, const float* s1,
                                         const float* bi1, const bf16* w2,
                                         const float* s2, const float* bi2, bf16* h1,
                                         float* mom, float* st2, float* h1_part, int N,
                                         int H, int W, int ld, int c_in, int ldm, int c_known,
                                         int gemm_bm, int gemm_slots, int h1_splits, int h1_chunk,
                                         int c3_images, int c3_rows, int c3_cols, int c3_grid,
                                         int c3_smem, cudaStream_t stream) {
  const int HW = H * W, P = N * HW;
  if (P == 0) return (int)cudaGetLastError();
  float* mean1 = mom;
  float* var1 = mom + (size_t)N * ldm;
  if (c_known < c_in)
    moments_kernel<<<dim3(N, (c_in - c_known) / RED_C), dim3(RED_C, RED_R), 0, stream>>>(
        buf, ld, c_known, HW, mean1, var1, ldm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto gemm = [&](auto aff) {
    return smg::gemm_affine(gemm_bm, buf, ld, aff, w1, P, c_in, H1Epilogue{h1}, stream);
  };
  if (gemm_slots == 4) {
    err = gemm(ImageAffine<4>{mean1, var1, ldm, s1, bi1, HW, N});
  } else if (gemm_slots == 16) {
    err = gemm(ImageAffine<16>{mean1, var1, ldm, s1, bi1, HW, N});
  } else if (gemm_slots == 64) {
    err = gemm(ImageAffine<64>{mean1, var1, ldm, s1, bi1, HW, N});
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const size_t nc2 = (size_t)N * BOTTLENECK;
  h1_sums_kernel<<<dim3(N, h1_splits), 256, 0, stream>>>(h1, HW, h1_chunk, h1_part);
  h1_moments_kernel<<<cdiv(N * BOTTLENECK, 256), 256, 0, stream>>>(h1_part, h1_splits, HW, s2,
                                                                    bi2, st2, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const smg::Conv3x3Plan plan{c3_images, c3_rows, c3_cols, c3_grid, c3_smem};
  return (int)smg::conv3x3(Y2Rows{h1, st2 + 2 * nc2, st2 + 3 * nc2, HW}, w2, buf, N, H, W, ld,
                           c_in, plan, stream);
}

// K6b. dbuf (P, ld) f32: reads the layer's cotangent [C_in, C_in + 32) and
// adds bf16(dx) to [0, C_in). w1 (C_in, 128), w2 (9, 128, 32) bf16 in
// their stored layouts; mean1/var1 (N, ldm1), mean2/var2 (N, 128).
// Scratch: aff1 (3, N, C_in), aff2 (3, N, 128), dc (P, 32) bf16, du2
// (P, 128) f32, dh1 (P, 128) bf16, part_dy2 (dg tiles, 2, 128), part_dy1
// (cdiv(P, dy1_rows), dy1_slots, 2, C_in), sums1 (2, N, C_in) and sums2 (2, N, 128)
// (per-image sum du, sum du xhat), part_w1 (w1_splits, C_in, 128) and
// part_w2 (dw_grid, 9, 128, 32) (the weight gradients' partials). Output:
// grads, finish_kernel's [dw1 | dw2 | dscale1 | dbias1 | dscale2 | dbias2].
// dg_*: the transposed 3x3's tile plan, dw_*: dw2's, dy1_rows, dy1_slots:
// dy1's pixels per tile and image slots (4 or 16)
// (ops/dense_layer_train.py).
extern "C" int smg_dense_layer_train_bwd(
    const bf16* buf, float* dbuf, const bf16* h1, const bf16* w1, const bf16* w2,
    const float* s1, const float* bi1, const float* mean1, const float* var1, int ldm1,
    const float* s2, const float* bi2, const float* mean2, const float* var2, float* aff1,
    float* aff2, bf16* dc, float* du2, bf16* dh1, float* part_dy2, float* part_dy1,
    float* sums1, float* sums2, float* part_w1, float* part_w2, float* grads, int N, int H,
    int W, int ld,
    int c_in, int dg_rows, int dg_cols, int dg_grid, int dg_smem, int dw_rows, int dw_cols,
    int dw_grid, int dw_smem, int w1_splits, int w1_chunk, int dy1_rows, int dy1_slots,
    cudaStream_t stream) {
  const int HW = H * W, P = N * HW;
  if ((dy1_slots != 4 && dy1_slots != 16) || dy1_rows < 1 || dy1_rows > DY_BM)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
  static const cudaError_t set = [] {
    cudaError_t e = allow_smem(dy2_kernel, smg::C3_SMEM_MAX);
    if (e == cudaSuccess) e = allow_smem(dw2_kernel, smg::C3_SMEM_MAX);
    if (e == cudaSuccess) e = allow_smem(dw1_kernel, W1_STAGES * W1_STAGE_BYTES);
    if (e == cudaSuccess) e = allow_smem(dy1_kernel<false, 4>, dy_smem<4>());
    if (e == cudaSuccess) e = allow_smem(dy1_kernel<true, 4>, dy_smem<4>());
    if (e == cudaSuccess) e = allow_smem(dy1_kernel<false, 16>, dy_smem<16>());
    if (e == cudaSuccess) e = allow_smem(dy1_kernel<true, 16>, dy_smem<16>());
    return e;
  }();
  if (set != cudaSuccess) return (int)set;
  const int nc_all = N * (c_in + BOTTLENECK);
  affine_kernel<<<cdiv(nc_all, 256), 256, 0, stream>>>(mean1, var1, ldm1, s1, bi1, mean2, var2,
                                                        s2, bi2, aff1, aff2, N, c_in);
  compact_dout_kernel<<<cdiv(P * 4, 256), 256, 0, stream>>>(dbuf, ld, c_in, P, dc);
  const TilePlan dg{dg_rows, dg_cols, dg_grid, dg_smem};
  dy2_kernel<<<dg_grid, DG_THREADS, dg_smem, stream>>>(dc, w2, h1, aff2, mean2, du2, part_dy2, N,
                                                        H, W, dg);
  const int dg_per_img = cdiv(H, dg_rows) * cdiv(W, dg_cols);
  dh1_kernel<<<dim3(cdiv(HW * 16, 256), N), 256, 0, stream>>>(du2, h1, aff2, mean2, part_dy2,
                                                              dg_per_img, sums2, dh1, N, HW);
  const TilePlan dw{dw_rows, dw_cols, dw_grid, dw_smem};
  dw2_kernel<<<dw_grid, DW_THREADS, dw_smem, stream>>>(dc, h1, aff2, part_w2, N, H, W, dw);
  dw1_kernel<<<dim3(cdiv(c_in, 128), w1_splits), 256, W1_STAGES * W1_STAGE_BYTES, stream>>>(
      buf, ld, c_in, aff1, dh1, part_w1, N, HW, P, w1_chunk);
  if (dy1_slots == 4) {
    dy1_passes<4>(dh1, w1, buf, ld, c_in, aff1, mean1, ldm1, part_dy1, sums1, dbuf, N, HW, P,
                  dy1_rows, stream);
  } else {
    dy1_passes<16>(dh1, w1, buf, ld, c_in, aff1, mean1, ldm1, part_dy1, sums1, dbuf, N, HW, P,
                   dy1_rows, stream);
  }
  const int n_grads = c_in * BOTTLENECK + W2_ELEMS + 2 * c_in + 2 * BOTTLENECK;
  finish_kernel<<<cdiv(n_grads, 256), 256, 0, stream>>>(part_w1, w1_splits, part_w2, dw_grid,
                                                        sums1, sums2, grads, N, c_in);
  return (int)cudaGetLastError();
}
