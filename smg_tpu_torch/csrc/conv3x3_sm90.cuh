// The dense layer's 3x3 / pad-1 convolution 128 -> 32 on wgmma, from a bf16
// h2 patch in shared memory: the tensor work of K5 (conv2.cu) and of K7's
// fused layer kernel (dense_block.cu). common.cuh's conv3x3_kernel, on
// mma.sync, stays K2's and K6a's.
//
// Both kernels run 384 threads: warpgroup 0 produces (K5: stages the raw h1
// patch and applies BN2 + ReLU; K7: streams the bottleneck GEMM's operands),
// warpgroups 1 and 2 do the tensor work. A tile is `images` whole images or
// `rows` x `cols` of one image (the plan, ops/conv2.py::conv2_plan and
// ops/dense_block.py::dense_plan); its h2 patch is the tile and one pixel
// all round, (rows + 2) x (cols + 2) per image, pixel q at q * 256 bytes,
// 16-byte chunk c at c ^ (q & 7), exact zeros off the image.
//
// A task is 64 output pixels of a tile, one warpgroup's wgmma m64n32k16:
//   - A from registers: each warp's 16 pixel rows are read by ldmatrix from
//     the tap-shifted patch rows (any pixel offset, which no shared-memory
//     descriptor can address);
//   - B the 9 x 128 x 32 tap weights, resident for the kernel's life, in
//     wgmma's N-major layout with the 64-byte swizzle (tap t's input channel
//     k is row 128 t + k of 64 bytes, chunk j at j ^ ((row >> 1) & 3)), read
//     through a descriptor;
//   - with RoundTaps each tap has its own accumulator; two alternate, so
//     that tap t + 1's eight wgmmas run while tap t waits, is rounded to
//     bf16 and added to the f32 total (taps in order 0..8); without it the
//     nine taps go into one accumulator (K7's taps_packed = False).
// The two warpgroups take a tile's tasks in turn.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace smg {

constexpr int C3W_THREADS = 384;
constexpr int C3W_PRODUCERS = 128;       // warpgroup 0
constexpr int C3W_CONSUMERS = 256;       // warpgroups 1 and 2
constexpr int C3W_TASK = 64;             // output pixels per warpgroup task
constexpr uint32_t C3W_LBO = 4096;       // N atoms' stride (one atom at N = 32)
constexpr uint32_t C3W_SBO = 512;        // 8 k-rows of 64 bytes

// The tap weights into shared memory by the consumer warpgroups (cp.async;
// the caller commits and waits), ctid their thread index 0..255.
__device__ __forceinline__ void c3w_load_weights(unsigned char* wsm, const bf16* w2, int ctid) {
  for (int e = ctid; e < 9 * C3_CIN * 4; e += C3W_CONSUMERS) {
    const int r = e >> 2, c = e & 3;
    cp_async16(smem_addr(wsm + r * 64 + ((c ^ ((r >> 1) & 3)) << 4)), w2 + r * C3_COUT + c * 8,
               true);
  }
}

// A tile: its first image, row and column, and its extents.
struct C3wTile {
  int n0, y0, x0, gn, th, tw;
};

__device__ __forceinline__ int c3w_tile_count(const Conv3x3Plan& plan, int N, int H, int W) {
  return (N + plan.images - 1) / plan.images * ((H + plan.rows - 1) / plan.rows) *
         ((W + plan.cols - 1) / plan.cols);
}

__device__ __forceinline__ C3wTile c3w_tile(int tile, const Conv3x3Plan& plan, int N, int H,
                                            int W) {
  const int tiles_x = (W + plan.cols - 1) / plan.cols;
  const int tiles_y = (H + plan.rows - 1) / plan.rows;
  C3wTile t;
  t.n0 = tile / (tiles_x * tiles_y) * plan.images;
  t.y0 = (tile / tiles_x) % tiles_y * plan.rows;
  t.x0 = tile % tiles_x * plan.cols;
  t.gn = min(plan.images, N - t.n0);
  t.th = min(plan.rows, H - t.y0);
  t.tw = min(plan.cols, W - t.x0);
  return t;
}

// Walks patch pixels q, q + step, ... with their (image, row, column) in the
// patch, incrementally; src() is the pixel's index in the NHWC input, or -1
// off the image (and past the patch).
struct PatchWalk {
  int q, gi, py, px;
  int patch_px, pw, ph;
  __device__ PatchWalk(int q0, const Conv3x3Plan& plan)
      : q(q0), patch_px(plan.images * (plan.rows + 2) * (plan.cols + 2)), pw(plan.cols + 2),
        ph(plan.rows + 2) {
    gi = q0 / (ph * pw);
    const int r = q0 - gi * ph * pw;
    py = r / pw;
    px = r - py * pw;
  }
  __device__ void advance(int step) {
    q += step;
    px += step;
    while (px >= pw) {
      px -= pw;
      if (++py == ph) {
        py = 0;
        ++gi;
      }
    }
  }
  __device__ int src(const C3wTile& t, int N, int H, int W) const {
    const int n = t.n0 + gi, y = t.y0 + py - 1, x = t.x0 + px - 1;
    return (q < patch_px && n < N && y >= 0 && y < H && x >= 0 && x < W) ? (n * H + y) * W + x
                                                                          : -1;
  }
};

// One warpgroup's task: output pixels u .. u + 63 of tile t (rows past M
// repeat pixel M - 1 and are not stored) from the h2 patch at pbase, the
// weights at wbase; the f32 result in `total` (wgmma's accumulator layout).
template <bool RoundTaps>
__device__ __forceinline__ void c3w_task(uint32_t pbase, uint32_t wbase, const Conv3x3Plan& plan,
                                         const C3wTile& t, int u, int wq, int lane,
                                         float (&total)[16]) {
  const int pw = plan.cols + 2, img_px = (plan.rows + 2) * pw;
  const int per_img = t.th * t.tw, M = t.gn * per_img;
  const int m = min(u + 16 * wq + (lane & 15), M - 1);
  const int gi = m / per_img, r = m - gi * per_img, yy = r / t.tw;
  const int q0 = gi * img_px + (yy + 1) * pw + (r - yy * t.tw) + 1;
  const int hi = lane >> 4;
  const uint64_t desc0 = make_desc(wbase, C3W_LBO, C3W_SBO, SWIZZLE_64B);
  auto load_tap = [&](int tap, uint32_t(&a)[8][4]) {
    const int q = q0 + (tap / 3 - 1) * pw + (tap % 3 - 1);
    const uint32_t row = pbase + q * C3_PIXEL_BYTES;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) ldmatrix_x4(row + (((2 * ks + hi) ^ (q & 7)) << 4), a[ks]);
  };
  // Tap t's k-slice ks of B: rows 128 t + 16 ks .., 64 bytes each.
  auto mma_tap = [&](int tap, const uint32_t(&a)[8][4], float(&d)[16], bool accumulate) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_m64n32k16(d, a[ks], desc0 + (uint64_t)((tap * C3_CIN + ks * 16) * 64 >> 4),
                      (accumulate || ks > 0) ? 1 : 0);
  };
  uint32_t a[2][8][4];
  float acc[2][16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    total[i] = 0.0f;
    acc[0][i] = acc[1][i] = 0.0f;
  }
  load_tap(0, a[0]);
  wgmma_fence();
  mma_tap(0, a[0], acc[0], false);
  wgmma_commit();
#pragma unroll
  for (int tap = 1; tap < 9; ++tap) {
    load_tap(tap, a[tap & 1]);
    wgmma_fence();
    if constexpr (RoundTaps) {
      mma_tap(tap, a[tap & 1], acc[tap & 1], false);
    } else {
      mma_tap(tap, a[tap & 1], acc[0], true);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if constexpr (RoundTaps) {
      fence_acc(acc[(tap - 1) & 1]);
#pragma unroll
      for (int i = 0; i < 16; ++i) total[i] += round_bf16(acc[(tap - 1) & 1][i]);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
#pragma unroll
  for (int i = 0; i < 16; ++i) total[i] = RoundTaps ? total[i] + round_bf16(acc[0][i]) : acc[0][i];
}

// The task's 32 channels, rounded to bf16, at channel c_off of the NHWC
// buffer `out` with pixel stride ld (4-byte stores: a quad exchange that
// makes them 16-byte stores measured slower).
__device__ __forceinline__ void c3w_store(const float (&total)[16], bf16* out, const C3wTile& t,
                                          int u, int wq, int lane, int H, int W, int ld,
                                          int c_off) {
  const int per_img = t.th * t.tw, M = t.gn * per_img;
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = u + 16 * wq + g + 8 * half;
    if (m >= M) continue;
    const int gi = m / per_img, r = m - gi * per_img, yy = r / t.tw;
    const size_t p = ((size_t)(t.n0 + gi) * H + t.y0 + yy) * W + t.x0 + (r - yy * t.tw);
    bf16* o = out + p * ld + c_off + 2 * q4;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
      *reinterpret_cast<uint32_t*>(o + nb * 8) =
          pack2(total[4 * nb + 2 * half], total[4 * nb + 2 * half + 1]);
  }
}

}  // namespace smg
