// K5: a dense layer's second half — eval BN2, ReLU, 3x3 conv 128 -> 32 —
// on a bf16 bottleneck output h1 that lies in device memory.
//
// Replaces smg_tpu/ops/conv2_pallas.py::conv2_bn_relu and
// ::conv2_bn_relu_merge (Pallas _kernel, conv2_pallas.py:55-137), the
// conv2 of the `xla_pk` eval backend, whose bottleneck runs outside any
// kernel (fast_trunk.py:164-201). For P = N*H*W pixels:
//
//   h2  = bf16( relu(h1 a + b) )                       f32 affine
//   out = bf16( sum_tap bf16( sum_c h2[pixel + tap, c] w2[tap, c, :] ) )
//
// The 3x3 zero padding applies to h2 after the BN and ReLU, at every image
// edge (conv2_pallas.py:74-93): out-of-image taps contribute exactly 0,
// not relu(b). Each tap's partial is rounded to bf16 before the f32 tap
// sum, as the TPU kernel's packed-taps product is (conv2_pallas.py:109-117).
// The 32 channels land at channel offset c_off of an NHWC buffer with pixel
// stride ld: the merge variant's lane placement into a 128-lane group
// buffer (one-hot matmul and `pend` copy on the TPU) is a write at the
// layer's channel offset of the port's block buffer, whose other channels
// are left untouched. The TPU's row bands, halo side input, width padding
// and column rolls have no counterpart: a tile reads its shifted rows
// straight from device memory, masked at the image edges.
//
// What bounds it on the H100: per 104-image trunk pass the 58 calls read
// h1 (128 bf16 per pixel) and write 32 channels: ~1.12 GB at 224 (~0.34 ms
// at 3.35 TB/s) against 259 GFLOP (~0.26 ms at the bf16 tensor peak), and
// 8.2x both at 640: bytes, by a little, at both sizes. The mma.sync kernel
// it had (common.cuh's conv3x3_kernel with a BN2 source) ran at a tenth of
// that: BN2 + ReLU was an in-place pass over each staged patch between two
// block barriers, on every tile's critical path, and mma.sync caps the
// tensor rate at half. The design (conv3x3_sm90.cuh), a persistent grid of
// one 384-thread block per SM over the tiles of ops/conv2.py::conv2_plan:
//   - warpgroup 0 (the producer) stages tile i + 1's raw h1 halo patch by
//     cp.async into one of two patch buffers, all of it in flight at once
//     (four commit groups), writes zeros off the image, and applies BN2 +
//     ReLU to each in-image chunk once its group has landed, four chunks at
//     a time, with its 8 channels' (a, b) in registers. Each thread
//     transforms only what it staged itself, so no barrier separates the
//     loads from the affine pass, and the pass runs while the tensor cores
//     work on tile i. (A separate raw ring, tried first, held only 14 KB of
//     loads in flight per SM and made the producer the bottleneck; the
//     buffer the h2 ends in is the largest landing space there is.) An
//     mbarrier pair per buffer (full / empty) hands it over. cp.async, not
//     TMA: the patch is a gather of pixel rows whose zero fill is per pixel;
//   - warpgroups 1 and 2 compute tile i from the other buffer with wgmma
//     (64-pixel tasks, A from the tap-shifted patch rows in registers, B the
//     resident tap weights, loaded while the first patch is staged) and
//     write the 32 channels from the accumulators.
// Whole-image tiles (blocks 3-4 at 224) need no halo loads: their halo is
// the zero padding.

#include "conv3x3_sm90.cuh"

namespace {

using smg::bf16;

constexpr int BOTTLENECK = 128;
constexpr int K5_BATCHES = 4;   // commit groups a patch is staged in

__global__ void __launch_bounds__(smg::C3W_THREADS, 1)
conv2_wgmma_kernel(const bf16* __restrict__ h1, const float* __restrict__ a,
                   const float* __restrict__ b, const bf16* __restrict__ w2,
                   bf16* __restrict__ out, int N, int H, int W, int ld, smg::Conv3x3Plan plan) {
  extern __shared__ __align__(1024) unsigned char sm[];
  const int tid = threadIdx.x;
  const int patch_px = plan.images * (plan.rows + 2) * (plan.cols + 2);
  unsigned char* wsm = sm;
  unsigned char* h2s = sm + smg::C3_WEIGHT_BYTES;               // two patch buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(h2s + 2 * patch_px * smg::C3_PIXEL_BYTES);
  uint64_t* empty = full + 2;
  const int n_tiles = smg::c3w_tile_count(plan, N, H, W);

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      smg::mbar_init(&full[i], smg::C3W_PRODUCERS);
      smg::mbar_init(&empty[i], smg::C3W_CONSUMERS);
    }
    smg::fence_mbar_init();
  }
  __syncthreads();

  if (tid < smg::C3W_PRODUCERS) {
    // ---- warpgroup 0: h1 patch -> BN2 + ReLU -> h2 buffer i % 2 -----------
    // Thread tid owns chunk c16 (channels 8 c16 ..) of patch pixels
    // tid / 16, + 8, ...: one pass of the 128 threads covers 8 pixels. It
    // stages all of its in-image chunks of the patch by cp.async in
    // K5_BATCHES commit groups, writes zeros off the image, and transforms
    // each group in place once it has landed: a thread reads only what it
    // staged itself, so no barrier separates the loads from the affine pass,
    // and the whole patch's loads are in flight at once.
    const int c16 = tid & 15;
    float av[8], bv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      av[c] = a[c16 * 8 + c];
      bv[c] = b[c16 * 8 + c];
    }
    const int passes = (patch_px + 7) / 8;     // at most 64 (the plan's patch cap)
    const int per_batch = (passes + K5_BATCHES - 1) / K5_BATCHES;
    const int q0 = tid >> 4;
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int buf = i & 1;
      smg::mbar_wait(&empty[buf], ((i >> 1) & 1) ^ 1);
      const smg::C3wTile t = smg::c3w_tile(tile, plan, N, H, W);
      unsigned char* dst = h2s + buf * patch_px * smg::C3_PIXEL_BYTES;
      auto chunk = [&](int q) { return dst + q * smg::C3_PIXEL_BYTES + ((c16 ^ (q & 7)) << 4); };
      // Bit j of `staged`: pass j's chunk lies in the image (was loaded).
      uint64_t staged = 0;
      smg::PatchWalk in(tid >> 4, plan);
      for (int bt = 0; bt < K5_BATCHES; ++bt) {
        for (int j = bt * per_batch; j < (bt + 1) * per_batch; ++j, in.advance(8)) {
          if (in.q >= patch_px) continue;
          const int p = in.src(t, N, H, W);
          if (p >= 0) {
            smg::cp_async16(smg::smem_addr(chunk(in.q)), h1 + (size_t)p * BOTTLENECK + c16 * 8,
                            true);
            staged |= 1ull << j;
          } else {
            *reinterpret_cast<uint4*>(chunk(in.q)) = make_uint4(0, 0, 0, 0);
          }
        }
        smg::cp_async_commit();
      }
      // BN2 + ReLU on batch bt's staged chunks, four at a time (independent
      // chains: the loads of all four before the arithmetic).
      auto transform = [&](int bt) {
        const uint64_t mine = staged & (((1ull << per_batch) - 1) << (bt * per_batch));
        for (int j0 = bt * per_batch; j0 < (bt + 1) * per_batch; j0 += 4) {
          uint4 x[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (mine >> (j0 + k) & 1)
              x[k] = *reinterpret_cast<const uint4*>(chunk(q0 + 8 * (j0 + k)));
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!(mine >> (j0 + k) & 1)) continue;
            float v[8];
            smg::unpack8(x[k], v);
#pragma unroll
            for (int c = 0; c < 8; ++c) v[c] = smg::bn_relu(v[c], av[c], bv[c]);
            *reinterpret_cast<uint4*>(chunk(q0 + 8 * (j0 + k))) = smg::pack8(v);
          }
        }
      };
      static_assert(K5_BATCHES == 4, "one wait per batch below");
      smg::cp_async_wait<3>();
      transform(0);
      smg::cp_async_wait<2>();
      transform(1);
      smg::cp_async_wait<1>();
      transform(2);
      smg::cp_async_wait<0>();
      transform(3);
      smg::mbar_arrive(&full[buf]);
    }
  } else {
    // ---- warpgroups 1, 2: the 3x3 of tile i from h2 buffer i % 2 ----------
    // The tap weights load while warpgroup 0 stages the first patch.
    const int ctid = tid - smg::C3W_PRODUCERS;
    const int wg = ctid >> 7, wq = (ctid >> 5) & 3, lane = tid & 31;
    smg::c3w_load_weights(wsm, w2, ctid);
    smg::cp_async_commit();
    smg::cp_async_wait<0>();
    smg::fence_proxy_async();
    smg::named_bar_sync(1, smg::C3W_CONSUMERS);
    const uint32_t wbase = smg::smem_addr(wsm);
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int buf = i & 1;
      smg::mbar_wait(&full[buf], (i >> 1) & 1);
      const smg::C3wTile t = smg::c3w_tile(tile, plan, N, H, W);
      const int M = t.gn * t.th * t.tw;
      const uint32_t pbase = smg::smem_addr(h2s + buf * patch_px * smg::C3_PIXEL_BYTES);
      for (int u = wg * smg::C3W_TASK; u < M; u += 2 * smg::C3W_TASK) {
        float total[16];
        smg::c3w_task<true>(pbase, wbase, plan, t, u, wq, lane, total);
        smg::c3w_store(total, out, t, u, wq, lane, H, W, ld, 0);
      }
      smg::mbar_arrive(&empty[buf]);
    }
  }
}

}  // namespace

// plan: ops/conv2.py::conv2_plan (tile extents, grid, dynamic shared memory).
extern "C" int smg_conv2_bn_relu(const bf16* h1, const float* a, const float* b,
                                 const bf16* w2, bf16* out, int N, int H, int W,
                                 int ld, int images, int rows, int cols, int grid, int smem,
                                 cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      conv2_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smg::C3_SMEM_MAX);
  if (set != cudaSuccess) return (int)set;
  if (N * H * W == 0) return (int)cudaGetLastError();
  const smg::Conv3x3Plan plan{images, rows, cols, grid, smem};
  conv2_wgmma_kernel<<<grid, smg::C3W_THREADS, smem, stream>>>(h1, a, b, w2, out, N, H, W, ld,
                                                               plan);
  return (int)cudaGetLastError();
}
