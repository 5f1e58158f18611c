// K4: the DenseNet stem tail — eval BN affine, ReLU, 3x3 / stride-2 /
// pad-1 max pool — on conv0's bf16 NHWC output.
//
// Replaces smg_tpu/ops/stem_pool_pallas.py::bn_relu_maxpool (Pallas
// _kernel, stem_pool_pallas.py:58-103). The TPU kernel read a quad-phase
// packed conv0 output so that every slice was lane-aligned; that
// repacking existed for the TPU's 128-lane tiles and is not carried over.
//
// What bounds it on the H100: device-memory bytes. Per output it reads 9
// (mostly L1/L2-shared) inputs and does ~30 flops: at 224 and 416 images
// the pass moves ~0.7 GB in and ~0.17 GB out. The design: one thread per
// (output pixel, 8-channel group), 16-byte loads and stores, neighbouring
// threads on neighbouring channels, and the pooled result written straight
// into the first dense block's buffer (pixel stride out_ld), so the stem
// output never takes a separate copy.
//
// Padding: windows skip out-of-image taps and start from 0, which equals
// the TPU kernel's pad-with-0-after-ReLU (stem_pool_pallas.py:15-16).

#include "common.cuh"

namespace {

using smg::bf16;

__global__ void stem_pool_kernel(const bf16* __restrict__ y,
                                 const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 bf16* __restrict__ out, int N, int H, int W,
                                 int C, int Ho, int Wo, int out_ld) {
  const int cg = C / 8;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)N * Ho * Wo * cg;
  if (idx >= total) return;
  const int g = (int)(idx % cg);
  size_t p = idx / cg;
  const int ox = (int)(p % Wo);
  p /= Wo;
  const int oy = (int)(p % Ho);
  const int n = (int)(p / Ho);

  float av[8], bv[8], m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    av[k] = a[g * 8 + k];
    bv[k] = b[g * 8 + k];
    m[k] = 0.0f;
  }
  for (int dy = -1; dy <= 1; ++dy) {
    const int iy = 2 * oy + dy;
    if (iy < 0 || iy >= H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int ix = 2 * ox + dx;
      if (ix < 0 || ix >= W) continue;
      float v[8];
      smg::unpack8(*reinterpret_cast<const uint4*>(
                       y + (((size_t)n * H + iy) * W + ix) * C + g * 8), v);
#pragma unroll
      for (int k = 0; k < 8; ++k) m[k] = fmaxf(m[k], smg::bn_relu(v[k], av[k], bv[k]));
    }
  }
  *reinterpret_cast<uint4*>(out + (((size_t)n * Ho + oy) * Wo + ox) * out_ld + g * 8) =
      smg::pack8(m);
}

}  // namespace

extern "C" int smg_stem_pool(const bf16* y, const float* a, const float* b,
                             bf16* out, int N, int H, int W, int C, int out_ld,
                             cudaStream_t stream) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const size_t total = (size_t)N * Ho * Wo * (C / 8);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0)
    stem_pool_kernel<<<blocks, threads, 0, stream>>>(y, a, b, out, N, H, W, C, Ho,
                                                     Wo, out_ld);
  return (int)cudaGetLastError();
}
