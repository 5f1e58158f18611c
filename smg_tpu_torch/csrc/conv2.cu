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
// What bounds it on the H100: per 104-image trunk pass at 224 the 58 calls
// read h1 (128 bf16 per pixel) and write 32 channels: ~1.12 GB, ~0.34 ms
// at 3.35 TB/s, against 259 GFLOP (~0.26 ms at the bf16 tensor peak), so
// bytes by a little. The design: common.cuh's conv3x3_kernel (the 3x3 of
// K2, K6a and K7 too) with a source whose prologue is BN2 + ReLU: the raw
// h1 patch is staged by cp.async and transformed in shared memory, in-image
// pixels only, so h2 never exists in device memory and the padding stays
// zero.

#include "common.cuh"

namespace {

using smg::bf16;

constexpr int BOTTLENECK = 128;

// conv2's source: h2 = relu(h1 a + b), computed from the staged h1.
struct EvalH2Rows {
  static constexpr bool kIdentity = false;
  const bf16* h1;  // (P, 128)
  const float* a;
  const float* b;
  __device__ const bf16* row(int p) const { return h1 + (size_t)p * BOTTLENECK; }
  __device__ uint4 apply(int, int c8, uint4 raw) const {
    float v[8];
    smg::unpack8(raw, v);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = smg::bn_relu(v[c], a[c8 + c], b[c8 + c]);
    return smg::pack8(v);
  }
};

}  // namespace

// c3_*: the 3x3's tile plan (ops/conv2.py::conv3x3_plan).
extern "C" int smg_conv2_bn_relu(const bf16* h1, const float* a, const float* b,
                                 const bf16* w2, bf16* out, int N, int H, int W,
                                 int ld, int c3_images, int c3_rows, int c3_cols,
                                 int c3_grid, int c3_smem, cudaStream_t stream) {
  const smg::Conv3x3Plan plan{c3_images, c3_rows, c3_cols, c3_grid, c3_smem};
  return (int)smg::conv3x3(EvalH2Rows{h1, a, b}, w2, out, N, H, W, ld, 0, plan, stream);
}
