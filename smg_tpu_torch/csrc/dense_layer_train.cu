// K6: one train-mode DenseNet dense layer, forward (K6a) and backward
// (K6b), with per-image batch statistics, in a dense block's NHWC buffer.
//
// Replaces smg_tpu/ops/dense_layer_train_pallas.py::layer_train_fwd
// (_fwd_kernel, :91-186) and ::layer_train_bwd (_bwd_kernel, :251-407).
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
// What bounds it on the H100: at 224 one style group of the update is up
// to 64 images (32 scenes x scene + mask stream). Over the 58 layers the
// forward does ~0.31 TFLOP (2 P K N of the bottleneck and conv2 GEMMs) and
// must read each layer's prefix and write h1 and out (~29 MB per image,
// ~1.9 GB in all): ~165 FLOP/B, under the bf16 ridge of ~295, so bytes bind
// (~0.56 ms at 3.35 TB/s against ~0.31 ms of tensor-core time). The
// backward does twice the FLOPs and must read the prefix, h1 and a bf16
// dout and write a bf16 dx (~47 MB per image, ~3.0 GB in all): bytes bind
// again (~0.91 ms against ~0.62 ms). This design moves more than that: it
// reads and writes the f32 prefix cotangent (8 B per prefix element instead
// of the 2 B of a bf16 dx), ~2.2x the bytes the function needs. What the
// design does about the rest:
// norms, ReLUs and roundings are computed in the GEMM loaders and
// epilogues, so y1, y2 and u never reach device memory; h1 is the only
// saved activation (the block buffer holds every layer's input). du2 and
// du1 are kept in f32 scratch instead of recomputing them as the TPU did to
// save VMEM (tens of MB at these shapes). The weight gradients reduce over
// every pixel of every image: split-K partial tiles, then a fixed-order sum
// by the caller, with no float atomics, so a repeated run gives the same
// bits. The forward's 3x3 is common.cuh's conv3x3_kernel (K2's);
// the GEMMs are simple WMMA tiles with one shared-memory stage.
//
// Dropped from the TPU kernel, as VMEM/lane devices with no job here: the
// width padding to 8 and its pad-column masks, the pltpu.roll column
// shifts, the 128-lane segment groups, and the VMEM gate `supported()`
// with its fallback to the 'conv' form: every layer runs here.

#include "common.cuh"

namespace {

using smg::bf16;

constexpr int BOTTLENECK = 128;
constexpr int GROWTH = 32;
constexpr int TAPS_K = 9 * GROWTH;         // 288: the shifted-dout operand's depth
constexpr float BN_EPS = 1e-5f;

// Per-channel reductions over one image: 32 channels x 8 pixel lanes.
constexpr int RED_C = 32;
constexpr int RED_R = 8;

__device__ __forceinline__ void bn_affine(float mean, float var, float scale,
                                          float bias, float* a, float* b) {
  *a = __fmul_rn(scale, 1.0f / sqrtf(var + BN_EPS));
  *b = __fsub_rn(bias, __fmul_rn(mean, *a));
}

// Per-image moments of x[..., :C] (bf16, pixel stride ldx) and the BN
// affine they give. st is (4, N, C) f32: mean, var, a, b.
__global__ void __launch_bounds__(RED_C * RED_R)
moments_kernel(const bf16* __restrict__ x, int ldx, int C, int HW, int N,
               const float* __restrict__ scale, const float* __restrict__ bias,
               float* __restrict__ st) {
  __shared__ float sh[2][RED_R][RED_C + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int img = blockIdx.x;
  const int c = blockIdx.y * RED_C + tx;
  float s = 0.0f, s2 = 0.0f;
  if (c < C) {
    const bf16* base = x + (size_t)img * HW * ldx + c;
    for (int p = ty; p < HW; p += RED_R) {
      const float v = __bfloat162float(base[(size_t)p * ldx]);
      s += v;
      s2 += v * v;
    }
  }
  sh[0][ty][tx] = s;
  sh[1][ty][tx] = s2;
  __syncthreads();
  if (ty == 0 && c < C) {
    s = 0.0f;
    s2 = 0.0f;
    for (int r = 0; r < RED_R; ++r) {
      s += sh[0][r][tx];
      s2 += sh[1][r][tx];
    }
    const float n = (float)HW;
    const float m = s / n;
    const float var = s2 / n - m * m;
    float a, b;
    bn_affine(m, var, scale[c], bias[c], &a, &b);
    const size_t o = (size_t)img * C + c;
    const size_t NC = (size_t)N * C;
    st[o] = m;
    st[NC + o] = var;
    st[2 * NC + o] = a;
    st[3 * NC + o] = b;
  }
}

// The forward's affine again, from saved moments: aff is (2, N, C): a, b.
__global__ void affine_kernel(const float* __restrict__ mean, const float* __restrict__ var,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias, float* __restrict__ aff,
                              int N, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * C) return;
  const int c = i % C;
  bn_affine(mean[i], var[i], scale[c], bias[c], &aff[i], &aff[(size_t)N * C + i]);
}

// BatchNorm backward over one image, two passes:
//   sums[0] = sum du, sums[1] = sum du * xhat  (per image and channel)
//   dx = a (du - sum du / n - xhat sum(du xhat) / n)  -> out.store(pixel, c, dx)
template <class Out>
__global__ void __launch_bounds__(RED_C * RED_R)
bn_bwd_kernel(const float* __restrict__ du, int ldu, const bf16* __restrict__ x, int ldx,
              const float* __restrict__ mean, const float* __restrict__ var,
              const float* __restrict__ scale, int C, int HW, int N,
              float* __restrict__ sums, Out out) {
  __shared__ float sh[2][RED_R][RED_C + 1];
  __shared__ float mu[2][RED_C];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int img = blockIdx.x;
  const int c = blockIdx.y * RED_C + tx;
  const bool live = c < C;
  float m = 0.0f, r = 0.0f, a = 0.0f;
  if (live) {
    const size_t o = (size_t)img * C + c;
    m = mean[o];
    r = 1.0f / sqrtf(var[o] + BN_EPS);
    a = __fmul_rn(scale[c], r);
  }
  const size_t q0 = (size_t)img * HW;
  float s = 0.0f, s2 = 0.0f;
  if (live) {
    for (int p = ty; p < HW; p += RED_R) {
      const size_t q = q0 + p;
      const float d = du[q * ldu + c];
      const float xh = __fmul_rn(__bfloat162float(x[q * ldx + c]) - m, r);
      s += d;
      s2 += d * xh;
    }
  }
  sh[0][ty][tx] = s;
  sh[1][ty][tx] = s2;
  __syncthreads();
  if (ty == 0) {
    s = 0.0f;
    s2 = 0.0f;
    for (int k = 0; k < RED_R; ++k) {
      s += sh[0][k][tx];
      s2 += sh[1][k][tx];
    }
    if (live) {
      const size_t o = (size_t)img * C + c;
      sums[o] = s;
      sums[(size_t)N * C + o] = s2;
    }
    mu[0][tx] = s / (float)HW;
    mu[1][tx] = s2 / (float)HW;
  }
  __syncthreads();
  if (!live) return;
  const float mu1 = mu[0][tx], mu2 = mu[1][tx];
  for (int p = ty; p < HW; p += RED_R) {
    const size_t q = q0 + p;
    const float d = du[q * ldu + c];
    const float xh = __fmul_rn(__bfloat162float(x[q * ldx + c]) - m, r);
    out.store(q, c, a * (d - mu1 - xh * mu2));
  }
}

struct StoreBf16 {  // dh1 (P, ld) bf16
  bf16* y;
  int ld;
  __device__ void store(size_t q, int c, float v) const {
    y[q * ld + c] = __float2bfloat16_rn(v);
  }
};

struct AccumRoundedF32 {  // the prefix cotangent: dbuf += bf16(dx)
  float* y;
  int ld;
  __device__ void store(size_t q, int c, float v) const {
    y[q * ld + c] += smg::round_bf16(v);
  }
};

// ---- GEMM operands and epilogues --------------------------------------

// relu(x a + b) of a bf16 buffer with a per-image affine (N, C): y1.
struct ImgBnReluLoader {
  const bf16* x;
  const float* a;
  const float* b;
  int ld, C, HW;
  __device__ void load8(int p, int k, float* v) const {
    const size_t o = (size_t)(p / HW) * C + k;
    float xv[8];
    smg::unpack8(*reinterpret_cast<const uint4*>(x + (size_t)p * ld + k), xv);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = smg::bn_relu(xv[c], a[o + c], b[o + c]);
  }
};

// relu(h1 a2 + b2) with a per-image affine (N, 128): y2.
struct Y2Loader {
  const bf16* h1;
  const float* a;
  const float* b;
  int HW;
  __device__ void load8(int p, int k, float* v) const {
    const size_t o = (size_t)(p / HW) * BOTTLENECK + k;
    float hv[8];
    smg::unpack8(*reinterpret_cast<const uint4*>(h1 + (size_t)p * BOTTLENECK + k), hv);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = smg::bn_relu(hv[c], a[o + c], b[o + c]);
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
    float v[8];
    smg::unpack8(raw, v);
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = smg::bn_relu(v[c], a[o + c], b[o + c]);
    return smg::pack8(v);
  }
};

// Row p of the 288-wide operand [shift_tap(dout)]_tap, column k = 32 tap + o:
// dout[pixel + (1 - dy, 1 - dx), o] with zeros off the image, where dout
// is channels c_off.. of the f32 cotangent buffer (rounded to bf16 when
// staged).
struct ShiftedDoutLoader {
  const float* d;
  int ld, c_off, H, W;
  __device__ void load8(int p, int k, float* v) const {
    const int tap = k >> 5;
    const int o = k & 31;
    const int sy = 1 - tap / 3, sx = 1 - tap % 3;
    const int x = p % W;
    const int y = (p / W) % H;
    const int yy = y + sy, xx = x + sx;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float* src = d + (size_t)(p + sy * W + sx) * ld + c_off + o;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = 0.0f;
    }
  }
};

struct Dh1Loader {  // dh1 (P, 128) bf16
  const bf16* dh1;
  __device__ void load8(int p, int k, float* v) const {
    smg::unpack8(*reinterpret_cast<const uint4*>(dh1 + (size_t)p * BOTTLENECK + k), v);
  }
};

struct H1Epilogue {  // h1 = bf16(sum): the residual
  bf16* h1;
  __device__ void store8(int p, int col, const float* v) const {
    *reinterpret_cast<uint4*>(h1 + (size_t)p * BOTTLENECK + col) = smg::pack8(v);
  }
};

__device__ __forceinline__ void store8_f32(float* dst, const float* o) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
}

struct Du2Epilogue {  // du2 = [h1 a2 + b2 > 0] dy2, f32 (P, 128)
  float* du2;
  const bf16* h1;
  const float* a;
  const float* b;
  int HW;
  __device__ void store8(int p, int col, const float* v) const {
    const size_t o = (size_t)(p / HW) * BOTTLENECK + col;
    float hv[8], out[8];
    smg::unpack8(*reinterpret_cast<const uint4*>(h1 + (size_t)p * BOTTLENECK + col), hv);
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = smg::affine(hv[c], a[o + c], b[o + c]) > 0.0f ? v[c] : 0.0f;
    store8_f32(du2 + (size_t)p * BOTTLENECK + col, out);
  }
};

struct Du1Epilogue {  // du1 = [x a1 + b1 > 0] dy1, f32 (P, C); pad columns dropped
  float* du1;
  const bf16* x;
  const float* a;
  const float* b;
  int ld, C, HW;
  __device__ void store8(int p, int col, const float* v) const {
    if (col >= C) return;
    const size_t o = (size_t)(p / HW) * C + col;
    float xv[8], out[8];
    smg::unpack8(*reinterpret_cast<const uint4*>(x + (size_t)p * ld + col), xv);
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = smg::affine(xv[c], a[o + c], b[o + c]) > 0.0f ? v[c] : 0.0f;
    store8_f32(du1 + (size_t)p * C + col, out);
  }
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// K6a. buf (P, ld) bf16: reads [0, C_in), writes [C_in, C_in + 32).
// w1 (C_in, 128), w2 (9, 128, 32) bf16; s*, bi* f32. Outputs h1 (P, 128)
// bf16, st1 (4, N, C_in) and st2 (4, N, 128) f32: mean, var, a, b.
// c3_*: the 3x3's tile plan (ops/conv2.py::conv3x3_plan).
extern "C" int smg_dense_layer_train_fwd(bf16* buf, const bf16* w1, const float* s1,
                                         const float* bi1, const bf16* w2,
                                         const float* s2, const float* bi2, bf16* h1,
                                         float* st1, float* st2, int N, int H, int W,
                                         int ld, int c_in, int c3_images, int c3_rows,
                                         int c3_cols, int c3_grid, int c3_smem,
                                         cudaStream_t stream) {
  const int HW = H * W, P = N * HW;
  if (P == 0) return (int)cudaGetLastError();
  const dim3 red(RED_C, RED_R);
  moments_kernel<<<dim3(N, cdiv(c_in, RED_C)), red, 0, stream>>>(buf, ld, c_in, HW, N,
                                                                 s1, bi1, st1);
  const size_t nc1 = (size_t)N * c_in, nc2 = (size_t)N * BOTTLENECK;
  smg::gemm_bf16_kernel<<<dim3(cdiv(P, smg::GEMM_BM), 1), smg::GEMM_THREADS, 0, stream>>>(
      ImgBnReluLoader{buf, st1 + 2 * nc1, st1 + 3 * nc1, ld, c_in, HW}, w1, BOTTLENECK, P,
      c_in, H1Epilogue{h1});
  moments_kernel<<<dim3(N, BOTTLENECK / RED_C), red, 0, stream>>>(h1, BOTTLENECK, BOTTLENECK,
                                                                  HW, N, s2, bi2, st2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const smg::Conv3x3Plan plan{c3_images, c3_rows, c3_cols, c3_grid, c3_smem};
  return (int)smg::conv3x3(Y2Rows{h1, st2 + 2 * nc2, st2 + 3 * nc2, HW}, w2, buf, N, H, W, ld,
                           c_in, plan, stream);
}

// K6b. dbuf (P, ld) f32: reads the layer's cotangent [C_in, C_in + 32) and
// adds dx to [0, C_in). w1t (128, ldw1) bf16 = w1^T zero-padded to a
// multiple of 128 columns; w2t (288, 128) bf16, row 32 tap + o = w2[tap]^T.
// Scratch: aff1 (2, N, C_in), aff2 (2, N, 128), du2 (P, 128) f32, dh1
// (P, 128) bf16, du1 (P, C_in) f32. Outputs: sums1 (2, N, C_in) and sums2
// (2, N, 128) (per-image sum du, sum du xhat), part1 (split1, C_in, 128)
// and part2 (split2, 128, 288) f32 weight-gradient partials.
extern "C" int smg_dense_layer_train_bwd(
    const bf16* buf, float* dbuf, const bf16* h1, const bf16* w1t, const bf16* w2t,
    const float* s1, const float* bi1, const float* mean1, const float* var1,
    const float* s2, const float* bi2, const float* mean2, const float* var2, float* aff1,
    float* aff2, float* du2, bf16* dh1, float* du1, float* sums1, float* sums2,
    float* part1, float* part2, int N, int H, int W, int ld, int c_in, int ldw1,
    int split1, int chunk1, int split2, int chunk2, cudaStream_t stream) {
  const int HW = H * W, P = N * HW;
  if (P == 0) return (int)cudaGetLastError();
  const size_t nc1 = (size_t)N * c_in, nc2 = (size_t)N * BOTTLENECK;
  affine_kernel<<<cdiv((int)nc1, 256), 256, 0, stream>>>(mean1, var1, s1, bi1, aff1, N, c_in);
  affine_kernel<<<cdiv((int)nc2, 256), 256, 0, stream>>>(mean2, var2, s2, bi2, aff2, N,
                                                          BOTTLENECK);
  const float *a1 = aff1, *b1 = aff1 + nc1, *a2 = aff2, *b2 = aff2 + nc2;
  const ShiftedDoutLoader dout{dbuf, ld, c_in, H, W};
  const dim3 red(RED_C, RED_R);
  // dy2 -> du2 (f32 scratch)
  smg::gemm_bf16_kernel<<<dim3(cdiv(P, smg::GEMM_BM), 1), smg::GEMM_THREADS, 0, stream>>>(
      dout, w2t, BOTTLENECK, P, TAPS_K, Du2Epilogue{du2, h1, a2, b2, HW});
  // BN2 backward -> dh1 (bf16), per-image sums
  bn_bwd_kernel<<<dim3(N, BOTTLENECK / RED_C), red, 0, stream>>>(
      du2, BOTTLENECK, h1, BOTTLENECK, mean2, var2, s2, BOTTLENECK, HW, N, sums2,
      StoreBf16{dh1, BOTTLENECK});
  // dw2 = y2^T shift(dout); dw1 = y1^T dh1 (split-K partials)
  smg::gemm_atb_kernel<<<dim3(cdiv(BOTTLENECK, smg::ATB_BM), cdiv(TAPS_K, smg::ATB_BN),
                              split2),
                         smg::ATB_THREADS, 0, stream>>>(Y2Loader{h1, a2, b2, HW}, dout,
                                                        BOTTLENECK, TAPS_K, P, chunk2, part2);
  smg::gemm_atb_kernel<<<dim3(cdiv(c_in, smg::ATB_BM), cdiv(BOTTLENECK, smg::ATB_BN), split1),
                         smg::ATB_THREADS, 0, stream>>>(
      ImgBnReluLoader{buf, a1, b1, ld, c_in, HW}, Dh1Loader{dh1}, c_in, BOTTLENECK, P, chunk1,
      part1);
  // dy1 = dh1 w1^T -> du1 (f32 scratch)
  smg::gemm_bf16_kernel<<<dim3(cdiv(P, smg::GEMM_BM), ldw1 / smg::GEMM_BN), smg::GEMM_THREADS,
                          0, stream>>>(Dh1Loader{dh1}, w1t, ldw1, P, BOTTLENECK,
                                       Du1Epilogue{du1, buf, a1, b1, ld, c_in, HW});
  // BN1 backward -> dbuf[..., :C_in] += bf16(dx), per-image sums
  bn_bwd_kernel<<<dim3(N, cdiv(c_in, RED_C)), red, 0, stream>>>(
      du1, c_in, buf, ld, mean1, var1, s1, c_in, HW, N, sums1, AccumRoundedF32{dbuf, ld});
  return (int)cudaGetLastError();
}
