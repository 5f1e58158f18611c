// K3: the DenseNet transition — eval BN affine, ReLU, 2x2 mean, then the
// 1x1 conv C -> C_out with f32 accumulation.
//
// Replaces smg_tpu/ops/transition_pallas.py::transition (Pallas _kernel,
// transition_pallas.py:29-59). As there, the pool is commuted ahead of the
// linear 1x1 (a quarter of the matmul rows), and the pooled value is
// rounded to bf16 before the product: pooled = bf16(((h00 + h10) +
// (h01 + h11)) * 0.25), h = relu(x * a + b) in f32.
//
// What bounds it on the H100: at 224 the three transitions are GEMMs of
// M = N*H*W/4 pooled pixels, K = C (256..1024) and C_out = C/2: ~0.4
// GFLOP per image over all three, i.e. above the card's ops:byte ridge
// once the BN/pool prologue reads each input byte once. The design: the
// shared tiled tensor-core GEMM (common.cuh) whose A-tile loader does the
// BN, ReLU and 2x2 mean while it stages the tile, so the pooled tensor
// never exists in device memory, and whose epilogue writes bf16 straight
// into the next dense block's buffer (pixel stride out_ld).

#include "common.cuh"

namespace {

using smg::bf16;

struct PoolLoader {
  const bf16* x;   // (N, H, W, x_ld)
  const float* a;
  const float* b;
  int H, W, x_ld;
  __device__ void load8(int q, int k, float* v) const {
    const int Wo = W / 2, Ho = H / 2;
    const int j = q % Wo;
    const int t = q / Wo;
    const int i = t % Ho;
    const int n = t / Ho;
    const size_t row0 = ((size_t)n * H + 2 * i) * W + 2 * j;  // (2i, 2j)
    const size_t row1 = row0 + W;                              // (2i+1, 2j)
    float h00[8], h10[8], h01[8], h11[8];
    smg::unpack8(*reinterpret_cast<const uint4*>(x + row0 * x_ld + k), h00);
    smg::unpack8(*reinterpret_cast<const uint4*>(x + row1 * x_ld + k), h10);
    smg::unpack8(*reinterpret_cast<const uint4*>(x + (row0 + 1) * x_ld + k), h01);
    smg::unpack8(*reinterpret_cast<const uint4*>(x + (row1 + 1) * x_ld + k), h11);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float av = a[k + c], bv = b[k + c];
      const float s0 = __fadd_rn(smg::bn_relu(h00[c], av, bv), smg::bn_relu(h10[c], av, bv));
      const float s1 = __fadd_rn(smg::bn_relu(h01[c], av, bv), smg::bn_relu(h11[c], av, bv));
      v[c] = __fmul_rn(__fadd_rn(s0, s1), 0.25f);
    }
  }
};

struct StoreEpilogue {
  bf16* out;   // (Q, out_ld), columns [0, C_out)
  int out_ld;
  __device__ void store8(int row, int col, const float* v) const {
    *reinterpret_cast<uint4*>(out + (size_t)row * out_ld + col) = smg::pack8(v);
  }
};

}  // namespace

extern "C" int smg_transition(const bf16* x, const float* a, const float* b,
                              const bf16* wt, bf16* out, int N, int H, int W,
                              int C, int x_ld, int C_out, int out_ld,
                              cudaStream_t stream) {
  const int Q = N * (H / 2) * (W / 2);
  PoolLoader ld{x, a, b, H, W, x_ld};
  StoreEpilogue ep{out, out_ld};
  dim3 grid((Q + smg::GEMM_BM - 1) / smg::GEMM_BM, C_out / smg::GEMM_BN);
  if (Q > 0)
    smg::gemm_bf16_kernel<<<grid, smg::GEMM_THREADS, 0, stream>>>(ld, wt, C_out, Q,
                                                                  C, ep);
  return (int)cudaGetLastError();
}
