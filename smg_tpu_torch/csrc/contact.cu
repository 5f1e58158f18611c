// K1: the pairwise penalty-contact sweep.
//
// Replaces smg_tpu/ops/contact_pallas.py::pairwise_forces (Pallas _kernel,
// contact_pallas.py:33-114). Per object sphere i (row, S of them) and
// scene b: the force from T sources (all object spheres, then the G
// gripper colliders), summed over j in order 0..T-1 — the TPU kernel's
// fori_loop order — with no atomics, so the result is deterministic.
//
// Layout: scene-minor SoA. rows (9, S, B) = cx cy cz vx vy vz rad mass live;
// cols (9, T, B) the same for the sources; out (3, S, B) = fx fy fz.
//
// What bounds it on the H100: neither bytes nor FLOPs. The state is
// O((S + T) B) floats and the work O(S T B) ~ 16k pair terms per scene
// (0.5 MFLOP); at B = 32 that is microseconds of arithmetic, so the call
// is bound by launch latency and by the serial 145-source loop of each
// thread. The design: one thread per (row, scene) with scenes on the
// fastest axis (coalesced loads), and 4 rows per block sharing each
// source's loads through L1. Nothing of the O(S T B) pair terms touches
// device memory.

#include <cuda_runtime.h>

namespace {

struct Gains {
  float kn, zeta, share, mu, mu_grip, v_eps, max_pen, max_vn;
};

constexpr int TB_X = 32;  // scenes per block
constexpr int TB_Y = 4;   // rows per block

__global__ void __launch_bounds__(TB_X * TB_Y)
contact_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
               float* __restrict__ out, int S, int T, int B, int K, Gains g) {
  const int b = blockIdx.x * TB_X + threadIdx.x;
  const int i = blockIdx.y * TB_Y + threadIdx.y;
  if (b >= B || i >= S) return;
  const size_t SB = (size_t)S * B;
  const size_t TB = (size_t)T * B;
  const float* r = rows + (size_t)i * B + b;
  const float cx = r[0], cy = r[SB], cz = r[2 * SB];
  const float vx = r[3 * SB], vy = r[4 * SB], vz = r[5 * SB];
  const float rad = r[6 * SB], mrow = r[7 * SB], live_row = r[8 * SB];
  const int row_owner = i / K;

  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int j = 0; j < T; ++j) {
    const float* c = cols + (size_t)j * B + b;
    const float jx = __ldg(c), jy = __ldg(c + TB), jz = __ldg(c + 2 * TB);
    const float jvx = __ldg(c + 3 * TB), jvy = __ldg(c + 4 * TB);
    const float jvz = __ldg(c + 5 * TB);
    const float jrad = __ldg(c + 6 * TB), jm = __ldg(c + 7 * TB);
    const float jlive = __ldg(c + 8 * TB);

    const float dx = cx - jx, dy = cy - jy, dz = cz - jz;
    const float dist2 = dx * dx + dy * dy + dz * dz;
    const float inv_dist = rsqrtf(dist2 + 1e-18f);
    const float pen = (rad + jrad) - dist2 * inv_dist;

    const bool is_grip = j >= S;
    const int col_owner = is_grip ? -1 : j / K;
    const bool ok = (row_owner != col_owner) && (live_row > 0.0f) &&
                    (jlive > 0.0f) && (pen > 0.0f);

    const float nx = dx * inv_dist, ny = dy * inv_dist, nz = dz * inv_dist;
    const float rvx = vx - jvx, rvy = vy - jvy, rvz = vz - jvz;
    const float vn = fminf(fmaxf(rvx * nx + rvy * ny + rvz * nz, -g.max_vn), g.max_vn);
    const float meff = is_grip ? mrow : mrow * jm / (mrow + jm);
    const float cn = 2.0f * g.zeta * sqrtf(g.kn * meff / g.share);
    float fn = fmaxf(0.0f, g.kn * fminf(pen, g.max_pen) - cn * vn);
    fn = ok ? fn : 0.0f;

    const float tx = rvx - vn * nx, ty = rvy - vn * ny, tz = rvz - vn * nz;
    const float vt2 = tx * tx + ty * ty + tz * tz;
    const float inv_vt = rsqrtf(vt2 + 1e-18f);
    const float mu_j = is_grip ? g.mu_grip : g.mu;
    const float ft = mu_j * fn * tanhf(vt2 * inv_vt / g.v_eps);

    ax = ax + fn * nx - ft * tx * inv_vt;
    ay = ay + fn * ny - ft * ty * inv_vt;
    az = az + fn * nz - ft * tz * inv_vt;
  }
  float* o = out + (size_t)i * B + b;
  o[0] = ax;
  o[SB] = ay;
  o[2 * SB] = az;
}

}  // namespace

extern "C" int smg_contact_forces(const float* rows, const float* cols,
                                  float* out, int S, int T, int B, int K,
                                  float kn, float zeta, float share, float mu,
                                  float mu_grip, float v_eps, float max_pen,
                                  float max_vn, cudaStream_t stream) {
  Gains g{kn, zeta, share, mu, mu_grip, v_eps, max_pen, max_vn};
  dim3 block(TB_X, TB_Y);
  dim3 grid((B + TB_X - 1) / TB_X, (S + TB_Y - 1) / TB_Y);
  contact_kernel<<<grid, block, 0, stream>>>(rows, cols, out, S, T, B, K, g);
  return (int)cudaGetLastError();
}
