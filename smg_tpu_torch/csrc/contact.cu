// K1: the pairwise penalty-contact sweep.
//
// Replaces smg_tpu/ops/contact_pallas.py::pairwise_forces (Pallas _kernel,
// contact_pallas.py:33-114). Per object sphere i (row, S of them) and
// scene b: the force from T sources (all object spheres, then the G
// gripper colliders). No atomics: a run gives the same bits every time.
//
// Layout: scene-minor SoA. rows (9, S, B) = cx cy cz vx vy vz rad mass live;
// cols (9, T, B) the same for the sources; out (3, S, B) = fx fy fz.
//
// The design (geometry planned by ops/contact.py::contact_plan): a block
// holds `scenes` x `rows` (row, scene) pairs (threadIdx.x, .y), and the T
// sources of each pair are split into `chunks` contiguous ranges
// [j T / chunks, (j + 1) T / chunks) summed by as many threads
// (threadIdx.z), each in source order. The partials are then added in
// chunk order through shared memory, so the sum order is fixed (no longer
// the TPU kernel's strict 0..T-1). The block stages its scenes' source
// columns in shared memory with one coalesced sweep, `slab` sources of
// each chunk per pass, and every thread reads them from there; a row's
// nine quantities and owner live in registers. The arithmetic is the
// plain version's: IEEE rsqrtf, sqrtf, tanhf and divisions. A pair that
// the mask drops (same owner, a dead sphere, no penetration) adds exactly
// +-0 to the sum, which leaves it unchanged, so the thread skips its force
// terms: the same bits for less work.
//
// What bounds it on the H100: not bytes (9 (S + T) + 3 S floats per scene)
// nor the f32 rate. At B = 32 (4 x 54 = 216 blocks of 256 threads, ~9
// sources a thread) it is launch latency and the staging sweep's L2
// round trip; at B = 1024 (448 blocks of 32 scenes x 8 rows, 145 sources
// a thread) the special-function unit's rate for the rsqrt, sqrt, tanh
// and divisions of the pairs in contact, and the distance test of all.

#include <cuda_runtime.h>

namespace {

struct Gains {
  float kn, zeta, share, mu, mu_grip, v_eps, max_pen, max_vn;
};

__global__ void contact_kernel(const float* __restrict__ rows,
                               const float* __restrict__ cols,
                               float* __restrict__ out, int S, int T, int B, int K,
                               Gains g, int slab) {
  extern __shared__ float sh[];   // [9][chunks][slab][scenes], then partials
  const int SC = blockDim.x, RB = blockDim.y, J = blockDim.z;
  const int sx = threadIdx.x, ry = threadIdx.y, ck = threadIdx.z;
  const int b0 = blockIdx.x * SC;
  const int b = b0 + sx;
  const int i = blockIdx.y * RB + ry;
  const bool active = b < B && i < S;
  const size_t SB = (size_t)S * B;
  const size_t TB = (size_t)T * B;

  float cx = 0.f, cy = 0.f, cz = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  float rad = 0.f, mrow = 0.f, live_row = 0.f;
  if (active) {
    const float* r = rows + (size_t)i * B + b;
    cx = r[0]; cy = r[SB]; cz = r[2 * SB];
    vx = r[3 * SB]; vy = r[4 * SB]; vz = r[5 * SB];
    rad = r[6 * SB]; mrow = r[7 * SB]; live_row = r[8 * SB];
  }
  const int row_owner = i / K;
  const int j_begin = ck * T / J, j_end = (ck + 1) * T / J;
  const int longest = (T + J - 1) / J;
  const int per_q = J * slab * SC;   // floats of one quantity in a slab

  const int worker = ry + RB * ck;   // this thread's share of the staging sweep
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int s0 = 0; s0 < longest; s0 += slab) {
    // Stage sources j_begin(c) + s0 .. + slab of every chunk c, for the
    // block's scenes: lane sx takes scene b0 + sx, the RB * J workers take
    // the (chunk, source) slots in turn, each loading its 9 quantities.
    for (int cs = worker; cs < J * slab; cs += RB * J) {
      const int c = cs / slab;
      const int j = c * T / J + s0 + cs - c * slab;
      const bool ok = j < (c + 1) * T / J && b < B;
      const float* src = cols + (size_t)(ok ? j : 0) * B + (ok ? b : 0);
      float* dst = sh + cs * SC + sx;
#pragma unroll
      for (int q = 0; q < 9; ++q) dst[q * per_q] = ok ? __ldg(src + q * TB) : 0.0f;
    }
    __syncthreads();
    const int n = min(slab, j_end - j_begin - s0);
    const float* base = sh + ck * slab * SC + sx;
    // The source's owner (j / K, or -1 for the gripper), kept incrementally.
    int j = j_begin + s0;
    int owner = j / K, within = j - owner * K;
    for (int s = 0; s < n; ++s, ++j) {
      const float* c = base + s * SC;
      const float jx = c[0], jy = c[per_q], jz = c[2 * per_q];
      const float jrad = c[6 * per_q], jlive = c[8 * per_q];

      const float dx = cx - jx, dy = cy - jy, dz = cz - jz;
      const float dist2 = dx * dx + dy * dy + dz * dz;
      const float inv_dist = rsqrtf(dist2 + 1e-18f);
      const float pen = (rad + jrad) - dist2 * inv_dist;

      const bool is_grip = j >= S;
      const int col_owner = is_grip ? -1 : owner;
      if (++within == K) {
        within = 0;
        ++owner;
      }
      const bool ok = (row_owner != col_owner) && (live_row > 0.0f) &&
                      (jlive > 0.0f) && (pen > 0.0f);
      if (!ok || !active) continue;

      const float jvx = c[3 * per_q], jvy = c[4 * per_q], jvz = c[5 * per_q];
      const float jm = c[7 * per_q];
      const float nx = dx * inv_dist, ny = dy * inv_dist, nz = dz * inv_dist;
      const float rvx = vx - jvx, rvy = vy - jvy, rvz = vz - jvz;
      const float vn = fminf(fmaxf(rvx * nx + rvy * ny + rvz * nz, -g.max_vn), g.max_vn);
      const float meff = is_grip ? mrow : mrow * jm / (mrow + jm);
      const float cn = 2.0f * g.zeta * sqrtf(g.kn * meff / g.share);
      const float fn = fmaxf(0.0f, g.kn * fminf(pen, g.max_pen) - cn * vn);

      const float tx = rvx - vn * nx, ty = rvy - vn * ny, tz = rvz - vn * nz;
      const float vt2 = tx * tx + ty * ty + tz * tz;
      const float inv_vt = rsqrtf(vt2 + 1e-18f);
      const float mu_j = is_grip ? g.mu_grip : g.mu;
      const float ft = mu_j * fn * tanhf(vt2 * inv_vt / g.v_eps);

      ax = ax + fn * nx - ft * tx * inv_vt;
      ay = ay + fn * ny - ft * ty * inv_vt;
      az = az + fn * nz - ft * tz * inv_vt;
    }
    __syncthreads();
  }

  if (J > 1) {
    // Partials in chunk order: sh[(q * J + ck) * RB * SC + ry * SC + sx].
    const int per_chunk = RB * SC;
    const int o = ry * SC + sx;
    sh[(0 * J + ck) * per_chunk + o] = ax;
    sh[(1 * J + ck) * per_chunk + o] = ay;
    sh[(2 * J + ck) * per_chunk + o] = az;
    __syncthreads();
    if (ck != 0) return;
    ax = sh[o];
    ay = sh[J * per_chunk + o];
    az = sh[2 * J * per_chunk + o];
    for (int c = 1; c < J; ++c) {
      ax = ax + sh[c * per_chunk + o];
      ay = ay + sh[(J + c) * per_chunk + o];
      az = az + sh[(2 * J + c) * per_chunk + o];
    }
  }
  if (!active) return;
  float* o = out + (size_t)i * B + b;
  o[0] = ax;
  o[SB] = ay;
  o[2 * SB] = az;
}

}  // namespace

// scenes, rows, chunks, slab, smem_bytes: ops/contact.py::contact_plan.
extern "C" int smg_contact_forces(const float* rows, const float* cols,
                                  float* out, int S, int T, int B, int K,
                                  float kn, float zeta, float share, float mu,
                                  float mu_grip, float v_eps, float max_pen,
                                  float max_vn, int scenes, int rows_per_block,
                                  int chunks, int slab, int smem_bytes,
                                  cudaStream_t stream) {
  Gains g{kn, zeta, share, mu, mu_grip, v_eps, max_pen, max_vn};
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  dim3 block(scenes, rows_per_block, chunks);
  dim3 grid((B + scenes - 1) / scenes, (S + rows_per_block - 1) / rows_per_block);
  contact_kernel<<<grid, block, smem_bytes, stream>>>(rows, cols, out, S, T, B, K, g, slab);
  return (int)cudaGetLastError();
}
