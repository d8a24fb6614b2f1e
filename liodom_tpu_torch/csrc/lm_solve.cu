// LM: the Huber Levenberg-Marquardt pose solve of ops/solver.lm_solve,
// written by hand for Hopper (sm_90a): every round of every lane in one
// launch.
//
// No TPU kernel: liodom_tpu/ops/solver.py:lm_solve is XLA ops.  In PyTorch
// the same solve is some hundreds of small launches a call (the Jacobian's
// elementwise ops and stacks, a batched 3 x 3 product, the sums,
// solve_ex, the selects), 2.67 ms of the captured replay step's 3.87 on
// the H100 and ~73 % of the eager step's host dispatch.
//
// The function, round for round the plain version's (laser_odometry.cc:
// 196-228): the Gauss-Newton normal equations of the weighted point-to-line
// residuals (Huber as IRLS weights) at pose0 and their robust cost; then
// `iters` rounds, each solving the damped system (JtJ + lambda diag(JtJ) +
// 1e-8 I) delta = -Jtr, retracting the pose by delta, and keeping the
// candidate when its robust cost is lower (lambda x 0.5), else dropping it
// (lambda x 4).  Lanes (the leading batch) are independent solves.
//
// What bounds it on the card: latency.  A call at the bench shape reads
// 5,632 edges x 10 words (~225 KB) once and does ~6.5 MFLOP; the least
// time for either is a few microseconds, while the rounds are a chain of
// dependent reductions: pass over the edges, sum across the lane, solve
// 6 x 6, retract, pass again.
//
// Design: one thread-block cluster a lane (cudaLaunchKernelEx), up to 8
// blocks of 512 threads, sized so a thread has about two edges.
//   - Each block stages its share of the lane's cp, lpa, lpb and valid
//     once, in shared memory, word-major (cp and valid with 16-byte loads
//     where the share's address allows; lpa and lpb are rows `lp_stride`
//     floats apart, the first two neighbours of the kNN's (E, k, 3) output
//     in place, read with 16-byte loads only where they are packed), with
//     each edge's pose-independent terms: |lpa - lpb|
//     (clamped, the plain de_norm) and (lpb - lpa) / de_norm (the plain
//     df_dlp's entries).  Edges past kMaxCached a block are read again from
//     device memory (L2) on each pass: any E, any B, one launch.
//   - One pass a round, 1 + iters in all (the plain version makes 2 + 2
//     iters: it builds the equations at pose0 twice and costs each
//     candidate apart): the first at pose0 gives JtJ, Jtr and their cost;
//     each round's pass at its candidate gives the candidate's robust cost
//     with its JtJ and Jtr.  On accept those are kept, on reject the pose
//     has not moved and the kept ones still hold; the last round's pass
//     sums the cost only.
//   - Each thread sums the 21 upper JtJ entries, the 6 of Jtr and the cost
//     of its edges in registers; a warp reduces its 32 sums by a transpose
//     (31 shuffles, lane j ends with sum j), the block sums its warps in
//     warp order, and the lane sums its blocks in rank order through
//     distributed shared memory after one cluster barrier.  The order is
//     fixed and there are no atomics, so a rerun gives the same bits.
//   - Every block then solves the same 6 x 6 system from the same sums on
//     one thread (LU with partial pivoting, as solve_ex's getrf/getrs),
//     retracts and decides the accept itself: the same bits in every block,
//     so nothing is broadcast and a round costs one cluster barrier.  The
//     partial sums are double-buffered by pass parity, so the next pass
//     may write while a slower block still reads.
//   - float32 throughout, built with -fmad=false and without fast math;
//     the expressions are the plain version's: build_normal_equations' for
//     the equations and the first cost (the clamped distance weight times
//     nu / de_norm), robust_cost's for a candidate's cost (w nu / de_norm,
//     the weight divided by max - min), the clamps 1e-12 and 1e-20, Huber's
//     weight and cost, new_cost < cost, lambda x 0.5 / x 4.  Only the order
//     of the sums over edges differs from the plain version.
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises with the host, so a step that calls it is captured whole by
// a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;                 // blocks a lane, portable
constexpr int kEdgesPerThread = 2;             // sets the cluster's size
constexpr int kAlign = 16;                     // a block's share, in edges
constexpr int kMaxCached = 2048;               // edges a block keeps on chip
constexpr int kWords = 14;                     // words an edge keeps there
constexpr int kSums = 28;                      // 21 JtJ + 6 Jtr + cost
// the cost's sum: the plain cost's 0.5 x is exact, so costs compare unhalved
constexpr int kCost = 27;

// the plain version's Python constants, rounded to float32 as PyTorch
// rounds a scalar operand of a float32 tensor
constexpr float kTiny = static_cast<float>(1e-12);
constexpr float kTinySq = static_cast<float>(1e-20);
constexpr float kWeight0 = static_cast<float>(1.01);
constexpr float kEps = static_cast<float>(1e-8);

// What a pass sums besides the cost: the normal equations and the cost of
// build_normal_equations (the first pass), the equations and robust_cost's
// cost (a round's candidate), or robust_cost's cost alone (the last round).
enum Mode { kFirst, kCandidate, kCostOnly };

struct Params {
  float min_range, inv_span, span;   // min, 1 / (max - min), max - min
  float delta, delta_sq, two_delta;  // Huber: delta, delta^2, 2 delta
};

struct Edge {
  float cx, cy, cz, ax, ay, az, bx, by, bz;  // cp, lpa, lpb
  float de, g0, g1, g2;                      // de_norm, (lpb - lpa) / de_norm
  float v;                                   // valid as 0 or 1
};

struct Pose {
  float q[4], t[3];
};

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// the pose-independent terms of point_to_line_jacobian
__device__ __forceinline__ void prepare(Edge& e) {
  const float dx = e.ax - e.bx, dy = e.ay - e.by, dz = e.az - e.bz;
  e.de = clamp_min(sqrtf((dx * dx + dy * dy) + dz * dz), kTiny);
  e.g0 = (e.bx - e.ax) / e.de;
  e.g1 = (e.by - e.ay) / e.de;
  e.g2 = (e.bz - e.az) / e.de;
}

// huber_weight and huber_cost
__device__ __forceinline__ float huber_weight(float s, const Params& p) {
  const float c = clamp_min(s, kTinySq);
  return c <= p.delta_sq ? 1.0f : p.delta / sqrtf(c);
}

__device__ __forceinline__ float huber_cost(float s, const Params& p) {
  return s <= p.delta_sq ? s
                         : p.two_delta * sqrtf(clamp_min(s, 0.0f)) -
                               p.delta_sq;
}

// one row of the Jacobian with its residual into the sums: JtJ's upper
// triangle row by row, then Jtr (Jw = J * wi, JtJ += Jw^T J, Jtr += Jw^T r)
__device__ __forceinline__ void add_row(float (&acc)[32], const float (&j)[6],
                                        float r, float wi) {
  float jw[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) jw[a] = j[a] * wi;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += jw[a] * j[b];
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += jw[a] * r;
}

// One edge's share of a pass at pose p, in the plain version's expressions
// (point_to_line_jacobian / point_to_line_residual, elementwise, each
// operation rounded on its own).
template <Mode M>
__device__ __forceinline__ void accumulate(const Edge& e, const Pose& p,
                                           const Params& prm,
                                           float (&acc)[32]) {
  // u = quat_rotate(q, cp): uv = qv x cp, uuv = qv x uv, cp + 2 (w uv + uuv)
  const float uvx = p.q[2] * e.cz - p.q[3] * e.cy;
  const float uvy = p.q[3] * e.cx - p.q[1] * e.cz;
  const float uvz = p.q[1] * e.cy - p.q[2] * e.cx;
  const float uuvx = p.q[2] * uvz - p.q[3] * uvy;
  const float uuvy = p.q[3] * uvx - p.q[1] * uvz;
  const float uuvz = p.q[1] * uvy - p.q[2] * uvx;
  const float ux = e.cx + 2.0f * (p.q[0] * uvx + uuvx);
  const float uy = e.cy + 2.0f * (p.q[0] * uvy + uuvy);
  const float uz = e.cz + 2.0f * (p.q[0] * uvz + uuvz);
  const float lx = ux + p.t[0], ly = uy + p.t[1], lz = uz + p.t[2];
  // nu = (lp - lpa) x (lp - lpb)
  const float ax = lx - e.ax, ay = ly - e.ay, az = lz - e.az;
  const float bx = lx - e.bx, by = ly - e.by, bz = lz - e.bz;
  const float nx = ay * bz - az * by;
  const float ny = az * bx - ax * bz;
  const float nz = ax * by - ay * bx;
  const float clx = e.cx - p.t[0], cly = e.cy - p.t[1];
  const float dxy = clx * clx + cly * cly;
  if (M != kCostOnly) {
    const float fx = nx / e.de, fy = ny / e.de, fz = nz / e.de;
    const float d = sqrtf(clamp_min(dxy, kTiny));
    const float w = kWeight0 - (d - prm.min_range) * prm.inv_span;
    const float rx = w * fx, ry = w * fy, rz = w * fz;
    const float s = (rx * rx + ry * ry) + rz * rz;
    const float wi = huber_weight(s, prm) * e.v;
    if (M == kFirst) acc[kCost] += huber_cost(s, prm) * e.v;
    // d lp / d theta = -skew(u); df_dlp = skew(g); dr_dtheta = w df_dlp
    // (-skew(u)), its zero terms left out; dr_dt = w df_dlp + f dw_dt^T,
    // dw_dt = (cp_l.x / d * inv_span, cp_l.y / d * inv_span, 0)
    const float dwx = clx / d * prm.inv_span, dwy = cly / d * prm.inv_span;
    const float g0 = e.g0, g1 = e.g1, g2 = e.g2;
    {
      const float j[6] = {w * (g2 * uz + g1 * uy), w * -(g1 * ux),
                          w * -(g2 * ux), fx * dwx,
                          w * -g2 + fx * dwy, w * g1 + fx * 0.0f};
      add_row(acc, j, rx, wi);
    }
    {
      const float j[6] = {w * -(g0 * uy), w * (g2 * uz + g0 * ux),
                          w * -(g2 * uy), w * g2 + fy * dwx, fy * dwy,
                          w * -g0 + fy * 0.0f};
      add_row(acc, j, ry, wi);
    }
    {
      const float j[6] = {w * -(g0 * uz), w * -(g1 * uz),
                          w * (g1 * uy + g0 * ux), w * -g1 + fz * dwx,
                          w * g0 + fz * dwy, fz * 0.0f};
      add_row(acc, j, rz, wi);
    }
  }
  if (M != kFirst) {
    // robust_cost: w = 1.01 - (d - min) / (max - min), r = w nu / de_norm
    const float w = kWeight0 - (sqrtf(dxy) - prm.min_range) / prm.span;
    const float rx = (w * nx) / e.de, ry = (w * ny) / e.de,
                rz = (w * nz) / e.de;
    acc[kCost] += huber_cost((rx * rx + ry * ry) + rz * rz, prm) * e.v;
  }
}

// A warp's 32 sums, transposed: lane j returns the warp's sum of v[j]
// (each step halves the values a lane holds; a fixed tree).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                    int lane) {
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const bool upper = (lane & half) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? v[k] : v[k + half];
      const float keep = upper ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return v[0];
}

// (JtJ + lambda diag(JtJ) + 1e-8 I) delta = -Jtr by LU with partial
// pivoting (the first largest |pivot|, rows swapped), the right-hand side
// eliminated with the rows, then back substitution column by column.
__device__ void solve6(const float* ne, float lam, float (&x)[6]) {
  float a[6][7];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j, ++k) {
      a[i][j] = ne[k];
      a[j][i] = ne[k];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    a[i][i] = (a[i][i] + lam * a[i][i]) + kEps;
    a[i][6] = -ne[21 + i];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float best = fabsf(a[c][c]);
#pragma unroll
    for (int i = c + 1; i < 6; ++i) {
      const float m = fabsf(a[i][c]);
      if (m > best) {
        best = m;
        p = i;
      }
    }
#pragma unroll
    for (int i = c + 1; i < 6; ++i) {
      if (p == i) {
#pragma unroll
        for (int j = c; j < 7; ++j) {
          const float t = a[c][j];
          a[c][j] = a[i][j];
          a[i][j] = t;
        }
      }
    }
#pragma unroll
    for (int i = c + 1; i < 6; ++i) {
      const float l = a[i][c] / a[c][c];
#pragma unroll
      for (int j = c + 1; j < 7; ++j) a[i][j] = a[i][j] - l * a[c][j];
    }
  }
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    x[j] = a[j][6] / a[j][j];
#pragma unroll
    for (int i = 0; i < j; ++i) a[i][6] = a[i][6] - x[j] * a[i][j];
  }
}

// core/pose.retract: q' = normalize(exp(delta[:3]) q), t' = t + delta[3:]
// (so3_exp_quat with its small-angle branch, quat_mul, quat_normalize)
__device__ void retract(const Pose& p, const float (&d)[6], Pose& out) {
  const float th2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2];
  const bool small = th2 < kTiny;
  const float th = sqrtf(small ? 1.0f : th2);
  const float half = 0.5f * th;
  const float sinc = small ? 0.5f - th2 / 48.0f : sinf(half) / th;
  const float aw = small ? 1.0f - th2 / 8.0f : cosf(half);
  const float ax = sinc * d[0], ay = sinc * d[1], az = sinc * d[2];
  const float bw = p.q[0], bx = p.q[1], by = p.q[2], bz = p.q[3];
  const float m[4] = {((aw * bw - ax * bx) - ay * by) - az * bz,
                      ((aw * bx + ax * bw) + ay * bz) - az * by,
                      ((aw * by - ax * bz) + ay * bw) + az * bx,
                      ((aw * bz + ax * by) - ay * bx) + az * bw};
  const float n =
      sqrtf(((m[0] * m[0] + m[1] * m[1]) + m[2] * m[2]) + m[3] * m[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) out.q[i] = m[i] / n;
#pragma unroll
  for (int i = 0; i < 3; ++i) out.t[i] = p.t[i] + d[3 + i];
}

// word c of edge i of a block's staged share
__device__ __forceinline__ float& word(float* s, int cached, int c, int i) {
  return s[c * cached + i];
}

// n 3-vectors `stride` floats apart from src into words c0..c0+2 of the
// first n staged edges, 16 bytes a load where they are packed and src
// allows
__device__ void stage_vec3(float* s, int cached, int c0, const float* src,
                           long long stride, int n) {
  const int nf = 3 * n;
  int done = 0;
  if (stride != 3) {
    for (int g = threadIdx.x; g < nf; g += kThreads)
      word(s, cached, c0 + g % 3, g / 3) = __ldg(src + (g / 3) * stride +
                                                 g % 3);
    return;
  }
  if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int n4 = nf / 4;
    for (int j = threadIdx.x; j < n4; j += kThreads) {
      const float4 v = __ldg(s4 + j);
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = 4 * j + u;
        word(s, cached, c0 + g % 3, g / 3) = f[u];
      }
    }
    done = 4 * n4;
  }
  for (int g = done + threadIdx.x; g < nf; g += kThreads)
    word(s, cached, c0 + g % 3, g / 3) = __ldg(src + g);
}

__device__ void stage_valid(float* s, int cached, const unsigned char* src,
                            int n) {
  int done = 0;
  if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    const int n16 = n / 16;
    for (int j = threadIdx.x; j < n16; j += kThreads) {
      const uint4 v = __ldg(s16 + j);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 16; ++u)
        word(s, cached, 13, 16 * j + u) =
            ((w[u / 4] >> (8 * (u % 4))) & 0xFFu) != 0 ? 1.0f : 0.0f;
    }
    done = 16 * n16;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads)
    word(s, cached, 13, i) = src[i] != 0 ? 1.0f : 0.0f;
}

__device__ __forceinline__ Edge staged_edge(const float* s, int cached,
                                            int i) {
  Edge e;
  e.cx = s[i];
  e.cy = s[cached + i];
  e.cz = s[2 * cached + i];
  e.ax = s[3 * cached + i];
  e.ay = s[4 * cached + i];
  e.az = s[5 * cached + i];
  e.bx = s[6 * cached + i];
  e.by = s[7 * cached + i];
  e.bz = s[8 * cached + i];
  e.de = s[9 * cached + i];
  e.g0 = s[10 * cached + i];
  e.g1 = s[11 * cached + i];
  e.g2 = s[12 * cached + i];
  e.v = s[13 * cached + i];
  return e;
}

// an edge past the block's staged share, read from device memory
__device__ __forceinline__ Edge loaded_edge(const float* cp, const float* lpa,
                                            const float* lpb,
                                            long long lp_stride,
                                            const unsigned char* valid,
                                            int i) {
  Edge e;
  e.cx = __ldg(cp + 3 * i);
  e.cy = __ldg(cp + 3 * i + 1);
  e.cz = __ldg(cp + 3 * i + 2);
  const long long j = lp_stride * i;
  e.ax = __ldg(lpa + j);
  e.ay = __ldg(lpa + j + 1);
  e.az = __ldg(lpa + j + 2);
  e.bx = __ldg(lpb + j);
  e.by = __ldg(lpb + j + 1);
  e.bz = __ldg(lpb + j + 2);
  e.v = valid[i] != 0 ? 1.0f : 0.0f;
  prepare(e);
  return e;
}

// Shared memory of a block besides its staged edges.
struct Shared {
  float red[kWarps][32];    // the warps' sums
  float part[2][32];        // the block's sums, by pass parity
  float total[32];          // the lane's sums of the last pass
  float kept[32];           // the equations at the current pose and cost
  Pose pose, cand;
};

// One pass at pose p over the block's edges: the lane's sums in
// sh.total (every block the same bits), behind one cluster barrier.
template <Mode M>
__device__ void pass(const float* s_edge, int cached, int n_cached,
                     int n_mine, const float* cp, const float* lpa,
                     const float* lpb, long long lp_stride,
                     const unsigned char* valid, const Params& prm,
                     const Pose& at, int parity, Shared& sh,
                     cg::cluster_group& cluster) {
  const Pose p = at;
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
  const int tid = threadIdx.x;
  for (int i = tid; i < n_cached; i += kThreads)
    accumulate<M>(staged_edge(s_edge, cached, i), p, prm, acc);
  for (int i = n_cached + tid; i < n_mine; i += kThreads)
    accumulate<M>(loaded_edge(cp, lpa, lpb, lp_stride, valid, i), p, prm,
                  acc);
  const int lane = tid & 31, warp = tid >> 5;
  sh.red[warp][lane] = warp_transpose_sum(acc, lane);
  __syncthreads();
  if (warp == 0) {
    float b = sh.red[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) b += sh.red[w][lane];
    sh.part[parity][lane] = b;
  }
  cluster.sync();
  if (warp == 0) {
    const int n_ranks = static_cast<int>(cluster.num_blocks());
    float got[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      got[r] = r < n_ranks
                   ? cluster.map_shared_rank(&sh.part[parity][0], r)[lane]
                   : 0.0f;
    float t = got[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < n_ranks) t += got[r];
    sh.total[lane] = t;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
lm_solve_kernel(const float* __restrict__ q0, const float* __restrict__ t0,
                const float* __restrict__ cp, const float* __restrict__ lpa,
                const float* __restrict__ lpb, long long lp_stride,
                const unsigned char* __restrict__ valid, int e, int share,
                int cached, int iters, float lambda0, Params prm,
                float* __restrict__ q_out, float* __restrict__ t_out) {
  extern __shared__ float s_edge[];   // kWords x cached, word-major
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / n_ranks;   // the lane
  const int tid = threadIdx.x;
  const int lo = min(e, rank * share);
  const int n_mine = min(e, lo + share) - lo;
  const int n_cached = min(n_mine, cached);
  const long long first = b * e + lo;   // the block's first edge
  cp += 3 * first;
  lpa += lp_stride * first;
  lpb += lp_stride * first;
  valid += first;

  stage_vec3(s_edge, cached, 0, cp, 3, n_cached);
  stage_vec3(s_edge, cached, 3, lpa, lp_stride, n_cached);
  stage_vec3(s_edge, cached, 6, lpb, lp_stride, n_cached);
  stage_valid(s_edge, cached, valid, n_cached);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sh.pose.q[i] = q0[4 * b + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) sh.pose.t[i] = t0[3 * b + i];
  }
  __syncthreads();
  for (int i = tid; i < n_cached; i += kThreads) {
    Edge ed = staged_edge(s_edge, cached, i);
    prepare(ed);
    word(s_edge, cached, 9, i) = ed.de;
    word(s_edge, cached, 10, i) = ed.g0;
    word(s_edge, cached, 11, i) = ed.g1;
    word(s_edge, cached, 12, i) = ed.g2;
  }
  __syncthreads();

  pass<kFirst>(s_edge, cached, n_cached, n_mine, cp, lpa, lpb, lp_stride,
               valid, prm, sh.pose, 0, sh, cluster);
  float lam = lambda0;                 // thread 0's
  __syncwarp();
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) sh.kept[k] = sh.total[k];
  }
  for (int it = 0; it < iters; ++it) {
    if (tid == 0) {
      float delta[6];
      solve6(sh.kept, lam, delta);
      retract(sh.pose, delta, sh.cand);
    }
    __syncthreads();
    const int parity = (it + 1) & 1;
    if (it + 1 < iters)
      pass<kCandidate>(s_edge, cached, n_cached, n_mine, cp, lpa, lpb,
                       lp_stride, valid, prm, sh.cand, parity, sh, cluster);
    else
      pass<kCostOnly>(s_edge, cached, n_cached, n_mine, cp, lpa, lpb,
                      lp_stride, valid, prm, sh.cand, parity, sh, cluster);
    __syncwarp();
    if (tid == 0) {
      if (sh.total[kCost] < sh.kept[kCost]) {
        sh.pose = sh.cand;
#pragma unroll
        for (int k = 0; k < kSums; ++k) sh.kept[k] = sh.total[k];
        lam = lam * 0.5f;
      } else {
        lam = lam * 4.0f;
      }
    }
  }
  cluster.sync();                      // no block leaves while it is read
  if (rank == 0 && tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q_out[4 * b + i] = sh.pose.q[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t_out[3 * b + i] = sh.pose.t[i];
  }
}

// The launch for e edges a lane: blocks a lane (the cluster), a block's
// share of the edges, the edges it stages, its dynamic shared memory.
struct Shape {
  int cluster, share, cached;
  long long smem;
};

Shape shape_of(int e) {
  Shape s;
  const long long per_block = static_cast<long long>(kThreads) *
                              kEdgesPerThread;
  const long long want = (e + per_block - 1) / per_block;
  s.cluster = static_cast<int>(want < 1 ? 1
                                        : (want > kMaxCluster ? kMaxCluster
                                                              : want));
  const long long even = (e + s.cluster - 1) / s.cluster;
  s.share = static_cast<int>((even + kAlign - 1) / kAlign * kAlign);
  s.cached = s.share < kMaxCached ? s.share : kMaxCached;
  s.smem = 4LL * kWords * s.cached;
  return s;
}

}  // namespace

// ops/solver.lm_solve on B lanes of e edges: q0 (B, 4), t0 (B, 3), cp
// (B, e, 3) float32, lpa and lpb (B, e, 3) float32 rows lp_stride >= 3
// floats apart (lanes e rows apart), valid (B, e) bool; writes q_out
// (B, 4), t_out (B, 3).  The scalars are the plain version's, each rounded
// to float32: min_range, 1 / (max - min) and max - min (computed in
// double), delta, delta^2 and 2 delta.  One launch of B clusters; returns
// its cudaError_t.
extern "C" int liodom_lm_solve(const void* q0, const void* t0, const void* cp,
                               const void* lpa, const void* lpb,
                               long long lp_stride, const void* valid,
                               int batch, int e, int iters,
                               float lambda0, float min_range, float inv_span,
                               float span, float delta, float delta_sq,
                               float two_delta, void* q_out, void* t_out,
                               void* stream) {
  if (batch <= 0 || e < 0 || iters < 0 || lp_stride < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_of(e);
  const long long blocks = static_cast<long long>(batch) * s.cluster;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (s.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lm_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(s.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(s.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Params prm = {min_range, inv_span, span, delta, delta_sq, two_delta};
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lm_solve_kernel, static_cast<const float*>(q0),
      static_cast<const float*>(t0), static_cast<const float*>(cp),
      static_cast<const float*>(lpa), static_cast<const float*>(lpb),
      lp_stride, static_cast<const unsigned char*>(valid), e, s.share,
      s.cached, iters,
      lambda0, prm, static_cast<float*>(q_out), static_cast<float*>(t_out));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch for e edges a lane: out[0] blocks a cluster (one cluster a
// lane), out[1] threads a block, out[2] a block's share of the edges,
// out[3] the edges it keeps in shared memory (the rest are read from device
// memory each pass), out[4] its dynamic shared memory in bytes.
extern "C" int liodom_lm_solve_shape(int e, int* out) {
  const Shape s = shape_of(e < 0 ? 0 : e);
  out[0] = s.cluster;
  out[1] = kThreads;
  out[2] = s.share;
  out[3] = s.cached;
  out[4] = static_cast<int>(s.smem);
  return 0;
}
