// K6: exact k-NN with the line-fit gate fused into the epilogue, written
// by hand for Hopper (sm_90a): the register walk for 2 <= k <= 16,
// ListWalk (liodom_knn_lines_any_k) for any k >= 2.
//
// Replaces the TPU kernel liodom_tpu/ops/knn_pallas.py:_knn_lines_kernel
// (launched by knn_lines_pallas).  The search is K3's (knn_search.cuh: the
// flagged ref tiles of a query tile dealt over a thread-block cluster, the
// partial lists merged through distributed shared memory, the same tie
// order); then, per query and still in registers of the cluster's rank-0
// block, the line test of laser_odometry.cc:325-357: the centroid and
// un-normalised covariance of the k neighbours, the Cardano eigenvalues,
// and the gates dk < max_sq_dist, e_max > eig_ratio * e_mid and
// sep^2 > min_line_sep^2.  Out: lpa (the nearest neighbour), lpb (the second)
// and valid (the gates AND the query's own mask), each at its query's
// original index.  The (E, k, 3) neighbour planes never reach device memory.
//
// What bounds it on the card: operations, as K3 (8 FP32 operations a flagged
// (query, ref) pair) plus about 160 a query for the epilogue.  What held it
// back was K3's: the one-block walk of the busiest query tile (0.86 ms).
//
// Design: the TPU kernel computed the epilogue on the VMEM planes in the
// last grid step and needed a polynomial arccos because Mosaic has none;
// here the thread that holds its query's merged neighbours runs the
// epilogue as scalar code on its registers with the native acosf.  The
// arithmetic follows the plain version (ops/neighbors.py:_line_fit and
// sym3_eigenvalues) operation by operation, each rounded on its own
// (-fmad=false); acosf and cosf may differ from the host's in the last ulp,
// so `valid` may differ from the plain version only where e_max sits at
// eig_ratio * e_mid.  The p == 0 branch (A = qI) sets every eigenvalue to
// q, as sym3_eigenvalues does.  Like K4, the kernel runs on a (n_e *
// cluster, B) grid: a solo call is B = 1, and a batched step makes one
// launch a solve iteration.  The kernel is a template on k; the entry point
// dispatches the caller's k to its instantiation.

#include <cuda_runtime.h>

#include "knn_search.cuh"

namespace {

using namespace liodom_knn;

constexpr float kTwoThirdsPi = 2.0943951023931953f;

template <int K>
__global__ void __launch_bounds__(CoordsWalk<K>::kThreads)
knn_lines_kernel(const float4* __restrict__ q4, const float4* __restrict__ r4,
                 const int* __restrict__ flags, const int* __restrict__ qperm,
                 int n_query, int n_e, int n_m, float max_sq_dist,
                 float eig_ratio, float min_sep_sq, float* __restrict__ out_a,
                 float* __restrict__ out_b, bool* __restrict__ out_ok) {
  const size_t bi = blockIdx.y;
  q4 += bi * n_e * kTileE;
  r4 += bi * n_m * kTileM;
  flags += bi * n_e * n_m;
  qperm += bi * n_query;
  out_a += bi * n_query * 3;
  out_b += bi * n_query * 3;
  out_ok += bi * n_query;

  const int et = blockIdx.x / kCluster;
  const int pos = et * kTileE + threadIdx.x % kTileE;
  const float4 q = q4[pos];
  float bd[K], x[K], y[K], z[K];
  int idx[K];
  if (!CoordsWalk<K>::search(q, r4, flags + static_cast<size_t>(et) * n_m,
                             n_m, bd, idx))
    return;
  if (pos >= n_query) return;
  gather<K>(r4, idx, x, y, z);

  // centroid and un-normalised covariance (sums in neighbour order)
  float mx = x[0], my = y[0], mz = z[0];
#pragma unroll
  for (int s = 1; s < K; ++s) {
    mx = mx + x[s];
    my = my + y[s];
    mz = mz + z[s];
  }
  mx = mx / static_cast<float>(K);
  my = my / static_cast<float>(K);
  mz = mz / static_cast<float>(K);
  float a00 = 0.0f, a01 = 0.0f, a02 = 0.0f, a11 = 0.0f, a12 = 0.0f, a22 = 0.0f;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float cx = x[s] - mx, cy = y[s] - my, cz = z[s] - mz;
    a00 = a00 + cx * cx;
    a01 = a01 + cx * cy;
    a02 = a02 + cx * cz;
    a11 = a11 + cy * cy;
    a12 = a12 + cy * cz;
    a22 = a22 + cz * cz;
  }

  // Cardano, the chain of sym3_eigenvalues
  const float p1 = (a01 * a01 + a02 * a02) + a12 * a12;
  const float qm = ((a00 + a11) + a22) / 3.0f;
  const float d0 = a00 - qm, d1 = a11 - qm, d2 = a22 - qm;
  const float p2 = ((d0 * d0 + d1 * d1) + d2 * d2) + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, 0.0f));
  const float sp = p > 0.0f ? p : 1.0f;
  const float b00 = d0 / sp, b11 = d1 / sp, b22 = d2 / sp;
  const float b01 = a01 / sp, b02 = a02 / sp, b12 = a12 / sp;
  const float det = (b00 * (b11 * b22 - b12 * b12)
                     - b01 * (b01 * b22 - b12 * b02))
                    + b02 * (b01 * b12 - b11 * b02);
  const float r = fminf(fmaxf(det / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  float e_max = qm + (2.0f * p) * cosf(phi);
  const float e_min = qm + (2.0f * p) * cosf(phi + kTwoThirdsPi);
  float e_mid = (3.0f * qm - e_max) - e_min;
  if (!(p > 0.0f)) {
    e_max = qm;
    e_mid = qm;
  }

  // the endpoints: the nearest neighbour and the second (itself at k = 1)
  const int s1 = K > 1 ? 1 : 0;
  const float sx = x[0] - x[s1], sy = y[0] - y[s1], sz = z[0] - z[s1];
  const float sep_sq = (sx * sx + sy * sy) + sz * sz;
  const bool ok = (q.w != 0.0f) && (bd[K - 1] < max_sq_dist)
                  && (e_max > eig_ratio * e_mid) && (sep_sq > min_sep_sq);

  const size_t dst = static_cast<size_t>(qperm[pos]);
  out_a[dst * 3 + 0] = x[0];
  out_a[dst * 3 + 1] = y[0];
  out_a[dst * 3 + 2] = z[0];
  out_b[dst * 3 + 0] = x[s1];
  out_b[dst * 3 + 1] = y[s1];
  out_b[dst * 3 + 2] = z[s1];
  out_ok[dst] = ok;
}

// K6 on ListWalk, for any k >= 2: the neighbours read from r4 by the
// indices of the list in memory, the sums in neighbour order, then the
// chain of knn_lines_kernel above, operation for operation.
__global__ void __launch_bounds__(ListWalk::kThreads)
knn_lines_any_k_kernel(const float4* __restrict__ q4,
                       const float4* __restrict__ r4,
                       const int* __restrict__ flags,
                       const int* __restrict__ qperm, int n_query, int n_e,
                       int n_m, int k, float* scratch, float max_sq_dist,
                       float eig_ratio, float min_sep_sq,
                       float* __restrict__ out_a, float* __restrict__ out_b,
                       bool* __restrict__ out_ok) {
  const size_t b = blockIdx.y;
  q4 += b * n_e * kTileE;
  r4 += b * n_m * kTileM;
  flags += b * n_e * n_m;
  qperm += b * n_query;
  out_a += b * n_query * 3;
  out_b += b * n_query * 3;
  out_ok += b * n_query;

  const int et = blockIdx.x;
  const int pos = et * kTileE + threadIdx.x;
  const float4 q = q4[pos];
  float* ld;
  int* li;
  ListWalk::search(q, r4, flags + static_cast<size_t>(et) * n_m, n_m, k,
                   tile_lists(scratch, k, n_e), ld, li);
  if (pos >= n_query) return;

  const float4 n0 = neighbour(r4, li[0]);
  const float4 n1 = neighbour(r4, li[kTileE]);
  float mx = n0.x, my = n0.y, mz = n0.z;
  for (int s = 1; s < k; ++s) {
    const float4 r = neighbour(r4, li[s * kTileE]);
    mx = mx + r.x;
    my = my + r.y;
    mz = mz + r.z;
  }
  mx = mx / static_cast<float>(k);
  my = my / static_cast<float>(k);
  mz = mz / static_cast<float>(k);
  float a00 = 0.0f, a01 = 0.0f, a02 = 0.0f, a11 = 0.0f, a12 = 0.0f, a22 = 0.0f;
  for (int s = 0; s < k; ++s) {
    const float4 r = neighbour(r4, li[s * kTileE]);
    const float cx = r.x - mx, cy = r.y - my, cz = r.z - mz;
    a00 = a00 + cx * cx;
    a01 = a01 + cx * cy;
    a02 = a02 + cx * cz;
    a11 = a11 + cy * cy;
    a12 = a12 + cy * cz;
    a22 = a22 + cz * cz;
  }

  const float p1 = (a01 * a01 + a02 * a02) + a12 * a12;
  const float qm = ((a00 + a11) + a22) / 3.0f;
  const float d0 = a00 - qm, d1 = a11 - qm, d2 = a22 - qm;
  const float p2 = ((d0 * d0 + d1 * d1) + d2 * d2) + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, 0.0f));
  const float sp = p > 0.0f ? p : 1.0f;
  const float b00 = d0 / sp, b11 = d1 / sp, b22 = d2 / sp;
  const float b01 = a01 / sp, b02 = a02 / sp, b12 = a12 / sp;
  const float det = (b00 * (b11 * b22 - b12 * b12)
                     - b01 * (b01 * b22 - b12 * b02))
                    + b02 * (b01 * b12 - b11 * b02);
  const float r = fminf(fmaxf(det / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  float e_max = qm + (2.0f * p) * cosf(phi);
  const float e_min = qm + (2.0f * p) * cosf(phi + kTwoThirdsPi);
  float e_mid = (3.0f * qm - e_max) - e_min;
  if (!(p > 0.0f)) {
    e_max = qm;
    e_mid = qm;
  }

  const float sx = n0.x - n1.x, sy = n0.y - n1.y, sz = n0.z - n1.z;
  const float sep_sq = (sx * sx + sy * sy) + sz * sz;
  const bool ok = (q.w != 0.0f) && (ld[(k - 1) * kTileE] < max_sq_dist)
                  && (e_max > eig_ratio * e_mid) && (sep_sq > min_sep_sq);

  const size_t dst = static_cast<size_t>(qperm[pos]);
  out_a[dst * 3 + 0] = n0.x;
  out_a[dst * 3 + 1] = n0.y;
  out_a[dst * 3 + 2] = n0.z;
  out_b[dst * 3 + 0] = n1.x;
  out_b[dst * 3 + 1] = n1.y;
  out_b[dst * 3 + 2] = n1.z;
  out_ok[dst] = ok;
}

}  // namespace

// B stacked (query set, ref set) pairs laid out as K3's: q4 (B, n_e * 64, 4),
// r4 (B, n_m * 512, 4), flags (B, n_e, n_m) i32, qperm (B, n_query) i32 ->
// out_a, out_b (B, n_query, 3) f32, out_ok (B, n_query) bool; 1 <= k <= 16.
extern "C" int liodom_knn_lines(const void* q4, const void* r4,
                                const void* flags, const void* qperm,
                                void* out_a, void* out_b, void* out_ok,
                                int batch, int n_query, int n_e, int n_m,
                                int tile_e, int tile_m, int k,
                                float max_sq_dist, float eig_ratio,
                                float min_sep_sq, void* stream) {
  if (tile_e != kTileE || tile_m != kTileM || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n_e <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return CoordsWalk<K>::launch(
        knn_lines_kernel<K>, n_e, batch, n_m, stream,
        static_cast<const float4*>(q4), static_cast<const float4*>(r4),
        static_cast<const int*>(flags), static_cast<const int*>(qperm),
        n_query, n_e, n_m, max_sq_dist, eig_ratio, min_sep_sq,
        static_cast<float*>(out_a), static_cast<float*>(out_b),
        static_cast<bool*>(out_ok));
  }));
}

// The walk as built (knn_search.cuh), as liodom_knn_coords' library reports
// it: blocks a cluster, thread groups a block, dynamic shared memory for n_m
// ref tiles at k = 5.
extern "C" int liodom_knn_walk_shape(int n_m, int* out) {
  return CoordsWalk<5>::shape(n_m, out);
}

// K6 at any k >= 2 on ListWalk, laid out as liodom_knn_lines.  scratch:
// nullptr to keep the lists in shared memory (refused where they do not
// fit: liodom_knn_any_k_shape), else batch * n_e * 2 k 64 words of device
// memory for them.
extern "C" int liodom_knn_lines_any_k(const void* q4, const void* r4,
                                      const void* flags, const void* qperm,
                                      void* scratch, void* out_a, void* out_b,
                                      void* out_ok, int batch, int n_query,
                                      int n_e, int n_m, int tile_e,
                                      int tile_m, int k, float max_sq_dist,
                                      float eig_ratio, float min_sep_sq,
                                      void* stream) {
  if (tile_e != kTileE || tile_m != kTileM || batch > 65535 || k < 2 ||
      (scratch == nullptr && !ListWalk::lists_fit(n_m, k)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_e <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(ListWalk::launch(
      knn_lines_any_k_kernel, n_e, batch, n_m, k, scratch == nullptr, stream,
      static_cast<const float4*>(q4), static_cast<const float4*>(r4),
      static_cast<const int*>(flags), static_cast<const int*>(qperm),
      n_query, n_e, n_m, k, static_cast<float*>(scratch), max_sq_dist,
      eig_ratio, min_sep_sq, static_cast<float*>(out_a),
      static_cast<float*>(out_b), static_cast<bool*>(out_ok)));
}

// ListWalk as built for n_m ref tiles and k neighbours.
extern "C" int liodom_knn_any_k_shape(int n_m, int k, int* out) {
  return ListWalk::shape(n_m, k, out);
}
