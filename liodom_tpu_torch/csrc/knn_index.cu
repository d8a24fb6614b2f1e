// K5: exact k-nearest-neighbours returning the neighbours' indices,
// written by hand for Hopper (sm_90a): the register walk for 1 <= k <= 16,
// ListWalk (liodom_knn_index_any_k) for any k.
//
// Replaces the TPU kernel liodom_tpu/ops/knn_pallas.py:_knn_kernel (launched
// by knn_pallas), the search of the map-sharded correspondence step
// (liodom_tpu/parallel/sharded.py:54).  For every query (an edge in the world
// frame) it returns the k smallest squared distances to the reference points
// (this rank's shard of the matching map) and those points' row indices,
// ascending.  Each rank then gathers its neighbours' rows and the ranks merge
// their candidates.
//
// What bounds it on the card: operations.  The sharded step searches without
// a radius, so every non-empty (query tile, ref tile) pair is visited:
// 5632 x 44544 pairs at 8 FP32 operations (3 sub, 3 mul, 2 add) each are
// ~2.0 GFLOP, ~30 us at the 67 TFLOP/s non-tensor FP32 peak; the inputs are
// under 1 MB.
//
// What held the earlier design back (0.18273 ms at the bench shape, NVIDIA
// H100 80GB HBM3, 700 W): 88 query tiles x 16 splits of one 64-thread block
// each, a branchy bubble insert for every ref, the 16 partial best-5 lists
// of every query written to device memory (~3.6 MB) and read back by a
// second merge kernel.
//
// Design: the TPU kernel walked the ref tiles on a sequential grid axis and
// carried the running best-k (distance, column) in scratch memory; on equal
// distances the lowest column wins, the carried best ahead of a new tile.
// That is the k smallest (d2, index) pairs in lexicographic order.  Here the
// search is the cluster walk of knn_search.cuh that K3, K4 and K6 share: a
// query tile's flagged ref tiles dealt by rank over a cluster of
// kIndexCluster blocks of kIndexGroups thread groups, cp.async double
// buffering, 8 distances behind one minimum test, a branch-free insert of
// only the refs that beat the K-th best, and the partial lists merged in
// (d2, index) order through shared and distributed shared memory into
// cluster rank 0: the sequential walk's exact answer, one launch and no
// partial list in device memory.  Without a radius the flags are dense and
// even (every non-empty tile pair, ~63 of 87 ref tiles a query tile at the
// bench shape) and the refs unsorted, so fresh lists take many refs in:
// pushing only the refs that beat the K-th best took K5 from 0.1929 to
// 0.1375 ms (scripts/knn_walk_experiment.py, one call).  The split is K5's
// own, chosen by timing (the experiment builds copies with other values:
// 4 x 2, 4 x 4 and 16 x 2 were slower than 8 x 2).  Rank
// 0's epilogue applies the wrapper steps of the TPU version: a FAR pick (an
// invalid or padding ref, d2 > _FAR_PICK_D2) or an invalid query reads back
// as _BIG, d2 is clamped at 0,
// the index is clamped to m - 1 (an empty slot reads index 0, the TPU
// kernel's initial index), and each row is written at its query's original
// index through qperm.  A batch of B independent (query set, ref set) pairs
// runs on the grid's second axis.  The kernel is a template on k; the entry
// point dispatches the caller's k to its instantiation.

#include <cuda_runtime.h>

#include "knn_search.cuh"

namespace {

using namespace liodom_knn;

constexpr int kIndexCluster = 8;   // blocks a query tile
constexpr int kIndexGroups = 2;    // thread groups a block

template <int K>
using IndexWalk = Walk<K, kIndexCluster, kIndexGroups>;

template <int K>
__global__ void __launch_bounds__(IndexWalk<K>::kThreads)
knn_index_kernel(const float4* __restrict__ q4, const float4* __restrict__ r4,
                 const int* __restrict__ flags, const int* __restrict__ qperm,
                 int n_query, int n_e, int n_m, int m,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
  const size_t b = blockIdx.y;
  q4 += b * n_e * kTileE;
  r4 += b * n_m * kTileM;
  flags += b * n_e * n_m;
  qperm += b * n_query;
  out_d += b * n_query * K;
  out_i += b * n_query * K;

  const int et = blockIdx.x / kIndexCluster;
  const int pos = et * kTileE + threadIdx.x % kTileE;
  const float4 q = q4[pos];                             // w = 1 if valid
  float bd[K];
  int bi[K];
  if (!IndexWalk<K>::search(q, r4, flags + static_cast<size_t>(et) * n_m,
                            n_m, bd, bi))
    return;
  if (pos >= n_query) return;

  const size_t dst = static_cast<size_t>(qperm[pos]);
  const bool valid = q.w != 0.0f;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float d = bd[s] > kFarPickD2 ? kBig : bd[s];
    out_d[dst * K + s] = valid ? fmaxf(d, 0.0f) : kBig;
    out_i[dst * K + s] = bi[s] == kNone ? 0 : min(bi[s], m - 1);
  }
}

// K5 on ListWalk, for any k: the same epilogue, slot by slot over the keyed
// merge of the partial lists.
__global__ void __launch_bounds__(AnyKWalk::kThreads)
knn_index_any_k_kernel(const float4* __restrict__ q4,
                       const float4* __restrict__ r4,
                       const int* __restrict__ flags,
                       const int* __restrict__ qperm, int n_query, int n_e,
                       int n_m, int m, int k, float* scratch,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  const size_t b = blockIdx.y;
  q4 += b * n_e * kTileE;
  r4 += b * n_m * kTileM;
  flags += b * n_e * n_m;
  qperm += b * n_query;
  out_d += b * n_query * k;
  out_i += b * n_query * k;

  const int et = blockIdx.x / AnyKWalk::kClusterBlocks;
  const int pos = et * kTileE + threadIdx.x % kTileE;
  const float4 q = q4[pos];
  AnyKWalk::Lists lists;
  if (AnyKWalk::search(q, r4, flags + static_cast<size_t>(et) * n_m, n_m, k,
                       scratch, lists) &&
      pos < n_query) {
    const size_t dst = static_cast<size_t>(qperm[pos]) * k;
    const bool valid = q.w != 0.0f;
    AnyKWalk::merged(lists, [&](int s, float bd, int bi) {
      const float d = bd > kFarPickD2 ? kBig : bd;
      out_d[dst + s] = valid ? fmaxf(d, 0.0f) : kBig;
      out_i[dst + s] = bi == kNone ? 0 : min(bi, m - 1);
    });
  }
  AnyKWalk::finish();
}

}  // namespace

// B stacked (query set, ref set) pairs: q4 (B, n_e * 64, 4) f32 queries
// [x y z valid], r4 (B, n_m * 512, 4) f32 encoded refs, flags (B, n_e, n_m)
// i32, qperm (B, n_query) i32 position -> original query index ->
// out_d (B, n_query, k) f32, out_i (B, n_query, k) i32 (indices into the
// r4 rows, clamped to m - 1), 1 <= k <= 16.  One launch on the stream, no
// sync.  tile_e and tile_m are the caller's layout and must equal the
// kernel's.
extern "C" int liodom_knn_index(const void* q4, const void* r4,
                                const void* flags, const void* qperm,
                                void* out_d, void* out_i, int batch,
                                int n_query, int n_e, int n_m, int m,
                                int tile_e, int tile_m, int k, void* stream) {
  if (tile_e != kTileE || tile_m != kTileM || batch > 65535 || m < 1 ||
      n_query > n_e * kTileE || k < 1 || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_e <= 0 || batch <= 0 || n_query <= 0)
    return static_cast<int>(cudaSuccess);
  return static_cast<int>(with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return IndexWalk<K>::launch(
        knn_index_kernel<K>, n_e, batch, n_m, stream,
        static_cast<const float4*>(q4), static_cast<const float4*>(r4),
        static_cast<const int*>(flags), static_cast<const int*>(qperm),
        n_query, n_e, n_m, m, static_cast<float*>(out_d),
        static_cast<int*>(out_i));
  }));
}

// K5 at any k >= 1 on ListWalk, laid out as liodom_knn_index.  scratch:
// nullptr to keep the lists in shared memory (refused where they do not
// fit: liodom_knn_any_k_shape), else batch * n_e times the shape's scratch
// bytes a query tile of device memory for them.
extern "C" int liodom_knn_index_any_k(const void* q4, const void* r4,
                                      const void* flags, const void* qperm,
                                      void* scratch, void* out_d,
                                      void* out_i, int batch, int n_query,
                                      int n_e, int n_m, int m, int tile_e,
                                      int tile_m, int k, void* stream) {
  if (tile_e != kTileE || tile_m != kTileM || batch > 65535 || m < 1 ||
      n_query > n_e * kTileE || k < 1 ||
      (scratch == nullptr && !AnyKWalk::lists_fit(n_m, k)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_e <= 0 || batch <= 0 || n_query <= 0)
    return static_cast<int>(cudaSuccess);
  return static_cast<int>(AnyKWalk::launch(
      knn_index_any_k_kernel, n_e, batch, n_m, k, scratch == nullptr, stream,
      static_cast<const float4*>(q4), static_cast<const float4*>(r4),
      static_cast<const int*>(flags), static_cast<const int*>(qperm),
      n_query, n_e, n_m, m, k, static_cast<float*>(scratch),
      static_cast<float*>(out_d), static_cast<int*>(out_i)));
}

// ListWalk as built for n_m ref tiles and k neighbours.
extern "C" int liodom_knn_any_k_shape(int n_m, int k, int* out) {
  return AnyKWalk::shape(n_m, k, out);
}

// K5's walk as built: out[0] blocks a cluster, out[1] thread groups a
// block, out[2] a block's dynamic shared memory in bytes for n_m ref tiles
// at k = 5.
extern "C" int liodom_knn_walk_shape(int n_m, int* out) {
  return IndexWalk<5>::shape(n_m, out);
}
