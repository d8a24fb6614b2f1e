// K3 and K4: exact k-nearest-neighbours carrying the neighbours'
// coordinates, written by hand for Hopper (sm_90a): the register walk for
// 1 <= k <= 16, ListWalk (liodom_knn_coords_any_k) for any k.
//
// K3 replaces the TPU kernel liodom_tpu/ops/knn_pallas.py:_knn_coords_kernel
// (launched by knn_coords_pallas); K4 replaces the same kernel with
// batched=True (launched by knn_coords_pallas_batched), which runs K3 over B
// independent (query set, ref set) pairs in one launch.  For every query (an
// edge in the world frame) it returns the k smallest squared distances to the
// reference points (the matching map) and those points' coordinates,
// ascending.  The wrapper sorts the queries spatially, flags the (query tile,
// ref tile) pairs whose bounding boxes are within the accept radius, and
// displaces invalid refs by 2 * _FAR so that they are never picked within
// the radius; this kernel visits only the flagged ref tiles.
//
// What bounds it on the card: operations.  A flagged (query, ref) pair
// costs 8 FP32 operations (3 sub, 3 mul, 2 add) plus a compare; the inputs
// are ~0.5 MB a batch element.  At the bench drive's last frame the 627
// flagged tile pairs are ~2.1e7 distances, ~2.5 us at the 67 TFLOP/s
// non-tensor FP32 peak.
//
// Design: the TPU kernel walked ref tiles on a sequential grid axis and
// carried the running best-k in scratch memory between grid steps.  Here a
// cluster of blocks owns one tile of 64 spatially sorted queries and deals
// its flagged ref tiles over its blocks by rank; each block double-buffers
// its tiles with cp.async and splits every staged copy over its thread
// groups, each thread keeping a partial (d2, index) best-k; the partial
// lists merge through shared and distributed shared memory into the
// sequential walk's exact answer (knn_search.cuh, which says what held the
// earlier one-block walk back, 0.86 ms for K3).  The
// epilogue applies the wrapper steps of the TPU version: a FAR pick (d2 >
// _FAR_PICK_D2) or an invalid query reads back as _BIG, d2 is clamped at 0,
// and each row is written at its query's original index (the query sort is
// undone here).  K3 is the batch of one: blockIdx.y selects the batch
// element, whose queries, refs, flags, permutation and outputs start at
// that element's offset, so a batch element is bit-identical to a K3 launch
// on that element alone.  The kernel is a template on k; the entry points
// dispatch the caller's k to its instantiation.  Above k = 16 the wrapper
// calls liodom_knn_coords_any_k: ListWalk (knn_search.cuh), the same split
// over a cluster, partial lists in shared or device memory kept by merging
// 8-ref batches, one keyed merge into the same answer and epilogue.

#include <cuda_runtime.h>

#include "knn_search.cuh"

namespace {

using namespace liodom_knn;

template <int K>
__global__ void __launch_bounds__(CoordsWalk<K>::kThreads)
knn_coords_kernel(const float4* __restrict__ q4, const float4* __restrict__ r4,
                  const int* __restrict__ flags, const int* __restrict__ qperm,
                  int n_query, int n_e, int n_m, float* __restrict__ out_d,
                  float* __restrict__ out_c) {
  const size_t bi = blockIdx.y;
  q4 += bi * n_e * kTileE;
  r4 += bi * n_m * kTileM;
  flags += bi * n_e * n_m;
  qperm += bi * n_query;
  out_d += bi * n_query * K;
  out_c += bi * n_query * K * 3;

  const int et = blockIdx.x / kCluster;
  const int pos = et * kTileE + threadIdx.x % kTileE;   // sorted position
  const float4 q = q4[pos];                             // w = 1 if valid
  float bd[K], x[K], y[K], z[K];
  int idx[K];
  if (!CoordsWalk<K>::search(q, r4, flags + static_cast<size_t>(et) * n_m,
                             n_m, bd, idx))
    return;
  if (pos >= n_query) return;
  gather<K>(r4, idx, x, y, z);

  const size_t dst = static_cast<size_t>(qperm[pos]);
  const bool valid = q.w != 0.0f;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float d = bd[s] > kFarPickD2 ? kBig : bd[s];
    d = valid ? fmaxf(d, 0.0f) : kBig;
    out_d[dst * K + s] = d;
    out_c[(dst * K + s) * 3 + 0] = x[s];
    out_c[(dst * K + s) * 3 + 1] = y[s];
    out_c[(dst * K + s) * 3 + 2] = z[s];
  }
}

int launch_coords(const void* q4, const void* r4, const void* flags,
                  const void* qperm, void* out_d, void* out_c, int batch,
                  int n_query, int n_e, int n_m, int tile_e, int tile_m,
                  int k, void* stream) {
  if (tile_e != kTileE || tile_m != kTileM || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n_e <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return CoordsWalk<K>::launch(
        knn_coords_kernel<K>, n_e, batch, n_m, stream,
        static_cast<const float4*>(q4), static_cast<const float4*>(r4),
        static_cast<const int*>(flags), static_cast<const int*>(qperm),
        n_query, n_e, n_m, static_cast<float*>(out_d),
        static_cast<float*>(out_c));
  }));
}

// K3 and K4 on ListWalk, for any k: the same epilogue, slot by slot over
// the keyed merge of the partial lists.
__global__ void __launch_bounds__(AnyKWalk::kThreads)
knn_coords_any_k_kernel(const float4* __restrict__ q4,
                        const float4* __restrict__ r4,
                        const int* __restrict__ flags,
                        const int* __restrict__ qperm, int n_query, int n_e,
                        int n_m, int k, float* scratch,
                        float* __restrict__ out_d, float* __restrict__ out_c) {
  const size_t b = blockIdx.y;
  q4 += b * n_e * kTileE;
  r4 += b * n_m * kTileM;
  flags += b * n_e * n_m;
  qperm += b * n_query;
  out_d += b * n_query * k;
  out_c += b * n_query * k * 3;

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
      const float4 r = neighbour(r4, bi);
      float d = bd > kFarPickD2 ? kBig : bd;
      d = valid ? fmaxf(d, 0.0f) : kBig;
      out_d[dst + s] = d;
      out_c[(dst + s) * 3 + 0] = r.x;
      out_c[(dst + s) * 3 + 1] = r.y;
      out_c[(dst + s) * 3 + 2] = r.z;
    });
  }
  AnyKWalk::finish();
}

}  // namespace

// q4 (n_e * 64, 4) f32 sorted queries [x y z valid], r4 (n_m * 512, 4) f32
// encoded refs, flags (n_e, n_m) i32, qperm (n_query,) i32 sorted -> original
// -> out_d (n_query, k) f32, out_c (n_query, k, 3) f32, 1 <= k <= 16.
// tile_e and tile_m are the caller's layout and must equal the kernel's.
extern "C" int liodom_knn_coords(const void* q4, const void* r4,
                                 const void* flags, const void* qperm,
                                 void* out_d, void* out_c, int n_query,
                                 int n_e, int n_m, int tile_e, int tile_m,
                                 int k, void* stream) {
  return launch_coords(q4, r4, flags, qperm, out_d, out_c, 1, n_query, n_e,
                       n_m, tile_e, tile_m, k, stream);
}

// K4: the same over a batch of B pairs, each laid out as K3's and stacked:
// q4 (B, n_e * 64, 4), r4 (B, n_m * 512, 4), flags (B, n_e, n_m), qperm
// (B, n_query) -> out_d (B, n_query, k), out_c (B, n_query, k, 3).
extern "C" int liodom_knn_coords_batched(const void* q4, const void* r4,
                                         const void* flags, const void* qperm,
                                         void* out_d, void* out_c, int batch,
                                         int n_query, int n_e, int n_m,
                                         int tile_e, int tile_m, int k,
                                         void* stream) {
  return launch_coords(q4, r4, flags, qperm, out_d, out_c, batch, n_query,
                       n_e, n_m, tile_e, tile_m, k, stream);
}

// K3 (batch 1) and K4 at any k >= 1 on ListWalk, laid out as above.
// scratch: nullptr to keep the lists in shared memory (refused where they
// do not fit: liodom_knn_any_k_shape), else batch * n_e times the shape's
// scratch bytes a query tile of device memory for them.
extern "C" int liodom_knn_coords_any_k(const void* q4, const void* r4,
                                       const void* flags, const void* qperm,
                                       void* scratch, void* out_d,
                                       void* out_c, int batch, int n_query,
                                       int n_e, int n_m, int tile_e,
                                       int tile_m, int k, void* stream) {
  if (tile_e != kTileE || tile_m != kTileM || batch > 65535 || k < 1 ||
      (scratch == nullptr && !AnyKWalk::lists_fit(n_m, k)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_e <= 0 || batch <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(AnyKWalk::launch(
      knn_coords_any_k_kernel, n_e, batch, n_m, k, scratch == nullptr, stream,
      static_cast<const float4*>(q4), static_cast<const float4*>(r4),
      static_cast<const int*>(flags), static_cast<const int*>(qperm),
      n_query, n_e, n_m, k, static_cast<float*>(scratch),
      static_cast<float*>(out_d), static_cast<float*>(out_c)));
}

// ListWalk as built for n_m ref tiles and k neighbours (knn_search.cuh:
// ListWalk::shape): out[0..5].
extern "C" int liodom_knn_any_k_shape(int n_m, int k, int* out) {
  return AnyKWalk::shape(n_m, k, out);
}

// The walk as built (knn_search.cuh): out[0] blocks a cluster, out[1]
// thread groups a block, out[2] a block's dynamic shared memory in bytes
// for n_m ref tiles at k = 5.
extern "C" int liodom_knn_walk_shape(int n_m, int* out) {
  return CoordsWalk<5>::shape(n_m, out);
}
