// K5: exact 5-nearest-neighbours returning the neighbours' indices, written
// by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel liodom_tpu/ops/knn_pallas.py:_knn_kernel (launched
// by knn_pallas), the search of the map-sharded correspondence step
// (liodom_tpu/parallel/sharded.py:54).  For every query (an edge in the world
// frame) it returns the 5 smallest squared distances to the reference points
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
// Design: the TPU kernel walked the ref tiles on a sequential grid axis and
// carried the running best-5 (distance, column) in scratch memory; on equal
// distances the lowest column wins, the carried best ahead of a new tile.
// That is the 5 smallest (d2, index) pairs in lexicographic order.  Here the
// ref tiles of a query tile are dealt round-robin to `splits` blocks, so that
// the unpruned search fills the card (88 query tiles alone would leave 44 of
// 132 SMs idle and the rest at 2 warps).  Each block keeps one thread per
// query, stages its flagged ref tiles in shared memory as float4 and keeps a
// partial best-5 in registers by insertion with a strict '<' (its refs come
// in ascending index, so a tie keeps the earlier).  A second kernel merges the
// partial lists of every split by (d2, index) order, which gives exactly the
// sequential walk's answer whatever the split.  The distance is rounded per
// operation (__fsub_rn/__fmul_rn/__fadd_rn, -fmad=false) in the plain
// version's order.  The merge applies the wrapper steps of the TPU version:
// a FAR pick (an invalid or padding ref, d2 > _FAR_PICK_D2) or an invalid
// query reads back as _BIG, d2 is clamped at 0, the index is clamped to
// m - 1, and each row is written at its query's original index.  A batch of
// B independent (query set, ref set) pairs runs on blockIdx.z.

#include <cuda_runtime.h>

namespace {

constexpr int kTileE = 64;    // queries per block, one thread each
constexpr int kTileM = 512;   // refs per staged tile (8 KB of float4)
constexpr int kK = 5;
constexpr int kMaxSplits = 64;
constexpr int kMergeThreads = 256;
constexpr float kBig = 1e30f;
constexpr float kFarPickD2 = 1.0e6f;

// Partial best-5 of one split: q4 (B, n_e * 64, 4) sorted-or-not queries
// [x y z valid], r4 (B, n_m * 512, 4) encoded refs, flags (B, n_e, n_m) ->
// part_d / part_i (B, splits, n_e * 64, 5).
__global__ void __launch_bounds__(kTileE)
knn_index_partial(const float4* __restrict__ q4, const float4* __restrict__ r4,
                  const int* __restrict__ flags, int n_e, int n_m, int splits,
                  float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 tile[kTileM];
  const int et = blockIdx.x;
  const int s = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t ep = static_cast<size_t>(n_e) * kTileE;
  const int pos = et * kTileE + threadIdx.x;
  const float4 q = q4[b * ep + pos];
  const float4* refs = r4 + b * static_cast<size_t>(n_m) * kTileM;
  const int* row_flags = flags + (b * n_e + et) * static_cast<size_t>(n_m);

  float bd[kK];
  int bi[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    bd[j] = kBig;
    bi[j] = 0;
  }
  for (int mt = s; mt < n_m; mt += splits) {
    if (row_flags[mt] == 0) continue;          // uniform across the block
    __syncthreads();                           // previous tile fully read
    const float4* src = refs + static_cast<size_t>(mt) * kTileM;
    for (int i = threadIdx.x; i < kTileM; i += kTileE) tile[i] = src[i];
    __syncthreads();
    const int base = mt * kTileM;
#pragma unroll 4
    for (int i = 0; i < kTileM; ++i) {
      const float4 r = tile[i];
      const float dx = __fsub_rn(q.x, r.x);
      const float dy = __fsub_rn(q.y, r.y);
      const float dz = __fsub_rn(q.z, r.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < bd[kK - 1]) {
        bd[kK - 1] = d;
        bi[kK - 1] = base + i;
#pragma unroll
        for (int j = kK - 1; j > 0; --j) {
          if (bd[j] < bd[j - 1]) {     // strict: ties keep the earlier entry
            const float td = bd[j]; bd[j] = bd[j - 1]; bd[j - 1] = td;
            const int ti = bi[j]; bi[j] = bi[j - 1]; bi[j - 1] = ti;
          }
        }
      }
    }
  }
  const size_t dst = ((b * splits + s) * ep + pos) * kK;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    part_d[dst + j] = bd[j];
    part_i[dst + j] = bi[j];
  }
}

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Merge of the splits' partial lists in (d2, index) order, then the
// wrapper's read-back rules; one thread per (batch element, query).
__global__ void __launch_bounds__(kMergeThreads)
knn_index_merge(const float* __restrict__ part_d,
                const int* __restrict__ part_i, const float4* __restrict__ q4,
                const int* __restrict__ qperm, int batch, int n_query, int n_e,
                int splits, int m, float* __restrict__ out_d,
                int* __restrict__ out_i) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kMergeThreads +
                   threadIdx.x;
  if (t >= static_cast<size_t>(batch) * n_query) return;
  const size_t b = t / n_query;
  const int pos = static_cast<int>(t % n_query);
  const size_t ep = static_cast<size_t>(n_e) * kTileE;

  float bd[kK];
  int bi[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    bd[j] = kBig;
    bi[j] = 0;
  }
  for (int s = 0; s < splits; ++s) {
    const size_t src = ((b * splits + s) * ep + pos) * kK;
    for (int c = 0; c < kK; ++c) {
      const float d = part_d[src + c];
      const int i = part_i[src + c];
      if (!before(d, i, bd[kK - 1], bi[kK - 1])) break;   // list ascending
      bd[kK - 1] = d;
      bi[kK - 1] = i;
#pragma unroll
      for (int j = kK - 1; j > 0; --j) {
        if (before(bd[j], bi[j], bd[j - 1], bi[j - 1])) {
          const float td = bd[j]; bd[j] = bd[j - 1]; bd[j - 1] = td;
          const int ti = bi[j]; bi[j] = bi[j - 1]; bi[j - 1] = ti;
        }
      }
    }
  }
  const bool valid = q4[b * ep + pos].w != 0.0f;
  const size_t dst = (b * n_query + static_cast<size_t>(
                          qperm[b * n_query + pos])) * kK;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    float d = bd[j] > kFarPickD2 ? kBig : bd[j];
    out_d[dst + j] = valid ? fmaxf(d, 0.0f) : kBig;
    out_i[dst + j] = bi[j] < m - 1 ? bi[j] : m - 1;
  }
}

}  // namespace

// B stacked (query set, ref set) pairs: q4 (B, n_e * 64, 4) f32 queries
// [x y z valid], r4 (B, n_m * 512, 4) f32 encoded refs, flags (B, n_e, n_m)
// i32, qperm (B, n_query) i32 position -> original query index; scratch
// part_d (B, splits, n_e * 64, 5) f32 and part_i (same) i32 ->
// out_d (B, n_query, 5) f32, out_i (B, n_query, 5) i32 (indices into the
// r4 rows, clamped to m - 1).  Two launches on the stream, no sync.
// tile_e, tile_m and k are the caller's layout and must equal the kernel's.
extern "C" int liodom_knn_index(const void* q4, const void* r4,
                                const void* flags, const void* qperm,
                                void* part_d, void* part_i, void* out_d,
                                void* out_i, int batch, int n_query, int n_e,
                                int n_m, int m, int splits, int tile_e,
                                int tile_m, int k, void* stream) {
  if (tile_e != kTileE || tile_m != kTileM || k != kK || batch > 65535 ||
      splits < 1 || splits > kMaxSplits || m < 1 ||
      n_query > n_e * kTileE)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_e <= 0 || batch <= 0 || n_query <= 0)
    return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  knn_index_partial<<<dim3(n_e, splits, batch), kTileE, 0, st>>>(
      static_cast<const float4*>(q4), static_cast<const float4*>(r4),
      static_cast<const int*>(flags), n_e, n_m, splits,
      static_cast<float*>(part_d), static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(batch) * n_query;
  const unsigned blocks =
      static_cast<unsigned>((rows + kMergeThreads - 1) / kMergeThreads);
  knn_index_merge<<<blocks, kMergeThreads, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<const float4*>(q4), static_cast<const int*>(qperm), batch,
      n_query, n_e, splits, m, static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
