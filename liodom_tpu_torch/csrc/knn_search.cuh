// The exact 5-NN search shared by K3/K4 (knn_coords.cu) and K6
// (knn_lines.cu): a query tile's flagged ref tiles dealt over the blocks of
// a thread-block cluster, each staged tile split over the block's thread
// groups, the partial lists merged through shared and distributed shared
// memory.
//
// What held the earlier walk back (NVIDIA H100 80GB HBM3, 700 W; K3 at the
// bench drive's last frame, 627 of 88 x 55 tile pairs flagged): one block
// of 64 threads walked every flagged ref tile of its query tile in turn,
// staging 512 refs, a barrier, then 512 dependent (distance, compare,
// insert) steps a thread, ~63 cycles each.  The flagged tiles per query
// tile are uneven (max 47, mean 7.1: a 2 m sort cell can put points 88 m
// apart in one tile), so the one block of the busiest tile, 47 x 512 ref
// steps, set the kernel's 0.86 ms while 87 blocks had finished; 88 blocks
// of 2 warps left 44 SMs idle and the rest at 2 of 64 warp slots; staging
// never overlapped the search.
//
// This design:
// - One cluster of kCluster blocks per query tile (grid (n_e * kCluster,
//   B)).  Every block ranks the flagged tiles of its query tile's flag row
//   (__ballot_sync / __popc, into shared memory) and takes those whose rank
//   is its cluster rank modulo kCluster: dealt by rank, not by tile index,
//   so bunched flags spread evenly (the busiest tile's 47 become at most 6
//   a block).
// - A block is kGroups groups of 64 threads, one thread per query in each
//   group; every staged tile is split into kGroups runs, one a group, so a
//   thread scans 512 / kGroups refs a tile and all groups share one double
//   buffer.  (Dealing whole tiles to the groups instead
//   gave each group its own buffers and one thread whole tiles: K3 0.0731
//   and K4 0.1878 ms at 8 x 2 against this design's 0.0680 and 0.1604 in
//   one call, scripts/knn_walk_experiment.py.)
// - Each thread keeps a partial best-5 of (d2, ref index) in registers,
//   inserting with a strict '<' over its refs in ascending index order, so
//   its list is exactly its own 5 smallest (d2, index) pairs.  It computes
//   16 distances at once and tests their minimum against its 5th best, and
//   inserts without a branch (each slot's compare independent), so a ref
//   does not wait on the previous ref's compare and bubble.
// - The block double-buffers its tiles in dynamic shared memory with
//   cp.async (16 bytes a thread): tile t + 1 lands while tile t is
//   searched.
// - The merge never touches device memory: a block's groups merge through
//   its shared memory, then after cluster.sync() cluster rank 0 reads the
//   other blocks' lists through distributed shared memory
//   (map_shared_rank).  Merging in (d2, index) order gives exactly the
//   sequential walk's answer whatever the split: the 5 lexicographically
//   smallest (d2, index) pairs of the flagged tiles, the TPU kernel's tie
//   order (carried best first, then the lower column).  Rank 0 then reads
//   the 5 neighbours' encoded coordinates from r4 by index.
// - The distance is rounded per operation (__fsub_rn/__fmul_rn/__fadd_rn,
//   -fmad=false) in the plain version's order, (dx*dx + dy*dy) + dz*dz.
//   No tensor cores: the |q|^2 - 2 q.r + |r|^2 form on wgmma / TF32 rounds
//   differently and would change which neighbour wins a near-tie, and the
//   bar is bit-exact neighbour choice.
//
// The result does not depend on kCluster and kGroups; 8 and 2 were chosen
// by timing other splits (scripts/knn_walk_experiment.py, which builds
// copies of this header with other values).  A cluster above 8 blocks is
// launched with the non-portable cluster size allowed.
// liodom_knn_walk_shape reports the split and a block's dynamic shared
// memory from the built library.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace liodom_knn {

namespace cg = cooperative_groups;

constexpr int kTileE = 64;    // queries a tile, one thread each in a group
constexpr int kTileM = 512;   // refs a ref tile (8 KB of float4)
constexpr int kK = 5;
constexpr int kCluster = 8;                    // blocks a query tile
constexpr int kGroups = 2;                     // thread groups a block
constexpr int kRun = kTileM / kGroups;         // refs a group scans a tile
constexpr int kThreads = kGroups * kTileE;
constexpr int kBatch = 16;                     // distances a list test
constexpr int kNone = 0x7fffffff;              // index of an empty slot
constexpr float kBig = 1e30f;
constexpr float kFarPickD2 = 1.0e6f;
// the staging buffers, which hold the groups' partial lists after the walk
constexpr size_t kListBytes = 2 * sizeof(float) * kK * kTileE;
constexpr size_t kBufBytes =
    2 * kTileM * sizeof(float4) > kGroups * kListBytes
        ? 2 * kTileM * sizeof(float4) : kGroups * kListBytes;
// a block's shared memory (227 KB) less the static merge list
constexpr size_t kMaxSmem = 232448 - kListBytes - 16;

static_assert(kCluster >= 1 && kCluster <= 16, "cluster of 1-16 blocks");
static_assert(kTileM % kThreads == 0 && kRun % kBatch == 0,
              "a tile splits into whole copies a thread, whole batches a group");

struct Best {
  float d[kK], x[kK], y[kK], z[kK];
};

// Dynamic shared memory of a block: the staging buffers, then the ranked
// list of the flagged tiles.
inline size_t smem_bytes(int n_m) { return kBufBytes + sizeof(int) * n_m; }

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, i) into the ascending (d2, index) list if it is before the
// last entry.
__device__ __forceinline__ void insert(float d, int i, float (&bd)[kK],
                                       int (&bi)[kK]) {
  if (!before(d, i, bd[kK - 1], bi[kK - 1])) return;
  bd[kK - 1] = d;
  bi[kK - 1] = i;
#pragma unroll
  for (int s = kK - 1; s > 0; --s) {
    if (before(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
      const float t = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = t;
      const int u = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = u;
    }
  }
}

// Merge an ascending list whose slot s is (d[s * stride], idx[s * stride]).
__device__ __forceinline__ void merge(const float* d, const int* idx,
                                      int stride, float (&bd)[kK],
                                      int (&bi)[kK]) {
  for (int s = 0; s < kK; ++s) {
    const float ds = d[s * stride];
    const int is = idx[s * stride];
    if (!before(ds, is, bd[kK - 1], bi[kK - 1])) break;   // list ascending
    insert(ds, is, bd, bi);
  }
}

// Start the copy of one ref tile into shared memory, 16 bytes a thread.
__device__ __forceinline__ void stage(float4* dst, const float4* src) {
#pragma unroll
  for (int c = 0; c < kTileM / kThreads; ++c) {
    const int i = c * kThreads + threadIdx.x;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + i)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Insert (d, i) after every entry <= d (a strict '<': ties keep the
// earlier entry), the last falling off; d >= bd[kK - 1] or NaN changes
// nothing.  Without a branch: the slots' compares are independent.
__device__ __forceinline__ void push(float d, int i, float (&bd)[kK],
                                     int (&bi)[kK]) {
  bool c[kK];
#pragma unroll
  for (int s = 0; s < kK; ++s) c[s] = d < bd[s];   // true from the slot on
#pragma unroll
  for (int s = kK - 1; s > 0; --s) {
    bd[s] = c[s - 1] ? bd[s - 1] : (c[s] ? d : bd[s]);
    bi[s] = c[s - 1] ? bi[s - 1] : (c[s] ? i : bi[s]);
  }
  bd[0] = c[0] ? d : bd[0];
  bi[0] = c[0] ? i : bi[0];
}

// The staged refs base .. base + kRun - 1 into the list, in index order.
// The distances of kBatch refs are computed first, independent of the list,
// and only a batch whose minimum beats the 5th best is inserted: a batch
// without d < bd[kK - 1] changes nothing, so the answer is the ref-by-ref
// walk's.
__device__ __forceinline__ void scan(const float4 q, const float4* refs,
                                     int base, float (&bd)[kK],
                                     int (&bi)[kK]) {
  for (int i0 = 0; i0 < kRun; i0 += kBatch) {
    float d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float4 r = refs[i0 + u];
      const float dx = __fsub_rn(q.x, r.x);
      const float dy = __fsub_rn(q.y, r.y);
      const float dz = __fsub_rn(q.z, r.z);
      d[u] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                       __fmul_rn(dz, dz));
    }
    float lo = d[0];                     // fminf skips a NaN, never enters
#pragma unroll
    for (int u = 1; u < kBatch; ++u) lo = fminf(lo, d[u]);
    if (!(lo < bd[kK - 1])) continue;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) push(d[u], base + i0 + u, bd, bi);
  }
}

// The best kK refs of the flagged tiles for query q (this thread's query of
// its block's query tile), in (d2, index) order.  Every thread of every
// block of the cluster must call it (it syncs the cluster).  row_flags is
// the (n_m,) flag row of the cluster's query tile, r4 the (n_m * 512, 4)
// encoded refs.  Returns true on the thread that holds the merged answer
// (cluster rank 0, group 0), with b filled: d2 ascending and each
// neighbour's encoded coordinates read from r4 (kBig and 0 in an empty
// slot); the caller's epilogue runs there alone.
__device__ __forceinline__ bool search(const float4 q,
                                       const float4* __restrict__ r4,
                                       const int* __restrict__ row_flags,
                                       int n_m, Best& b) {
  extern __shared__ __align__(16) float4 smem[];
  __shared__ float blk_d[kK * kTileE];
  __shared__ int blk_i[kK * kTileE];
  __shared__ int n_flagged;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = threadIdx.x / kTileE;
  const int lane = threadIdx.x % kTileE;
  int* flagged = reinterpret_cast<int*>(
      reinterpret_cast<char*>(smem) + kBufBytes);

  // rank the flagged tiles: flagged[j] is the j-th, ascending
  if (threadIdx.x < 32) {
    int count = 0;
    for (int base = 0; base < n_m; base += 32) {
      const int mt = base + threadIdx.x;
      const bool f = mt < n_m && row_flags[mt] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) flagged[count + __popc(m & ((1u << threadIdx.x) - 1u))] = mt;
      count += __popc(m);
    }
    if (threadIdx.x == 0) n_flagged = count;
  }
  __syncthreads();
  const int nf = n_flagged;

  // this block's tiles, ranks rank, rank + kCluster, ..., double-buffered:
  // tile t + 1 lands while tile t is searched
  float bd[kK];
  int bi[kK];
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    bd[s] = kBig;
    bi[s] = kNone;
  }
  const int tiles = nf > rank ? (nf - rank + kCluster - 1) / kCluster : 0;
  auto first = [&](int t) {              // the first ref of tile t
    return flagged[rank + t * kCluster] * kTileM;
  };
  if (tiles > 0) stage(smem, r4 + first(0));
  commit();
  for (int t = 0; t < tiles; ++t) {      // uniform in the block
    if (t + 1 < tiles) stage(smem + ((t + 1) & 1) * kTileM, r4 + first(t + 1));
    commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // tile t landed
    __syncthreads();
    scan(q, smem + (t & 1) * kTileM + g * kRun, first(t) + g * kRun, bd, bi);
    __syncthreads();                     // buffer free for tile t + 2
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the block's groups merge through shared memory (the staging buffers,
  // free now), then the cluster's blocks through rank 0
  float* part_d = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem) + g * kListBytes);
  int* part_i = reinterpret_cast<int*>(part_d + kK * kTileE);
  if (g > 0) {
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      part_d[s * kTileE + lane] = bd[s];
      part_i[s * kTileE + lane] = bi[s];
    }
  }
  __syncthreads();
  if (g == 0) {
    for (int h = 1; h < kGroups; ++h) {
      const float* hd = reinterpret_cast<const float*>(
          reinterpret_cast<const char*>(smem) + h * kListBytes);
      const int* hi = reinterpret_cast<const int*>(hd + kK * kTileE);
      merge(hd + lane, hi + lane, kTileE, bd, bi);
    }
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      blk_d[s * kTileE + lane] = bd[s];
      blk_i[s * kTileE + lane] = bi[s];
    }
  }
  cluster.sync();
  const bool owner = rank == 0 && g == 0;
  if (owner) {
    for (int r = 1; r < kCluster; ++r) {
      const float* rd = cluster.map_shared_rank(blk_d, r);
      const int* ri = cluster.map_shared_rank(blk_i, r);
      merge(rd + lane, ri + lane, kTileE, bd, bi);
    }
  }
  cluster.sync();                        // no block leaves while it is read
  if (!owner) return false;

#pragma unroll
  for (int s = 0; s < kK; ++s) {
    const bool real = bi[s] != kNone;
    const float4 r = real ? r4[bi[s]] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    b.d[s] = bd[s];
    b.x[s] = r.x;
    b.y[s] = r.y;
    b.z[s] = r.z;
  }
  return true;
}

// Launch `kernel` on the (n_e * kCluster, batch) grid of kCluster-block
// clusters with the dynamic shared memory of n_m ref tiles.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int n_e, int batch, int n_m,
                   void* stream, Args... args) {
  const size_t smem = smem_bytes(n_m);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && kCluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_e) * kCluster,
                     static_cast<unsigned>(batch));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace liodom_knn

// The walk as built: out[0] blocks a cluster, out[1] thread groups a block,
// out[2] a block's dynamic shared memory in bytes for n_m ref tiles.  Each
// library that includes this header exports it.
extern "C" int liodom_knn_walk_shape(int n_m, int* out) {
  out[0] = liodom_knn::kCluster;
  out[1] = liodom_knn::kGroups;
  out[2] = static_cast<int>(liodom_knn::smem_bytes(n_m));
  return 0;
}
