// The exact k-NN search shared by K3/K4 (knn_coords.cu), K5 (knn_index.cu)
// and K6 (knn_lines.cu): a query tile's flagged ref tiles dealt over the
// blocks of a thread-block cluster, each staged tile split over the block's
// thread groups, the partial lists merged through shared and distributed
// shared memory.  Everything is a template on the number of neighbours K
// (1 <= K <= kMaxK) and on the split, so each kernel instantiates every k
// and dispatches on the caller's at run time (with_k).  Any other k takes
// ListWalk (at the end of this file): the same kind of split, one
// instantiation for every k, its lists in shared or device memory.
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
// - One cluster of Cluster blocks per query tile (grid (n_e * Cluster,
//   B)).  Every block ranks the flagged tiles of its query tile's flag row
//   (__ballot_sync / __popc, into shared memory) and takes those whose rank
//   is its cluster rank modulo Cluster: dealt by rank, not by tile index,
//   so bunched flags spread evenly (the busiest tile's 47 become at most 6
//   a block).
// - A block is Groups groups of 64 threads, one thread per query in each
//   group; every staged tile is split into Groups runs, one a group, so a
//   thread scans 512 / Groups refs a tile and all groups share one double
//   buffer.  (Dealing whole tiles to the groups instead
//   gave each group its own buffers and one thread whole tiles: K3 0.0731
//   and K4 0.1878 ms at 8 x 2 against this design's 0.0680 and 0.1604 in
//   one call, scripts/knn_walk_experiment.py.)
// - Each thread keeps a partial best-K of (d2, ref index) in registers,
//   inserting with a strict '<' over its refs in ascending index order, so
//   its list is exactly its own K smallest (d2, index) pairs.  It computes
//   8 distances at once and tests their minimum against its K-th best; in
//   a batch that passes, only the refs that beat the K-th best are pushed,
//   each without a branch inside the insert (each slot's compare
//   independent), so a ref does not wait on the previous ref's bubble.
//   (Pushing every ref of a passing 16-ref batch cost K5, whose dense
//   unsorted refs enter often, 0.1929 ms against 0.1375 for this, and K4
//   0.1645 against 0.1439, in one call: scripts/knn_walk_experiment.py.)
// - The block double-buffers its tiles in dynamic shared memory with
//   cp.async (16 bytes a thread): tile t + 1 lands while tile t is
//   searched.
// - The merge never touches device memory: a block's groups merge through
//   its shared memory, then after cluster.sync() cluster rank 0 reads the
//   other blocks' lists through distributed shared memory
//   (map_shared_rank).  Merging in (d2, index) order gives exactly the
//   sequential walk's answer whatever the split: the K lexicographically
//   smallest (d2, index) pairs of the flagged tiles, the TPU kernel's tie
//   order (carried best first, then the lower column).  The caller's
//   epilogue runs on the thread that holds the merged list, with its
//   indices (K5 writes them; K3 and K6 read the neighbours' coordinates).
// - The distance is rounded per operation (__fsub_rn/__fmul_rn/__fadd_rn,
//   -fmad=false) in the plain version's order, (dx*dx + dy*dy) + dz*dz.
//   No tensor cores: the |q|^2 - 2 q.r + |r|^2 form on wgmma / TF32 rounds
//   differently and would change which neighbour wins a near-tie, and the
//   bar is bit-exact neighbour choice.
//
// The result depends on neither the split nor K's instantiation beyond K
// itself.  K3/K4/K6 walk at kCluster x kGroups = 8 x 2, chosen by timing
// other splits (scripts/knn_walk_experiment.py, which builds copies of
// this header with other values); K5 has its own split (knn_index.cu).  A
// cluster above 8 blocks is launched with the non-portable cluster size
// allowed.  liodom_knn_walk_shape reports a library's split and a block's
// dynamic shared memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace liodom_knn {

namespace cg = cooperative_groups;

constexpr int kTileE = 64;    // queries a tile, one thread each in a group
constexpr int kTileM = 512;   // refs a ref tile (8 KB of float4)
constexpr int kMaxK = 16;     // neighbours the kernels are built for
constexpr int kCluster = 8;    // K3/K4/K6: blocks a query tile
constexpr int kGroups = 2;     // K3/K4/K6: thread groups a block
constexpr int kBatch = 8;     // distances a list test
constexpr int kNone = 0x7fffffff;   // index of an empty slot
constexpr float kBig = 1e30f;
constexpr float kFarPickD2 = 1.0e6f;

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, i) into the ascending (d2, index) list if it is before the
// last entry.
template <int K>
__device__ __forceinline__ void insert(float d, int i, float (&bd)[K],
                                       int (&bi)[K]) {
  if (!before(d, i, bd[K - 1], bi[K - 1])) return;
  bd[K - 1] = d;
  bi[K - 1] = i;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (before(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
      const float t = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = t;
      const int u = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = u;
    }
  }
}

// Merge an ascending list whose slot s is (d[s * stride], idx[s * stride]).
template <int K>
__device__ __forceinline__ void merge(const float* d, const int* idx,
                                      int stride, float (&bd)[K],
                                      int (&bi)[K]) {
  for (int s = 0; s < K; ++s) {
    const float ds = d[s * stride];
    const int is = idx[s * stride];
    if (!before(ds, is, bd[K - 1], bi[K - 1])) break;   // list ascending
    insert<K>(ds, is, bd, bi);
  }
}

// Insert (d, i) after every entry <= d (a strict '<': ties keep the
// earlier entry), the last falling off; d >= bd[K - 1] or NaN changes
// nothing.  Without a branch: the slots' compares are independent.
template <int K>
__device__ __forceinline__ void push(float d, int i, float (&bd)[K],
                                     int (&bi)[K]) {
  bool c[K];
#pragma unroll
  for (int s = 0; s < K; ++s) c[s] = d < bd[s];    // true from the slot on
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    bd[s] = c[s - 1] ? bd[s - 1] : (c[s] ? d : bd[s]);
    bi[s] = c[s - 1] ? bi[s - 1] : (c[s] ? i : bi[s]);
  }
  bd[0] = c[0] ? d : bd[0];
  bi[0] = c[0] ? i : bi[0];
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The walk of K neighbours over Cluster blocks of Groups thread groups.
template <int K, int Cluster, int Groups>
struct Walk {
  static_assert(K >= 1 && K <= kMaxK, "1 <= K <= kMaxK");
  static_assert(Cluster >= 1 && Cluster <= 16, "cluster of 1-16 blocks");
  static constexpr int kRun = kTileM / Groups;   // refs a group scans a tile
  static constexpr int kThreads = Groups * kTileE;
  static_assert(kTileM % kThreads == 0 && kRun % kBatch == 0,
                "a tile splits into whole copies a thread, whole batches a "
                "group");
  // the staging buffers, which hold the groups' partial lists after the walk
  static constexpr size_t kListBytes = 2 * sizeof(float) * K * kTileE;
  static constexpr size_t kBufBytes =
      2 * kTileM * sizeof(float4) > Groups * kListBytes
          ? 2 * kTileM * sizeof(float4) : Groups * kListBytes;
  // a block's shared memory (227 KB) less the static merge list
  static constexpr size_t kMaxSmem = 232448 - kListBytes - 16;

  // Dynamic shared memory of a block: the staging buffers, then the ranked
  // list of the flagged tiles.
  static size_t smem_bytes(int n_m) { return kBufBytes + sizeof(int) * n_m; }

  // Start the copy of one ref tile into shared memory, 16 bytes a thread.
  static __device__ __forceinline__ void stage(float4* dst,
                                               const float4* src) {
#pragma unroll
    for (int c = 0; c < kTileM / kThreads; ++c) {
      const int i = c * kThreads + threadIdx.x;
      const unsigned s =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src + i)
                   : "memory");
    }
  }

  // The staged refs base .. base + kRun - 1 into the list, in index order.
  // The distances of kBatch refs are computed first, independent of the
  // list; only a batch whose minimum beats the K-th best goes on, and in it
  // only the refs that beat it are pushed: a ref without d < bd[K - 1]
  // changes nothing, so the answer is the ref-by-ref walk's.
  static __device__ __forceinline__ void scan(const float4 q,
                                              const float4* refs, int base,
                                              float (&bd)[K], int (&bi)[K]) {
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
      float lo = d[0];                   // fminf skips a NaN, never enters
#pragma unroll
      for (int u = 1; u < kBatch; ++u) lo = fminf(lo, d[u]);
      if (!(lo < bd[K - 1])) continue;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (d[u] < bd[K - 1]) push<K>(d[u], base + i0 + u, bd, bi);
    }
  }

  // The best K refs of the flagged tiles for query q (this thread's query
  // of its block's query tile), in (d2, index) order.  Every thread of
  // every block of the cluster must call it (it syncs the cluster).
  // row_flags is the (n_m,) flag row of the cluster's query tile, r4 the
  // (n_m * 512, 4) encoded refs.  Returns true on the thread that holds the
  // merged answer (cluster rank 0, group 0), with bd / bi its d2 ascending
  // and the refs' indices into r4 (kBig and kNone in an empty slot); the
  // caller's epilogue runs there alone.
  static __device__ __forceinline__ bool search(
      const float4 q, const float4* __restrict__ r4,
      const int* __restrict__ row_flags, int n_m, float (&bd)[K],
      int (&bi)[K]) {
    extern __shared__ __align__(16) float4 smem[];
    __shared__ float blk_d[K * kTileE];
    __shared__ int blk_i[K * kTileE];
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

    // this block's tiles, ranks rank, rank + Cluster, ..., double-buffered:
    // tile t + 1 lands while tile t is searched
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[s] = kBig;
      bi[s] = kNone;
    }
    const int tiles = nf > rank ? (nf - rank + Cluster - 1) / Cluster : 0;
    auto first = [&](int t) {            // the first ref of tile t
      return flagged[rank + t * Cluster] * kTileM;
    };
    if (tiles > 0) stage(smem, r4 + first(0));
    commit();
    for (int t = 0; t < tiles; ++t) {    // uniform in the block
      if (t + 1 < tiles)
        stage(smem + ((t + 1) & 1) * kTileM, r4 + first(t + 1));
      commit();
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t landed
      __syncthreads();
      scan(q, smem + (t & 1) * kTileM + g * kRun, first(t) + g * kRun, bd,
           bi);
      __syncthreads();                   // buffer free for tile t + 2
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");

    // the block's groups merge through shared memory (the staging buffers,
    // free now), then the cluster's blocks through rank 0
    float* part_d = reinterpret_cast<float*>(
        reinterpret_cast<char*>(smem) + g * kListBytes);
    int* part_i = reinterpret_cast<int*>(part_d + K * kTileE);
    if (g > 0) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        part_d[s * kTileE + lane] = bd[s];
        part_i[s * kTileE + lane] = bi[s];
      }
    }
    __syncthreads();
    if (g == 0) {
      for (int h = 1; h < Groups; ++h) {
        const float* hd = reinterpret_cast<const float*>(
            reinterpret_cast<const char*>(smem) + h * kListBytes);
        const int* hi = reinterpret_cast<const int*>(hd + K * kTileE);
        merge<K>(hd + lane, hi + lane, kTileE, bd, bi);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
        blk_d[s * kTileE + lane] = bd[s];
        blk_i[s * kTileE + lane] = bi[s];
      }
    }
    cluster.sync();
    const bool owner = rank == 0 && g == 0;
    if (owner) {
      for (int r = 1; r < Cluster; ++r) {
        const float* rd = cluster.map_shared_rank(blk_d, r);
        const int* ri = cluster.map_shared_rank(blk_i, r);
        merge<K>(rd + lane, ri + lane, kTileE, bd, bi);
      }
    }
    cluster.sync();                      // no block leaves while it is read
    return owner;
  }

  // Launch `kernel` on the (n_e * Cluster, batch) grid of Cluster-block
  // clusters with the dynamic shared memory of n_m ref tiles.
  template <typename... Params, typename... Args>
  static cudaError_t launch(void (*kernel)(Params...), int n_e, int batch,
                            int n_m, void* stream, Args... args) {
    const size_t smem = smem_bytes(n_m);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess && Cluster > 8)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(n_e) * Cluster,
                       static_cast<unsigned>(batch));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? err : cudaGetLastError();
  }

  // The split as built: out[0] blocks a cluster, out[1] thread groups a
  // block, out[2] a block's dynamic shared memory in bytes for n_m ref
  // tiles.
  static int shape(int n_m, int* out) {
    out[0] = Cluster;
    out[1] = Groups;
    out[2] = static_cast<int>(smem_bytes(n_m));
    return 0;
  }
};

// The walk of K3, K4 and K6.
template <int K>
using CoordsWalk = Walk<K, kCluster, kGroups>;

// The neighbours' encoded coordinates read from r4 by index, for the
// merged list of search (0 in an empty slot).
template <int K>
__device__ __forceinline__ void gather(const float4* __restrict__ r4,
                                       const int (&bi)[K], float (&x)[K],
                                       float (&y)[K], float (&z)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool real = bi[s] != kNone;
    const float4 r = real ? r4[bi[s]] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[s] = r.x;
    y[s] = r.y;
    z[s] = r.z;
  }
}

// f(std::integral_constant<int, K>{}) for the run-time k, 1 <= k <= kMaxK:
// every K is instantiated; any other k is refused.
template <int K = 1, typename F>
cudaError_t with_k(int k, F&& f) {
  if constexpr (K > kMaxK) {
    return cudaErrorInvalidValue;
  } else {
    if (k == K) return f(std::integral_constant<int, K>{});
    return with_k<K + 1>(k, f);
  }
}

// The walk at any k (the *_any_k entry points; the wrappers take it for k >
// kMaxK, where the register lists above would not fit), written for this
// card rather than carried over from Walk: with a run-time k the lists live
// in memory, and their upkeep, not the distances, is what costs.
//
// What held the earlier ListWalk back (NVIDIA H100 80GB HBM3, 700 W, K3' on
// the bench drive's last frame: 0.61 ms at k = 5, 1.62 at 17, 10.7 at 64,
// 1,346 at 512): one 64-thread block a query tile walked every flagged ref
// tile alone (24,064 refs a thread on the busiest tile, not dealt over a
// cluster), and each ref that beat the k-th best was shifted into its list
// on its own, one dependent slot at a time (through L2 above ~420
// neighbours).
//
// This design:
// - The split of Walk: a cluster of Cluster blocks a query tile (grid (n_e
//   * Cluster, B)); every block ranks its tile's flag row (__ballot_sync /
//   __popc) and takes the flagged tiles whose rank is its cluster rank
//   modulo Cluster; a block is Groups groups of 64 threads, one thread a
//   query in each, and every staged tile (cp.async, double-buffered) is
//   split into Groups runs of whole 8-ref batches.
// - Each thread (a walker) keeps a partial list of (d2, index) of which
//   only its `filled` real entries are ever written or read (the rest are
//   empty slots, kBig and kNone).  8 distances at a time are tested by
//   their minimum against the k-th best; in a batch that passes, the
//   entrants (d < the k-th best, so NaN never enters) are sorted by (d2,
//   index) with a 19-comparator network and merged into the list from its
//   tail in one pass: each entry above an entrant moves up by the number of
//   entrants below it, each entrant lands after the entries <= it (strict
//   '<': a walker meets its refs in ascending index, so a tie keeps the
//   earlier), and each slot is written at most once a batch.  The list is
//   then exactly its walker's k smallest (d2, index) pairs.  The merge
//   reads the list 4 entries at a time, all loads ahead of their stores
//   (an entry's move is its own count of the entrants below it, so no step
//   waits on the one before), and keeps the k-th best in a register.  The
//   walk is inlined once for lists in shared memory and once for the
//   scratch, so that each reaches its lists by its own loads.
// - One keyed merge: after cluster.sync(), the thread of each query in
//   cluster rank 0, group 0 merges the Cluster x Groups partial lists in
//   (d2, index) order (the lists read in place: its block's shared memory
//   and the other blocks' through distributed shared memory, or the
//   device scratch; their heads and cursors in the block's staging
//   buffers, free by then, so that the merge adds no registers to the
//   walk) and hands the k-entry answer to the caller's epilogue slot by
//   slot (merged; K6 calls it twice).  The k lexicographically smallest
//   pairs of the flagged tiles whatever the split: the sequential walk's
//   answer and knn_launch_plain's.
// - The lists are slot-major ([slot][query], stride kTileE, so a warp's 32
//   accesses to one slot fall in 32 banks): in the block's dynamic shared
//   memory while its Groups lists of 8 k 64 bytes fit beside the 16 KB of
//   buffers, the filled counts and the ranked flags; else in a device
//   scratch the caller allocates, Cluster x Groups lists a query tile laid
//   out the same, in (query tile, rank, group) order.  The same code reads
//   both through a base pointer.  The block has no static shared memory,
//   so the dynamic size alone is held to the 227 KB a block may opt in to.
// - The distance is rounded per operation as in Walk (-fmad=false); no
//   tensor cores, the bar being the neighbour choice bit for bit.
template <int Cluster, int Groups>
struct ListWalk {
  static_assert(Cluster >= 1 && Cluster <= 16, "cluster of 1-16 blocks");
  static_assert(Groups >= 1 && Groups <= 16, "1-16 thread groups a block");
  static constexpr int kClusterBlocks = Cluster;
  static constexpr int kThreads = Groups * kTileE;
  static constexpr int kLists = Cluster * Groups;   // partial lists a query
  static constexpr int kChunk = 4;    // list entries a merge reads at once
  // refs a group scans of a staged tile, whole batches (the last group's
  // run the rest of the tile)
  static constexpr int kRun =
      ((kTileM + Groups - 1) / Groups + kBatch - 1) / kBatch * kBatch;
  static constexpr size_t kBufBytes = 2 * kTileM * sizeof(float4);
  static constexpr size_t kMaxSmem = 232448;

  // Where a cluster's lists are: base this block's first list (in its
  // shared memory or the scratch), tile the cluster's first list in the
  // scratch (nullptr when they are in shared memory), filled the block's
  // walkers' counts, k the slots a list.
  struct Lists {
    float* base;
    const float* tile;
    int* filled;
    int k;
  };

  // a walker's list: (d2, index) in k slots for 64 queries
  static __host__ __device__ size_t list_bytes(int k) {
    return static_cast<size_t>(8) * k * kTileE;
  }
  static bool lists_fit(int n_m, int k) {
    return smem_bytes(n_m, k, true) <= kMaxSmem;
  }
  // Dynamic shared memory: the staging buffers, the block's lists if they
  // are kept there, the walkers' filled counts, then the ranked flagged
  // tiles and their count.
  static size_t smem_bytes(int n_m, int k, bool lists_in_smem) {
    return kBufBytes + (lists_in_smem ? Groups * list_bytes(k) : 0) +
           sizeof(int) * kThreads + sizeof(int) * (n_m + 1);
  }

  static __device__ __forceinline__ void stage(float4* dst,
                                               const float4* src) {
#pragma unroll
    for (int c = 0; c < (kTileM + kThreads - 1) / kThreads; ++c) {
      const int i = c * kThreads + threadIdx.x;
      if (kTileM % kThreads != 0 && i >= kTileM) break;
      const unsigned s =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src + i)
                   : "memory");
    }
  }

  // (da, ia) and (db, ib) in (d2, index) order
  static __device__ __forceinline__ void exchange(float& da, int& ia,
                                                  float& db, int& ib) {
    const bool swap = before(db, ib, da, ia);
    const float d = swap ? db : da;
    const int i = swap ? ib : ia;
    db = swap ? da : db;
    ib = swap ? ia : ib;
    da = d;
    ia = i;
  }

  // Sort 8 (d2, index) pairs: Batcher's network of 19 comparators.
  static __device__ __forceinline__ void sort8(float (&d)[kBatch],
                                               int (&i)[kBatch]) {
    static_assert(kBatch == 8, "the network sorts 8");
    exchange(d[0], i[0], d[2], i[2]);
    exchange(d[1], i[1], d[3], i[3]);
    exchange(d[4], i[4], d[6], i[6]);
    exchange(d[5], i[5], d[7], i[7]);
    exchange(d[0], i[0], d[4], i[4]);
    exchange(d[1], i[1], d[5], i[5]);
    exchange(d[2], i[2], d[6], i[6]);
    exchange(d[3], i[3], d[7], i[7]);
    exchange(d[0], i[0], d[1], i[1]);
    exchange(d[2], i[2], d[3], i[3]);
    exchange(d[4], i[4], d[5], i[5]);
    exchange(d[6], i[6], d[7], i[7]);
    exchange(d[2], i[2], d[4], i[4]);
    exchange(d[3], i[3], d[5], i[5]);
    exchange(d[1], i[1], d[4], i[4]);
    exchange(d[3], i[3], d[6], i[6]);
    exchange(d[1], i[1], d[2], i[2]);
    exchange(d[3], i[3], d[4], i[4]);
    exchange(d[5], i[5], d[6], i[6]);
  }

  // The n entrants ed / ei (ascending, each after every entry <= it; the
  // rest +inf) into the list ld / li (slot s at s * kTileE) of `filled`
  // real entries, from its tail: an entry moves up by the number c of
  // entrants below it, entrant u lands at u + the first entry with more
  // than u entrants below it (after the entries <= it), what passes slot
  // k - 1 falls off; each slot is written at most once.  The entries are
  // read kChunk at a time, every load ahead of the chunk's stores, until
  // one has no entrant below it (nor has any entry under it).  worst
  // becomes the k-th best.
  static __device__ __forceinline__ void merge(const float (&ed)[kBatch],
                                               const int (&ei)[kBatch],
                                               int n, float* ld, int* li,
                                               int k, int& filled,
                                               float& worst) {
    int above[kBatch];                   // the first entry above entrant u
#pragma unroll
    for (int u = 0; u < kBatch; ++u) above[u] = filled;
    float last = kBig;                   // what lands in slot k - 1
    for (int top = filled - 1; top >= 0; top -= kChunk) {
      float p[kChunk];
      int pi[kChunk], c[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int s = max(top - j, 0);
        p[j] = ld[s * kTileE];
        pi[j] = li[s * kTileE];
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        int below = 0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) below += ed[u] < p[j] ? 1 : 0;
        c[j] = top - j >= 0 ? below : 0;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int s = top - j, o = s + c[j];
        if (c[j] > 0 && o < k) {
          ld[o * kTileE] = p[j];
          li[o * kTileE] = pi[j];
          if (o == k - 1) last = p[j];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (c[j] > u) above[u] = s;     // descending: ends at the first
      }
      if (c[kChunk - 1] == 0) break;     // every entry below stays
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int o = u + above[u];
      if (u < n && o < k) {
        ld[o * kTileE] = ed[u];
        li[o * kTileE] = ei[u];
        if (o == k - 1) last = ed[u];
      }
    }
    filled = min(k, filled + n);
    worst = filled < k ? kBig : last;    // slot k - 1 was written if full
  }

  // The staged refs first .. first + len - 1 (len whole batches) into the
  // list, 8 at a time; worst is the k-th best (kBig until the list is
  // full).
  static __device__ __forceinline__ void scan(const float4 q,
                                              const float4* refs, int first,
                                              int len, float* ld, int* li,
                                              int k, int& filled,
                                              float& worst) {
    for (int i0 = 0; i0 < len; i0 += kBatch) {
      float d[kBatch];
      int e[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float4 r = refs[i0 + u];
        const float dx = __fsub_rn(q.x, r.x);
        const float dy = __fsub_rn(q.y, r.y);
        const float dz = __fsub_rn(q.z, r.z);
        d[u] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz));
      }
      float lo = d[0];                   // fminf skips a NaN, never enters
#pragma unroll
      for (int u = 1; u < kBatch; ++u) lo = fminf(lo, d[u]);
      if (!(lo < worst)) continue;
      int n = 0;                         // the entrants; the rest sort last
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = d[u] < worst;
        n += in ? 1 : 0;
        d[u] = in ? d[u] : __int_as_float(0x7f800000);
        e[u] = first + i0 + u;
      }
      if (n > 1) {
        sort8(d, e);
      } else {                           // the one entrant to the front
#pragma unroll
        for (int u = 1; u < kBatch; ++u) {
          if (d[u] < d[0]) {
            d[0] = d[u];
            e[0] = e[u];
            d[u] = __int_as_float(0x7f800000);
          }
        }
      }
      merge(d, e, n, ld, li, k, filled, worst);
    }
  }

  // This block's tiles (ranks rank, rank + Cluster, ..., of the nf ranked
  // in flagged), double-buffered: tile t + 1 lands while tile t is
  // searched; this thread's group's run of each into its list at ld / li.
  // Inlined once for lists in shared memory and once for the scratch, so
  // that each reaches its lists by its own loads.
  static __device__ __forceinline__ void walk(const float4 q,
                                              const float4* __restrict__ r4,
                                              const int* flagged, int nf,
                                              int rank, float* ld, int* li,
                                              int k, int& filled) {
    extern __shared__ __align__(16) float4 smem[];
    const int tiles = nf > rank ? (nf - rank + Cluster - 1) / Cluster : 0;
    const int run0 = threadIdx.x / kTileE * kRun;
    const int len = max(0, min(kRun, kTileM - run0));
    auto first = [&](int t) {            // the first ref of tile t
      return flagged[rank + t * Cluster] * kTileM;
    };
    float worst = kBig;
    if (tiles > 0) stage(smem, r4 + first(0));
    commit();
    for (int t = 0; t < tiles; ++t) {    // uniform in the block
      if (t + 1 < tiles)
        stage(smem + ((t + 1) & 1) * kTileM, r4 + first(t + 1));
      commit();
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t landed
      __syncthreads();
      scan(q, smem + (t & 1) * kTileM + run0, first(t) + run0, len, ld, li,
           k, filled, worst);
      __syncthreads();                   // buffer free for tile t + 2
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // Walk this thread's share of the flagged tiles of its block's query tile
  // for query q into its partial list.  Every thread of every block of the
  // cluster must call it (it syncs the cluster), then, on the thread it
  // returns true to (cluster rank 0, group 0), merged may run, then every
  // thread must call finish.  row_flags is the (n_m,) flag row of the
  // cluster's query tile, r4 the (n_m * 512, 4) encoded refs; scratch is
  // the device scratch of the launch's lists (kLists lists a query tile,
  // blocks in grid order), or nullptr to keep them in shared memory.
  static __device__ __forceinline__ bool search(
      const float4 q, const float4* __restrict__ r4,
      const int* __restrict__ row_flags, int n_m, int k, float* scratch,
      Lists& lists) {
    extern __shared__ __align__(16) float4 smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int g = threadIdx.x / kTileE;
    const int lane = threadIdx.x % kTileE;
    const size_t words = 2 * static_cast<size_t>(k) * kTileE;   // a list
    const size_t mine = g * words + lane;      // this thread's slot 0
    const size_t index_slots = static_cast<size_t>(k) * kTileE;
    char* after = reinterpret_cast<char*>(smem) + kBufBytes;
    lists.tile = nullptr;
    if (scratch != nullptr) {
      const size_t blk =
          static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
      lists.base = scratch + blk * Groups * words;
      lists.tile = scratch + (blk - rank) * Groups * words;
    } else {
      lists.base = reinterpret_cast<float*>(after);
      after += Groups * list_bytes(k);
    }
    lists.filled = reinterpret_cast<int*>(after);
    lists.k = k;
    int* flagged = lists.filled + kThreads;
    int& n_flagged = flagged[n_m];

    if (threadIdx.x < 32) {              // flagged[j]: the j-th, ascending
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
    int filled = 0;
    if (scratch != nullptr) {
      float* ld = lists.base + mine;
      walk(q, r4, flagged, nf, rank, ld,
           reinterpret_cast<int*>(ld + index_slots), k, filled);
    } else {                             // reached from smem alone
      float* ld = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                           kBufBytes) + mine;
      walk(q, r4, flagged, nf, rank, ld,
           reinterpret_cast<int*>(ld + index_slots), k, filled);
    }
    lists.filled[threadIdx.x] = filled;
    cluster.sync();                      // every list complete and visible
    return rank == 0 && g == 0;
  }

  // Partial list h (rank h / Groups, group h % Groups) of this lane.
  static __device__ __forceinline__ const float* list(const Lists& lists,
                                                      int h) {
    const size_t words = 2 * static_cast<size_t>(lists.k) * kTileE;
    const int lane = threadIdx.x % kTileE;
    if (lists.tile != nullptr) return lists.tile + h * words + lane;
    return cg::this_cluster().map_shared_rank(lists.base, h / Groups) +
           (h % Groups) * words + lane;
  }

  // Slot s of partial list h, (kBig, kNone) past its filled entries.
  static __device__ __forceinline__ void read(const Lists& lists, int h,
                                              int s, int fill, float& d,
                                              int& i) {
    if (s >= fill) {
      d = kBig;
      i = kNone;
      return;
    }
    const float* p = list(lists, h);
    d = p[s * kTileE];
    i = reinterpret_cast<const int*>(p)[(lists.k + s) * kTileE];
  }

  // The keyed merge of this query's kLists partial lists: emit(s, d2,
  // index) for s = 0 .. k - 1 in (d2, index) order, kBig and kNone where
  // the lists hold fewer than k.  The lists' heads, cursors and counts
  // live in this block's staging buffers (free after the walk), so that
  // the merge adds no registers to the walk.  On search's owner thread
  // only, before finish; may run more than once.
  template <typename F>
  static __device__ __forceinline__ void merged(const Lists& lists,
                                                F&& emit) {
    extern __shared__ __align__(16) float4 smem[];
    static_assert(4 * kLists * kTileE * sizeof(int) <= kBufBytes,
                  "the heads fit the staging buffers");
    cg::cluster_group cluster = cg::this_cluster();
    const int lane = threadIdx.x % kTileE;
    float* hd = reinterpret_cast<float*>(smem) + lane;   // [h * kTileE]
    int* hi = reinterpret_cast<int*>(hd + kLists * kTileE);
    int* at = hi + kLists * kTileE;
    int* fill = at + kLists * kTileE;
    for (int h = 0; h < kLists; ++h) {
      const int f = cluster.map_shared_rank(lists.filled, h / Groups)
                        [(h % Groups) * kTileE + lane];
      float d;
      int i;
      read(lists, h, 0, f, d, i);
      hd[h * kTileE] = d;
      hi[h * kTileE] = i;
      at[h * kTileE] = 0;
      fill[h * kTileE] = f;
    }
    for (int s = 0; s < lists.k; ++s) {
      int w = 0;
      float bd = hd[0];
      int bi = hi[0];
#pragma unroll 4
      for (int h = 1; h < kLists; ++h) {
        const float d = hd[h * kTileE];
        const int i = hi[h * kTileE];
        if (before(d, i, bd, bi)) {
          w = h;
          bd = d;
          bi = i;
        }
      }
      emit(s, bd, bi);
      const int a = at[w * kTileE] + 1;
      float d;
      int i;
      read(lists, w, a, fill[w * kTileE], d, i);
      hd[w * kTileE] = d;
      hi[w * kTileE] = i;
      at[w * kTileE] = a;
    }
  }

  // No block leaves while rank 0 may read its lists.
  static __device__ __forceinline__ void finish() {
    cg::this_cluster().sync();
  }

  // Launch `kernel` on the (n_e * Cluster, batch) grid of Cluster-block
  // clusters with the dynamic shared memory of n_m ref tiles and, unless
  // the lists go to the device scratch, the block's lists of k neighbours.
  template <typename... Params, typename... Args>
  static cudaError_t launch(void (*kernel)(Params...), int n_e, int batch,
                            int n_m, int k, bool lists_in_smem, void* stream,
                            Args... args) {
    const size_t smem = smem_bytes(n_m, k, lists_in_smem);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess && Cluster > 8)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(n_e) * Cluster,
                       static_cast<unsigned>(batch));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? err : cudaGetLastError();
  }

  // As built for n_m ref tiles and k neighbours: out[0] threads a block,
  // out[1] 1 if the block's lists fit its shared memory (else they need
  // the device scratch), out[2] the block's dynamic shared memory in bytes
  // as launched, out[3] the scratch's bytes a query tile when it is used
  // (kLists lists), out[4] blocks a cluster, out[5] thread groups a block.
  static int shape(int n_m, int k, int* out) {
    const size_t scratch = kLists * list_bytes(k);
    if (k < 1 || scratch > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidValue);
    const bool fit = lists_fit(n_m, k);
    out[0] = kThreads;
    out[1] = fit ? 1 : 0;
    out[2] = static_cast<int>(smem_bytes(n_m, k, fit));
    out[3] = static_cast<int>(scratch);
    out[4] = Cluster;
    out[5] = Groups;
    return 0;
  }
};

// The split of the any-k walk of K3-K6, chosen by timing
// (scripts/knn_walk_experiment.py --list-splits builds copies with other
// values; NVIDIA H100 80GB HBM3, 700 W, bench frame, one call): 8 x 2
// took K3' 0.373 ms at k = 17 and 1.444 at 64, against 0.437 / 1.775 at
// 8 x 1, 0.494 / 1.592 at 4 x 2, 0.436 / 1.562 at 4 x 4 and 0.437 / 1.613
// at 16 x 1 (the earlier one-block ListWalk 1.644 / 10.66).  Reading the
// list 4 entries a merge step took it from 0.537 ms at k = 17 (one
// dependent entry a step, the merge's heads in registers: 111 registers
// against 64); 2 or 8 entries a step were slower at k = 17.
constexpr int kListCluster = 8;   // blocks a query tile
constexpr int kListGroups = 2;    // thread groups a block
using AnyKWalk = ListWalk<kListCluster, kListGroups>;

// The encoded ref at index i of r4, zero for an empty slot.
__device__ __forceinline__ float4 neighbour(const float4* __restrict__ r4,
                                            int i) {
  return i != kNone ? r4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace liodom_knn
