// The exact k-NN search shared by K3/K4 (knn_coords.cu), K5 (knn_index.cu)
// and K6 (knn_lines.cu): a query tile's flagged ref tiles dealt over the
// blocks of a thread-block cluster, each staged tile split over the block's
// thread groups, the partial lists merged through shared and distributed
// shared memory.  Everything is a template on the number of neighbours K
// (1 <= K <= kMaxK) and on the split, so each kernel instantiates every k
// and dispatches on the caller's at run time (with_k).
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

}  // namespace liodom_knn
