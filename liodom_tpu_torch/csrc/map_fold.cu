// The map update's fold: a frame's points folded into the slots they hit,
// written by hand for Hopper (sm_90a).
//
// No TPU kernel: the JAX package folds with XLA ops, either over the whole
// table (liodom_tpu/mapping/grid.py:update_map, a capacity-sized scatter-add
// and element-wise passes) or over the frame
// (grid.py:update_map_sparse_epilogue).  The port keeps the frame-sized fold:
// its plain PyTorch version is liodom_tpu_torch/mapping/grid.py:_sparse_fold,
// and this kernel is that function in one launch.
//
// The function: each row that is valid and was not dropped by the probe
// (`ok`) adds [x y z 1] to its slot's sums, each slot's rows added in row
// order starting from 0 (the order of _slot_sums: a stable sort by slot,
// then segment_reduce); a hit slot's centroid becomes
// (xyz * w + sum) / max(w + n, 1) with w = 1 if the slot was occupied, each
// product, sum and quotient rounded on its own (IEEE division, no fused
// multiply-add); a slot claimed by one of its rows gets the reference's
// cell key of that row (trunc(floor(p / size) * size + size / 2) per axis,
// map.cc:103-105, the expression of grid.py:cell_keys) and is marked valid;
// the rows the probe dropped (valid and failed) are added to the overflow.
// Every other row of the state is left as the copies the wrapper made hold
// it.  The result is bit-exact with the plain version on the CPU.
//
// What bounds it on the card: latency and one SM's memory pipeline.  The
// frame is small (5,632 rows at the KITTI preset: 45 KB of slots and row
// ids, 67 KB of points, the hit slots' 16 bytes each), so the time is the
// launch, a chain of block barriers and a few dependent trips to device
// memory; but every hit slot is its own scattered read of the stored state
// and its own scattered writes, and on one SM those took 55 us for the
// bench frame (a %globaltimer timeline: 16 warps issuing 32-sector
// accesses through one load/store pipeline), so that part is spread over a
// cluster.  The capacity-sized work left is the wrapper's three copies of
// the state (xyz, key, valid), one device-to-device copy each.
//
// Design: one launch of one thread-block cluster of up to kMaxCluster
// blocks.
//   1. Sort: the first ceil(E / kBlockRows) blocks each take a contiguous
//      share of the rows (at most kBlockRows = 12,288; the bench's 5,632
//      take one block) and sort their (slot, row) pairs by slot in shared
//      memory: a stable LSD radix sort, 4 bits a pass over the slot's bits
//      (ceil(log2(C + 1)), the dropped rows keyed C so they sort last),
//      each thread counting and placing a contiguous run of the rows in its
//      column of the (digit, thread) counts, one block scan of the counts a
//      pass.  (Rows held in registers and sorted in place, or 8-bit digits
//      ranked by warp matches, took longer a pass on the H100.)
//   2. Fold: after a cluster barrier every block of the cluster takes an
//      even part of the positions of the sorted shares, read through
//      distributed shared memory.  A slot's rows are one run in each
//      share, the shares in row order, so the thread at the head of a run
//      in the first share that holds the slot (binary searches of the
//      earlier shares) owns it and adds its run, then the runs of the
//      later shares, one row at a time.  One thread a slot: each touched
//      slot is written once, no atomics.  The cluster has about one
//      thread a row, so the scattered reads and writes go through up to 16
//      SMs.
// Block 0 adds the sorting blocks' dropped counts in block order to the
// overflow and, when asked, writes the number of slots folded.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 4;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kBlockRows = 12288;             // rows a sorting block
constexpr int kMaxCluster = 16;               // blocks, non-portable past 8
constexpr int kCountBytes = kDigits * kThreads * 2;   // u16 digit counts
constexpr long long kMaxSmem = 232448;        // a block's shared memory

struct Shape {
  int blocks;   // blocks of the one cluster
  int sort;     // of them, the blocks that sort (the first ones)
  int share;    // rows a sorting block
  int smem;     // dynamic shared memory a block, bytes
};

Shape shape_of(int e) {
  Shape s;
  s.sort = e <= 0 ? 1 : (e + kBlockRows - 1) / kBlockRows;
  s.share = e <= 0 ? 0 : (e + s.sort - 1) / s.sort;
  const int fold = (e + kThreads - 1) / kThreads;   // about a thread a row
  s.blocks = s.sort > kMaxCluster ? s.sort
             : (fold < s.sort ? s.sort
                              : (fold > kMaxCluster ? kMaxCluster : fold));
  s.smem = s.share * 16 + kCountBytes;
  return s;
}

// the reference's cell key of one coordinate (grid.py:cell_keys)
__device__ __forceinline__ int cell_key(float p, float size, float half) {
  return static_cast<int>(
      truncf(__fadd_rn(__fmul_rn(floorf(__fdiv_rn(p, size)), size), half)));
}

// first index of a sorted run of n keys whose key is not below v
__device__ __forceinline__ int lower_bound(const unsigned* k, int n,
                                           unsigned v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The block's digit counts, cnt[d * kThreads + t] (rows of thread t with
// digit d), replaced by their exclusive prefix sums in that order: each
// thread sums kDigits consecutive entries, then warp and block scans.
// Ends with a block barrier.
__device__ __forceinline__ void scan_counts(unsigned short* cnt,
                                            int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned short* mine = cnt + tid * kDigits;
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kDigits; ++j) sum += mine[j];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += v;
    }
    if (lane < kWarps) s_warp[lane] = wi - w;
  }
  __syncthreads();
  int base = s_warp[warp] + incl - sum;
#pragma unroll
  for (int j = 0; j < kDigits; ++j) {
    const int v = mine[j];
    mine[j] = static_cast<unsigned short>(base);
    base += v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
map_fold_kernel(const float* __restrict__ xyz_in,
                const unsigned char* __restrict__ valid_in,
                const int* __restrict__ overflow_in,
                const float* __restrict__ pts,
                const unsigned char* __restrict__ pts_valid,
                const int* __restrict__ slot,
                const unsigned char* __restrict__ claimed,
                const unsigned char* __restrict__ failed, int c, int e,
                int n_sort, int share, int passes, float xy, float xy_half,
                float z, float z_half, float* __restrict__ xyz_out,
                int* __restrict__ key_out,
                unsigned char* __restrict__ valid_out,
                int* __restrict__ overflow_out, int* __restrict__ folded) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_dropped, s_folded;
  __shared__ int s_block_folded[kMaxCluster];   // block 0's: every block's
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  unsigned* key_s = reinterpret_cast<unsigned*>(smem);
  unsigned* key_t = key_s + share;
  int* row_s = reinterpret_cast<int*>(key_t + share);
  int* row_t = row_s + share;
  unsigned short* cnt = reinterpret_cast<unsigned short*>(row_t + share);

  if (tid == 0) {
    s_dropped = 0;
    s_folded = 0;
  }
  __syncthreads();
  if (rank < n_sort) {
    const int first = rank * share;
    const int n = max(0, min(share, e - first));
    // the block's rows, keyed by slot (C: not ok, sorted last)
    int dropped = 0;
    for (int i = tid; i < n; i += kThreads) {
      const int r = first + i;
      const bool v = pts_valid[r] != 0, f = failed[r] != 0;
      key_s[i] = v && !f ? static_cast<unsigned>(slot[r])
                         : static_cast<unsigned>(c);
      row_s[i] = r;
      dropped += v && f;
    }
    if (dropped) atomicAdd(&s_dropped, dropped);
    __syncthreads();

    // stable LSD radix sort by slot; this thread counts and places the rows
    // [lo, hi) of the current order; the passes alternate between the two
    // buffers
    const int run = (n + kThreads - 1) / kThreads;
    const int lo = min(n, tid * run), hi = min(n, lo + run);
    unsigned* src_k = key_s;
    unsigned* dst_k = key_t;
    int* src_r = row_s;
    int* dst_r = row_t;
    for (int pass = 0; pass < passes; ++pass) {
      const int shift = pass * kDigitBits;
#pragma unroll
      for (int d = 0; d < kDigits; ++d) cnt[d * kThreads + tid] = 0;
      for (int i = lo; i < hi; ++i)
        ++cnt[((src_k[i] >> shift) & (kDigits - 1)) * kThreads + tid];
      __syncthreads();
      scan_counts(cnt, s_warp);
      for (int i = lo; i < hi; ++i) {
        const unsigned k = src_k[i];
        unsigned short* at =
            cnt + ((k >> shift) & (kDigits - 1)) * kThreads + tid;
        const int pos = *at;
        *at = static_cast<unsigned short>(pos + 1);
        dst_k[pos] = k;
        dst_r[pos] = src_r[i];
      }
      __syncthreads();
      unsigned* tk = src_k;
      src_k = dst_k;
      dst_k = tk;
      int* tr = src_r;
      src_r = dst_r;
      dst_r = tr;
    }
  }
  // every share is sorted (and every dropped count final), in the buffers
  // the last pass wrote
  cluster.sync();
  unsigned* const sorted_k = passes & 1 ? key_t : key_s;
  int* const sorted_r = passes & 1 ? row_t : row_s;

  int n_folded = 0;
  const int part = (e + n_blocks - 1) / n_blocks;
  const int g_end = min(e, (rank + 1) * part);
  for (int g = rank * part + tid; g < g_end; g += kThreads) {
    const int s0 = g / share, p = g - s0 * share;
    const unsigned* keys = cluster.map_shared_rank(sorted_k, s0);
    const unsigned k = keys[p];
    if (k >= static_cast<unsigned>(c) || (p > 0 && keys[p - 1] == k))
      continue;
    // the slot belongs to the first share that holds it
    bool owner = true;
    for (int b = 0; b < s0 && owner; ++b) {
      const unsigned* bk = cluster.map_shared_rank(sorted_k, b);
      const int nb = max(0, min(share, e - b * share));
      const int q = lower_bound(bk, nb, k);
      owner = !(q < nb && bk[q] == k);
    }
    if (!owner) continue;
    const int s = static_cast<int>(k);
    const float w0 = valid_in[s] ? 1.0f : 0.0f;
    const float x0 = xyz_in[3 * s], y0 = xyz_in[3 * s + 1],
                z0 = xyz_in[3 * s + 2];
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, cn = 0.0f;
    int claim = -1;
    for (int b = s0; b < n_sort; ++b) {
      const unsigned* bk = cluster.map_shared_rank(sorted_k, b);
      const int* br = cluster.map_shared_rank(sorted_r, b);
      const int nb = max(0, min(share, e - b * share));
      for (int q = b == s0 ? p : lower_bound(bk, nb, k);
           q < nb && bk[q] == k; ++q) {
        const int r = br[q];
        sx = __fadd_rn(sx, pts[3 * r]);
        sy = __fadd_rn(sy, pts[3 * r + 1]);
        sz = __fadd_rn(sz, pts[3 * r + 2]);
        cn = __fadd_rn(cn, 1.0f);
        if (claim < 0 && claimed[r]) claim = r;
      }
    }
    const float den = fmaxf(__fadd_rn(w0, cn), 1.0f);
    xyz_out[3 * s] = __fdiv_rn(__fadd_rn(__fmul_rn(x0, w0), sx), den);
    xyz_out[3 * s + 1] = __fdiv_rn(__fadd_rn(__fmul_rn(y0, w0), sy), den);
    xyz_out[3 * s + 2] = __fdiv_rn(__fadd_rn(__fmul_rn(z0, w0), sz), den);
    if (claim >= 0) {
      key_out[3 * s] = cell_key(pts[3 * claim], xy, xy_half);
      key_out[3 * s + 1] = cell_key(pts[3 * claim + 1], xy, xy_half);
      key_out[3 * s + 2] = cell_key(pts[3 * claim + 2], z, z_half);
      valid_out[s] = 1;
    }
    ++n_folded;
  }
  if (n_folded) atomicAdd(&s_folded, n_folded);
  __syncthreads();
  if (tid == 0) {
    cluster.map_shared_rank(s_block_folded, 0)[rank] = s_folded;
    if (rank == 0) {
      // the dropped counts in block order (read before the barrier below,
      // after which a block may leave)
      int total = 0;
      for (int b = 0; b < n_sort; ++b)
        total += *cluster.map_shared_rank(&s_dropped, b);
      *overflow_out = *overflow_in + total;
    }
  }
  cluster.sync();   // no block leaves while it is read
  if (folded != nullptr && rank == 0 && tid == 0) {
    int total = 0;
    for (int b = 0; b < n_blocks; ++b) total += s_block_folded[b];
    *folded = total;
  }
}

}  // namespace

// xyz_in (c, 3) f32, valid_in (c,) bool, overflow_in () i32: the stored
// state; pts (e, 3) f32 the frame in the world frame, pts_valid (e,) bool,
// slot (e,) i32, claimed (e,) bool, failed (e,) bool: the probe's result;
// xy, xy_half, z, z_half: the cell sizes and their halves as float32 ->
// the hit rows of xyz_out (c, 3), the claimed rows of key_out (c, 3) i32 and
// valid_out (c,) bool (the rest of them copies of the state the caller
// made), overflow_out () i32, and, unless null, folded () i32 (the slots
// folded).  One launch of one cluster; nothing is launched for e == 0.
extern "C" int liodom_map_fold(const void* xyz_in, const void* valid_in,
                               const void* overflow_in, const void* pts,
                               const void* pts_valid, const void* slot,
                               const void* claimed, const void* failed,
                               int c, int e, float xy, float xy_half,
                               float z, float z_half, void* xyz_out,
                               void* key_out, void* valid_out,
                               void* overflow_out, void* folded,
                               void* stream) {
  if (c <= 0 || e < 0 || e > kBlockRows * kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return static_cast<int>(cudaSuccess);
  const Shape s = shape_of(e);
  // 4-bit passes over the bits of C
  int bits = 0;
  while (bits < 32 && (static_cast<unsigned>(c) >> bits) != 0u) ++bits;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  cudaError_t err = cudaSuccess;
  if (s.smem > 48 * 1024) {
    if (s.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(map_fold_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s.smem);
  }
  if (err == cudaSuccess && s.blocks > 8)
    err = cudaFuncSetAttribute(
        map_fold_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(s.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, map_fold_kernel, static_cast<const float*>(xyz_in),
      static_cast<const unsigned char*>(valid_in),
      static_cast<const int*>(overflow_in), static_cast<const float*>(pts),
      static_cast<const unsigned char*>(pts_valid),
      static_cast<const int*>(slot),
      static_cast<const unsigned char*>(claimed),
      static_cast<const unsigned char*>(failed), c, e, s.sort, s.share, passes,
      xy, xy_half, z, z_half, static_cast<float*>(xyz_out),
      static_cast<int*>(key_out), static_cast<unsigned char*>(valid_out),
      static_cast<int*>(overflow_out), static_cast<int*>(folded));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch for e rows: out[0] blocks in the cluster, out[1] of them the
// blocks that sort, out[2] threads a block, out[3] rows a sorting block,
// out[4] a block's dynamic shared memory in bytes, out[5] the most rows a
// launch takes.
extern "C" int liodom_map_fold_shape(int e, int* out) {
  const Shape s = shape_of(e < 0 ? 0 : e);
  out[0] = s.blocks;
  out[1] = s.sort;
  out[2] = kThreads;
  out[3] = s.share;
  out[4] = s.smem;
  out[5] = kBlockRows * kMaxCluster;
  return 0;
}
