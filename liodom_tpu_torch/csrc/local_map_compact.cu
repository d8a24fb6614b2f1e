// K7: local-map extraction (membership + order-preserving compaction),
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/compact_pallas_experiment.py:_compact_kernel
// (launched by compact_rows_pallas) together with the membership test of
// liodom_tpu/mapping/grid.py:get_local_map that feeds it.  A map row is a hit
// when it is valid and its int32 cell key equals one of the K target keys
// (base + offset_k, the getLocalMap neighbourhood, map.cc:141-189).  The
// first `cap` hits, in ascending row order, are copied to out_xyz; rows past
// the hit count are zero; out_valid[j] = j < n_hits; n_hits counts every hit.
// The cut at capacity is exact (the TPU kernel could stop up to a tile early).
//
// What bounds it on the card: bytes.  At the bench map (C = 524,288 rows,
// about 39,000 occupied) it must read the mask (0.5 MB), the keys of the
// occupied rows only (12 B each, about 0.5 MB: no empty row can hit) and a
// few thousand hit rows, and write a 16,384-row buffer (0.2 MB); 27 x 3
// integer compares an occupied row are far below the ALU rate.
//
// Design: the TPU kernel carried the running output offset across a
// sequential grid.  Blocks here run in no order, so it takes two launches of
// one tile grid (4,096 rows a block, 1,024 threads, one row a thread per
// step so loads coalesce):
//   1. hits_kernel: the targets go to shared memory, each thread tests its
//      rows, the block counts its hits (__syncthreads_count) and stores one
//      hit byte a row and its count;
//   2. place_kernel: each block sums the counts of the blocks before it (its
//      global offset) and of all blocks (n_hits), ranks its hits with a
//      block-wide scan (warp shuffles, then one warp over the warp sums) in
//      row order, writes the hit rows that fall below cap, and the grid
//      zero-fills rows [n_hits, cap) and writes out_valid.
// No atomics: the output is the same on every run and bit-exact with the
// plain PyTorch version (cumsum ranks + scatter).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kMaxTargets = 128;

struct Offsets {
  int v[kMaxTargets * 3];
};

// Exclusive scan of v over the block, in thread order; *total gets the sum.
// Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];   // kWarps == 32
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  *total = s_warp[kWarps - 1];
  __syncthreads();   // s_warp is reused by the next call
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
hits_kernel(const int* __restrict__ key, const unsigned char* __restrict__ valid,
            const int* __restrict__ base, Offsets offs, int n_targets,
            int rows, unsigned char* __restrict__ hit,
            int* __restrict__ block_count) {
  __shared__ int tgt[kMaxTargets * 3];
  for (int t = threadIdx.x; t < n_targets * 3; t += kThreads)
    tgt[t] = base[t % 3] + offs.v[t];
  __syncthreads();

  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  int count = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long i = row0 + r * kThreads + threadIdx.x;
    int h = 0;
    if (i < rows && valid[i]) {
      const int kx = key[3 * i + 0];
      const int ky = key[3 * i + 1];
      const int kz = key[3 * i + 2];
      for (int t = 0; t < n_targets; ++t) {
        if (kx == tgt[3 * t] && ky == tgt[3 * t + 1] && kz == tgt[3 * t + 2]) {
          h = 1;
          break;
        }
      }
    }
    if (i < rows) hit[i] = static_cast<unsigned char>(h);
    count += __syncthreads_count(h);
  }
  if (threadIdx.x == 0) block_count[blockIdx.x] = count;
}

__global__ void __launch_bounds__(kThreads)
place_kernel(const float* __restrict__ xyz,
             const unsigned char* __restrict__ hit,
             const int* __restrict__ block_count, int n_blocks, int rows,
             int cap, float* __restrict__ out_xyz,
             unsigned char* __restrict__ out_valid, int* __restrict__ n_hits) {
  __shared__ int s_warp[kWarps];
  // this block's global offset (hits of the blocks before it) and the total
  int before = 0, all = 0;
  for (int j = threadIdx.x; j < n_blocks; j += kThreads) {
    const int c = block_count[j];
    all += c;
    if (j < static_cast<int>(blockIdx.x)) before += c;
  }
  int total_before, total_all;
  block_exclusive_scan(before, s_warp, &total_before);
  block_exclusive_scan(all, s_warp, &total_all);

  long long off = total_before;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long i = row0 + r * kThreads + threadIdx.x;
    const int h = i < rows ? hit[i] : 0;
    int step_total;
    const int rank = block_exclusive_scan(h, s_warp, &step_total);
    const long long dst = off + rank;
    if (h && dst < cap) {
      out_xyz[3 * dst + 0] = xyz[3 * i + 0];
      out_xyz[3 * dst + 1] = xyz[3 * i + 1];
      out_xyz[3 * dst + 2] = xyz[3 * i + 2];
    }
    off += step_total;
  }

  // rows past the hit count: zero, and the validity of every output row
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       j < cap; j += stride) {
    const bool v = j < total_all;
    out_valid[j] = v ? 1 : 0;
    if (!v) {
      out_xyz[3 * j + 0] = 0.0f;
      out_xyz[3 * j + 1] = 0.0f;
      out_xyz[3 * j + 2] = 0.0f;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_hits = total_all;
}

}  // namespace

// xyz (C, 3) f32, key (C, 3) i32, valid (C,) bool, base (3,) i32 on the
// device; offsets (K, 3) i32 on the host, K <= 128 -> out_xyz (cap, 3) f32,
// out_valid (cap,) bool, n_hits () i32.  Scratch: hit (C,) u8 and
// block_count (ceil(C / 4096) or 1,) i32.
extern "C" int liodom_local_map_compact(const void* xyz, const void* key,
                                        const void* valid, const void* base,
                                        const void* offsets, int n_targets,
                                        int rows, int cap, void* hit,
                                        void* block_count, void* out_xyz,
                                        void* out_valid, void* n_hits,
                                        void* stream) {
  if (n_targets < 0 || n_targets > kMaxTargets || rows < 0 || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs = {};
  const int* o = static_cast<const int*>(offsets);
  for (int t = 0; t < n_targets * 3; ++t) offs.v[t] = o[t];
  const int n_blocks = rows > 0 ? (rows + kTile - 1) / kTile : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hits_kernel<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const int*>(key), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(base), offs, n_targets, rows,
      static_cast<unsigned char*>(hit), static_cast<int*>(block_count));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  place_kernel<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(xyz), static_cast<const unsigned char*>(hit),
      static_cast<const int*>(block_count), n_blocks, rows, cap,
      static_cast<float*>(out_xyz), static_cast<unsigned char*>(out_valid),
      static_cast<int*>(n_hits));
  return static_cast<int>(cudaGetLastError());
}
