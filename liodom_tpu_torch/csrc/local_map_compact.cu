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
// What bounds it on the card: latency.  The bytes are few (at the bench
// map, C = 524,288 rows with about 39,000 occupied: the 0.5 MB mask, the
// 12-byte keys of the occupied rows only, the hit rows, a 16,384-row
// output), so the time is the launch and a chain of dependent steps: the
// mask, the keys of the valid rows, the search among the targets, the
// look-back, the hit rows.  Every occupied row's key is its own 128-byte
// line and an SM issues one such line every few cycles, so the work is
// spread over the whole card (on one cluster of 16 blocks the keys and
// the search took 11 us on the H100, scripts/map_kernels_trace.py).
//
// Design: one launch, one tile of 2,048 rows a block (256 threads, 8
// contiguous rows a thread): 256 blocks at the bench, all resident.  The TPU
// kernel's sequential grid carried the running output offset from tile to
// tile; here each block finds its offset by a decoupled look-back:
//   1. each thread reads its 8 rows' mask in one load (uint2), then the
//      12-byte key of each valid row only, up to four rows' keys in flight
//      at once, and tests them against the targets, which sit in shared
//      memory (12 bytes a target, sized at launch) sorted by (x, y, z), by
//      branch-free binary searches of a fixed number of steps, the four
//      rows' interleaved; its hits stay in a register mask;
//   2. a block-wide scan (warp shuffles, then one warp over the warp sums)
//      gives each thread its offset in the tile and the tile's count, which
//      the block publishes at once in its status word;
//   3. one warp looks back over the status words of the tiles before, 32 at
//      a time, summing their counts down to the nearest tile that has
//      published its inclusive offset, then publishes its own;
//   4. the hits are placed in row order (their coordinates read four at a
//      time, those at or past `cap` dropped) with out_valid set;
//   5. the last tile, which then knows n_hits, zero-fills rows
//      [n_hits, cap) and writes n_hits.
// A status word is (tag, kind, value) in 64 bits; the tag is the launch's,
// taken from an epoch word that the last tile advances, so the words never
// need clearing between launches (no memset, in a CUDA graph too).  A
// block waits only on tiles before it (blocks start in index order; at the
// bench all 256 are resident at once).  No atomics: the output is the same
// on every run and bit-exact with the plain PyTorch version (cumsum ranks +
// scatter).  Launches on one device share the status words, so they must
// be ordered (one stream).  The targets' shared memory limits K to 19,349.
//
// Above that (liodom_local_map_compact_global, any K; the wrapper takes it
// where the targets do not fit): the same kernel with the targets left in
// device memory, the offsets sorted by (x, y, z) as three int32 arrays,
// and each key searched as key - base (mod 2^32) among them: key == base +
// offset exactly when key - base == offset, the int32 comparison of
// get_local_map.  A search wholly in device memory was a chain of
// ceil(log2 K) + 1 dependent trips through L1/L2 (16 at 19,883 targets,
// 233 KiB of offsets; 0.0162 ms against K7's 0.0103 on the H100), so the
// search is fenced: the launch picks a stride s, the smallest power of two
// for which ceil(K / s) fence entries (every s-th sorted offset) fit
// kFenceBytes of shared memory; the wrapper keeps the fence in device
// memory ahead of the offsets, each block stages it in shared memory as
// K7 stages the targets, and each key takes the branch-free search among
// the fence there, then log2 s steps inside its s-entry segment in device
// memory (one or two lines of each array, the same lines for a key's
// every step), then the one compare.  Everything else (the look-back, the
// placement, the zero-fill, the status words) is the kernel above.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 8;                       // rows a thread (load_mask)
constexpr int kTile = kThreads * kSpan;
constexpr int kBatch = 4;                      // rows whose loads fly together
constexpr int kFixedBytes = 256;               // warp sums and the offset
constexpr long long kMaxSmem = 232448;         // a block's shared memory
// the global path's fence: at most this many bytes of shared memory, 12 an
// entry (several blocks stay resident on an SM)
constexpr long long kFenceBytes = 32768;
constexpr unsigned long long kAggregate = 1;   // a status word's kinds
constexpr unsigned long long kInclusive = 2;

__host__ __device__ constexpr long long smem_bytes(long long n_targets) {
  return kFixedBytes + n_targets * 12;
}

// the global path's fence stride for K targets: the smallest power of two
// s with ceil(K / s) entries in kFenceBytes, as log2 s
__host__ __device__ inline int fence_shift(long long n_targets) {
  int shift = 0;
  while (((n_targets + (1LL << shift) - 1) >> shift) * 12 > kFenceBytes)
    ++shift;
  return shift;
}

__host__ __device__ inline int fence_count(long long n_targets, int shift) {
  return static_cast<int>((n_targets + (1LL << shift) - 1) >> shift);
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// (tag, kind, value): the tag in the top 30 bits, the kind in the next 2
__device__ __forceinline__ unsigned long long status(unsigned tag,
                                                     unsigned long long kind,
                                                     unsigned value) {
  return (static_cast<unsigned long long>(tag) << 34) | (kind << 32) | value;
}

// The validity of a thread's 8 rows from row0 as 8 bits (bit j: row
// row0 + j is valid): one 8-byte load of the mask, or byte loads at the
// ragged end.
__device__ __forceinline__ unsigned load_mask(
    const unsigned char* __restrict__ valid, long long row0, int rows) {
  uint2 v = make_uint2(0u, 0u);
  if (row0 + kSpan <= rows) {
    v = __ldg(reinterpret_cast<const uint2*>(valid + row0));
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (row0 + b < rows)
        v.x |= static_cast<unsigned>(valid[row0 + b]) << (8 * b);
      if (row0 + 4 + b < rows)
        v.y |= static_cast<unsigned>(valid[row0 + 4 + b]) << (8 * b);
    }
  }
  const unsigned lo = __vcmpne4(v.x, 0u) & 0x01010101u;
  const unsigned hi = __vcmpne4(v.y, 0u) & 0x01010101u;
  return ((lo * 0x01020408u) >> 24) | (((hi * 0x01020408u) >> 24) << 4);
}

// Bytes [lo, hi) of p (16-byte aligned) set to 0 by the block's threads,
// 16 bytes a store but at the two ends.
__device__ __forceinline__ void zero_bytes(unsigned char* __restrict__ p,
                                           long long lo, long long hi) {
  const long long a = min(hi, (lo + 15) & ~15LL);
  const long long b = max(a, hi & ~15LL);
  for (long long j = lo + threadIdx.x; j < a; j += kThreads) p[j] = 0;
  for (long long j = a / 16 + threadIdx.x; j < b / 16; j += kThreads)
    reinterpret_cast<uint4*>(p)[j] = make_uint4(0u, 0u, 0u, 0u);
  for (long long j = b + threadIdx.x; j < hi; j += kThreads) p[j] = 0;
}

// Membership of kBatch keys at once: each key's lower bound among the
// `count` targets, which sit in shared memory sorted by (x, y, z) as three
// arrays, by a branch-free binary search of a fixed number of steps (the
// same for every lane), the kBatch searches interleaved so their loads
// overlap; then one compare each.  Bit q of the result: key q is a target.
__device__ __forceinline__ unsigned targets_hit(
    const int* __restrict__ tx, const int* __restrict__ ty,
    const int* __restrict__ tz, int count, const int (&x)[kBatch],
    const int (&y)[kBatch], const int (&z)[kBatch]) {
  int pos[kBatch];
#pragma unroll
  for (int q = 0; q < kBatch; ++q) pos[q] = 0;     // targets below key q
  for (int step = count > 0 ? 1 << (31 - __clz(count)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int m = pos[q] + step - 1;
      const int mm = m < count ? m : count - 1;
      const int a = tx[mm], b = ty[mm], c = tz[mm];
      const bool below =
          (a < x[q]) |
          ((a == x[q]) & ((b < y[q]) | ((b == y[q]) & (c < z[q]))));
      pos[q] += (m < count && below) ? step : 0;
    }
  }
  unsigned hit = 0;
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const int m = pos[q] < count ? pos[q] : 0;
    hit |= (pos[q] < count && tx[m] == x[q] && ty[m] == y[q] &&
            tz[m] == z[q])
               ? 1u << q
               : 0u;
  }
  return hit;
}

// Membership of kBatch keys (already shifted by -base) on the global path:
// g, the fence entries below each key, by targets_hit's search among the
// `fence` entries in shared memory; the key's lower bound is then past
// target (g - 1) s and at most g s, found by log2 s fixed steps among the
// `count` offsets in device memory (every index past g s holds a larger
// offset, so only the end of the array bounds a step), the kBatch searches
// interleaved; then one compare each.  s == 1: the fence is the offsets.
__device__ __forceinline__ unsigned targets_hit_fenced(
    const int* __restrict__ fx, const int* __restrict__ fy,
    const int* __restrict__ fz, int fence, const int* __restrict__ tx,
    const int* __restrict__ ty, const int* __restrict__ tz, int count,
    int shift, const int (&x)[kBatch], const int (&y)[kBatch],
    const int (&z)[kBatch]) {
  int g[kBatch];
#pragma unroll
  for (int q = 0; q < kBatch; ++q) g[q] = 0;       // fence entries below
  for (int step = fence > 0 ? 1 << (31 - __clz(fence)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int m = g[q] + step - 1;
      const int mm = m < fence ? m : fence - 1;
      const int a = fx[mm], b = fy[mm], c = fz[mm];
      const bool below =
          (a < x[q]) |
          ((a == x[q]) & ((b < y[q]) | ((b == y[q]) & (c < z[q]))));
      g[q] += (m < fence && below) ? step : 0;
    }
  }
  unsigned hit = 0;
  if (shift == 0) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int m = g[q] < fence ? g[q] : 0;
      hit |= (g[q] < fence && fx[m] == x[q] && fy[m] == y[q] &&
              fz[m] == z[q])
                 ? 1u << q
                 : 0u;
    }
    return hit;
  }
  int pos[kBatch];                                 // the last offset below
#pragma unroll
  for (int q = 0; q < kBatch; ++q) pos[q] = (g[q] - 1) << shift;
  for (int step = 1 << (shift - 1); step > 0; step >>= 1) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int m = pos[q] + step;
      const int mm = g[q] > 0 && m < count ? m : 0;
      const int a = __ldg(tx + mm), b = __ldg(ty + mm), c = __ldg(tz + mm);
      const bool below =
          (a < x[q]) |
          ((a == x[q]) & ((b < y[q]) | ((b == y[q]) & (c < z[q]))));
      pos[q] = (g[q] > 0 && m < count && below) ? m : pos[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const int lb = g[q] > 0 ? pos[q] + 1 : 0;      // the lower bound
    const int m = lb < count ? lb : 0;
    hit |= (lb < count && __ldg(tx + m) == x[q] && __ldg(ty + m) == y[q] &&
            __ldg(tz + m) == z[q])
               ? 1u << q
               : 0u;
  }
  return hit;
}

// kSmemTargets: the targets base + offset in shared memory, offs (K, 3);
// else offs (3, F + K): the fence (every s-th sorted offset, F = ceil(K /
// s), fence_shift), then the offsets alone, each row's x, y and z
// contiguous, the fence staged in shared memory and the keys searched as
// key - base.
template <bool kSmemTargets>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const float* __restrict__ xyz, const int* __restrict__ key,
               const unsigned char* __restrict__ valid,
               const int* __restrict__ base, const int* __restrict__ offs,
               int n_targets, int rows, int cap,
               unsigned long long* __restrict__ state,
               float* __restrict__ out_xyz,
               unsigned char* __restrict__ out_valid,
               int* __restrict__ n_hits) {
  extern __shared__ __align__(16) int smem[];
  int* s_warp = smem;                    // the warps' inclusive sums
  int* s_off = smem + kWarps;            // the tile's offset
  int* s_tx = smem + kFixedBytes / 4;    // the targets' x, y and z,
  int* s_ty = s_tx + n_targets;          // sorted by (x, y, z)
  int* s_tz = s_ty + n_targets;
  int shift = 0, fence = 0;              // the global path's fence
  if constexpr (!kSmemTargets) {
    shift = fence_shift(n_targets);
    fence = fence_count(n_targets, shift);
    s_ty = s_tx + fence;
    s_tz = s_ty + fence;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const bool last = tile == static_cast<int>(gridDim.x) - 1;
  // the launch's tag: one past the epoch the launch before left
  const unsigned tag =
      static_cast<unsigned>(ld_relaxed(state) % 0x3FFFFFFFull) + 1u;
  unsigned long long* words = state + 1;

  // 1. the mask, the targets, the keys of the valid rows, membership
  const long long row0 = static_cast<long long>(tile) * kTile +
                         static_cast<long long>(tid) * kSpan;
  unsigned todo = load_mask(valid, row0, rows);   // bit j: row row0 + j
  // what the keys are shifted by before the search: 0, or -base
  unsigned sx = 0u, sy = 0u, sz = 0u;
  if constexpr (kSmemTargets) {
    for (int t = tid; t < n_targets; t += kThreads) {
      s_tx[t] = base[0] + offs[3 * t];
      s_ty[t] = base[1] + offs[3 * t + 1];
      s_tz[t] = base[2] + offs[3 * t + 2];
    }
    __syncthreads();
  } else {
    sx = 0u - static_cast<unsigned>(base[0]);
    sy = 0u - static_cast<unsigned>(base[1]);
    sz = 0u - static_cast<unsigned>(base[2]);
    for (int t = tid; t < 3 * fence; t += kThreads) s_tx[t] = __ldg(offs + t);
    __syncthreads();
  }
  unsigned hits = 0;
  while (todo != 0) {
    int j[kBatch], kx[kBatch], ky[kBatch], kz[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      j[q] = todo != 0 ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      const int* kp = key + 3 * (row0 + (j[q] < 0 ? 0 : j[q]));
      kx[q] = j[q] >= 0 ? __ldg(kp + 0) : 0;
      ky[q] = j[q] >= 0 ? __ldg(kp + 1) : 0;
      kz[q] = j[q] >= 0 ? __ldg(kp + 2) : 0;
      if constexpr (!kSmemTargets) {     // key - base, wrapping as int32
        kx[q] = static_cast<int>(static_cast<unsigned>(kx[q]) + sx);
        ky[q] = static_cast<int>(static_cast<unsigned>(ky[q]) + sy);
        kz[q] = static_cast<int>(static_cast<unsigned>(kz[q]) + sz);
      }
    }
    unsigned found;
    if constexpr (kSmemTargets) {
      found = targets_hit(s_tx, s_ty, s_tz, n_targets, kx, ky, kz);
    } else {
      const int* t = offs + 3 * fence;   // the offsets past the fence
      found = targets_hit_fenced(s_tx, s_ty, s_tz, fence, t, t + n_targets,
                                 t + 2 * n_targets, n_targets, shift, kx, ky,
                                 kz);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (j[q] >= 0 && ((found >> q) & 1u)) hits |= 1u << j[q];
  }

  // 2. this thread's offset in the tile, and the tile's count, published
  const int mine = __popc(hits);
  int x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    const unsigned count = __shfl_sync(0xffffffffu, w, kWarps - 1);
    if (lane < kWarps) s_warp[lane] = w;

    // 3. the look-back
    unsigned before = 0;
    if (tile == 0) {
      if (lane == 0) st_relaxed(words, status(tag, kInclusive, count));
    } else {
      if (lane == 0) st_relaxed(words + tile, status(tag, kAggregate, count));
      for (int end = tile;;) {       // the tiles [end - 32, end) in turn
        const int p = end - 1 - lane;
        unsigned long long st = 0;
        if (p >= 0) {
          do {
            st = ld_relaxed(words + p);
          } while (static_cast<unsigned>(st >> 34) != tag);
        }
        const unsigned incl = __ballot_sync(
            0xffffffffu, p >= 0 && ((st >> 32) & 3u) == kInclusive);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        unsigned v = (p >= 0 && lane <= stop)
                         ? static_cast<unsigned>(st & 0xFFFFFFFFull)
                         : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, o);
        before += __shfl_sync(0xffffffffu, v, 0);
        if (incl || end <= 32) break;
        end -= 32;
      }
      if (lane == 0)
        st_relaxed(words + tile, status(tag, kInclusive, before + count));
    }
    if (lane == 0) *s_off = static_cast<int>(before);
    // every tile has read the epoch (each published before this one could
    // find its offset): the next launch takes the next tag
    if (last && lane == 0) st_relaxed(state, tag);
  }
  __syncthreads();

  // 4. place the hits in row order, kBatch rows' coordinates in flight
  int dst = *s_off + (warp > 0 ? s_warp[warp - 1] : 0) + x - mine;
  while (hits != 0 && dst < cap) {
    int j[kBatch];
    float px[kBatch], py[kBatch], pz[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      j[q] = hits != 0 && dst + q < cap ? __ffs(hits) - 1 : -1;
      if (j[q] >= 0) hits &= hits - 1;
      const float* p = xyz + 3 * (row0 + (j[q] < 0 ? 0 : j[q]));
      px[q] = j[q] >= 0 ? __ldg(p + 0) : 0.0f;
      py[q] = j[q] >= 0 ? __ldg(p + 1) : 0.0f;
      pz[q] = j[q] >= 0 ? __ldg(p + 2) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (j[q] < 0) continue;
      out_xyz[3LL * (dst + q) + 0] = px[q];
      out_xyz[3LL * (dst + q) + 1] = py[q];
      out_xyz[3LL * (dst + q) + 2] = pz[q];
      out_valid[dst + q] = 1;
    }
    dst += kBatch;
  }

  // 5. the last tile: rows past the hit count, and the count
  if (last) {
    const int total = *s_off + s_warp[kWarps - 1];
    const int from = total < cap ? total : cap;
    zero_bytes(out_valid, from, cap);
    zero_bytes(reinterpret_cast<unsigned char*>(out_xyz), 12LL * from,
               12LL * cap);
    if (tid == 0) *n_hits = total;
  }
}

}  // namespace

// xyz (C, 3) f32, key (C, 3) i32, valid (C,) bool (16-byte aligned), base
// (3,) i32, offsets (K, 3) i32 sorted by (x, y, z), state (1 + tiles,) u64
// (zeroed once, then the kernel's), all on the device -> out_xyz (cap, 3)
// f32 and out_valid (cap,) bool (both 16-byte aligned), n_hits () i32.
// One launch of ceil(C / 2048) blocks (at least 1).  Refused
// (cudaErrorInvalidValue) when the targets need more than a block's 227 KB
// of shared memory (K > 19,349).
extern "C" int liodom_local_map_compact(const void* xyz, const void* key,
                                        const void* valid, const void* base,
                                        const void* offsets, int n_targets,
                                        int rows, int cap, void* state,
                                        void* out_xyz, void* out_valid,
                                        void* n_hits, void* stream) {
  if (n_targets < 0 || rows < 0 || cap < 0 ||
      smem_bytes(n_targets) > kMaxSmem ||
      ((reinterpret_cast<unsigned long long>(valid) |
        reinterpret_cast<unsigned long long>(out_xyz) |
        reinterpret_cast<unsigned long long>(out_valid)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = rows > 0 ? (rows + kTile - 1) / kTile : 1;
  const int smem = static_cast<int>(smem_bytes(n_targets));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        compact_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  compact_kernel<true><<<tiles, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(key),
      static_cast<const unsigned char*>(valid), static_cast<const int*>(base),
      static_cast<const int*>(offsets), n_targets, rows, cap,
      static_cast<unsigned long long*>(state), static_cast<float*>(out_xyz),
      static_cast<unsigned char*>(out_valid), static_cast<int*>(n_hits));
  return static_cast<int>(cudaGetLastError());
}

// The same with the targets in device memory, any K >= 0: offsets (3 F +
// 3 K,) i32 (liodom_local_map_fence: F fence entries of stride s), the
// fence's x, y and z rows of length F (every s-th sorted offset), then the
// x, y and z of the offsets sorted by (x, y, z), rows of length K (the
// base is not added); everything else as above.  A block's shared memory
// is kFixedBytes plus the fence's 12 F.
extern "C" int liodom_local_map_compact_global(
    const void* xyz, const void* key, const void* valid, const void* base,
    const void* offsets, int n_targets, int rows, int cap, void* state,
    void* out_xyz, void* out_valid, void* n_hits, void* stream) {
  if (n_targets < 0 || rows < 0 || cap < 0 ||
      ((reinterpret_cast<unsigned long long>(valid) |
        reinterpret_cast<unsigned long long>(out_xyz) |
        reinterpret_cast<unsigned long long>(out_valid)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = rows > 0 ? (rows + kTile - 1) / kTile : 1;
  const int smem = static_cast<int>(
      kFixedBytes + 12LL * fence_count(n_targets, fence_shift(n_targets)));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        compact_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  compact_kernel<false><<<tiles, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(key),
      static_cast<const unsigned char*>(valid), static_cast<const int*>(base),
      static_cast<const int*>(offsets), n_targets, rows, cap,
      static_cast<unsigned long long*>(state), static_cast<float*>(out_xyz),
      static_cast<unsigned char*>(out_valid), static_cast<int*>(n_hits));
  return static_cast<int>(cudaGetLastError());
}

// The launch for C rows and K targets: out[0] blocks (tiles), out[1]
// threads a block, out[2] rows a thread, out[3] a block's dynamic shared
// memory in bytes, out[4] the most targets.
extern "C" int liodom_local_map_compact_shape(int rows, int n_targets,
                                              int* out) {
  out[0] = rows > 0 ? (rows + kTile - 1) / kTile : 1;
  out[1] = kThreads;
  out[2] = kSpan;
  out[3] = static_cast<int>(smem_bytes(n_targets));
  out[4] = static_cast<int>((kMaxSmem - kFixedBytes) / 12);
  return 0;
}

// The global path's fence for K targets: out[0] the stride s, out[1] the
// fence entries F = ceil(K / s), out[2] a block's dynamic shared memory in
// bytes.
extern "C" int liodom_local_map_fence(int n_targets, int* out) {
  const int shift = fence_shift(n_targets < 0 ? 0 : n_targets);
  out[0] = 1 << shift;
  out[1] = fence_count(n_targets < 0 ? 0 : n_targets, shift);
  out[2] = static_cast<int>(kFixedBytes + 12LL * out[1]);
  return 0;
}
