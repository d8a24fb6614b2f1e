// K2: region-wise greedy edge selection, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel liodom_tpu/ops/select_pallas.py:_select_kernel
// (launched by select_edges_pallas; above 128 slots a ring the JAX package
// takes select_edges_xla, which this kernel also replaces).  Per ring,
// regions j = 0..n_regions-1 in order, each with up to max_picks dependent
// picks (reference feature_extractor.cc:256-313):
//   - candidates: columns in [start_j, end_j) not yet picked, ring active,
//     region not ended;
//   - pick = highest smoothness, lowest column on ties; it must be >= thr
//     (and > -inf), else the region ends (the first failing pick ends it);
//   - a pick marks itself and up to 5 neighbours per side as picked, a
//     neighbour only while every consecutive-point gap^2 between it and the
//     pick is <= gap_thr; the picked mask carries across regions.
// Outputs per (ring, slot = region * max_picks + pick): the column (bidx),
// whether the slot holds an edge (bval) and the edge's xyz, zero otherwise.
//
// What bounds it on the card: latency, not bytes or operations.  It reads
// ~1.8 MB (the smoothness plane and the ring image at 64 x 4096) and does a
// few million compares, but each ring's picks form a dependent chain.  The
// earlier design (one block of 512 threads a ring, 64 blocks) ran that
// chain as 88 block-wide arg-max reductions, each ended by barriers:
// 0.13766 ms at the bench shape (NVIDIA H100 80GB HBM3, 700 W), ~1.56 us a
// pick.
//
// This design shortens the chain instead of each reduction.  The greedy
// "best unpicked column, stop at the first below thr" visits a region's
// columns in (value desc, column asc) order: walking that order, skipping
// marked columns and stopping at the first unmarked one that fails, gives
// the same picks, because marks are only ever added (the first unmarked
// entry after the cursor is always the current arg-max).  Each pick marks
// at most 10 other columns and the earlier regions' picks at most the
// first 5 of this one, so a region's walk visits at most
// L = 11 * max_picks + 5 entries of that order.
//   Phase 1 (parallel): a cluster of C = min(n_regions, 8) blocks a ring
//   (grid rings x C); block r takes regions r, r + C, ...  For each it
//   loads the region's values into shared memory (-0.0 folded into +0.0 and
//   NaN into -inf, so that the order is the one better() gives), ranks
//   every column by counting the columns before it, and writes the ones of
//   rank < L, as (value, column, reach), into cluster rank 0's shared
//   memory through distributed shared memory.  The reach is how many
//   neighbours a pick there suppresses forward and backward, from the ring's
//   gap flags gap[c] = |p[c] - p[c-1]|^2 <= gap_thr, each operation rounded
//   on its own in the plain version's order.
//   Phase 2 (per ring, one warp of rank 0): the regions in order, each walked
//   a window of 32 entries at a time, all the window's picks resolved
//   together by ballots (below, at the walk): about one step a window and
//   one a conflict inside it, 51 at most on the bench frame's rings against
//   88 block-wide reductions (a first walk here, one ballot a pick, read
//   0.0337 ms and this one 0.0289, in two calls whose earlier kernel read
//   0.1345 both times, scripts/select_walk_experiment.py; a block's ranking
//   takes ~6.4 us and rank 0's walk ~10.5, scripts/select_walk_trace.py).
// Then rank 0 writes the ring's slots.  Comparisons only, no arithmetic on
// the smoothness values: the result is bit-exact with the plain PyTorch
// version for a finite smoothness plane, and with the earlier kernel for
// any plane.  The lists (region after region, each min(L, its length)
// entries, so at most min(n_regions L, width) in all), the slots and a
// region's values live in dynamic shared memory sized at launch
// (select_smem_bytes), so any number of slots a ring fits while
// 8 min(n_regions L, width) + 4 S + 5 width + 10 bytes fit a block's
// 227 KB: every S at the bench's 4096 columns.
//
// Wider rings (liodom_select_edges_global; the wrapper takes it where
// select_smem_bytes exceeds 227 KB): the same walk, but no array of the
// ring's width in shared memory, and the lists built by a top-L selection
// instead of the ranking, whose O(len^2) compares were nearly all of the
// time on long regions (5.37 ms at 64 x 49,152 columns, ~6,100-column
// regions, 88 slots, on the H100).  For each of its regions a block:
//   - maps each column's folded value to a 32-bit key whose ascending
//     order is the value's descending order (bits u of the folded float,
//     asc = u < 0 ? ~u : u | 2^31, key = ~asc; equal keys are equal
//     values), kept in shared memory while the region fits the room left
//     (keys_room columns), else recomputed from the smoothness plane at
//     each pass;
//   - finds the key t of the region's n-th entry, n = min(L, len), by a
//     radix select: a histogram of one kRadixBits digit of the keys that
//     share the digits found so far, most significant first, each pass
//     keeping the digit whose counts reach the rank left, stopping early
//     once every key with the prefix found is wanted;
//   - keeps the keys below the prefix (atomics place them in any order),
//     then the lowest columns among those equal to it, up to the count
//     left, by a block-wide prefix count in column order (256 columns a
//     step, stopped once enough are taken): exactly the region's first n
//     entries of the (value desc, column asc) order;
//   - orders the keys below t as 64-bit (key << 32 | column): while the
//     list has at most one entry a thread by counting (each thread ranks
//     its own in one sweep over the others, broadcast reads), else by a
//     bitonic network of ascending comparators in place, each comparator
//     past their count skipped (the padding would be +inf at the top,
//     which none of them moves); the ties at t follow in column order
//     already (where every key with the prefix is wanted, all are ranked);
//   - writes each as (value, column, reach) at its place in rank 0's list,
//     the reach from the ring image (gap_small, the same rounded
//     operations): from the region's gap flags, found in parallel into the
//     keys' room, where the entries' 11-column neighbourhoods cover the
//     region (11 n >= len), else gap after gap at each entry.
// A network for a 300-entry list took 8.6 us of a block's 46 and the
// gaps read one after another 16.6 at 64 x 38,741 columns, 424 slots;
// counting 4 entries a thread took longer than the network there
// (scripts/select_walk_trace.py, the H100); the registers are held to 48
// (select_global_kernel's launch bounds) so that 5 blocks share an SM and
// 64 rings of 8-block clusters start in one wave where shared memory
// allows it (at 64 registers, 4 an SM, a cluster waited ~30 us; at 424
// slots a block's 59.8 KB allow 3, and a quarter of the clusters wait).
// The sort runs in the block's own shared memory (rank 0 in place in its
// lists, the others in their unused list room), or in place in the scratch
// when the lists are there.  Rank 0's walk is the one above, its window
// tags and picked mask in a device scratch of 5 bytes a column and ring
// (set by every block of the cluster before it starts); the lists and
// slots stay in shared memory while 8 min(n_regions L, width) + 4 S
// bytes leave room for the histogram, else they too go to the scratch,
// where the other blocks' list writes reach rank 0 through cluster.sync()
// (a release arrive and an acquire wait at cluster scope order global
// writes as shared ones).  Each ring has its own scratch, so no cluster
// reads another's; launches on one stream are ordered.  The same lists,
// so the same picks: bit-exact with the shared-memory kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;   // a block's dynamic shared memory, 227 KB
constexpr int kColMask = 0xffffff;
// the global path's radix select: bits a digit, bins a histogram, and the
// bins each thread scans
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kBinsPerThread = (kBins + kThreads - 1) / kThreads;
// its fixed shared memory: the histogram, the warps' counts and the
// select's scalars (16-byte aligned)
constexpr int kWorkBytes = (4 * (kBins + 16) + 15) & ~15;
// blocks an SM the global path's registers leave room for: 64 rings of
// 8-block clusters then start in one wave where shared memory allows it
// (at 64 registers, 4 an SM, a cluster waited on the H100)
constexpr int kGlobalBlocksPerSm = 5;

// L: the entries of a region's order that the walk can visit
long long list_len(int max_picks) { return 11LL * max_picks + 5; }

// A block's dynamic shared memory: the lists (8 bytes an entry, together
// at most min(n_regions L, width) entries: the regions are disjoint), the
// slots (4 bytes), a region's values (4 bytes a column) and its gap flags
// (1 byte a column, 10 more).
long long select_smem_bytes(int width, int n_regions, int max_picks) {
  const long long lists = n_regions * list_len(max_picks);
  return 8LL * (lists < width ? lists : width) +
         4LL * n_regions * max_picks + 5LL * width + 10;
}

__device__ __forceinline__ void region_bounds(int j, int n_regions, int total,
                                              int sector, int width,
                                              int& start, int& len) {
  start = 5 + sector * j;
  const int end = 5 + (j == n_regions - 1 ? total : sector * (j + 1));
  len = max(0, min(end, width) - start);
}

// where region j's list starts: after min(L, length) entries of each
// region before it
__device__ __forceinline__ int list_offset(int j, int n_regions, int total,
                                           int sector, int width, int cap) {
  int off = 0;
  for (int i = 0; i < j; ++i) {
    int start, len;
    region_bounds(i, n_regions, total, sector, width, start, len);
    off += min(len, cap);
  }
  return off;
}

// how far a pick at b suppresses: bits 0-2 forward, 3-5 backward
__device__ __forceinline__ bool covers(int d, int reach) {
  return d == 0 || (d > 0 && d <= (reach & 7)) ||
         (d < 0 && -d <= (reach >> 3));
}

// gap[c] = |p[c] - p[c-1]|^2 <= gap_thr (c - 1 wrapping at column 0, the
// roll's), each operation rounded on its own in the plain version's order
__device__ __forceinline__ bool gap_small(const float* p, int c, int width,
                                          float gap_thr) {
  const int prev = c == 0 ? width - 1 : c - 1;
  const float dx = __fsub_rn(p[3 * c + 0], p[3 * prev + 0]);
  const float dy = __fsub_rn(p[3 * c + 1], p[3 * prev + 1]);
  const float dz = __fsub_rn(p[3 * c + 2], p[3 * prev + 2]);
  const float g = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return g <= gap_thr;
}

// the global path's order key of a smoothness value: NaN as -inf, -0.0 as
// +0.0, then bits whose ascending order is the value's descending order
__device__ __forceinline__ unsigned order_key(float v) {
  const float f = v != v ? -INFINITY : (v == 0.0f ? 0.0f : v);
  const unsigned u = __float_as_uint(f);
  return ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}

// the folded value's bits back from its order key
__device__ __forceinline__ int key_value(unsigned key) {
  const unsigned asc = ~key;
  return static_cast<int>((asc & 0x80000000u) ? (asc & 0x7fffffffu) : ~asc);
}

// buf[0, n) sorted ascending by the block: a bitonic network over the next
// power of two p >= n with ascending comparators only (each stage's first
// step compares i with its mirror in the 2^s block, the rest i with i + j),
// every comparator whose upper index is n or more skipped.  buf is shared,
// another block's shared or global memory (generic addressing).
__device__ void sort_block(unsigned long long* buf, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int c = threadIdx.x; c < p / 2; c += kThreads) {
        const int off = c & (j - 1);
        const int lo = 2 * c - off;
        const int hi = lo + (j == k >> 1 ? k - 1 - 2 * off : j);
        if (hi < n) {
          const unsigned long long a = buf[lo], b = buf[hi];
          if (b < a) {
            buf[lo] = b;
            buf[hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// One region's list on the global path, by the block: the first n =
// min(cap, len) entries of the region's (value desc, column asc) order,
// written to dst as (value, column | reach << 24).  s_key holds the
// region's keys when it has keys_room columns or fewer, else each pass
// reads the plane; work is kWorkBytes of shared memory; buf, n 64-bit
// entries, is where they are sorted (dst itself when it is the block's own).
__device__ void region_list_topl(const float* __restrict__ row_smooth,
                                 const float* __restrict__ p, int width,
                                 float gap_thr, int start, int len, int cap,
                                 unsigned* s_key, int keys_room, int* work,
                                 unsigned long long* buf,
                                 unsigned long long* dst) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* hist = work;                       // kBins counts
  int* s_warp = work + kBins;             // 8 warps' counts
  int* s_sel = s_warp + kThreads / 32;    // digit, rank left, below, all
  const int n = min(cap, len);
  const bool in_smem = len <= keys_room;
  if (in_smem) {
    for (int i = tid; i < len; i += kThreads)
      s_key[i] = order_key(__ldg(row_smooth + start + i));
    __syncthreads();
  }
  auto key_at = [&](int i) -> unsigned {
    return in_smem ? s_key[i] : order_key(__ldg(row_smooth + start + i));
  };

  // the radix select: prefix/mask the digits found, k the rank left among
  // the keys that share them, below the count of keys under the prefix
  unsigned prefix = 0, mask = 0;
  int k = n, below = 0;
  bool take_all = n == len;
  for (int hi = 32; !take_all && hi > 0;) {
    const int lo = hi > kRadixBits ? hi - kRadixBits : 0;
    const unsigned ones = (1u << (hi - lo)) - 1u;
    for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
    __syncthreads();
    for (int i = tid; i < len; i += kThreads) {
      const unsigned key = key_at(i);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> lo) & ones], 1);
    }
    __syncthreads();
    // each thread's run of bins, then a scan over the threads
    const int b0 = tid * kBinsPerThread;
    int mine = 0;
#pragma unroll
    for (int b = 0; b < kBinsPerThread; ++b)
      mine += b0 + b < kBins ? hist[b0 + b] : 0;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int excl = incl - mine;
    for (int w = 0; w < warp; ++w) excl += s_warp[w];
    if (excl < k && k <= excl + mine) {
      for (int b = b0;; ++b) {
        const int h = hist[b];
        if (k <= excl + h) {
          s_sel[0] = b;
          s_sel[1] = k - excl;
          s_sel[2] = excl;
          s_sel[3] = k - excl == h;
          break;
        }
        excl += h;
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(s_sel[0]) << lo;
    mask |= ones << lo;
    k = s_sel[1];
    below += s_sel[2];
    take_all = s_sel[3] != 0;
    hi = lo;
    __syncthreads();                      // hist, s_warp, s_sel reused
  }

  // the kept entries into buf as key << 32 | column: below the prefix (and
  // at it, when every such key is wanted) by atomics in any order
  if (tid == 0) s_sel[4] = 0;
  __syncthreads();
  for (int i = tid; i < len; i += kThreads) {
    const unsigned key = key_at(i);
    const unsigned m = key & mask;
    if (m < prefix || (take_all && m == prefix))
      buf[atomicAdd(&s_sel[4], 1)] =
          (static_cast<unsigned long long>(key) << 32) | (start + i);
  }
  // else the k lowest columns whose key is the prefix, in column order
  for (int base = 0, run = 0; !take_all && base < len && run < k;
       base += kThreads) {
    const int i = base + tid;
    const unsigned key = i < len ? key_at(i) : 0u;
    const bool eq = i < len && key == prefix;
    const unsigned ball = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int r = run + __popc(ball & ((1u << lane) - 1u));
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) r += s_warp[w];
      run += s_warp[w];
    }
    if (eq && r < k)
      buf[below + r] =
          (static_cast<unsigned long long>(key) << 32) | (start + i);
    __syncthreads();                      // s_warp reused
  }
  __syncthreads();
  // the keys are done: where the entries' neighbourhoods cover the region
  // (11 n >= len), their room takes the region's gap flags, [start - 4,
  // start + len + 5), found in parallel; else each entry reads the ring
  // image, one gap after another
  const int lo_gap = start - 4;
  const bool gaps = 11 * n >= len && len + 9 <= 4 * keys_room;
  unsigned char* s_gap = reinterpret_cast<unsigned char*>(s_key);
  if (gaps) {
    const int end_gap = min(start + len + 5, width);
    for (int c = lo_gap + tid; c < end_gap; c += kThreads)
      s_gap[c - lo_gap] = gap_small(p, c, width, gap_thr) ? 1 : 0;
  }
  // the order: the m keys below t are ranked (the ties taken at t follow
  // them in column order already; where every key with the prefix is
  // wanted, all n are ranked): by counting while the list has at most one
  // entry a thread, each ranking its own in one sweep over the others,
  // else by the network in place
  const int m = take_all ? n : below;
  const bool counted = n <= kThreads;
  const unsigned long long mine = counted && tid < n ? buf[tid] : 0ull;
  int rank = tid;                         // a tie keeps its place
  if (counted && tid < m) {
    rank = 0;
    for (int j = 0; j < m; ++j) rank += buf[j] < mine;
  }
  if (!counted) sort_block(buf, m);
  __syncthreads();                        // the flags; buf read before written

  // (value, column | reach << 24) at its place: a pick at b suppresses
  // b + l while the gaps b+1 .. b+l are small, b - l while the gaps
  // b-l+1 .. b are
  auto put = [&](unsigned long long e, int at) {
    const int b = static_cast<int>(e & 0xffffffffu);
    int fwd = 0, bwd = 0;
    if (gaps) {
      while (fwd < 5 && b + fwd + 1 < width && s_gap[b + fwd + 1 - lo_gap])
        ++fwd;
      while (bwd < 5 && b - bwd - 1 >= 0 && s_gap[b - bwd - lo_gap]) ++bwd;
    } else {
      while (fwd < 5 && b + fwd + 1 < width &&
             gap_small(p, b + fwd + 1, width, gap_thr))
        ++fwd;
      while (bwd < 5 && b - bwd - 1 >= 0 &&
             gap_small(p, b - bwd, width, gap_thr))
        ++bwd;
    }
    const unsigned y = static_cast<unsigned>(b | ((fwd | (bwd << 3)) << 24));
    dst[at] = (static_cast<unsigned long long>(y) << 32) |
              static_cast<unsigned>(key_value(static_cast<unsigned>(e >> 32)));
  };
  if (counted) {
    if (tid < n) put(mine, rank);
  } else {
    for (int i = tid; i < n; i += kThreads) put(buf[i], i);
  }
  __syncthreads();                        // s_key, work, buf reused
}

// kSmem: every array in shared memory (list_room lists, slots, values and
// gap flags of `width` columns).  Else (the global path) scratch holds, for
// each ring, the window tags (4 bytes a column) and the picked mask (1),
// then, when lists_global, the lists and slots; shared memory holds the
// lists and slots otherwise, then the select's work area (kWorkBytes) and
// a region's keys while it is at most keys_room columns.
template <bool kSmem>
__device__ __forceinline__ void select_body(
    const float* __restrict__ smooth, const int* __restrict__ count,
    const float* __restrict__ xyz, int width, int n_regions, int max_picks,
    int min_points, float thr, float gap_thr, int list_cap, int list_room,
    int* __restrict__ bidx, int* __restrict__ bval, float* __restrict__ pts,
    unsigned char* scratch, long long ring_bytes, bool lists_global,
    int keys_room) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int ring = blockIdx.x / n_blocks;
  const int tid = threadIdx.x;
  const int slots = n_regions * max_picks;
  int2* lists = reinterpret_cast<int2*>(smem);     // every region's list
  int* s_col = reinterpret_cast<int*>(lists + list_room);
  float* s_v = reinterpret_cast<float*>(s_col + slots);  // a region's values
  unsigned char* s_gap = reinterpret_cast<unsigned char*>(s_v + width);
  // the walk's (rank 0's) use of the same room: a window tag a column
  // (stamp << 11 | reach << 5 | lane), and the picked mask
  int* s_tag = reinterpret_cast<int*>(s_v);
  unsigned char* s_picked = s_gap;
  int* work = nullptr;                   // the global path's select
  unsigned* s_key = nullptr;             // and a region's keys
  if constexpr (!kSmem) {
    unsigned char* mine = scratch + static_cast<size_t>(ring) * ring_bytes;
    s_tag = reinterpret_cast<int*>(mine);
    s_picked = mine + 4LL * width;
    if (lists_global) {
      lists = reinterpret_cast<int2*>(mine + ((5LL * width + 7) & ~7LL));
      s_col = reinterpret_cast<int*>(lists + list_room);
    }
    work = reinterpret_cast<int*>(
        smem + (lists_global ? 0 : ((8LL * list_room + 4LL * slots + 15) &
                                    ~15LL)));
    s_key = reinterpret_cast<unsigned*>(work + kWorkBytes / 4);
  }
  // every block of the cluster has started before any writes into rank 0
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const size_t row = static_cast<size_t>(ring) * width;
  const float* p = xyz + row * 3;
  const int cnt = count[ring];
  const int total = max(cnt - 10, 0);
  const int sector = total / n_regions;
  const bool active = cnt >= min_points;
  int2* root = lists;
  if (kSmem || !lists_global) root = cluster.map_shared_rank(lists, 0);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  if constexpr (!kSmem) {
    // the top-L selection a region; the sort in the block's own memory:
    // rank 0's lists, another block's unused list room, or the scratch
    for (int j = rank; active && j < n_regions; j += n_blocks) {
      int start, len;
      region_bounds(j, n_regions, total, sector, width, start, len);
      const int off = list_offset(j, n_regions, total, sector, width,
                                  list_cap);
      int2* dst = (rank == 0 ? lists : root) + off;
      int2* buf = rank == 0 || lists_global ? dst : lists;
      if (len > 0)
        region_list_topl(smooth + row, p, width, gap_thr, start, len,
                         list_cap, s_key, keys_room, work,
                         reinterpret_cast<unsigned long long*>(buf),
                         reinterpret_cast<unsigned long long*>(dst));
    }
    // every block sets its share of the ring's tags and picked mask
    for (int c = rank * kThreads + tid; active && c < width;
         c += n_blocks * kThreads) {
      s_tag[c] = -1;                       // no window's
      s_picked[c] = 0;
    }
    if (rank == 0)
      for (int k = tid; k < slots; k += kThreads) s_col[k] = -1;
  } else {
    for (int j = rank; active && j < n_regions; j += n_blocks) {
      int start, len;
      region_bounds(j, n_regions, total, sector, width, start, len);
      int2* dst = root + list_offset(j, n_regions, total, sector, width,
                                     list_cap);
      const int lo = max(start - 5, 0);
      const int hi = min(start + len + 5, width);
      for (int i = tid; i < len; i += kThreads) {
        const float v = smooth[row + start + i];
        s_v[i] = v != v ? -INFINITY : (v == 0.0f ? 0.0f : v);
      }
      for (int c = lo + tid; c < hi; c += kThreads)
        s_gap[c - lo] = gap_small(p, c, width, gap_thr) ? 1 : 0;
      __syncthreads();
      for (int i = tid; i < len; i += kThreads) {
        // the columns ahead of i in the order: larger values, and equal ones
        // at lower columns
        const float vi = s_v[i];
        int before = 0;
#pragma unroll 4
        for (int k = 0; k < i; ++k) before += s_v[k] >= vi;
#pragma unroll 4
        for (int k = i + 1; k < len; ++k) before += s_v[k] > vi;
        if (before < list_cap) {
          // a pick at b suppresses b + l while the gaps b+1 .. b+l are small,
          // b - l while the gaps b-l+1 .. b are
          const int b = start + i;
          int fwd = 0, bwd = 0;
          while (fwd < 5 && b + fwd + 1 < width && s_gap[b + fwd + 1 - lo])
            ++fwd;
          while (bwd < 5 && b - bwd - 1 >= 0 && s_gap[b - bwd - lo]) ++bwd;
          dst[before] =
              make_int2(__float_as_int(vi), b | ((fwd | (bwd << 3)) << 24));
        }
      }
      __syncthreads();                       // s_v, s_gap free for region j+C
    }
    if (rank == 0) {
      for (int c = tid; c < width; c += kThreads) {
        s_tag[c] = -1;                       // no window's
        s_picked[c] = 0;
      }
      for (int k = tid; k < slots; k += kThreads) s_col[k] = -1;
    }
  }
  cluster.sync();                          // every list in rank 0
  if (rank != 0) return;

  // The walk, one warp, a window of 32 entries of a region's order at a
  // time (lane i holds entry pos + i).  An entry is open if no earlier
  // window's pick marked it; cov holds the window's lanes before this one
  // whose pick would mark it (found through the column tags, at most 10).
  // The open entries not marked by this window's picks so far are the
  // candidates: every candidate before the first one that an earlier
  // candidate would mark (a conflict) and before the first that fails the
  // threshold is a pick, in order, up to the picks left; a conflict is
  // then dropped (an earlier pick marked it) and the rest is resolved
  // again; a failing candidate ends the region.  The same picks as one
  // entry at a time, in about one step a window.
  if (tid < 32 && active) {
    const int lane = tid;
    const unsigned below = (1u << lane) - 1u;
    int stamp = 0;
    const int2* lst = lists;
    for (int j = 0; j < n_regions; ++j) {
      int start, len;
      region_bounds(j, n_regions, total, sector, width, start, len);
      const int n = min(len, list_cap);
      int picks = 0;
      bool ended = false;
      for (int pos = 0; !ended && picks < max_picks && pos < n;
           pos += 32, ++stamp) {
        const int e = pos + lane;
        const bool valid = e < n;
        const int2 ent = valid ? lst[e] : make_int2(0, 0);
        const float v = __int_as_float(ent.x);
        const int c = ent.y & kColMask;
        const int reach = ent.y >> 24;
        const bool ok = v >= thr && v > -INFINITY;
        const bool open = valid && !s_picked[c];
        if (valid) s_tag[c] = (stamp << 11) | (reach << 5) | lane;
        __syncwarp();
        unsigned cov = 0;
        if (open) {
#pragma unroll
          for (int d = -5; d <= 5; ++d) {
            const int cc = c + d;
            if (d == 0 || cc < 0 || cc >= width) continue;
            const int t = s_tag[cc];
            if ((t >> 11) == stamp && (t & 31) < lane &&
                covers(-d, (t >> 5) & 63))
              cov |= 1u << (t & 31);
          }
        }
        unsigned rem = __ballot_sync(0xffffffffu, open);
        unsigned taken = 0;                // this window's picks
        while (rem != 0) {
          const bool cand = ((rem >> lane) & 1u) && !(cov & taken);
          const unsigned cands = __ballot_sync(0xffffffffu, cand);
          const bool conflict = cand && (cov & cands & below);
          const unsigned confl = __ballot_sync(0xffffffffu, conflict);
          const unsigned fails =
              __ballot_sync(0xffffffffu, cand && !conflict && !ok);
          const int first_conflict = confl ? __ffs(confl) - 1 : 32;
          const int first_fail = fails ? __ffs(fails) - 1 : 32;
          const int stop = min(first_conflict, first_fail);
          unsigned acc = stop == 32 ? cands : cands & ((1u << stop) - 1u);
          while (__popc(acc) > max_picks - picks)
            acc &= ~(1u << (31 - __clz(acc)));   // the picks left
          if ((acc >> lane) & 1u) {
            s_col[j * max_picks + picks + __popc(acc & below)] = c;
#pragma unroll
            for (int d = -5; d <= 5; ++d)
              if (covers(d, reach)) s_picked[c + d] = 1;
          }
          taken |= acc;
          picks += __popc(acc);
          if (picks == max_picks) break;
          if (first_fail < first_conflict) {
            ended = true;                  // the region's first failing pick
            break;
          }
          if (stop == 32) break;           // every candidate picked
          rem = cands & ~((2u << first_conflict) - 1u);
        }
        __syncwarp();                      // the marks, before the next read
      }
      lst += n;
    }
  }
  __syncthreads();

  for (int k = tid; k < slots; k += kThreads) {
    const size_t slot = static_cast<size_t>(ring) * slots + k;
    const int col = s_col[k];
    const bool pick = col >= 0;
    const int c = pick ? col : 0;
    bidx[slot] = c;
    bval[slot] = pick ? 1 : 0;
    pts[slot * 3 + 0] = pick ? p[3 * c + 0] : 0.0f;
    pts[slot * 3 + 1] = pick ? p[3 * c + 1] : 0.0f;
    pts[slot * 3 + 2] = pick ? p[3 * c + 2] : 0.0f;
  }
}

// K2, every array in shared memory
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ smooth, const int* __restrict__ count,
              const float* __restrict__ xyz, int width, int n_regions,
              int max_picks, int min_points, float thr, float gap_thr,
              int list_cap, int list_room, int* __restrict__ bidx,
              int* __restrict__ bval, float* __restrict__ pts,
              unsigned char* scratch, long long ring_bytes, bool lists_global,
              int keys_room) {
  select_body<kSmem>(smooth, count, xyz, width, n_regions, max_picks,
                     min_points, thr, gap_thr, list_cap, list_room, bidx, bval,
                     pts, scratch, ring_bytes, lists_global, keys_room);
}

// the global path, its registers held to what kGlobalBlocksPerSm blocks an
// SM leave (48 a thread)
__global__ void __launch_bounds__(kThreads, kGlobalBlocksPerSm)
select_global_kernel(const float* __restrict__ smooth,
                     const int* __restrict__ count,
                     const float* __restrict__ xyz, int width, int n_regions,
                     int max_picks, int min_points, float thr, float gap_thr,
                     int list_cap, int list_room, int* __restrict__ bidx,
                     int* __restrict__ bval, float* __restrict__ pts,
                     unsigned char* scratch, long long ring_bytes,
                     bool lists_global, int keys_room) {
  select_body<false>(smooth, count, xyz, width, n_regions, max_picks,
                     min_points, thr, gap_thr, list_cap, list_room, bidx,
                     bval, pts, scratch, ring_bytes, lists_global, keys_room);
}

}  // namespace

// smooth (R, W) f32, count (R,) i32, xyz (R, W, 3) f32 -> bidx (R, S) i32,
// bval (R, S) i32, pts (R, S, 3) f32, S = n_regions * max_picks.  One
// launch of R clusters of min(n_regions, 8) blocks; refused when the
// block's shared memory (select_smem_bytes) exceeds 227 KB.
extern "C" int liodom_select_edges(const void* smooth, const void* count,
                                   const void* xyz, void* bidx, void* bval,
                                   void* pts, int rings, int width,
                                   int n_regions, int max_picks,
                                   int min_points, float thr, float gap_thr,
                                   void* stream) {
  if (width <= 0 || width > kColMask || n_regions < 1 || max_picks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = select_smem_bytes(width, n_regions, max_picks);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long lists = n_regions * list_len(max_picks);
  const long long room = lists < width ? lists : width;
  if (rings <= 0) return static_cast<int>(cudaSuccess);
  const int n_blocks = n_regions < kMaxCluster ? n_regions : kMaxCluster;
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rings) * n_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, select_kernel<true>, static_cast<const float*>(smooth),
      static_cast<const int*>(count), static_cast<const float*>(xyz), width,
      n_regions, max_picks, min_points, thr, gap_thr,
      static_cast<int>(list_len(max_picks)), static_cast<int>(room),
      static_cast<int*>(bidx), static_cast<int*>(bval),
      static_cast<float*>(pts), static_cast<unsigned char*>(nullptr), 0LL,
      false, 0);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

namespace {

// The global path's layout for a ring width and slot layout: out[0] 1 if
// the lists and slots go to the scratch, out[1] the columns of a region
// whose keys shared memory holds, out[2] a block's dynamic shared memory
// in bytes, out[3] the scratch's bytes a ring (16-byte aligned).
void global_layout(int width, int n_regions, int max_picks, long long* out) {
  const long long lists = n_regions * list_len(max_picks);
  const long long room = lists < width ? lists : width;
  const long long small = 8 * room + 4LL * n_regions * max_picks;
  const long long lists_smem = (small + 15) & ~15LL;
  const bool lists_global = lists_smem + kWorkBytes > kMaxSmem;
  const long long used = kWorkBytes + (lists_global ? 0 : lists_smem);
  // the longest region while the counts are at most the width: the last,
  // (width - 10) / n_regions + n_regions - 1 columns; sized to it, a block
  // leaves room for others on its SM
  const long long most =
      (width > 10 ? (width - 10) / n_regions : 0) + n_regions;
  const long long keys = std::min(std::min((kMaxSmem - used) / 4, most),
                                  static_cast<long long>(width));
  out[0] = lists_global ? 1 : 0;
  out[1] = keys;
  out[2] = used + 4 * keys;
  out[3] = (((5LL * width + 7) & ~7LL) + (lists_global ? small : 0) + 15) &
           ~15LL;
}

}  // namespace

// K2 with the ring's columns in device memory, any width up to 2^24 - 1:
// the same contract as liodom_select_edges; scratch holds rings x
// liodom_select_global_shape's out[3] bytes (written before read, never
// cleared).
extern "C" int liodom_select_edges_global(
    const void* smooth, const void* count, const void* xyz, void* bidx,
    void* bval, void* pts, void* scratch, int rings, int width,
    int n_regions, int max_picks, int min_points, float thr, float gap_thr,
    void* stream) {
  if (width <= 0 || width > kColMask || n_regions < 1 || max_picks < 1 ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rings <= 0) return static_cast<int>(cudaSuccess);
  long long lay[4];
  global_layout(width, n_regions, max_picks, lay);
  const long long lists = n_regions * list_len(max_picks);
  const long long room = lists < width ? lists : width;
  const int n_blocks = n_regions < kMaxCluster ? n_regions : kMaxCluster;
  cudaError_t err = cudaFuncSetAttribute(
      select_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay[2]));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rings) * n_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(lay[2]);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, select_global_kernel, static_cast<const float*>(smooth),
      static_cast<const int*>(count), static_cast<const float*>(xyz), width,
      n_regions, max_picks, min_points, thr, gap_thr,
      static_cast<int>(list_len(max_picks)), static_cast<int>(room),
      static_cast<int*>(bidx), static_cast<int*>(bval),
      static_cast<float*>(pts), static_cast<unsigned char*>(scratch), lay[3],
      lay[0] != 0, static_cast<int>(lay[1]));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The global path as built for a ring width and slot layout: out[0] 1 if
// the lists and slots go to the scratch, out[1] a region's columns whose
// keys shared memory holds, out[2] a block's dynamic shared memory in
// bytes, out[3] the scratch's bytes a ring, out[4] bits a radix digit,
// out[5] blocks a ring's cluster.
extern "C" int liodom_select_global_shape(int width, int n_regions,
                                          int max_picks, long long* out) {
  global_layout(width, n_regions, max_picks, out);
  out[4] = kRadixBits;
  out[5] = n_regions < kMaxCluster ? n_regions : kMaxCluster;
  return 0;
}

// The launch as built for a ring width and slot layout: out[0] blocks a
// ring's cluster, out[1] entries a region's list at most (L), out[2] a
// block's dynamic shared memory in bytes.
extern "C" int liodom_select_shape(int width, int n_regions, int max_picks,
                                   int* out) {
  out[0] = n_regions < kMaxCluster ? n_regions : kMaxCluster;
  out[1] = static_cast<int>(list_len(max_picks));
  out[2] = static_cast<int>(select_smem_bytes(width, n_regions, max_picks));
  return 0;
}
