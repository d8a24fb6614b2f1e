// Hash-grid find-or-insert: the probe rounds of update_map, written by hand
// for Hopper (sm_90a).
//
// No TPU kernel: liodom_tpu/mapping/grid.py:_probe_insert is a lax.while_loop
// whose exit test depends on the data (jnp.any(~done)).  In PyTorch that test
// would be one host synchronisation a round; this kernel runs every round on
// the card instead, so the map update is enqueued without waiting.
//
// The function (the JAX package's, round for round): each active row starts
// at the hash of its packed code; in round r every unfinished row reads its
// slot; a row whose code is there is done; a row that finds the slot empty
// claims it with a 64-bit atomicMin of its code, and wins when the slot then
// holds its code (the smallest claimant wins, so the table does not depend on
// the order the claims land in, and duplicate codes share one slot); a row
// that neither matched nor won steps to slot + r + 1 (mod n).  At most
// max_probes rounds; rows still unfinished have failed.
//
// What bounds it on the card: latency.  Each round is a chain of dependent
// trips to L2 (the table lives there: 4 MB at the bench capacity, of which
// only the probed slots are touched) ended by barriers, and the rounds run
// one after another.  Bytes and operations are far below that.  On the
// H100 one block alone spent 4 us on the first reads (an SM issues one
// scattered load every few cycles), so the rows are spread over a cluster,
// whose barrier costs 0.5-0.8 us against 0.05 us for a block's
// (scripts/map_kernels_trace.py).
//
// Design: one thread-block cluster of 8 blocks of 512 threads owns all
// rows, because the rounds must stay in step across every row, as they are
// in the JAX loop.  A block takes an even share of the rows, up to 4 a
// thread on chip (16,384 a launch; the bench has 5,632): their codes in
// shared memory, their slots and state in registers.  A round is two
// phases split by cluster barriers (barrier.cluster, release and acquire):
//   1. match or claim: a row whose last read found its code is done; one
//      that found the slot empty claims it (atomicMin); each block tells
//      every block (distributed shared memory) whether it had a row left;
//      the barrier that follows lands every claim of the round before any
//      read-back, and ends the loop when no block had a row left;
//   2. read: the table is now the one JAX's round r + 1 gathers from (every
//      claim of round r landed, none of round r + 1 started), so in one go
//      the pending rows read their claim back and every unfinished row
//      reads its next slot (slot + r + 1: used only if the claim was lost),
//      all of a thread's loads issued before any is used (ld.global.cg: the
//      atomics live in L2, so a read must not hit a stale L1 line); the
//      second barrier keeps these reads ahead of the next round's claims.
// So two dependent L2 trips (the claim, the reads) and two cluster
// barriers a round.  atomicMin returns the old value, but a smaller
// claimant may land after it, so the read-back stays.  Rows past what the
// cluster keeps on chip follow the same schedule with their slot and state
// in device memory (`spill`, `slot`).  The kernel writes the rounds it ran.
// The result is bit-exact with the plain PyTorch rounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;                       // rows a thread on chip
constexpr int kOnChip = kThreads * kRows;      // rows a block on chip
constexpr int kCluster = 8;                    // blocks, portable
constexpr long long kEmpty = 0x7FFFFFFFFFFFFFFFLL;   // EMPTY in grid.py
// state of a row kept in device memory
constexpr unsigned char kLive = 1;      // active and not yet done
constexpr unsigned char kMatch = 2;     // its last read found its code
constexpr unsigned char kSeenEmpty = 4; // its last read found the slot empty
constexpr unsigned char kPending = 8;   // claimed this round
constexpr unsigned char kWon = 16;      // claimed its slot

// the JAX package's _hash_pair on the code's words (k1 = code >> 26, taken
// mod 2^32; k2 = the low 26 bits)
__device__ __forceinline__ int home_slot(long long code, int n) {
  const unsigned k1 = static_cast<unsigned>(code >> 26);
  const unsigned k2 = static_cast<unsigned>(code & 0x3FFFFFFLL);
  unsigned h = (k1 * 0x9E3779B1u) ^ (k2 * 0x85EBCA77u);
  h ^= h >> 15;
  return static_cast<int>(h % static_cast<unsigned>(n));
}

// slot + r + 1 (mod n), a subtraction unless n <= r + 1; slot + r + 1 <
// 2^31 (n <= 2^31 - 1 - max_probes)
__device__ __forceinline__ int next_slot(int slot, int r, int n) {
  const int s = slot + r + 1;
  return s < n ? s : (s - n < n ? s - n : s % n);
}

__device__ __forceinline__ unsigned char seen(long long g, long long c) {
  return g == c ? kMatch : (g == kEmpty ? kSeenEmpty : 0);
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(long long* __restrict__ tab, int n,
             const long long* __restrict__ code,
             const unsigned char* __restrict__ active, int e, int max_probes,
             int share, int* __restrict__ slot_out,
             unsigned char* __restrict__ spill,
             unsigned char* __restrict__ claimed,
             unsigned char* __restrict__ failed, int* __restrict__ rounds) {
  extern __shared__ long long s_code[];   // the block's on-chip rows' codes
  __shared__ int s_left[kCluster];        // which blocks had a row left
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  // this block's on-chip rows: [first, first + mine); rows from spill_base
  // on are kept in device memory, dealt over the cluster's threads
  const int first = rank * share;
  const int spill_base = n_blocks * share;
  const int mine = max(0, min(share, e - first));
  const int spill_step = n_blocks * kThreads;
  int slot[kRows];
  // bit k: row first + k * kThreads + tid
  unsigned live = 0, match = 0, empty = 0, won = 0;
  // home slots and the first reads (the table as round 0 finds it)
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int l = k * kThreads + tid;
    slot[k] = 0;
    if (l < mine) {
      const long long c = code[first + l];
      s_code[l] = c;
      slot[k] = home_slot(c, n);
      if (active[first + l]) live |= 1u << k;
    }
  }
  {
    long long g[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if ((live >> k) & 1u) g[k] = __ldcg(tab + slot[k]);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (!((live >> k) & 1u)) continue;
      const long long c = s_code[k * kThreads + tid];
      if (g[k] == c) match |= 1u << k;
      if (g[k] == kEmpty) empty |= 1u << k;
    }
  }
  int spill_live = 0;
  for (int i = spill_base + rank * kThreads + tid; i < e; i += spill_step) {
    const long long c = code[i];
    const int s = home_slot(c, n);
    slot_out[i] = s;
    unsigned char st = 0;
    if (active[i]) {
      st = kLive | seen(__ldcg(tab + s), c);
      spill_live = 1;
    }
    spill[i - spill_base] = st;
  }
  // every block's first reads are done before any claim of round 0 (and
  // every block has started before any writes into it)
  cluster.sync();

  int r = 0;
  for (; r < max_probes; ++r) {
    // 1: match or claim; whether this block has a row left, to every block
    const int left = __syncthreads_or(live != 0 || spill_live);
    if (tid < n_blocks) cluster.map_shared_rank(s_left, tid)[rank] = left;
    unsigned pend = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (!((live >> k) & 1u)) continue;
      if ((match >> k) & 1u) {
        live &= ~(1u << k);
      } else if ((empty >> k) & 1u) {
        pend |= 1u << k;
        atomicMin(reinterpret_cast<unsigned long long*>(tab + slot[k]),
                  static_cast<unsigned long long>(s_code[k * kThreads + tid]));
      }
    }
    for (int i = spill_base + rank * kThreads + tid; i < e; i += spill_step) {
      unsigned char st = spill[i - spill_base];
      if (!(st & kLive)) continue;
      if (st & kMatch) {
        st &= static_cast<unsigned char>(~kLive);
      } else if (st & kSeenEmpty) {
        st |= kPending;
        atomicMin(reinterpret_cast<unsigned long long*>(tab + slot_out[i]),
                  static_cast<unsigned long long>(code[i]));
      }
      spill[i - spill_base] = st & static_cast<unsigned char>(~(kMatch |
                                                                kSeenEmpty));
    }
    cluster.sync();   // every claim of round r has landed
    int any = 0;
    for (int b = 0; b < n_blocks; ++b) any |= s_left[b];
    if (!any) break;  // no row was left: the round did nothing

    // 2: read back the claims and read the next slots, all loads at once
    {
      long long back[kRows], nxt[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!((live >> k) & 1u)) continue;
        if ((pend >> k) & 1u) back[k] = __ldcg(tab + slot[k]);
        nxt[k] = __ldcg(tab + next_slot(slot[k], r, n));
      }
      match = empty = 0;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!((live >> k) & 1u)) continue;
        const long long c = s_code[k * kThreads + tid];
        if (((pend >> k) & 1u) && back[k] == c) {
          won |= 1u << k;
          live &= ~(1u << k);
        } else {
          slot[k] = next_slot(slot[k], r, n);
          if (nxt[k] == c) match |= 1u << k;
          if (nxt[k] == kEmpty) empty |= 1u << k;
        }
      }
    }
    spill_live = 0;
    for (int i = spill_base + rank * kThreads + tid; i < e; i += spill_step) {
      unsigned char st = spill[i - spill_base];
      if (!(st & kLive)) continue;
      const long long c = code[i];
      const int s = slot_out[i];
      const int s1 = next_slot(s, r, n);
      const long long back = (st & kPending) ? __ldcg(tab + s) : ~c;
      const long long g = __ldcg(tab + s1);
      if (back == c) {
        st = kWon;
      } else {
        slot_out[i] = s1;
        st = (st & kWon) | kLive | seen(g, c);
        spill_live = 1;
      }
      spill[i - spill_base] = st;
    }
    cluster.sync();   // these reads before the next round's claims
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int l = k * kThreads + tid;
    if (l >= mine) continue;
    slot_out[first + l] = slot[k];
    claimed[first + l] = (won >> k) & 1u;
    failed[first + l] = (live >> k) & 1u;
  }
  for (int i = spill_base + rank * kThreads + tid; i < e; i += spill_step) {
    const unsigned char st = spill[i - spill_base];
    claimed[i] = (st & kWon) ? 1 : 0;
    failed[i] = (st & kLive) ? 1 : 0;
  }
  if (rank == 0 && tid == 0) *rounds = r;
}

}  // namespace

// tab (n,) i64 (updated in place), code (e,) i64, active (e,) bool ->
// slot (e,) i32, claimed (e,) bool, failed (e,) bool, rounds () i32 (the
// rounds run); spill (e,) u8 scratch for the rows past what the cluster
// keeps on chip.  One launch of one cluster.
extern "C" int liodom_probe_insert(void* tab, int n, const void* code,
                                   const void* active, int e, int max_probes,
                                   void* slot, void* spill, void* claimed,
                                   void* failed, void* rounds, void* stream) {
  if (n <= 0 || e < 0 || max_probes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return static_cast<int>(cudaSuccess);
  const int even = (e + kCluster - 1) / kCluster;
  const int share = even < kOnChip ? even : kOnChip;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(share) * 8;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, probe_kernel, static_cast<long long*>(tab), n,
      static_cast<const long long*>(code),
      static_cast<const unsigned char*>(active), e, max_probes, share,
      static_cast<int*>(slot), static_cast<unsigned char*>(spill),
      static_cast<unsigned char*>(claimed),
      static_cast<unsigned char*>(failed), static_cast<int*>(rounds));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch: out[0] blocks in the cluster, out[1] threads a block, out[2]
// rows a thread keeps on chip, out[3] rows on chip in all (past them, rows
// keep their state in device memory).
extern "C" int liodom_probe_insert_shape(int* out) {
  out[0] = kCluster;
  out[1] = kThreads;
  out[2] = kRows;
  out[3] = out[0] * kOnChip;
  return 0;
}
