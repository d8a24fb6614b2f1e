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
// gathers and atomics over a few thousand rows, ended by barriers, and the
// rounds run one after another (about 5-10 at the bench load).  Bytes (the
// table is 4 MB at the bench capacity, but only the probed slots are
// touched) and operations are far below that.
//
// Design: one block of 1,024 threads owns all rows (a row's state lives in
// global memory and only its own thread touches it), because the rounds must
// stay in step across every row, as they are in the JAX loop.  Each round has
// three phases split by barriers, so that all reads of a round see the table
// as the round found it and every claim of the round has landed before any
// thread reads it back:
//   A: read the slot (ld.global.cg: the atomics live in L2, so the read must
//      not hit a stale L1 line), match or mark the row pending; the barrier
//      is __syncthreads_or, which also ends the loop when no row is left;
//   B: atomicMin for the pending rows;
//   C: read the slot back; a pending row whose code is there has claimed it;
//      unfinished rows step.
// The result is bit-exact with the plain PyTorch rounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr long long kEmpty = 0x7FFFFFFFFFFFFFFFLL;   // EMPTY in grid.py
constexpr unsigned char kDone = 1;
constexpr unsigned char kPending = 2;
constexpr unsigned char kClaimed = 4;

// the JAX package's _hash_pair on the code's words (k1 = code >> 26, taken
// mod 2^32; k2 = the low 26 bits)
__device__ __forceinline__ int home_slot(long long code, int n) {
  const unsigned k1 = static_cast<unsigned>(code >> 26);
  const unsigned k2 = static_cast<unsigned>(code & 0x3FFFFFFLL);
  unsigned h = (k1 * 0x9E3779B1u) ^ (k2 * 0x85EBCA77u);
  h ^= h >> 15;
  return static_cast<int>(h % static_cast<unsigned>(n));
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(long long* __restrict__ tab, int n,
             const long long* __restrict__ code,
             const unsigned char* __restrict__ active, int e, int max_probes,
             int* __restrict__ slot, unsigned char* __restrict__ flags,
             unsigned char* __restrict__ claimed,
             unsigned char* __restrict__ failed) {
  const int tid = threadIdx.x;
  for (int i = tid; i < e; i += kThreads) {
    slot[i] = home_slot(code[i], n);
    flags[i] = active[i] ? 0 : kDone;
  }
  for (int r = 0; r < max_probes; ++r) {
    // A: read and match
    int left = 0;
    for (int i = tid; i < e; i += kThreads) {
      unsigned char f = flags[i];
      if (f & kDone) continue;
      left = 1;
      const long long g = __ldcg(tab + slot[i]);
      if (g == code[i])
        f |= kDone;
      else if (g == kEmpty)
        f |= kPending;
      flags[i] = f;
    }
    if (!__syncthreads_or(left)) break;
    // B: claim
    for (int i = tid; i < e; i += kThreads) {
      if (flags[i] & kPending)
        atomicMin(reinterpret_cast<unsigned long long*>(tab + slot[i]),
                  static_cast<unsigned long long>(code[i]));
    }
    __syncthreads();
    // C: read back the claims, step the unfinished rows
    for (int i = tid; i < e; i += kThreads) {
      unsigned char f = flags[i];
      if (f & kDone) continue;
      const int s = slot[i];
      if ((f & kPending) && __ldcg(tab + s) == code[i]) f |= kDone | kClaimed;
      f &= static_cast<unsigned char>(~kPending);
      if (!(f & kDone)) slot[i] = static_cast<int>((s + r + 1LL) % n);
      flags[i] = f;
    }
    // no barrier: phase C only reads the table, and the next round's first
    // barrier orders these reads before its claims
  }
  for (int i = tid; i < e; i += kThreads) {
    const unsigned char f = flags[i];
    claimed[i] = (f & kClaimed) ? 1 : 0;
    failed[i] = (active[i] && !(f & kDone)) ? 1 : 0;
  }
}

}  // namespace

// tab (n,) i64 (updated in place), code (e,) i64, active (e,) bool ->
// slot (e,) i32, claimed (e,) bool, failed (e,) bool; flags (e,) u8 scratch.
extern "C" int liodom_probe_insert(void* tab, int n, const void* code,
                                   const void* active, int e, int max_probes,
                                   void* slot, void* flags, void* claimed,
                                   void* failed, void* stream) {
  if (n <= 0 || e < 0 || max_probes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return static_cast<int>(cudaSuccess);
  probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(tab), n, static_cast<const long long*>(code),
      static_cast<const unsigned char*>(active), e, max_probes,
      static_cast<int*>(slot), static_cast<unsigned char*>(flags),
      static_cast<unsigned char*>(claimed),
      static_cast<unsigned char*>(failed));
  return static_cast<int>(cudaGetLastError());
}
