// K2: region-wise greedy edge selection, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel liodom_tpu/ops/select_pallas.py:_select_kernel
// (launched by select_edges_pallas).  Per ring, regions j = 0..n_regions-1 in
// order, each with up to max_picks dependent picks (reference
// feature_extractor.cc:256-313):
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
// ~1.8 MB (the smoothness plane and the ring image at 64 x 4096) and does
// ~10 M compares, but every ring is a chain of 88 dependent block-wide
// arg-max reductions, each ended by barriers.
//
// Design: one block per ring (64 blocks at the bench shape; filling the 132
// SMs is later work).  The ring's smoothness row, its gap flags and a picked
// byte mask live in shared memory (6 B a column, 24 KB at width 4096).  The
// gap flags are the TPU wrapper's reach plane (_reach_plane) in unpacked
// form, computed here in the prologue from the ring's points instead of by a
// dozen separate element-wise launches: gap[c] = |p[c] - p[c-1]|^2 <= gap_thr,
// each operation rounded on its own in the plain version's order.  Each pick
// is a block-wide reduction over the region's columns to (max value, lowest
// column), by warp shuffles and one pass over the per-warp results; 11
// threads then apply the suppression.  The chosen columns are kept in shared
// memory and gathered into the outputs after the chain, so no global memory
// access sits on the chain.  Comparisons only, no arithmetic on the
// smoothness values: for a finite smoothness plane the result is bit-exact
// with the plain PyTorch version.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 128;   // the TPU kernel's slot layout per ring

__device__ __forceinline__ bool better(float v1, int c1, float v2, int c2) {
  return v1 > v2 || (v1 == v2 && c1 < c2);
}

__device__ __forceinline__ void warp_best(float& v, int& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oc = __shfl_down_sync(0xffffffffu, c, off);
    if (better(ov, oc, v, c)) {
      v = ov;
      c = oc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ smooth, const int* __restrict__ count,
              const float* __restrict__ xyz, int width, int n_regions,
              int max_picks, int min_points, float thr, float gap_thr,
              int* __restrict__ bidx, int* __restrict__ bval,
              float* __restrict__ pts) {
  extern __shared__ float smem[];
  float* s_sm = smem;
  unsigned char* s_gap = reinterpret_cast<unsigned char*>(s_sm + width);
  unsigned char* s_picked = s_gap + width;
  __shared__ float red_v[kWarps];
  __shared__ int red_c[kWarps];
  __shared__ int s_col[kMaxSlots];
  __shared__ int s_ok[kMaxSlots];

  const int ring = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = static_cast<size_t>(ring) * width;
  const float* p = xyz + row * 3;
  for (int c = tid; c < width; c += kThreads) {
    s_sm[c] = smooth[row + c];
    const int prev = c == 0 ? width - 1 : c - 1;   // the roll's wrap
    const float dx = __fsub_rn(p[3 * c + 0], p[3 * prev + 0]);
    const float dy = __fsub_rn(p[3 * c + 1], p[3 * prev + 1]);
    const float dz = __fsub_rn(p[3 * c + 2], p[3 * prev + 2]);
    const float g = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    s_gap[c] = g <= gap_thr ? 1 : 0;
    s_picked[c] = 0;
  }
  const int cnt = count[ring];
  const int total = max(cnt - 10, 0);
  const int sector = total / n_regions;
  const bool active = cnt >= min_points;
  const int slots = n_regions * max_picks;
  bool done = false;
  __syncthreads();

  for (int k = 0; k < slots; ++k) {
    const int j = k / max_picks;
    const int pk = k - j * max_picks;
    const int start = 5 + sector * j;
    const int end = 5 + (j == n_regions - 1 ? total : sector * (j + 1));
    if (pk == 0) done = false;  // a fresh region resets the break

    float bv = -INFINITY;
    int bc = width;
    if (active && !done) {
      for (int c = start + tid; c < end; c += kThreads) {
        if (!s_picked[c] && better(s_sm[c], c, bv, bc)) {
          bv = s_sm[c];
          bc = c;
        }
      }
    }
    warp_best(bv, bc);
    if (lane == 0) {
      red_v[warp] = bv;
      red_c[warp] = bc;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -INFINITY;
      bc = lane < kWarps ? red_c[lane] : width;
      warp_best(bv, bc);
      if (lane == 0) {
        const bool pick = bv >= thr && bv > -INFINITY;
        s_col[k] = bc;
        s_ok[k] = pick ? 1 : 0;
      }
    }
    __syncthreads();
    const bool pick = s_ok[k] != 0;
    done = done || !pick;
    if (pick && tid < 11) {
      // neighbour b + l is suppressed when the gaps between it and the pick
      // b (columns b+1..b+l forward, b+l+1..b backward) are all small
      const int b = s_col[k];
      const int l = tid - 5;
      const int c = b + l;
      if (c >= 0 && c < width) {
        bool sup = true;
        const int lo = l > 0 ? b + 1 : c + 1;
        const int hi = l > 0 ? c : b;
        for (int m = lo; m <= hi; ++m) sup = sup && s_gap[m];
        if (sup) s_picked[c] = 1;
      }
    }
    __syncthreads();
  }

  for (int k = tid; k < slots; k += kThreads) {
    const size_t slot = static_cast<size_t>(ring) * slots + k;
    const bool pick = s_ok[k] != 0;
    const int c = pick ? s_col[k] : 0;
    bidx[slot] = c;
    bval[slot] = pick ? 1 : 0;
    pts[slot * 3 + 0] = pick ? p[3 * c + 0] : 0.0f;
    pts[slot * 3 + 1] = pick ? p[3 * c + 1] : 0.0f;
    pts[slot * 3 + 2] = pick ? p[3 * c + 2] : 0.0f;
  }
}

}  // namespace

// smooth (R, W) f32, count (R,) i32, xyz (R, W, 3) f32 -> bidx (R, S) i32,
// bval (R, S) i32, pts (R, S, 3) f32, S = n_regions * max_picks <= 128.
extern "C" int liodom_select_edges(const void* smooth, const void* count,
                                   const void* xyz, void* bidx, void* bval,
                                   void* pts, int rings, int width,
                                   int n_regions, int max_picks,
                                   int min_points, float thr, float gap_thr,
                                   void* stream) {
  if (n_regions * max_picks > kMaxSlots || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rings <= 0) return static_cast<int>(cudaSuccess);
  const size_t shmem = static_cast<size_t>(width) * (sizeof(float) + 2);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  select_kernel<<<rings, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(smooth), static_cast<const int*>(count),
      static_cast<const float*>(xyz), width, n_regions, max_picks, min_points,
      thr, gap_thr, static_cast<int*>(bidx), static_cast<int*>(bval),
      static_cast<float*>(pts));
  return static_cast<int>(cudaGetLastError());
}
