// K1: the 11-tap smoothness stencil, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel liodom_tpu/ops/smoothness_pallas.py:_smooth_kernel
// (launched by smoothness_pallas).  Per ring r and column j:
//   smooth[r, j] = || sum_{l=-5..5} p[j+l] - 11 p[j] ||^2   for 5 <= j < count[r]-5
//                = 0                                         elsewhere
// (reference feature_extractor.cc:195-232).  count[r] <= width, as the ring
// split guarantees.
//
// What bounds it on the card: bytes.  ~41 flops a point against 12 bytes in
// and 4 out.  Only the columns below count[r] carry data: the bench frame's
// rings hold ~1,800 points of their 4,096 columns, so the least traffic is
// sum_r min(count[r], W) * 12 + R * 4 + R * W * 4 bytes (2.4 MB at the bench
// frame, against 4.2 MB for the whole image).
//
// Design: a block owns a segment of kSeg = 512 columns of one ring, a
// thread 4 consecutive columns (a group: 48 bytes, three 16-byte words,
// 16-byte aligned when width % 4 == 0 since a ring is 12 * width bytes).
//   * The block stages only columns [seg0 - 5, min(seg_end + 5, count)) in
//     shared memory, whole groups by cp.async 16 bytes at a time.  A segment
//     at or past count - 5 has no interior column: it reads nothing and
//     writes zeros.
//   * Each thread reads its 4 columns and their 5-column halos as 11
//     16-byte words from shared memory (a 48-byte stride: conflict-free in
//     each quarter warp), sums the taps in registers and stores its 4
//     outputs as one 16-byte word.
//   * 128 threads a block: 512 blocks at the bench frame, enough to spread
//     the ~1,800 points a ring holds over most of the card's 132 SMs (256
//     and 512 threads were slower, 64 no faster on an H100 80GB HBM3 at
//     700 W: scripts/smoothness_experiment.py).
//   * A width with width % 4 != 0 (or an unaligned pointer) takes scalar
//     global loads and stores in the same kernel; the shared-memory layout
//     and the arithmetic are the same.
// The tap order is the TPU kernel's and the plain version's: acc = -11 p,
// then acc += p[j+l] for l = -5..5, then ax*ax + ay*ay + az*az, every
// operation rounded on its own (__fmul_rn / __fadd_rn, and the library is
// built with -fmad=false), so the result is bit-exact with the plain PyTorch
// version.  No running sum: a sliding window would round differently, and
// the edge selection (K2) compares these values with the 0.1 threshold and
// breaks ties by column, so one ulp moves an edge.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                    // columns a thread (one group)
constexpr int kSeg = kThreads * kCols;      // columns a block
constexpr int kHalo = 5;
// shared groups: the segment's plus two on each side (the 5-column halos)
constexpr int kGroups = kSeg / kCols + 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    smooth_kernel(const float* __restrict__ xyz, const int* __restrict__ count,
                  float* __restrict__ out, int width, int vec) {
  // group i of the block holds columns [seg0 - 8 + 4 i, seg0 - 4 + 4 i)
  __shared__ __align__(16) float4 s[kGroups * 3];
  const int ring = blockIdx.y;
  const int seg0 = blockIdx.x * kSeg;
  const int seg_end = min(seg0 + kSeg, width);
  const int n = min(count[ring], width);
  const float* row = xyz + static_cast<size_t>(ring) * width * 3;
  float* orow = out + static_cast<size_t>(ring) * width;
  const int j0 = seg0 + kCols * threadIdx.x;

  // a segment at or past count - 5 has no interior column: zeros, unread
  float r[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (seg0 < n - kHalo) {       // uniform over the block
    // columns [lo, hi) carry every tap of the segment's interior columns
    const int lo = max(seg0 - kHalo, 0);
    const int hi = min(seg_end + kHalo, n);
    const int gbase = seg0 / kCols - 2;
    if (vec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (int g = lo / kCols + threadIdx.x; g < (hi + kCols - 1) / kCols;
           g += kThreads) {
        float4* dst = s + (g - gbase) * 3;
        cp_async16(dst + 0, row4 + 3 * g + 0);
        cp_async16(dst + 1, row4 + 3 * g + 1);
        cp_async16(dst + 2, row4 + 3 * g + 2);
      }
      cp_async_wait_all();
    } else {
      float* sf = reinterpret_cast<float*>(s);
      const int f0 = 3 * kCols * gbase;
      for (int f = 3 * lo + threadIdx.x; f < 3 * hi; f += kThreads) {
        sf[f - f0] = row[f];
      }
    }
    __syncthreads();

    // columns j0 - 8 .. j0 + 11 as floats: group g-2's last word holds
    // column j0 - 5 (floats 1..3), group g+2's first word column j0 + 8
    float p[20 * 3];
    const float4* src = s + 3 * threadIdx.x;       // group g - 2
#pragma unroll
    for (int w = 0; w < 15; ++w) {
      if (w == 0 || w == 1 || w == 13 || w == 14) continue;
      const float4 v = src[w];
      p[4 * w + 0] = v.x;
      p[4 * w + 1] = v.y;
      p[4 * w + 2] = v.z;
      p[4 * w + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c;
      const float* q = p + 3 * (8 + c);            // column j
      float ax = __fmul_rn(-11.0f, q[0]);
      float ay = __fmul_rn(-11.0f, q[1]);
      float az = __fmul_rn(-11.0f, q[2]);
#pragma unroll
      for (int l = -kHalo; l <= kHalo; ++l) {
        ax = __fadd_rn(ax, q[3 * l + 0]);
        ay = __fadd_rn(ay, q[3 * l + 1]);
        az = __fadd_rn(az, q[3 * l + 2]);
      }
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)),
                                __fmul_rn(az, az));
      if (j >= kHalo && j < n - kHalo) r[c] = v;
    }
  }

  if (vec) {
    if (j0 < seg_end) {
      reinterpret_cast<float4*>(orow)[j0 / kCols] =
          make_float4(r[0], r[1], r[2], r[3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (j0 + c < seg_end) orow[j0 + c] = r[c];
    }
  }
}

}  // namespace

// xyz (rings, width, 3) f32, count (rings,) i32 -> out (rings, width) f32.
extern "C" int liodom_smoothness(const void* xyz, const void* count, void* out,
                                 int rings, int width, void* stream) {
  if (rings <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  const int vec = (width % kCols == 0 &&
                   reinterpret_cast<std::uintptr_t>(xyz) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0)
                      ? 1
                      : 0;
  const dim3 grid((width + kSeg - 1) / kSeg, rings);
  smooth_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(count),
      static_cast<float*>(out), width, vec);
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape: out[0] threads a block, out[1] columns a thread,
// out[2] columns a block.
extern "C" int liodom_smoothness_shape(int* out) {
  out[0] = kThreads;
  out[1] = kCols;
  out[2] = kSeg;
  return 0;
}
