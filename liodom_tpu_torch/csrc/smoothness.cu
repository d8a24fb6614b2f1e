// K1: the 11-tap smoothness stencil, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel liodom_tpu/ops/smoothness_pallas.py:_smooth_kernel
// (launched by smoothness_pallas).  Per ring r and column j:
//   smooth[r, j] = || sum_{l=-5..5} p[j+l] - 11 p[j] ||^2   for 5 <= j < count[r]-5
//                = 0                                         elsewhere
// (reference feature_extractor.cc:195-232).
//
// What bounds it on the card: bytes.  It reads the (R, W, 3) image once and
// writes the (R, W) plane once (4.2 MB at 64 x 4096), against ~41 flops a
// point, so the least time is the HBM traffic.
//
// Design: one thread per (ring, column).  A block stages its 256 columns plus
// a 5-column halo on each side in shared memory as a flat, coalesced copy of
// the interleaved xyz row (stride 3 is coprime with the 32 banks, so the
// stencil reads are conflict-free), then each thread sums its 11 taps.  The
// tap order is the TPU kernel's and the plain version's: acc = -11 p, then
// acc += p[j+l] for l = -5..5, then ax*ax + ay*ay + az*az, every operation
// rounded on its own (__fmul_rn / __fadd_rn, and the library is built with
// -fmad=false), so the result is bit-exact with the plain PyTorch version.
// Bit-exactness matters downstream: the edge selection (K2) compares these
// values against the 0.1 threshold and breaks ties by column.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kHalo = 5;
constexpr int kSpan = kTile + 2 * kHalo;

__global__ void smooth_kernel(const float* __restrict__ xyz,
                              const int* __restrict__ count,
                              float* __restrict__ out, int width) {
  __shared__ float s[kSpan * 3];
  const int ring = blockIdx.y;
  const int col0 = blockIdx.x * kTile;
  const float* row = xyz + static_cast<size_t>(ring) * width * 3;

  // flat copy of columns [col0 - 5, col0 + 256 + 5) clipped to the row
  const int first = (col0 - kHalo) * 3;
  for (int i = threadIdx.x; i < kSpan * 3; i += blockDim.x) {
    const int f = first + i;
    s[i] = (f >= 0 && f < width * 3) ? row[f] : 0.0f;
  }
  __syncthreads();

  const int j = col0 + threadIdx.x;
  if (j >= width) return;
  const int n = count[ring];
  float v = 0.0f;
  if (j >= 5 && j < n - 5) {
    const float* c = s + (threadIdx.x + kHalo) * 3;
    float ax = __fmul_rn(-11.0f, c[0]);
    float ay = __fmul_rn(-11.0f, c[1]);
    float az = __fmul_rn(-11.0f, c[2]);
#pragma unroll
    for (int l = -5; l <= 5; ++l) {
      ax = __fadd_rn(ax, c[3 * l + 0]);
      ay = __fadd_rn(ay, c[3 * l + 1]);
      az = __fadd_rn(az, c[3 * l + 2]);
    }
    v = __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)),
                  __fmul_rn(az, az));
  }
  out[static_cast<size_t>(ring) * width + j] = v;
}

}  // namespace

// xyz (rings, width, 3) f32, count (rings,) i32 -> out (rings, width) f32.
extern "C" int liodom_smoothness(const void* xyz, const void* count, void* out,
                                 int rings, int width, void* stream) {
  if (rings <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((width + kTile - 1) / kTile, rings);
  smooth_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(count),
      static_cast<float*>(out), width);
  return static_cast<int>(cudaGetLastError());
}
