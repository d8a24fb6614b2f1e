// The exact 5-NN search shared by K3/K4 (knn_coords.cu) and K6
// (knn_lines.cu): one thread per query of a block of kTileE spatially sorted
// queries, looping over the ref tiles the wrapper flagged for this query
// tile.
//
// A flagged ref tile is staged into shared memory as float4 (every thread
// then reads the same element: a broadcast), and each thread keeps its best
// 5 (d2, x, y, z) in registers by insertion with a strict '<'.  That
// reproduces the TPU kernel's tie order: on equal distances the carried
// entry stays ahead and, within a tile, the lower column.  The distance is
// rounded per operation (__fsub_rn/__fmul_rn/__fadd_rn, -fmad=false) in the
// plain version's order, so both pick the same neighbours.

#pragma once

#include <cuda_runtime.h>

namespace liodom_knn {

constexpr int kTileE = 64;    // queries per block, one thread each
constexpr int kTileM = 512;   // refs per staged tile (8 KB of float4)
constexpr int kK = 5;
constexpr float kBig = 1e30f;
constexpr float kFarPickD2 = 1.0e6f;

struct Best {
  float d[kK], x[kK], y[kK], z[kK];
};

// The best kK refs of the flagged tiles for query q, ascending.  Every
// thread of the block must call it (it stages tiles between barriers);
// row_flags is the (n_m,) flag row of this block's query tile.
__device__ __forceinline__ void search(const float4 q,
                                       const float4* __restrict__ r4,
                                       const int* __restrict__ row_flags,
                                       int n_m, float4* tile, Best& b) {
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    b.d[s] = kBig;
    b.x[s] = b.y[s] = b.z[s] = 0.0f;
  }
  for (int mt = 0; mt < n_m; ++mt) {
    if (row_flags[mt] == 0) continue;          // uniform across the block
    __syncthreads();                           // previous tile fully read
    const float4* src = r4 + static_cast<size_t>(mt) * kTileM;
    for (int i = threadIdx.x; i < kTileM; i += kTileE) tile[i] = src[i];
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTileM; ++i) {
      const float4 r = tile[i];
      const float dx = __fsub_rn(q.x, r.x);
      const float dy = __fsub_rn(q.y, r.y);
      const float dz = __fsub_rn(q.z, r.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < b.d[kK - 1]) {
        b.d[kK - 1] = d;
        b.x[kK - 1] = r.x;
        b.y[kK - 1] = r.y;
        b.z[kK - 1] = r.z;
#pragma unroll
        for (int s = kK - 1; s > 0; --s) {
          if (b.d[s] < b.d[s - 1]) {   // strict: ties keep the earlier entry
            float t = b.d[s]; b.d[s] = b.d[s - 1]; b.d[s - 1] = t;
            t = b.x[s]; b.x[s] = b.x[s - 1]; b.x[s - 1] = t;
            t = b.y[s]; b.y[s] = b.y[s - 1]; b.y[s - 1] = t;
            t = b.z[s]; b.z[s] = b.z[s - 1]; b.z[s - 1] = t;
          }
        }
      }
    }
  }
}

}  // namespace liodom_knn
