// K3: exact 5-nearest-neighbours carrying the neighbours' coordinates,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel liodom_tpu/ops/knn_pallas.py:_knn_coords_kernel
// (launched by knn_coords_pallas).  For every query (an edge in the world
// frame) it returns the 5 smallest squared distances to the reference points
// (the matching map) and those points' coordinates, ascending.  The wrapper
// sorts the queries spatially, flags the (query tile, ref tile) pairs whose
// bounding boxes are within the accept radius, and displaces invalid refs by
// 2 * _FAR so that they are never picked within the radius; this kernel
// visits only the flagged ref tiles.
//
// What bounds it on the card: operations.  A flagged (query, ref) pair
// costs 8 FP32 operations (3 sub, 3 mul, 2 add) plus a compare; the inputs
// are ~0.5 MB.  Unpruned, 5632 x 28160 pairs are ~1.3 GFLOP (~19 us at the
// 67 TFLOP/s non-tensor FP32 peak); the tile flags cut that to the fraction
// chip_smoke.py reports.
//
// Design: the TPU kernel walked ref tiles on a sequential grid axis and
// carried the running best-5 in scratch memory between grid steps.  Blocks
// on the GPU run in no order, so here one block owns one tile of 64
// spatially sorted queries (one thread per query) and loops over the ref
// tiles itself, skipping unflagged ones (a block-uniform branch).  A flagged
// ref tile is staged into shared memory as float4 (every thread then reads
// the same element: a broadcast), and each thread keeps its best 5 (d2, x,
// y, z) in registers by insertion with a strict '<'.  That reproduces the
// TPU kernel's tie order: on equal distances the carried entry stays ahead
// and, within a tile, the lower column.  The distance is rounded per
// operation (__fsub_rn/__fmul_rn/__fadd_rn, -fmad=false) in the plain
// version's order, so both pick the same neighbours.  The epilogue applies
// the wrapper steps of the TPU version: a FAR pick (d2 > _FAR_PICK_D2) or an
// invalid query reads back as _BIG, d2 is clamped at 0, and each row is
// written at its query's original index (the query sort is undone here).

#include <cuda_runtime.h>

namespace {

constexpr int kTileE = 64;    // queries per block, one thread each
constexpr int kTileM = 512;   // refs per staged tile (8 KB of float4)
constexpr int kK = 5;
constexpr float kBig = 1e30f;
constexpr float kFarPickD2 = 1.0e6f;

__global__ void __launch_bounds__(kTileE)
knn_coords_kernel(const float4* __restrict__ q4, const float4* __restrict__ r4,
                  const int* __restrict__ flags, const int* __restrict__ qperm,
                  int n_query, int n_m, float* __restrict__ out_d,
                  float* __restrict__ out_c) {
  __shared__ float4 tile[kTileM];
  const int et = blockIdx.x;
  const int pos = et * kTileE + threadIdx.x;   // position in the sorted order
  const float4 q = q4[pos];                    // w = 1 for a valid query

  float bd[kK], bx[kK], by[kK], bz[kK];
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    bd[s] = kBig;
    bx[s] = by[s] = bz[s] = 0.0f;
  }

  const int* row_flags = flags + static_cast<size_t>(et) * n_m;
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
      if (d < bd[kK - 1]) {
        bd[kK - 1] = d;
        bx[kK - 1] = r.x;
        by[kK - 1] = r.y;
        bz[kK - 1] = r.z;
#pragma unroll
        for (int s = kK - 1; s > 0; --s) {
          if (bd[s] < bd[s - 1]) {   // strict: ties keep the earlier entry
            float t = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = t;
            t = bx[s]; bx[s] = bx[s - 1]; bx[s - 1] = t;
            t = by[s]; by[s] = by[s - 1]; by[s - 1] = t;
            t = bz[s]; bz[s] = bz[s - 1]; bz[s - 1] = t;
          }
        }
      }
    }
  }

  if (pos >= n_query) return;
  const size_t dst = static_cast<size_t>(qperm[pos]);
  const bool valid = q.w != 0.0f;
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    float d = bd[s] > kFarPickD2 ? kBig : bd[s];
    d = valid ? fmaxf(d, 0.0f) : kBig;
    out_d[dst * kK + s] = d;
    out_c[(dst * kK + s) * 3 + 0] = bx[s];
    out_c[(dst * kK + s) * 3 + 1] = by[s];
    out_c[(dst * kK + s) * 3 + 2] = bz[s];
  }
}

}  // namespace

// q4 (n_e * 64, 4) f32 sorted queries [x y z valid], r4 (n_m * 512, 4) f32
// encoded refs, flags (n_e, n_m) i32, qperm (n_query,) i32 sorted -> original
// -> out_d (n_query, 5) f32, out_c (n_query, 5, 3) f32.  tile_e, tile_m and k
// are the caller's layout and must equal the kernel's.
extern "C" int liodom_knn_coords(const void* q4, const void* r4,
                                 const void* flags, const void* qperm,
                                 void* out_d, void* out_c, int n_query,
                                 int n_e, int n_m, int tile_e, int tile_m,
                                 int k, void* stream) {
  if (tile_e != kTileE || tile_m != kTileM || k != kK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_e <= 0) return static_cast<int>(cudaSuccess);
  knn_coords_kernel<<<n_e, kTileE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q4), static_cast<const float4*>(r4),
      static_cast<const int*>(flags), static_cast<const int*>(qperm), n_query,
      n_m, static_cast<float*>(out_d), static_cast<float*>(out_c));
  return static_cast<int>(cudaGetLastError());
}
