// Part-constrained masked nearest-neighbour argmin, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels avatar_tpu/optim/nn_pallas.py::_kernel_ranges
// (reached through nn_argmin_ranges, every LM step of gauss_newton.fit) and
// ::_kernel (nn_argmin).  The second is this kernel with every data tile
// scanning the whole model axis (cstart = 0, cend = n_chunks): the tie rule
// below makes the result independent of the chunk size.
//
// For each data row n: the minimum squared distance to a model vertex j and
// that j, over the model chunks [cstart[t], cend[t]) of the row's 256-row
// tile t, where j is a candidate when
//     (part[j] == dpart[n] || (dpart[n] == wild && part[j] < 2^30))
//     && valid[j]
// Tie rule: the lowest index wins (the Pallas kernel takes the lowest index
// within a chunk and the earlier chunk across chunks, with strict <; both
// reduce to "first index of the minimum").  No candidate: d = 3e38, i = -1.
//
// What bounds it on this card: compute and latency, not bytes.  The two
// clouds are about 200 KB and stay in L2; each data row does ~10 flops per
// scanned column.  Design: one block of 256 threads handles 64 data rows
// (all in one tile, so the chunk range is block-uniform), 4 threads per row
// scanning interleaved columns of a model chunk staged through shared
// memory as float4 {x, y, z, part-or-invalid bits}; each thread keeps a
// running (d, i) with strict <, and the 4 partial results merge through
// warp shuffles (smaller d, then smaller index).  At the steady-state
// N = 8192 that is 128 blocks against 132 SMs with 8 warps each; occupancy,
// wgmma-style tiling and TMA staging are later work.
//
// Rounding: d2 = (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// on its own (__fmul_rn / __fadd_rn, and the library is built with
// --fmad=false).  A contracted FMA would round differently from the plain
// PyTorch version and could pick a different index on a near-tie.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // data rows per block
constexpr int kLanes = 4;                 // threads per data row
constexpr int kThreads = kRows * kLanes;  // 256
constexpr int kMaxChunk = 3072;           // 48 KB of float4 staging
constexpr float kInf = 3.0e38f;
constexpr int kBigPart = 1 << 30;         // model pad slots carry this part
constexpr int kInvalid = INT_MIN;         // staged key of an invisible vertex

__global__ void __launch_bounds__(kThreads)
nn_argmin_ranges_kernel(const float* __restrict__ dpts,
                        const int* __restrict__ dpart,
                        const float* __restrict__ mpts,
                        const int* __restrict__ mpart,
                        const uint8_t* __restrict__ mvalid,
                        const int* __restrict__ cstart,
                        const int* __restrict__ cend,
                        float* __restrict__ best_d,
                        int* __restrict__ best_i,
                        int n_chunks, int tile_n, int chunk, int wild) {
  extern __shared__ float4 stage[];       // [chunk]
  const int lane = threadIdx.x % kLanes;
  const int row = blockIdx.x * kRows + threadIdx.x / kLanes;
  const int tile = blockIdx.x * kRows / tile_n;

  const float px = dpts[3 * row];
  const float py = dpts[3 * row + 1];
  const float pz = dpts[3 * row + 2];
  const int part = dpart[row];
  const int c0 = max(cstart[tile], 0);
  const int c1 = min(cend[tile], n_chunks);

  float bd = kInf;
  int bi = -1;
  for (int c = c0; c < c1; ++c) {
    const int base = c * chunk;
    __syncthreads();                      // the previous chunk is consumed
    for (int k = threadIdx.x; k < chunk; k += kThreads) {
      const int j = base + k;
      const int key = mvalid[j] ? mpart[j] : kInvalid;
      stage[k] = make_float4(mpts[3 * j], mpts[3 * j + 1], mpts[3 * j + 2],
                             __int_as_float(key));
    }
    __syncthreads();
    for (int k = lane; k < chunk; k += kLanes) {
      const float4 m = stage[k];
      const int key = __float_as_int(m.w);
      const bool ok = key != kInvalid &&
                      (key == part || (part == wild && key < kBigPart));
      const float dx = __fsub_rn(px, m.x);
      const float dy = __fsub_rn(py, m.y);
      const float dz = __fsub_rn(pz, m.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (ok && d2 < bd) {                // strict: the lowest index stays
        bd = d2;
        bi = base + k;
      }
    }
  }
  // merge the lanes of this row: smaller d, then smaller index.  A lane
  // without a candidate holds (kInf, -1); equal finite d means both lanes
  // hold a candidate.
  for (int off = 1; off < kLanes; off <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, bd, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (od < bd || (od == bd && oi < bi)) {
      bd = od;
      bi = oi;
    }
  }
  if (lane == 0) {
    best_d[row] = bd;
    best_i[row] = bi;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers; the launch goes on ``stream`` and does not synchronise.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int avatar_nn_argmin_ranges(
    const float* dpts, const int* dpart, const float* mpts, const int* mpart,
    const uint8_t* mvalid, const int* cstart, const int* cend, float* best_d,
    int* best_i, int n, int pp, int tile_n, int chunk, int wild,
    void* stream) {
  if (n <= 0 || n % kRows != 0 || tile_n <= 0 || tile_n % kRows != 0 ||
      n % tile_n != 0 || chunk <= 0 || chunk > kMaxChunk || pp <= 0 ||
      pp % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(chunk) * sizeof(float4);
  nn_argmin_ranges_kernel<<<n / kRows, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      dpts, dpart, mpts, mpart, mvalid, cstart, cend, best_d, best_i,
      pp / chunk, tile_n, chunk, wild);
  return static_cast<int>(cudaGetLastError());
}
