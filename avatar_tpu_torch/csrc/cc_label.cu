// Connected components of a masked grid by label propagation, hand-written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package labels components in plain jnp
// (avatar_tpu/perception/cc.py::connected_components, a while_loop compiled
// into the frame's program).  Its eager PyTorch counterpart
// (perception/cc.py::connected_components_plain) issues ~24 small launches
// and one host read of its `changed` flag per sweep, ~10-30 sweeps a call,
// two calls a tracked frame: on this card the labelling was bound by the
// host's launches and reads, not by the device.  This kernel runs the whole
// loop in one launch and reads nothing back to the host.
//
// It runs the plain loop's iteration, not another labelling algorithm, so
// its labels equal the loop's to the bit on every input, including inputs
// where the loop stops at max_iters (union-find would give the true minimum
// there).  With n = H * W and A the labels:
//   start   A[p] = p where active, else n;
//   sweep   B[p] = min(A[p], A[q]) over the 4-neighbours q whose edge is
//           open (Jacobi: every read is of the previous A);
//   jump    C[p] = min(B[p], B[B[p]]), B[n] = n, written over A (a pixel
//           reads only its own A[p] in this phase);
//   repeat  while some C[p] != A[p] and fewer than max_iters sweeps ran;
//   end     -1 where A[p] == n (exactly the inactive pixels).
// A grid with nothing active runs one sweep that changes nothing, where the
// loop runs none: the same labels.  An edge (p, q) is open when both are
// active and, by the gate: always (no values); their uint8 values are equal;
// or ((dx * dx + dy * dy) + dz * dz) <= thresh for the float32 XYZ values,
// d = v[p] - v[q], each operation rounded alone as the plain gate's
// separate tensor operations are (no fused multiply-add), thresh read from
// the device.
//
// Bound.  Bytes are few: a call reads the mask and the values once (1 + 1
// or 12 bytes a pixel) and writes 4 bytes a pixel of labels, ~3.7 MB at
// most on the main path (360x640 with XYZ values), ~1 us at 3.35 TB/s; the
// sweeps' own traffic stays in the 50 MB L2.  What binds it is the chain of
// dependent sweeps, each a pass of a few L2 round trips and two grid-wide
// barriers.
//
// Design.  One cooperative launch of a persistent grid: at most as many
// blocks as are co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// once per device), and no more than the pixels need, so a small grid syncs
// few blocks.  Each thread owns the pixels p = tid + k * threads for the
// whole launch, so its edge bits (computed once, one byte a pixel) and its
// own labels are its own; the phases are separated by grid.sync().
// Labels written by other blocks are read through L2 (__ldcg).  The
// `changed` flag is one int that the jump phase of sweep `it` sets to it + 1
// (one store per block that changed), so it is never reset.  No shared
// memory, no allocation, no host read: the wrapper hands in the output and
// one scratch buffer.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 1024;
constexpr int kMaxDevices = 64;

enum Gate { kAlways = 0, kEqual = 1, kDist2 = 2 };

struct Grid {
  int h, w;
  const uint8_t* active;     // one byte a pixel (bool), element strides
  long long a_sy, a_sx;
  const void* values;        // uint8 [h, w] or float32 [h, w, 3]
  long long v_sy, v_sx, v_sc;
  const float* thresh;       // kDist2's threshold, on the device
};

template <int kGate>
__device__ __forceinline__ bool open_edge(const Grid& g, int y, int x, int qy,
                                          int qx, float thr) {
  if (kGate == kEqual) {
    const uint8_t* v = static_cast<const uint8_t*>(g.values);
    return __ldg(v + y * g.v_sy + x * g.v_sx) ==
           __ldg(v + qy * g.v_sy + qx * g.v_sx);
  }
  if (kGate == kDist2) {
    const float* v = static_cast<const float*>(g.values);
    const float* a = v + y * g.v_sy + x * g.v_sx;
    const float* b = v + qy * g.v_sy + qx * g.v_sx;
    const float d0 = __fsub_rn(__ldg(a), __ldg(b));
    const float d1 = __fsub_rn(__ldg(a + g.v_sc), __ldg(b + g.v_sc));
    const float d2 = __fsub_rn(__ldg(a + 2 * g.v_sc), __ldg(b + 2 * g.v_sc));
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                              __fmul_rn(d2, d2));
    return s <= thr;
  }
  return true;
}

template <int kGate>
__global__ void __launch_bounds__(kBlock)
cc_label(Grid g, int max_iters, int* __restrict__ lab, int* __restrict__ nxt,
         int* __restrict__ mark, uint8_t* __restrict__ edges) {
  cg::grid_group grid = cg::this_grid();
  const int n = g.h * g.w;
  const int w = g.w;
  const int step = gridDim.x * kBlock;
  const int t0 = blockIdx.x * kBlock + threadIdx.x;
  const float thr = kGate == kDist2 ? __ldg(g.thresh) : 0.0f;
  // the plain loop's four gates: the neighbour above, below, left, right
  const int dys[4] = {-1, 1, 0, 0};
  const int dxs[4] = {0, 0, -1, 1};
  for (int p = t0; p < n; p += step) {
    const int y = p / w, x = p - y * w;
    const bool act = __ldg(g.active + y * g.a_sy + x * g.a_sx) != 0;
    uint8_t bits = 0;
    if (act) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int qy = y + dys[k], qx = x + dxs[k];
        if (qy >= 0 && qy < g.h && qx >= 0 && qx < w &&
            __ldg(g.active + qy * g.a_sy + qx * g.a_sx) != 0 &&
            open_edge<kGate>(g, y, x, qy, qx, thr)) {
          bits |= 1 << k;
        }
      }
    }
    edges[p] = bits;
    lab[p] = act ? p : n;
  }
  if (t0 == 0) {
    nxt[n] = n;
    *mark = 0;
  }
  grid.sync();
  for (int it = 0; it < max_iters; ++it) {
    for (int p = t0; p < n; p += step) {
      const uint8_t bits = edges[p];
      int b = __ldcg(lab + p);
      if (bits & 1) b = min(b, __ldcg(lab + p - w));
      if (bits & 2) b = min(b, __ldcg(lab + p + w));
      if (bits & 4) b = min(b, __ldcg(lab + p - 1));
      if (bits & 8) b = min(b, __ldcg(lab + p + 1));
      nxt[p] = b;
    }
    grid.sync();
    int changed = 0;
    for (int p = t0; p < n; p += step) {
      const int b = __ldcg(nxt + p);
      const int c = min(b, __ldcg(nxt + b));
      changed |= c != __ldcg(lab + p);
      lab[p] = c;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) *mark = it + 1;
    grid.sync();
    if (__ldcg(mark) != it + 1) break;
  }
  for (int p = t0; p < n; p += step) {
    if (lab[p] == n) lab[p] = -1;
  }
}

template <int kGate>
cudaError_t launch(const Grid& g, int max_iters, int* lab, int* scratch,
                   cudaStream_t stream) {
  static int resident[kMaxDevices];   // co-resident blocks, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cc_label<kGate>, kBlock, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const int n = g.h * g.w;
  const int need = (n + kBlock - 1) / kBlock;
  const int blocks = need < resident[dev] ? need : resident[dev];
  Grid grid_arg = g;
  int* nxt = scratch;                 // n + 1 ints
  int* mark = scratch + n + 1;        // 1 int
  uint8_t* edges = reinterpret_cast<uint8_t*>(scratch + n + 2);   // n bytes
  void* args[] = {&grid_arg, &max_iters, &lab, &nxt, &mark, &edges};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cc_label<kGate>), dim3(blocks),
      dim3(kBlock), args, 0, stream);
}

}  // namespace

// Labels (int32 [h, w], contiguous, -1 where not active) of the components
// of `active` (one byte a pixel, strides a_sy, a_sx in elements) joined by
// the gate: 0 always, 1 equal uint8 `values`, 2 the squared distance of
// float32 XYZ `values` at most *thresh (values' strides v_sy, v_sx, v_sc in
// elements).  `scratch` holds at least n + 2 + ceil(n / 4) ints, n = h * w
// <= 2^30.  Returns the launch's CUDA error (0: queued).
extern "C" int avatar_cc_label(const uint8_t* active, long long a_sy,
                               long long a_sx, int gate, const void* values,
                               long long v_sy, long long v_sx, long long v_sc,
                               const float* thresh, int h, int w,
                               int max_iters, int* labels, int* scratch,
                               void* stream) {
  if (h <= 0 || w <= 0 || static_cast<long long>(h) * w > (1LL << 30) ||
      max_iters < 0 || gate < kAlways || gate > kDist2 ||
      (gate != kAlways && values == nullptr) ||
      (gate == kDist2 && thresh == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid g = {h, w, active, a_sy, a_sx, values, v_sy, v_sx, v_sc,
                  thresh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (gate) {
    case kEqual: err = launch<kEqual>(g, max_iters, labels, scratch, s); break;
    case kDist2: err = launch<kDist2>(g, max_iters, labels, scratch, s); break;
    default: err = launch<kAlways>(g, max_iters, labels, scratch, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
