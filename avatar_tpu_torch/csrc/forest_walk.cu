// The random forest's walk over a set of pixels, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package walks the forest in plain JAX
// (avatar_tpu/perception/rtree.py::walk_pixels, a fori_loop compiled into
// the frame's program).  Its eager PyTorch counterpart issues ~54 small
// launches per tree level, ~17 levels per tree: on this card the walk was
// bound by the host's launch cost (~2,750 launches a fused frame), not by
// the device.  This kernel walks a set of trees over a set of pixels in one
// launch.
//
// One thread per (tree, pixel).  From the root, until a leaf or max_depth
// levels: read the node, probe the depth image at the pixel plus u / z and
// plus v / z, and go to lnode when
//     f = depth(pix + u / z) - depth(pix + v / z) < thresh
// else to rnode.  A probe outside the inclusive ROI, or on a zero depth,
// reads BACKGROUND_DEPTH.  Leaves self-loop in the fixed-depth plain walk,
// so stopping at the first leaf gives the same id.  Pixels with fg false
// write -1 and walk nothing.
//
// Arithmetic mirrors the plain walk (perception/rtree.py::
// walk_pixels_plain) to the bit: u / z is an IEEE float32 division (no fast
// math; the library is built with --fmad=false), rintf rounds half to
// even as torch.round does, the cast to int32 truncates and saturates as
// PyTorch's float-to-int copy does on the card, and the probe coordinates
// and the flat index are 64-bit, the index clamped to the image before the
// read.  The labels feed the fit, so the leaf ids must be equal.
//
// Bound.  Random reads, dependent level to level.  A level reads one node
// (leafid, u, v, thresh, lnode, rnode: 32 bytes in six arrays) and two
// probe pixels at data-dependent addresses.  The bench's three trees hold
// ~200k nodes (~6.5 MB of node arrays) and the probe image is at most a
// 1280x720 float32 frame (3.7 MB): all of it stays in the 50 MB L2.  Bytes
// are few (a 3,072-pixel walk of 17 levels touches ~2 MB of sectors); the
// time is the chain of L2 round trips, two per level, of the deepest walk.
//
// Design.  Every (tree, pixel) is its own thread, so every walk is in
// flight at once and the chain is paid once per launch, not once per
// pixel.  The six node fields of a level are independent loads issued
// together (one round trip), then the two probes (the second); a probe
// outside the ROI reads nothing.  The grid's y axis is the tree range
// [t0, t0 + n_trees) of a stacked forest, so the fused tracker's trees 1
// and 2 over its hard pixels take one launch.  No shared memory, no
// atomics, no allocation: the output is written once per thread.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr float kBackground = 20.0f;   // meters (reference RTree.cpp:325)

struct Roi {
  long long hp, wp, tlx, tly, brx, bry;
};

__device__ __forceinline__ float probe_at(const float* __restrict__ probe,
                                          const Roi& r, long long px,
                                          long long py) {
  if (px < r.tlx || px > r.brx || py < r.tly || py > r.bry) {
    return kBackground;
  }
  long long idx = py * r.wp + px;
  const long long last = r.hp * r.wp - 1;
  idx = idx < 0 ? 0 : (idx > last ? last : idx);
  const float pz = __ldg(probe + idx);
  return pz == 0.0f ? kBackground : pz;
}

__device__ __forceinline__ long long offset(float w, float z) {
  // torch.round(w / z).to(torch.int32): IEEE division, half to even, then
  // the saturating truncation of cvt.rzi.s32.f32
  return static_cast<long long>(static_cast<int>(rintf(__fdiv_rn(w, z))));
}

__global__ void __launch_bounds__(kBlock)
walk(const float2* __restrict__ u, const float2* __restrict__ v,
     const float* __restrict__ thresh, const int* __restrict__ lnode,
     const int* __restrict__ rnode, const int* __restrict__ leafid,
     long long n_nodes, int t0, const long long* __restrict__ ys,
     const long long* __restrict__ xs, const float* __restrict__ z,
     const uint8_t* __restrict__ fg, int k, const float* __restrict__ probe,
     Roi roi, int max_depth, int* __restrict__ out) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= k) return;
  const int t = blockIdx.y;
  int* dst = out + static_cast<long long>(t) * k + p;
  if (!fg[p]) {
    *dst = -1;
    return;
  }
  const long long base = static_cast<long long>(t0 + t) * n_nodes;
  const long long y = ys[p], x = xs[p];
  const float zp = z[p];
  int node = 0;
  for (int d = 0; d < max_depth; ++d) {
    const long long n = base + node;
    const int leaf = __ldg(leafid + n);
    const float2 uu = __ldg(u + n);
    const float2 vv = __ldg(v + n);
    const float th = __ldg(thresh + n);
    const int ln = __ldg(lnode + n);
    const int rn = __ldg(rnode + n);
    if (leaf >= 0) break;
    const float fu = probe_at(probe, roi, x + offset(uu.x, zp),
                              y + offset(uu.y, zp));
    const float fv = probe_at(probe, roi, x + offset(vv.x, zp),
                              y + offset(vv.y, zp));
    node = __fsub_rn(fu, fv) < th ? ln : rn;
  }
  *dst = __ldg(leafid + base + node);
}

}  // namespace

// Leaf ids out[t][p] (int32, -1 where fg[p] is 0) of trees [t0, t0 +
// n_trees) of a forest whose node arrays hold n_nodes nodes per tree (u, v
// float32 [T, n_nodes, 2]; thresh float32, lnode, rnode, leafid int32
// [T, n_nodes]; one tree is T = 1), over k pixels (ys, xs int64, z
// float32, fg one byte each) probing the hp x wp float32 image ``probe``
// inside the inclusive ROI.  Returns the launch's CUDA error (0: queued).
extern "C" int avatar_forest_walk(
    const float* u, const float* v, const float* thresh, const int* lnode,
    const int* rnode, const int* leafid, long long n_nodes, int t0,
    int n_trees, const long long* ys, const long long* xs, const float* z,
    const uint8_t* fg, int k, const float* probe, long long hp, long long wp,
    long long tlx, long long tly, long long brx, long long bry,
    int max_depth, int* out, void* stream) {
  if (n_nodes <= 0 || t0 < 0 || n_trees <= 0 || n_trees > 65535 || k < 0 ||
      hp <= 0 || wp <= 0 || max_depth < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == 0) return 0;
  const Roi roi = {hp, wp, tlx, tly, brx, bry};
  const dim3 grid((k + kBlock - 1) / kBlock, n_trees);
  walk<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(u), reinterpret_cast<const float2*>(v),
      thresh, lnode, rnode, leafid, n_nodes, t0, ys, xs, z, fg, k, probe,
      roi, max_depth, out);
  return static_cast<int>(cudaGetLastError());
}
