// Part-constrained masked nearest-neighbour argmin, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels avatar_tpu/optim/nn_pallas.py::_kernel_ranges
// (reached through nn_argmin_ranges, every LM step of gauss_newton.fit) and
// ::_kernel (nn_argmin).  The second is the first with every data tile
// scanning the whole model axis (a null cstart/cend): the tie rule below
// makes the result independent of the chunk size.
//
// For each data row n: the minimum squared distance to a model slot j and
// that j, over the model chunks [cstart[t], cend[t]) of the row's tile t,
// where j is a candidate when
//     (part[j] == dpart[n] || (dpart[n] == wild && part[j] < 2^30))
//     && valid[j]
// Tie rule: the lowest index of the minimum.  No candidate: d = 3e38,
// i = -1.
//
// Rounding: d2 = (dx*dx + dy*dy) + dz*dz with every difference, product and
// sum rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn, and the library
// is built with --fmad=false).  LM convergence compares correspondences for
// equality, so the index must be the plain version's to the bit.  That is
// why the distance is NOT taken by norm expansion on the tensor cores
// (wgmma in TF32 or bf16): |d|^2 + |m|^2 - 2 d.m rounds differently and
// resolves near-ties differently.  Direct differences leave the FP32 pipes
// as the only resource, so the kernel is bound by FP32 instruction issue,
// not bytes: both clouds are under 0.4 MB and stay in L2, and each scanned
// (row, slot) pair costs 8 unfusable FP32 operations plus the compare and
// two selects that keep (d, i).
//
// Design.
// * Pack once.  A pre-pass writes the model as float4 {x, y, z, key}
//   [Pp], key = valid ? part : INT_MIN (an invalid slot also gets x = +inf,
//   so its distance can never win), recentred and permuted when the caller
//   asks (the fused entry), and resets the scratch.  The scan stages slots
//   with 16-byte cp.async copies, double-buffered: the copy of a block's
//   next unit overlaps the scan of the current one.
// * Balance by pairs, not rows.  The unit of work is (64 data rows, up to
//   1024 model slots of one chunk of the rows' tile).  A tile that scans 13
//   chunks becomes 13 units per row group instead of one long block.  The
//   units of every tile are numbered through a prefix sum over the tiles'
//   chunk ranges (each block recomputes it in shared memory: at most 1024
//   tiles), and a fixed grid, as many blocks as the SMs hold at once (8 per
//   SM at chunk 512), walks them with a stride.  The scan is launched as a
//   programmatic dependent of the pre-pass: its blocks number the units
//   while the pre-pass drains.
// * Merge through an order-free atomic.  A unit's result for a row merges
//   into keys[n] with atomicMin on (d2 bits << 32) | index: d2 >= 0, so
//   its float bits order as unsigned, and the low word breaks ties to the
//   lowest index.  The initial key is the no-candidate value.  The block
//   that finishes a row group's last unit (a ticket counter per group)
//   unpacks the 64 rows: no third launch.
// * Fewer instructions per pair.  A thread holds 4 rows in registers and
//   reuses each staged slot for all of them (one LDS.128 per 4 pairs); 8
//   threads share a row set on interleaved slots, so a warp reads 8
//   consecutive float4.  The update is a predicated select.  The part test
//   is one unsigned range compare per pair, and where the 64 rows of a
//   unit carry one label (most units of a part-sorted launch) it is taken
//   once per slot instead.
//
// The fused entry (avatar_nn_match) does one planned or unplanned match
// with one host call: the pre-pass recentres, permutes and pads the model,
// the scan recentres each data row, and the finishing block writes best_d,
// corr (through mperm, with the dpart >= 0 and wildcard-gate rules), wgt
// and n_matched (a float atomicAdd of whole numbers below 2^24: exact in
// any order).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // data rows per work unit
constexpr int kR = 4;                     // rows per thread (register tile)
constexpr int kLanes = 8;                 // threads per row set
constexpr int kThreads = kRows / kR * kLanes;  // 128
constexpr int kMaxUnit = 1024;            // model slots per work unit, at most
constexpr int kMaxChunk = 3072;
constexpr int kMaxTiles = 1024;           // prefix sum held in shared memory
constexpr int kResident = 8;              // blocks per SM the registers allow
constexpr float kInf = 3.0e38f;
constexpr int kBigPart = 1 << 30;         // model pad slots carry this part
constexpr int kInvalid = INT_MIN;         // packed key of an invalid slot
constexpr unsigned kFull = 0xffffffffu;
// a wildcard row takes keys in [INT_MIN + 1, 2^30)
constexpr unsigned kWildLo = 0x80000001u;
constexpr unsigned kWildSpan = 0x3fffffffu - 0x80000001u;

typedef unsigned long long u64;

struct Args {
  // data rows: n_real read, rows up to n are padding (label -1)
  const float* dpts;
  const int* dpart;
  int n_real, n;
  // model: p rows of mpts, pp slots; slot j reads row mperm[j] (or j)
  const float* mpts;
  const float* center;      // null: no recentring
  const int* mperm;         // null: identity, slots >= p invalid
  const uint8_t* mvalid;
  const int* mpart;         // [mpart_len]
  int p, pp, mpart_len;
  const int* cstart;        // null: every tile scans every chunk
  const int* cend;
  int tile_n, chunk, n_chunks, wild;
  int unit, upc;            // slots per work unit, units per chunk
  int gate_mode;            // 0 none, 1 gate_val, 2 *gate_ptr
  float gate_val;
  const float* gate_ptr;
  float4* pack;             // scratch [pp]
  u64* keys;                // scratch [n]
  int* done;                // scratch [n / kRows]
  float* best_d;            // [n]
  int* best_i;              // [n]: raw index, or corr when fused
  float* wgt;               // [n] or null
  float* n_matched;         // [1] or null
  int fused;
};

__device__ __forceinline__ u64 no_key() {
  return (static_cast<u64>(__float_as_uint(kInf)) << 32) | 0xffffffffull;
}

// Pre-pass: pack the model, reset the keys, the tickets and the outputs
// (a row group without any unit keeps these defaults).
__global__ void __launch_bounds__(256) pack_kernel(Args a) {
  // the scan may start its prologue now; it waits for this grid's end
  // before it reads what is written here
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.pp) {
    const bool in_model = a.mperm != nullptr || i < a.p;
    const int src = a.mperm != nullptr ? a.mperm[i] : i;
    float x = 0.f, y = 0.f, z = 0.f;
    bool valid = false;
    if (in_model) {
      x = a.mpts[3 * src];
      y = a.mpts[3 * src + 1];
      z = a.mpts[3 * src + 2];
      if (a.center != nullptr) {
        x = __fsub_rn(x, a.center[0]);
        y = __fsub_rn(y, a.center[1]);
        z = __fsub_rn(z, a.center[2]);
      }
      valid = a.mvalid[src] != 0;
    }
    const int part = i < a.mpart_len ? a.mpart[i] : kBigPart;
    a.pack[i] = make_float4(valid ? x : __int_as_float(0x7f800000), y, z,
                            __int_as_float(valid ? part : kInvalid));
  }
  if (i < a.n) {
    a.keys[i] = no_key();
    a.best_d[i] = kInf;
    a.best_i[i] = -1;
    if (a.wgt != nullptr) a.wgt[i] = 0.f;
  }
  if (i < a.n / kRows) a.done[i] = 0;
  if (i == 0 && a.n_matched != nullptr) *a.n_matched = 0.f;
}

__device__ __forceinline__ int tile_c0(const Args& a, int t) {
  return a.cstart != nullptr ? max(a.cstart[t], 0) : 0;
}

__device__ __forceinline__ int tile_c1(const Args& a, int t) {
  return a.cend != nullptr ? min(a.cend[t], a.n_chunks) : a.n_chunks;
}

struct Unit {
  int group;      // 64-row group
  int per_group;  // units of this group in all
  int base;       // first model slot
  int count;      // slots
};

__device__ __forceinline__ Unit decode(const Args& a, const int* tstart,
                                       int n_tiles, int u) {
  int lo = 0, hi = n_tiles;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tstart[mid] <= u) lo = mid; else hi = mid;
  }
  const int gpt = a.tile_n / kRows;
  const int v = u - tstart[lo];
  const int c0 = tile_c0(a, lo);
  const int s = v / gpt;
  const int upc = a.upc;
  const int sub = s % upc;
  Unit out;
  out.group = lo * gpt + v % gpt;
  out.per_group = (tile_c1(a, lo) - c0) * upc;
  out.base = (c0 + s / upc) * a.chunk + sub * a.unit;
  out.count = min(a.unit, a.chunk - sub * a.unit);
  return out;
}

__device__ __forceinline__ void stage_unit(float4* dst, const float4* pack,
                                           const Unit& u) {
  for (int k = threadIdx.x; k < u.count; k += kThreads) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + k));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(pack + u.base + k) : "memory");
  }
}

template <bool kUniform>
__device__ __forceinline__ void scan_unit(
    const float4* __restrict__ st, int count, int lane,
    const float (&px)[kR], const float (&py)[kR], const float (&pz)[kR],
    const unsigned (&lo)[kR], const unsigned (&span)[kR],
    float (&bd)[kR], int (&bk)[kR]) {
#pragma unroll 4
  for (int k = lane; k < count; k += kLanes) {
    const float4 m = st[k];
    const unsigned key = __float_as_uint(m.w);
    const bool ok_all = key - lo[0] <= span[0];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float dx = __fsub_rn(px[r], m.x);
      const float dy = __fsub_rn(py[r], m.y);
      const float dz = __fsub_rn(pz[r], m.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const bool ok = kUniform ? ok_all : key - lo[r] <= span[r];
      const bool take = ok && d2 < bd[r];   // strict: the lowest slot stays
      bd[r] = take ? d2 : bd[r];
      bk[r] = take ? k : bk[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kResident) scan_kernel(Args a) {
  extern __shared__ float4 stage[];        // [2][a.unit], double-buffered
  __shared__ int tstart[kMaxTiles + 1];
  __shared__ int ticket;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int n_tiles = a.n / a.tile_n;
  const int gpt = a.tile_n / kRows;
  const int upc = a.upc;

  // units before each tile: warp 0, a run of tiles per lane
  if (tid < 32) {
    const int per = (n_tiles + 31) / 32;
    const int t0 = min(tid * per, n_tiles), t1 = min(t0 + per, n_tiles);
    int sum = 0;
    for (int t = t0; t < t1; ++t)
      sum += max(tile_c1(a, t) - tile_c0(a, t), 0) * upc * gpt;
    int inc = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, off);
      if (tid >= off) inc += v;
    }
    int run = inc - sum;
    for (int t = t0; t < t1; ++t) {
      tstart[t] = run;
      run += max(tile_c1(a, t) - tile_c0(a, t), 0) * upc * gpt;
    }
    if (tid == 31) tstart[n_tiles] = inc;
  }
  __syncthreads();
  const int total = tstart[n_tiles];

  int u = blockIdx.x;
  if (u >= total) return;
  Unit cur = decode(a, tstart, n_tiles, u);
  // everything above read only the caller's inputs; the packed model, the
  // keys and the tickets are the pre-pass's
  asm volatile("griddepcontrol.wait;" ::: "memory");
  stage_unit(stage, a.pack, cur);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (a.center != nullptr) {
    cx = a.center[0];
    cy = a.center[1];
    cz = a.center[2];
  }
  for (int b = 0; u < total; u += gridDim.x, b ^= 1) {
    const int next = u + gridDim.x;
    Unit nxt = cur;
    if (next < total) {
      nxt = decode(a, tstart, n_tiles, next);
      stage_unit(stage + (b ^ 1) * a.unit, a.pack, nxt);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // this thread's rows, recentred as the caller's torch code would
    const int row0 = cur.group * kRows + tid / kLanes * kR;
    float px[kR], py[kR], pz[kR], bd[kR];
    unsigned lo[kR], span[kR];
    int bk[kR];
    bool same = true;
    const int part0 = cur.group * kRows < a.n_real
        ? a.dpart[cur.group * kRows] : -1;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = row0 + r;
      int part = -1;
      px[r] = py[r] = pz[r] = 0.f;
      if (row < a.n_real) {
        part = a.dpart[row];
        px[r] = a.dpts[3 * row];
        py[r] = a.dpts[3 * row + 1];
        pz[r] = a.dpts[3 * row + 2];
      }
      if (a.center != nullptr) {
        px[r] = __fsub_rn(px[r], cx);
        py[r] = __fsub_rn(py[r], cy);
        pz[r] = __fsub_rn(pz[r], cz);
      }
      same = same && part == part0;
      lo[r] = part == a.wild ? kWildLo : static_cast<unsigned>(part);
      span[r] = part == a.wild ? kWildSpan : 0u;
      bd[r] = kInf;
      bk[r] = -1;
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    const int uniform = __syncthreads_and(same);   // also: the stage landed
    if (uniform) {
      scan_unit<true>(stage + b * a.unit, cur.count, lane, px, py, pz, lo,
                      span, bd, bk);
    } else {
      scan_unit<false>(stage + b * a.unit, cur.count, lane, px, py, pz, lo,
                       span, bd, bk);
    }

    // merge the lanes of each row (smaller d, then smaller index), then
    // into the row's key
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float d = bd[r];
      int i = bk[r] < 0 ? -1 : cur.base + bk[r];
      for (int off = 1; off < kLanes; off <<= 1) {
        const float od = __shfl_xor_sync(kFull, d, off);
        const int oi = __shfl_xor_sync(kFull, i, off);
        if (od < d || (od == d && static_cast<unsigned>(oi) <
                                      static_cast<unsigned>(i))) {
          d = od;
          i = oi;
        }
      }
      if (lane == 0 && i >= 0) {
        atomicMin(a.keys + row0 + r,
                  (static_cast<u64>(__float_as_uint(d)) << 32) |
                      static_cast<unsigned>(i));
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) ticket = atomicAdd(a.done + cur.group, 1);
    __syncthreads();
    if (ticket == cur.per_group - 1) {
      // the group's last unit: every key is final
      __threadfence();
      bool matched = false;
      if (tid < kRows) {
        const int row = cur.group * kRows + tid;
        const u64 key = __ldcg(a.keys + row);
        const float d = __uint_as_float(static_cast<unsigned>(key >> 32));
        const int i = static_cast<int>(key & 0xffffffffull);
        a.best_d[row] = d;
        if (!a.fused) {
          a.best_i[row] = i;
        } else {
          const int part = row < a.n_real ? a.dpart[row] : -1;
          matched = i >= 0 && part >= 0;
          if (a.gate_mode != 0 && part == a.wild) {
            const float gate = a.gate_mode == 2 ? *a.gate_ptr : a.gate_val;
            matched = matched && d <= gate;
          }
          a.best_i[row] = !matched ? -1
              : (a.mperm != nullptr ? a.mperm[i] : i);
          if (a.wgt != nullptr) a.wgt[row] = matched ? 1.f : 0.f;
        }
      }
      const int count = __syncthreads_count(matched);
      if (tid == 0 && a.n_matched != nullptr && count > 0)
        atomicAdd(a.n_matched, static_cast<float>(count));
    }
    cur = nxt;
  }
}

// The grid that walks the units: the blocks of the scan one SM holds, times
// the SMs.  Asked once for each of the two staging sizes (units of up to
// 512 slots, and up to kMaxUnit).
int walkers(bool big) {
  static int cached[2] = {0, 0};
  int& slot = cached[big ? 1 : 0];
  if (slot == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, scan_kernel, kThreads,
            sizeof(float4) * 2 * (big ? kMaxUnit : 512)) != cudaSuccess ||
        sms <= 0 || per_sm <= 0) {
      return 0;
    }
    slot = sms * per_sm;
  }
  return slot;
}

// Both kernels on ``stream``, no synchronise.  cudaGetLastError() is read
// after each launch; the first error is returned (0 = both launched).
int launch(Args a, void* scratch, void* stream) {
  if (a.n <= 0 || a.n % kRows != 0 || a.tile_n <= 0 ||
      a.tile_n % kRows != 0 || a.n % a.tile_n != 0 ||
      a.n / a.tile_n > kMaxTiles || a.chunk <= 0 || a.chunk > kMaxChunk ||
      a.pp <= 0 || a.pp % a.chunk != 0 || a.n_real < 0 || a.n_real > a.n ||
      a.p <= 0 || a.p > a.pp || a.wild >= kBigPart ||
      (a.cstart == nullptr) != (a.cend == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_chunks = a.pp / a.chunk;
  a.unit = a.chunk < kMaxUnit ? a.chunk : kMaxUnit;
  a.upc = (a.chunk + a.unit - 1) / a.unit;
  char* base = static_cast<char*>(scratch);
  a.pack = reinterpret_cast<float4*>(base);
  a.keys = reinterpret_cast<u64*>(base + sizeof(float4) * a.pp);
  a.done = reinterpret_cast<int*>(base + sizeof(float4) * a.pp +
                                  sizeof(u64) * a.n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int most = a.pp > a.n ? a.pp : a.n;
  pack_kernel<<<(most + 255) / 256, 256, 0, s>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long upper =
      static_cast<long long>(a.n / kRows) * a.n_chunks * a.upc;
  const size_t smem = sizeof(float4) * 2 * a.unit;
  const long long walk = walkers(a.unit > 512);
  if (walk <= 0) return static_cast<int>(cudaErrorUnknown);
  // programmatic dependent launch: the scan's blocks start while the
  // pre-pass drains and wait (griddepcontrol.wait) before they read it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(upper < walk ? upper : walk));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, scan_kernel, a);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  All pointers are device
// pointers.  Each returns 0 when its launches were accepted, the CUDA error
// otherwise, and cudaErrorInvalidValue for shapes the kernel does not take.

// Bytes of scratch one launch needs (16-byte aligned by the caller).
extern "C" long long avatar_nn_scratch_bytes(int n, int pp) {
  return static_cast<long long>(sizeof(float4)) * pp +
         static_cast<long long>(sizeof(u64)) * n +
         static_cast<long long>(sizeof(int)) * (n / kRows);
}

// The raw argmin: (best_d, best_i) [n] over the sorted, padded inputs.
// A null cstart/cend scans every chunk for every tile.
extern "C" int avatar_nn_argmin_ranges(
    const float* dpts, const int* dpart, const float* mpts, const int* mpart,
    const uint8_t* mvalid, const int* cstart, const int* cend, float* best_d,
    int* best_i, void* scratch, int n, int pp, int tile_n, int chunk,
    int wild, void* stream) {
  Args a = {};
  a.dpts = dpts;
  a.dpart = dpart;
  a.n_real = a.n = n;
  a.mpts = mpts;
  a.mvalid = mvalid;
  a.mpart = mpart;
  a.p = a.pp = a.mpart_len = pp;
  a.cstart = cstart;
  a.cend = cend;
  a.tile_n = tile_n;
  a.chunk = chunk;
  a.wild = wild;
  a.best_d = best_d;
  a.best_i = best_i;
  return launch(a, scratch, stream);
}

// One whole match: the model rows recentred on ``center``, permuted by
// ``mperm`` (or padded from p to pp slots), the n_real data rows recentred
// and padded to n, and per row best_d, corr (the original model index, -1
// without a match), wgt and the count n_matched.  gate_mode: 0 no wildcard
// gate, 1 gate_val, 2 the float at gate_ptr.
extern "C" int avatar_nn_match(
    const float* dpts, const int* dpart, int n_real, int n,
    const float* model, const float* center, const int* mperm,
    const uint8_t* visible, const int* mpart, int p, int pp, int mpart_len,
    const int* cstart, const int* cend, int tile_n, int chunk, int wild,
    int gate_mode, float gate_val, const float* gate_ptr, void* scratch,
    float* best_d, int* corr, float* wgt, float* n_matched, void* stream) {
  Args a = {};
  a.dpts = dpts;
  a.dpart = dpart;
  a.n_real = n_real;
  a.n = n;
  a.mpts = model;
  a.center = center;
  a.mperm = mperm;
  a.mvalid = visible;
  a.mpart = mpart;
  a.p = p;
  a.pp = pp;
  a.mpart_len = mpart_len;
  a.cstart = cstart;
  a.cend = cend;
  a.tile_n = tile_n;
  a.chunk = chunk;
  a.wild = wild;
  a.gate_mode = gate_mode;
  a.gate_val = gate_val;
  a.gate_ptr = gate_ptr;
  a.best_d = best_d;
  a.best_i = corr;
  a.wgt = wgt;
  a.n_matched = n_matched;
  a.fused = 1;
  if (center == nullptr || (gate_mode == 2 && gate_ptr == nullptr) ||
      gate_mode < 0 || gate_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(a, scratch, stream);
}
