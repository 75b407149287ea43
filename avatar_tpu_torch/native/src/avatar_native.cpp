// Native host-side helpers for avatar_tpu_torch (the port's copy of
// avatar_tpu/native/src/avatar_native.cpp; built by build.py into
// avatar_tpu_torch/_build/ and loaded via ctypes from
// avatar_tpu_torch/native/*.py — every entry point has a numpy
// fallback).
//
// Components:
//   * rle_decode / rle_encode — the reference's .depth zero-run-length codec
//     (semantics of Util.cpp:176-247): float stream where a negative value
//     -n is a run of n zeros; runs span rows; trailing zero runs omitted.
//   * cc_label — gated union-find connected components over a 2D grid
//     (host alternative to the on-device label-propagation kernel; the
//     discovery-order root ids match the reference's flood-fill component
//     ordering).
//   * depth_batch_decode — decode many .depth buffers into one contiguous
//     batch (parallelized dataset prefetch path).

#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>

extern "C" {

// Decode a .depth byte stream (after validation of >= 4 byte header).
// Returns floats written, or -1 on corruption.
long long rle_decode(const char* data, long long nbytes, float* out,
                     long long n) {
    if (nbytes < 4) return -1;
    const float* vals = reinterpret_cast<const float*>(data + 4);
    long long nvals = (nbytes - 4) / 4;
    long long w = 0;
    for (long long i = 0; i < nvals && w < n; ++i) {
        float x = vals[i];
        if (x < 0.0f) {
            long long run = static_cast<long long>(-x);
            long long take = run < (n - w) ? run : (n - w);
            std::memset(out + w, 0, take * sizeof(float));
            w += take;
        } else {
            out[w++] = x;
        }
    }
    // zero-fill the remainder (decoder semantics: trailing run omitted)
    if (w < n) std::memset(out + w, 0, (n - w) * sizeof(float));
    return n;
}

// Encode n floats; writes at most max_bytes into out.  Returns the number
// of FLOATS written (caller slices out[:ret*4]), or -1 on overflow.
long long rle_encode(const float* flat, long long n, char* out,
                     long long max_bytes) {
    float* o = reinterpret_cast<float*>(out);
    long long cap = max_bytes / 4;
    long long w = 0;
    long long zrun = 0;
    for (long long i = 0; i < n; ++i) {
        if (flat[i] == 0.0f) {
            ++zrun;
            continue;
        }
        if (zrun >= 1) {
            if (w >= cap) return -1;
            o[w++] = static_cast<float>(-zrun);
        }
        zrun = 0;
        if (w >= cap) return -1;
        o[w++] = flat[i];
    }
    // trailing zero run intentionally not flushed (Util.cpp:226-243)
    return w;
}

// Union-find with path halving.
static inline int32_t uf_find(int32_t* parent, int32_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

// Gated 4-neighbor connected components.
//   active  [H*W] uint8 (0/1)
//   values  [H*W] uint8 part values; edges require equal values when
//           use_values != 0
//   labels  [H*W] int32 out: root = smallest flat index of the component
//           (scan-order discovery id), or -1 for inactive pixels.
// Returns the number of components.
int cc_label(const uint8_t* active, const uint8_t* values, int use_values,
             int H, int W, int32_t* labels) {
    const long long n = static_cast<long long>(H) * W;
    std::vector<int32_t> parent(n);
    for (long long i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);

    auto join = [&](long long a, long long b) {
        int32_t ra = uf_find(parent.data(), (int32_t)a);
        int32_t rb = uf_find(parent.data(), (int32_t)b);
        if (ra == rb) return;
        if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
    };

    for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
            long long i = (long long)y * W + x;
            if (!active[i]) continue;
            if (x > 0 && active[i - 1] &&
                (!use_values || values[i] == values[i - 1]))
                join(i, i - 1);
            if (y > 0 && active[i - W] &&
                (!use_values || values[i] == values[i - W]))
                join(i, i - W);
        }
    }
    int count = 0;
    for (long long i = 0; i < n; ++i) {
        if (!active[i]) { labels[i] = -1; continue; }
        int32_t r = uf_find(parent.data(), (int32_t)i);
        labels[i] = r;
        if (r == (int32_t)i) ++count;
    }
    return count;
}

// Decode `count` RLE buffers (concatenated; offsets[i] = byte offset of
// buffer i, offsets[count] = total) into out[count * n] with a thread pool.
void depth_batch_decode(const char* data, const long long* offsets,
                        int count, float* out, long long n, int threads) {
    if (threads < 1) threads = 1;
    std::vector<std::thread> pool;
    std::atomic_int next{0};
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= count) break;
            rle_decode(data + offsets[i], offsets[i + 1] - offsets[i],
                       out + (long long)i * n, n);
        }
    };
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
}

}  // extern "C"
