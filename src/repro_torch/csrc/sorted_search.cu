// Kernel K1: sorted search (searchsorted-right) and the sorted-array Get.
//
// Replaces the TPU kernel repro/kernels/sorted_search/kernel.py
// (_search_kernel / sorted_search_kernel, wrapped by ops.sorted_search and
// ops.sorted_get).  The TPU version counts keys <= q with a tiled
// all-compare, O(N) per query, because the VPU prefers dense compares to
// data-dependent indexing.  On Hopper every thread can index memory on its
// own, so one thread per query runs a branchless upper-bound binary search:
// ceil(log2 N) dependent loads per query, no divergence (the loop trip
// count depends on N only).
//
// What bounds it on the H100: the latency of those dependent loads, not
// bandwidth.  The first levels of every search touch the same few keys,
// which stay in L1/L2; only the last ~log2(N / L2-resident keys) levels go
// to HBM.  Many queries in flight (one thread each, 256 per block) hide
// that latency.
//
// Semantics (the reference ops): rank[q] = #{i : keys[i] <= q}, clamped to
// N (a search over the N real keys never exceeds N, which is what the
// reference's dtype-max padding plus clamp gives).  sorted_get returns
// found = keys[clip(rank - 1, 0, N - 1)] == q and the value there (0 when
// absent).
//
// Plain C interface, loaded with ctypes: each launcher returns
// cudaGetLastError() after its launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename K>
__device__ __forceinline__ int64_t upper_bound(const K* __restrict__ keys,
                                               int64_t n, K x) {
    if (n <= 0) return 0;
    int64_t base = 0;
    int64_t len = n;
    while (len > 1) {
        const int64_t half = len >> 1;
        base = (keys[base + half] <= x) ? base + half : base;
        len -= half;
    }
    return base + (keys[base] <= x ? 1 : 0);
}

template <typename K>
__global__ void search_kernel(const K* __restrict__ keys, int64_t n,
                              const K* __restrict__ queries, int64_t q,
                              int32_t* __restrict__ ranks) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
    if (i >= q) return;
    const int64_t r = upper_bound(keys, n, queries[i]);
    ranks[i] = static_cast<int32_t>(r < n ? r : n);
}

template <typename K, typename V>
__global__ void get_kernel(const K* __restrict__ keys,
                           const V* __restrict__ values, int64_t n,
                           const K* __restrict__ queries, int64_t q,
                           uint8_t* __restrict__ found,
                           V* __restrict__ out) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
    if (i >= q) return;
    const K x = queries[i];
    int64_t idx = upper_bound(keys, n, x) - 1;
    idx = idx < 0 ? 0 : (idx > n - 1 ? n - 1 : idx);
    const bool hit = keys[idx] == x;
    found[i] = hit ? 1 : 0;
    out[i] = hit ? values[idx] : V(0);
}

inline unsigned blocks_for(int64_t q) {
    return static_cast<unsigned>((q + kThreads - 1) / kThreads);
}

template <typename K>
int launch_search(const void* keys, int64_t n, const void* queries,
                  int64_t q, int32_t* ranks, cudaStream_t stream) {
    search_kernel<K><<<blocks_for(q), kThreads, 0, stream>>>(
        static_cast<const K*>(keys), n, static_cast<const K*>(queries), q,
        ranks);
    return static_cast<int>(cudaGetLastError());
}

template <typename K, typename V>
int launch_get(const void* keys, const void* values, int64_t n,
               const void* queries, int64_t q, uint8_t* found, void* out,
               cudaStream_t stream) {
    get_kernel<K, V><<<blocks_for(q), kThreads, 0, stream>>>(
        static_cast<const K*>(keys), static_cast<const V*>(values), n,
        static_cast<const K*>(queries), q, found, static_cast<V*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_get_values(int val_bytes, const void* keys, const void* values,
                      int64_t n, const void* queries, int64_t q,
                      uint8_t* found, void* out, cudaStream_t stream) {
    // values move as raw 4- or 8-byte words: an all-zero word is 0 in
    // every integer and float type the wrapper accepts
    if (val_bytes == 4)
        return launch_get<K, uint32_t>(keys, values, n, queries, q, found,
                                       out, stream);
    if (val_bytes == 8)
        return launch_get<K, uint64_t>(keys, values, n, queries, q, found,
                                       out, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// key_dtype: 0 = int32, 1 = int64, 2 = float32
extern "C" int sorted_search_launch(int key_dtype, const void* keys,
                                    int64_t n, const void* queries,
                                    int64_t q, int32_t* ranks,
                                    void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (key_dtype) {
        case 0: return launch_search<int32_t>(keys, n, queries, q, ranks, s);
        case 1: return launch_search<int64_t>(keys, n, queries, q, ranks, s);
        case 2: return launch_search<float>(keys, n, queries, q, ranks, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" int sorted_get_launch(int key_dtype, int val_bytes,
                                 const void* keys, const void* values,
                                 int64_t n, const void* queries, int64_t q,
                                 uint8_t* found, void* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (key_dtype) {
        case 0: return launch_get_values<int32_t>(val_bytes, keys, values,
                                                  n, queries, q, found, out,
                                                  s);
        case 1: return launch_get_values<int64_t>(val_bytes, keys, values,
                                                  n, queries, q, found, out,
                                                  s);
        case 2: return launch_get_values<float>(val_bytes, keys, values, n,
                                                queries, q, found, out, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
