// Kernel K2: scan of an unsorted key column, equality and range at once.
//
// Replaces the TPU kernel repro/kernels/scan_filter/kernel.py
// (_scan_kernel / scan_filter_kernel, wrapped by ops.scan_filter and
// ops.scan_get).  For each query q it computes
//     pos[q] = the first index i with keys[i] == queries[q] (else
//              NOT_FOUND = int32 max), and
//     cnt[q] = #{i : lo[q] <= keys[i] < hi[q]},
// both on every call, as the TPU kernel does.  The TPU version runs a grid
// of (query block, key block) whose key axis is sequential, carrying min
// and += in the output block from one key block to the next.  Blocks of a
// Hopper grid run in no order, so here:
//   * each thread owns kQPT queries and keeps, in registers, their running
//     first-match index and count over every key of its block's range;
//   * the block stages its key range through shared memory, kTile keys at
//     a time, every thread reading each staged key (a broadcast);
//   * where the key range is split across blocks (blockIdx.y), the partial
//     results combine with atomicMin / atomicAdd on int32.  Both are
//     order-independent, so the answer is exact and repeatable;
//   * ragged N and Q are masked here; no padding key exists, so a query
//     equal to the dtype's maximum finds a real key of that value only.
//
// What bounds it on the H100: integer operations.  Every (key, query) pair
// costs an equality compare, two bound compares and a count add; N * Q
// pairs at the INT32 throughput (64 lanes per SM per clock).  The key
// column is read once per query block, from L2 after the first.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() after its launch.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQPT = 4;                       // queries per thread
constexpr int kQueriesPerBlock = kThreads * kQPT;
constexpr int kTile = 2048;                   // keys staged per step
constexpr int32_t kNotFound = 2147483647;

template <typename T>
__global__ void scan_kernel(const T* __restrict__ keys, int64_t n,
                            int64_t keys_per_split,
                            const T* __restrict__ queries,
                            const T* __restrict__ lo,
                            const T* __restrict__ hi, int64_t q,
                            int32_t* __restrict__ pos,
                            int32_t* __restrict__ cnt) {
    __shared__ T tile[kTile];
    T qv[kQPT], lov[kQPT], hiv[kQPT];
    int32_t first[kQPT], count[kQPT];
    const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQueriesPerBlock;
#pragma unroll
    for (int j = 0; j < kQPT; ++j) {
        const int64_t i = q0 + j * kThreads + threadIdx.x;
        const bool ok = i < q;
        qv[j] = ok ? queries[i] : T(0);
        lov[j] = ok ? lo[i] : T(0);
        hiv[j] = ok ? hi[i] : T(0);
        first[j] = kNotFound;
        count[j] = 0;
    }
    const int64_t k_begin = static_cast<int64_t>(blockIdx.y) * keys_per_split;
    const int64_t k_end =
        n < k_begin + keys_per_split ? n : k_begin + keys_per_split;
    for (int64_t base = k_begin; base < k_end; base += kTile) {
        const int m = static_cast<int>(k_end - base < kTile ? k_end - base
                                                            : kTile);
        __syncthreads();
        for (int t = threadIdx.x; t < m; t += kThreads) tile[t] = keys[base + t];
        __syncthreads();
        const int32_t idx0 = static_cast<int32_t>(base);
#pragma unroll 4
        for (int t = 0; t < m; ++t) {
            const T key = tile[t];
            const int32_t idx = idx0 + t;
#pragma unroll
            for (int j = 0; j < kQPT; ++j) {
                if (key == qv[j] && idx < first[j]) first[j] = idx;
                count[j] += (key >= lov[j]) & (key < hiv[j]);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < kQPT; ++j) {
        const int64_t i = q0 + j * kThreads + threadIdx.x;
        if (i >= q) continue;
        if (first[j] != kNotFound) atomicMin(pos + i, first[j]);
        if (count[j] != 0) atomicAdd(cnt + i, count[j]);
    }
}

template <typename T>
int launch(const void* keys, int64_t n, const void* queries, const void* lo,
           const void* hi, int64_t q, int32_t* pos, int32_t* cnt,
           cudaStream_t stream) {
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int64_t q_blocks = (q + kQueriesPerBlock - 1) / kQueriesPerBlock;
    const int64_t k_tiles = (n + kTile - 1) / kTile;
    // split the key range until about four blocks per SM are in flight
    int64_t splits = (4 * static_cast<int64_t>(sms) + q_blocks - 1) / q_blocks;
    splits = std::max<int64_t>(
        1, std::min<int64_t>(splits, std::min<int64_t>(k_tiles, 65535)));
    const int64_t per_split = (k_tiles + splits - 1) / splits * kTile;
    splits = (n + per_split - 1) / per_split;
    dim3 grid(static_cast<unsigned>(q_blocks), static_cast<unsigned>(splits));
    scan_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(keys), n, per_split,
        static_cast<const T*>(queries), static_cast<const T*>(lo),
        static_cast<const T*>(hi), q, pos, cnt);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 int32, 1 float32.  pos must hold NOT_FOUND and cnt 0 on entry
// (the kernel only lowers and adds).
extern "C" int scan_filter_launch(int dtype, const void* keys, int64_t n,
                                  const void* queries, const void* lo,
                                  const void* hi, int64_t q, int32_t* pos,
                                  int32_t* cnt, void* stream) {
    if (q == 0 || n == 0) return 0;
    if (n >= kNotFound || q / kQueriesPerBlock >= kNotFound)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<int32_t>(keys, n, queries, lo, hi, q, pos, cnt, s);
        case 1: return launch<float>(keys, n, queries, lo, hi, q, pos, cnt, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
