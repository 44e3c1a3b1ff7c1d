// Kernel K4: bloom-filter probe, k multiply-shift bit tests per query.
//
// Replaces the TPU kernel repro/kernels/bloom_probe/kernel.py
// (_bloom_kernel / bloom_probe_kernel, wrapped by ops.bloom_probe).  The
// TPU version streams every uint32 word of the filter through VMEM and
// tests each (query, hash) pair against each word block with a predicated
// compare, because a gather is slow there.  On Hopper a thread can fetch
// the word it needs, so here one thread owns one query: it wraps the query
// to uint32, computes its k hashes h_j = (a_j * x mod 2^32) >> (32 - s) in
// uint32_t (which wraps exactly as the TPU's uint32 does), gathers the k
// words directly and writes hits[q, j] = bit (h_j & 31) of word h_j >> 5.
//
// One kernel, two outputs chosen at launch (template parameter kMask):
// hits [Q, k] int32, the reference kernel's output, or the [Q] membership
// mask (1 iff all k bits are set) that the reference's op reduces the hits
// to under one jit.  The op launches the mask variant, so a membership
// probe is one launch with no elementwise pass after it.
//
// What bounds it on the H100: bytes.  Each (query, hash) pair reads one
// random 32-byte sector of the filter; the query is read once and k int32
// hits (or one mask byte) are written.  The k gathers of one thread are
// independent, so they are all in flight together.  The log store's
// filter (2^24 bits, 2 MB) is L2-resident, so its gathers are L2 hits and
// the launch is close to a launch's own floor; a filter larger than L2
// pays a DRAM sector per pair.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() after its launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHashes = 8;

// the k multipliers travel by value in the kernel's parameters
struct Coeffs {
    uint32_t a[kMaxHashes];
};

// kMask = false: hits [q, k] int32 (out); true: mask [q] uint8 (out).
template <bool kMask>
__global__ void bloom_kernel(const uint32_t* __restrict__ words,
                             const int32_t* __restrict__ queries, int64_t q,
                             Coeffs coeffs, int k, int s,
                             void* __restrict__ out) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
    if (i >= q) return;
    const uint32_t x = static_cast<uint32_t>(queries[i]);
    uint32_t w[kMaxHashes];
    uint32_t bit[kMaxHashes];
#pragma unroll
    for (int j = 0; j < kMaxHashes; ++j) {
        if (j < k) {
            const uint32_t h = x * coeffs.a[j];
            // 64-bit shift: s = 32 shifts by 0, s = 0 by 32
            const uint64_t pos = static_cast<uint64_t>(h) >> (32 - s);
            w[j] = __ldg(words + (pos >> 5));
            bit[j] = static_cast<uint32_t>(pos & 31u);
        }
    }
    if (kMask) {
        uint32_t all = 1u;
#pragma unroll
        for (int j = 0; j < kMaxHashes; ++j)
            if (j < k) all &= w[j] >> bit[j];
        static_cast<uint8_t*>(out)[i] = static_cast<uint8_t>(all & 1u);
    } else {
        int32_t* hits = static_cast<int32_t*>(out);
#pragma unroll
        for (int j = 0; j < kMaxHashes; ++j) {
            if (j < k)
                hits[i * k + j] = static_cast<int32_t>((w[j] >> bit[j]) & 1u);
        }
    }
}

}  // namespace

// coeffs: k uint32 multipliers in host memory; mask: 0 writes hits [q, k]
// int32 to out, 1 the membership mask [q] as bytes
extern "C" int bloom_probe_launch(const uint32_t* words,
                                  const int32_t* queries, int64_t q,
                                  const uint32_t* coeffs, int k, int s,
                                  int mask, void* out, void* stream) {
    if (k < 1 || k > kMaxHashes || s < 5 || s > 32)
        return static_cast<int>(cudaErrorInvalidValue);
    Coeffs c{};
    for (int j = 0; j < k; ++j) c.a[j] = coeffs[j];
    const unsigned blocks =
        static_cast<unsigned>((q + kThreads - 1) / kThreads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (mask)
        bloom_kernel<true><<<blocks, kThreads, 0, st>>>(words, queries, q, c,
                                                       k, s, out);
    else
        bloom_kernel<false><<<blocks, kThreads, 0, st>>>(words, queries, q, c,
                                                        k, s, out);
    return static_cast<int>(cudaGetLastError());
}
