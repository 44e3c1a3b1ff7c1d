// Kernel K3: hash probe against a bucket-major [2^s, CAP] table.
//
// Replaces the TPU kernel repro/kernels/hash_probe/kernel.py
// (_probe_kernel / hash_probe_kernel, wrapped by ops.hash_probe).  The TPU
// version streams every bucket block through VMEM and matches a slot iff
// (its bucket == hash(q)) and (its key == q): it keeps the hash's
// semantics but compares each query against the whole table.  On Hopper a
// query can fetch its own bucket directly, so here one warp owns one
// query: it hashes the query with the multiply-shift hash
// h(x) = (a * x mod 2^32) >> (32 - s) in uint32_t (which wraps exactly
// like the TPU's uint32), reads ONLY that bucket's row, 32 slots per step
// (one coalesced 128-byte load for CAP = 32), and takes the first matching
// slot from a warp ballot.
//
// What bounds it on the H100: bytes.  Each query must read its CAP keys
// (CAP * 4 bytes, one random row) plus its own 4-byte query and write an
// 8-byte answer; the value is read only on a hit.  The row read is a
// single full-line transaction per 32 slots, so the kernel moves about
// Q * (CAP * 4 + 32) bytes, the least a bucket probe can.
//
// Returns the flat slot pos = bucket * CAP + j of the first match and its
// value, or NOT_FOUND (int32 max) and 0.  Like the reference, a query equal
// to the empty-slot sentinel matches an empty slot of its bucket.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() after its launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int32_t kNotFound = 2147483647;

__global__ void probe_kernel(const int32_t* __restrict__ tkeys,
                             const int32_t* __restrict__ tvals, int64_t cap,
                             const int32_t* __restrict__ queries, int64_t q,
                             uint32_t a, int s, int32_t* __restrict__ pos,
                             int32_t* __restrict__ val) {
    const int64_t warp = (blockIdx.x * static_cast<int64_t>(blockDim.x) +
                          threadIdx.x) / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (warp >= q) return;   // whole warps exit together
    const int32_t x = queries[warp];
    const uint32_t h = static_cast<uint32_t>(x) * (a | 1u);
    // 64-bit shift: s = 0 (one bucket) shifts by 32, which is 0 here and
    // undefined for a 32-bit operand
    const int64_t bucket =
        static_cast<int64_t>(static_cast<uint64_t>(h) >> (32 - s));
    const int32_t* row = tkeys + bucket * cap;
    int32_t p = kNotFound;
    int32_t v = 0;
    for (int64_t j0 = 0; j0 < cap; j0 += kWarp) {
        const int64_t j = j0 + lane;
        const bool match = j < cap && row[j] == x;
        const unsigned hits = __ballot_sync(0xffffffffu, match);
        if (hits) {
            const int64_t first = j0 + (__ffs(hits) - 1);
            p = static_cast<int32_t>(bucket * cap + first);
            v = tvals[bucket * cap + first];
            break;
        }
    }
    if (lane == 0) {
        pos[warp] = p;
        val[warp] = v;
    }
}

}  // namespace

extern "C" int hash_probe_launch(const int32_t* tkeys, const int32_t* tvals,
                                 int64_t cap, const int32_t* queries,
                                 int64_t q, uint32_t a, int s, int32_t* pos,
                                 int32_t* val, void* stream) {
    const int64_t threads = q * kWarp;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tkeys, tvals, cap, queries, q, a, s, pos, val);
    return static_cast<int>(cudaGetLastError());
}
