// Kernel K3: hash probe against a bucket-major [2^s, CAP] table.
//
// Replaces the TPU kernel repro/kernels/hash_probe/kernel.py
// (_probe_kernel / hash_probe_kernel, wrapped by ops.hash_probe).  The TPU
// version streams every bucket block through VMEM and matches a slot iff
// (its bucket == hash(q)) and (its key == q): it keeps the hash's
// semantics but compares each query against the whole table.  On Hopper a
// query can fetch its own bucket directly, with the multiply-shift hash
// h(x) = (a * x mod 2^32) >> (32 - s) in uint32_t (which wraps exactly
// like the TPU's uint32).
//
// What bounds it on the H100: bytes, and the latency of reaching them.
// Each query must read its CAP keys (one random row of CAP * 4 bytes) plus
// its own 4-byte query and write an 8-byte answer; the value is read only
// on a hit.  Rows are random, so what the card can do is keep enough of
// them in flight: hiding HBM latency at 3.35 TB/s takes several MB in
// flight across the card.  So one warp owns 32 queries:
//
//   1. one coalesced load of its 32 queries, one per lane, and their
//      hashes;
//   2. each 8-lane group reads one row at a time, 16 bytes a lane (an
//      int4 covers 4 slots, so 8 lanes cover 32 slots, one 128-byte row
//      for CAP = 32); the 4 groups take the warp's 32 rows in 8 rounds,
//      and ALL 8 rounds' loads are issued before any compare: 32 rows
//      (4 KB) in flight per warp, where one query per warp had one;
//   3. a ballot per round: the first lane of a group with a match, then
//      its first matching slot, is the lowest matching slot of the row;
//   4. the owner lane loads the value only on a hit, and the warp writes
//      its 32 answers with coalesced stores.
//
// Rows longer than 32 slots are read 32 slots a step, lowest first, and a
// warp stops once all its queries have matched.  When CAP is not a
// multiple of 4 (or the table is not 16-byte aligned) rows lose 16-byte
// alignment: the same kernel then reads each lane's 4 slots as scalars
// (template parameter kVec = false).
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
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 8;                  // lanes that read one row
constexpr int kGroups = kWarp / kGroup;    // rows a warp reads a round: 4
constexpr int kRounds = kWarp / kGroups;   // rounds per 32 queries: 8
constexpr int kStep = kGroup * 4;          // slots a group reads a step
constexpr int32_t kNotFound = 2147483647;

// Slots j..j+3 of a row; `n` of them (0..4) lie inside it.
template <bool kVec>
__device__ __forceinline__ int4 load_slots(const int32_t* row, int64_t j,
                                           int n) {
    if (kVec) {
        // CAP % 4 == 0: a chunk lies wholly inside the row or outside it
        if (n == 0) return make_int4(0, 0, 0, 0);
        return __ldg(reinterpret_cast<const int4*>(row + j));
    }
    int4 v = make_int4(0, 0, 0, 0);
    if (n > 0) v.x = __ldg(row + j);
    if (n > 1) v.y = __ldg(row + j + 1);
    if (n > 2) v.z = __ldg(row + j + 2);
    if (n > 3) v.w = __ldg(row + j + 3);
    return v;
}

template <bool kVec>
__global__ void probe_kernel(const int32_t* __restrict__ tkeys,
                             const int32_t* __restrict__ tvals, int64_t cap,
                             const int32_t* __restrict__ queries, int64_t q,
                             uint32_t a, int s, int32_t* __restrict__ pos,
                             int32_t* __restrict__ val) {
    const int lane = threadIdx.x % kWarp;
    const int64_t q0 = (blockIdx.x * static_cast<int64_t>(blockDim.x) +
                        threadIdx.x) / kWarp * kWarp;
    if (q0 >= q) return;   // whole warps exit together
    const bool mine = q0 + lane < q;
    const int32_t x = mine ? queries[q0 + lane] : 0;
    // 64-bit shift: s = 0 (one bucket) shifts by 32, which is 0 here and
    // undefined for a 32-bit operand
    const uint32_t h = static_cast<uint32_t>(x) * (a | 1u);
    const uint32_t bucket =
        static_cast<uint32_t>(static_cast<uint64_t>(h) >> (32 - s));
    const int group = lane / kGroup;
    const int sub = lane % kGroup;
    int32_t p = kNotFound;     // the answer for this lane's query
    for (int64_t j0 = 0; j0 < cap; j0 += kStep) {
        const int64_t j = j0 + sub * 4;
        const int n = static_cast<int>(cap - j < 0 ? 0
                                       : (cap - j > 4 ? 4 : cap - j));
        // round k: group g serves the query of lane k * kGroups + g
        int32_t qx[kRounds];
        uint32_t qb[kRounds];
        int4 keys[kRounds];
#pragma unroll
        for (int k = 0; k < kRounds; ++k) {
            qx[k] = __shfl_sync(kFull, x, k * kGroups + group);
            qb[k] = __shfl_sync(kFull, bucket, k * kGroups + group);
        }
#pragma unroll
        for (int k = 0; k < kRounds; ++k) {
            keys[k] = load_slots<kVec>(
                tkeys + static_cast<int64_t>(qb[k]) * cap, j, n);
        }
#pragma unroll
        for (int k = 0; k < kRounds; ++k) {
            unsigned bits = (keys[k].x == qx[k] ? 1u : 0u) |
                            (keys[k].y == qx[k] ? 2u : 0u) |
                            (keys[k].z == qx[k] ? 4u : 0u) |
                            (keys[k].w == qx[k] ? 8u : 0u);
            bits &= (1u << n) - 1u;
            const unsigned hits = __ballot_sync(kFull, bits != 0);
            const unsigned mask = (hits >> (group * kGroup)) & 0xffu;
            const int first = mask ? __ffs(mask) - 1 : 0;
            const unsigned first_bits =
                __shfl_sync(kFull, bits, group * kGroup + first);
            const int32_t found =
                mask ? static_cast<int32_t>(
                           static_cast<int64_t>(qb[k]) * cap + j0 +
                           first * 4 + (__ffs(first_bits) - 1))
                     : kNotFound;
            // the owner of this round's query in group (lane % kGroups)
            // takes the group's answer, unless an earlier step matched
            const int32_t got =
                __shfl_sync(kFull, found, (lane % kGroups) * kGroup);
            if (lane / kGroups == k && p == kNotFound) p = got;
        }
        if (__all_sync(kFull, p != kNotFound || !mine)) break;
    }
    if (mine) {
        pos[q0 + lane] = p;
        val[q0 + lane] = p == kNotFound ? 0 : __ldg(tvals + p);
    }
}

}  // namespace

extern "C" int hash_probe_launch(const int32_t* tkeys, const int32_t* tvals,
                                 int64_t cap, const int32_t* queries,
                                 int64_t q, uint32_t a, int s, int vec,
                                 int32_t* pos, int32_t* val, void* stream) {
    const int64_t warps = (q + kWarp - 1) / kWarp;
    const unsigned blocks = static_cast<unsigned>(
        (warps * kWarp + kThreads - 1) / kThreads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec) {
        probe_kernel<true><<<blocks, kThreads, 0, st>>>(
            tkeys, tvals, cap, queries, q, a, s, pos, val);
    } else {
        probe_kernel<false><<<blocks, kThreads, 0, st>>>(
            tkeys, tvals, cap, queries, q, a, s, pos, val);
    }
    return static_cast<int>(cudaGetLastError());
}
