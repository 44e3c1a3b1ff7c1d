// Kernel K1: sorted search (searchsorted-right) and the sorted-array Get.
//
// Replaces the TPU kernel repro/kernels/sorted_search/kernel.py
// (_search_kernel / sorted_search_kernel, wrapped by ops.sorted_search and
// ops.sorted_get).  The TPU version counts keys <= q with a tiled
// all-compare, O(N) per query, because the VPU prefers dense compares to
// data-dependent indexing.  On Hopper every thread can index memory on its
// own, so each query runs the branchless upper-bound search
//
//     base = 0, len = N
//     while len > 1: half = len / 2; if keys[base + half] <= x: base += half
//                    len -= half
//     rank = base + (keys[base] <= x)
//
// whose trip count and every `half` depend on N only.
//
// What bounds it on the H100: bytes in 32-byte sectors (the memory system
// moves sectors, not keys), reached through random accesses.  At N = 2^24
// a search is 24 dependent loads; the top levels touch the same few keys
// for every query, the bottom ones a random sector each, and those
// random sector reads, from L2 and from DRAM, are what the launch waits
// on.  The design cuts the accesses:
//
//   1. The top of the search tree in shared memory.  The probe positions
//      of the first L levels form a fixed binary tree of 2^L - 1 keys:
//      node i (BFS/Eytzinger order, root 1) at level l probes
//      base(path) + half_l, its children are 2i and 2i + 1.  A first
//      launch (tree_kernel) writes the tree once into a 128 KB scratch;
//      each block of the search copies it into shared memory with
//      coalesced 16-byte loads and runs the first L levels from it.  L is
//      the depth that fits 128 KB: 15 levels of 4-byte keys, 14 of int64
//      (or all the levels of a smaller N).  The search is launched as a
//      programmatic dependent of tree_kernel: its blocks start and load
//      their first queries while the tree is written.  The grid is
//      persistent, one 1024-thread block per SM walking tiles of
//      queries, so the tree is copied once per SM.  The rest of the
//      SM's 256 KB stays L1, which serves the levels just below the
//      tree.
//   2. Several searches in flight per thread.  A thread walks 4 queries
//      in lockstep (2 of int64 keys); every level below the tree issues
//      their loads before any compare.
//   3. The last levels from one window.  Once len <= 64 / sizeof(K) keys
//      (16 int32 or float32 keys, 8 int64), the thread loads the window
//      [base, base + len) with 16-byte loads, all issued together, and sets
//          rank = first + #{i in [first, end) : keys[i] <= x}
//      over the aligned 16-byte chunks [first, end) that cover the window
//      (clipped to N).  This is exact for sorted keys: when base > 0 every
//      key before base is <= keys[base] <= x, and every key at or past
//      base + len is > x (the loop keeps both).  So the last 4 dependent
//      loads become one round of independent ones, and Get's
//      keys[rank - 1] lies in the window: found = some key in the window
//      equals x, and only a hit loads its value.
//   Keys that are not 16-byte aligned (a sliced tensor) take the same
//   kernel with a 32-byte window read as scalars (kVec = false).
//
// Semantics (the reference ops): rank[q] = #{i : keys[i] <= q}, which is
// at most N (a search over the N real keys never exceeds N, which is what
// the reference's dtype-max padding plus clamp gives).  sorted_get returns
// found = keys[clip(rank - 1, 0, N - 1)] == q and the value there (0 when
// absent).  N < 2^31 (the ranks are int32).
//
// Plain C interface, loaded with ctypes: each launcher returns
// cudaGetLastError() after its launches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
// The queries a thread walks: 4 of 4-byte keys, 2 of int64 (the same
// registers), and so the queries a block takes a step.
template <typename K>
struct Group {
    static constexpr int kQueries = 16 / sizeof(K);
    static constexpr int kTile = kThreads * kQueries;
};
constexpr int kTreeBytes = 128 * 1024;      // room of the shared tree
constexpr int kWindowBytes = 64;

// Depth of the deepest tree of K that fits kTreeBytes (2^L keys, slot 0
// unused): 15 levels of 4-byte keys, 14 of int64.
template <typename K>
constexpr int max_top() {
    int levels = 0;
    while ((2 << levels) * static_cast<int>(sizeof(K)) <= kTreeBytes)
        ++levels;
    return levels;
}

// kVec: 16-byte loads; else one load a key, over half the bytes (the
// scalar window's keys all sit in registers at once)
template <typename K, bool kVec>
struct Window {
    static constexpr int kKeys =                              // len limit
        (kVec ? kWindowBytes : kWindowBytes / 2) / sizeof(K);
    static constexpr int kPerChunk = 16 / sizeof(K);         // keys a load
    // aligned chunks an unaligned window of kKeys keys can touch
    static constexpr int kChunks = (kKeys - 1) / kPerChunk + 2;
};

// Key e of a 16-byte chunk (e known at compile time).
template <typename K>
__device__ __forceinline__ K chunk_key(const int4& v, int e);

template <>
__device__ __forceinline__ int32_t chunk_key<int32_t>(const int4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <>
__device__ __forceinline__ float chunk_key<float>(const int4& v, int e) {
    return __int_as_float(chunk_key<int32_t>(v, e));
}

template <>
__device__ __forceinline__ int64_t chunk_key<int64_t>(const int4& v, int e) {
    const uint32_t lo = static_cast<uint32_t>(e == 0 ? v.x : v.z);
    const uint32_t hi = static_cast<uint32_t>(e == 0 ? v.y : v.w);
    return static_cast<int64_t>((static_cast<uint64_t>(hi) << 32) | lo);
}

// Levels of the branchless search over n keys (halvings until len == 1).
inline int search_levels(int64_t n) {
    int levels = 0;
    for (int64_t len = n; len > 1; len -= len >> 1) ++levels;
    return levels;
}

template <typename K>
int top_levels(int64_t n) {
    const int levels = search_levels(n);
    return levels < max_top<K>() ? levels : max_top<K>();
}

// The rank of x counted over its window [base, base + len) (len >= 1),
// and whether the window holds x.  kVec: 16-byte loads of the aligned
// chunks that cover the window (keys 16-byte aligned), else scalar loads.
template <typename K, bool kVec>
__device__ __forceinline__ void window_rank(const K* __restrict__ keys,
                                            int n, int base, int len, K x,
                                            int* rank, bool* hit) {
    using W = Window<K, kVec>;
    int count = 0;
    bool eq = false;
    if (kVec) {
        constexpr int E = W::kPerChunk;
        const int full = n / E;             // chunks wholly inside [0, n)
        const int first = base / E;
        const int last = (base + len - 1) / E;
        K c[W::kChunks][E];
#pragma unroll
        for (int j = 0; j < W::kChunks; ++j) {
            const int at = first + j;
            if (at <= last && at < full) {
                const int4 v = __ldg(reinterpret_cast<const int4*>(keys) + at);
#pragma unroll
                for (int e = 0; e < E; ++e) c[j][e] = chunk_key<K>(v, e);
            } else {
                // past the window, or the ragged chunk at the end
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const int i = at * E + e;
                    c[j][e] = (at <= last && i < n) ? __ldg(keys + i) : K(0);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < W::kChunks; ++j) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const bool valid = first + j <= last && (first + j) * E + e < n;
                count += (valid && c[j][e] <= x) ? 1 : 0;
                eq |= valid && c[j][e] == x;
            }
        }
        *rank = first * E + count;
    } else {
        K w[W::kKeys];
#pragma unroll
        for (int j = 0; j < W::kKeys; ++j)
            w[j] = j < len ? __ldg(keys + base + j) : K(0);
#pragma unroll
        for (int j = 0; j < W::kKeys; ++j) {
            count += (j < len && w[j] <= x) ? 1 : 0;
            eq |= j < len && w[j] == x;
        }
        *rank = base + count;
    }
    *hit = eq;
}

// Position of tree node `node` (root 1) of the search over n keys: at
// level l it probes base + half_l, base the sum of half_j over the right
// turns j < l that the bits of node below its leading one spell.
__device__ __forceinline__ int tree_position(int node, int n) {
    const int level = 31 - __clz(node);
    int pos = 0;
    int len = n;
    for (int j = 0; j < level; ++j) {
        const int half = len >> 1;
        if ((node >> (level - 1 - j)) & 1) pos += half;
        len -= half;
    }
    return pos + (len >> 1);
}

// The top `top` levels as a BFS tree in global memory, 2^top keys (slot 0
// holds K(0) and is never read).
template <typename K>
__global__ void tree_kernel(const K* __restrict__ keys, int n, int top,
                            K* __restrict__ tree) {
    // the search may start (its launch, its first queries) meanwhile; it
    // waits for this grid's stores before it reads the tree
    asm volatile("griddepcontrol.launch_dependents;");
    const int node = blockIdx.x * blockDim.x + threadIdx.x;
    if (node >= (1 << top)) return;
    tree[node] = node == 0 ? K(0) : __ldg(keys + tree_position(node, n));
}

// kGet = false: ranks[i] = rank.  kGet = true: found[i], out[i] (the
// value at rank - 1 on a hit, else 0).
template <typename K, typename V, bool kGet, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
search_kernel(const K* __restrict__ keys, int n, int top,
              const int4* __restrict__ tree_global,
              const K* __restrict__ queries, int q,
              int32_t* __restrict__ ranks, const V* __restrict__ values,
              uint8_t* __restrict__ found, V* __restrict__ out) {
    constexpr int kGroup = Group<K>::kQueries;
    constexpr int kTile = Group<K>::kTile;
    extern __shared__ int4 tree_shared[];
    const K* tree = reinterpret_cast<const K*>(tree_shared);
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kTile;
    K x[kGroup];
    // a thread past the end searches for K(0): every load stays inside
    // the keys whatever x is, and nothing is stored
    auto load_queries = [&](int64_t tile) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
            const int64_t i = tile + g * kThreads + threadIdx.x;
            x[g] = i < q ? __ldg(queries + i) : K(0);
        }
    };
    load_queries(static_cast<int64_t>(blockIdx.x) * kTile);

    // 1. the tree into shared memory, once tree_kernel's stores are
    //    visible: coalesced 16-byte loads, a thread's kBatch loads issued
    //    before it stores any
    asm volatile("griddepcontrol.wait;" ::: "memory");
    {
        constexpr int kBatch = 8;
        const int chunks = ((1 << top) * static_cast<int>(sizeof(K)) + 15) /
                           16;
        for (int c0 = threadIdx.x; c0 < chunks; c0 += kThreads * kBatch) {
            int4 v[kBatch];
#pragma unroll
            for (int r = 0; r < kBatch; ++r) {
                const int c = c0 + r * kThreads;
                v[r] = c < chunks ? __ldg(tree_global + c)
                                  : make_int4(0, 0, 0, 0);
            }
#pragma unroll
            for (int r = 0; r < kBatch; ++r) {
                const int c = c0 + r * kThreads;
                if (c < chunks) tree_shared[c] = v[r];
            }
        }
    }
    __syncthreads();

    for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kTile; tile < q;
         tile += stride) {
        int base[kGroup];
        int node[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
            base[g] = 0;
            node[g] = 1;
        }
        int len = n;
        for (int l = 0; l < top; ++l) {
            const int half = len >> 1;
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
                const int right = tree[node[g]] <= x[g] ? 1 : 0;
                base[g] += right * half;
                node[g] = 2 * node[g] + right;
            }
            len -= half;
        }
        // 2. the levels between the tree and the window: kGroup loads in
        //    flight, then the compares
        while (len > Window<K, kVec>::kKeys) {
            const int half = len >> 1;
            K probe[kGroup];
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
                probe[g] = __ldg(keys + base[g] + half);
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
                base[g] += probe[g] <= x[g] ? half : 0;
            len -= half;
        }
        // 3. the windows, one query at a time (all kGroup at once would
        //    take 4x the registers for no gain in time); then the Get's
        //    kGroup value loads, issued together
        int rank[kGroup];
        bool hit[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
            window_rank<K, kVec>(keys, n, base[g], len, x[g], &rank[g],
                                 &hit[g]);
        V val[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
            val[g] = kGet && hit[g] ? __ldg(values + rank[g] - 1) : V(0);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
            const int64_t i = tile + g * kThreads + threadIdx.x;
            if (i < q) {
                if (kGet) {
                    found[i] = hit[g] ? 1 : 0;
                    out[i] = val[g];
                } else {
                    ranks[i] = rank[g];
                }
            }
        }
        load_queries(tile + stride);
    }
}

template <typename K, typename V, bool kGet, bool kVec>
int launch(const void* keys, int64_t n, const void* queries, int64_t q,
           int32_t* ranks, const void* values, uint8_t* found, void* out,
           void* tree, cudaStream_t stream) {
    if (n < 1 || n > INT32_MAX || q > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    if (q == 0) return 0;
    const int top = top_levels<K>(n);
    const int tree_bytes = (1 << top) * static_cast<int>(sizeof(K));
    const int smem = tree_bytes < 16 ? 16 : tree_bytes;
    static bool sized = false;  // shared memory past 48 KB is opted into
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err == cudaSuccess && !sized) {
        err = cudaFuncSetAttribute(search_kernel<K, V, kGet, kVec>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kTreeBytes);
        sized = err == cudaSuccess;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    // a persistent grid: one block per SM (a 1024-thread block holds more
    // than half an SM's registers), or fewer when the queries are fewer
    // tiles
    const int64_t tiles = (q + Group<K>::kTile - 1) / Group<K>::kTile;
    const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
    tree_kernel<K><<<((1 << top) + 255) / 256, 256, 0, stream>>>(
        static_cast<const K*>(keys), static_cast<int>(n), top,
        static_cast<K*>(tree));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // programmatic dependent launch: the search may begin before
    // tree_kernel ends, and waits for it (griddepcontrol.wait) before it
    // reads the tree
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(grid);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = static_cast<size_t>(smem);
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &config, search_kernel<K, V, kGet, kVec>,
        static_cast<const K*>(keys), static_cast<int>(n), top,
        static_cast<const int4*>(tree), static_cast<const K*>(queries),
        static_cast<int>(q), ranks, static_cast<const V*>(values), found,
        static_cast<V*>(out));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_search(int vec, const void* keys, int64_t n, const void* queries,
                  int64_t q, int32_t* ranks, void* tree,
                  cudaStream_t stream) {
    if (vec)
        return launch<K, uint32_t, false, true>(keys, n, queries, q, ranks,
                                                nullptr, nullptr, nullptr,
                                                tree, stream);
    return launch<K, uint32_t, false, false>(keys, n, queries, q, ranks,
                                             nullptr, nullptr, nullptr, tree,
                                             stream);
}

template <typename K, typename V>
int launch_get(int vec, const void* keys, const void* values, int64_t n,
               const void* queries, int64_t q, uint8_t* found, void* out,
               void* tree, cudaStream_t stream) {
    if (vec)
        return launch<K, V, true, true>(keys, n, queries, q, nullptr, values,
                                        found, out, tree, stream);
    return launch<K, V, true, false>(keys, n, queries, q, nullptr, values,
                                     found, out, tree, stream);
}

template <typename K>
int launch_get_values(int val_bytes, int vec, const void* keys,
                      const void* values, int64_t n, const void* queries,
                      int64_t q, uint8_t* found, void* out, void* tree,
                      cudaStream_t stream) {
    // values move as raw 4- or 8-byte words: an all-zero word is 0 in
    // every integer and float type the wrapper accepts
    if (val_bytes == 4)
        return launch_get<K, uint32_t>(vec, keys, values, n, queries, q,
                                       found, out, tree, stream);
    if (val_bytes == 8)
        return launch_get<K, uint64_t>(vec, keys, values, n, queries, q,
                                       found, out, tree, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Bytes of the device scratch each launch takes for its tree (`tree`
// below).
extern "C" int sorted_search_tree_bytes() { return kTreeBytes; }

// Depth L of the shared-memory tree a launch over n keys uses.
extern "C" int sorted_search_top_levels(int key_dtype, int64_t n) {
    switch (key_dtype) {
        case 0: return top_levels<int32_t>(n);
        case 1: return top_levels<int64_t>(n);
        case 2: return top_levels<float>(n);
        default: return -1;
    }
}

// key_dtype: 0 = int32, 1 = int64, 2 = float32; vec: keys 16-byte
// aligned; tree: sorted_search_tree_bytes() of device scratch, 16-byte
// aligned, which the launch overwrites
extern "C" int sorted_search_launch(int key_dtype, int vec, const void* keys,
                                    int64_t n, const void* queries,
                                    int64_t q, int32_t* ranks, void* tree,
                                    void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (key_dtype) {
        case 0: return launch_search<int32_t>(vec, keys, n, queries, q,
                                              ranks, tree, s);
        case 1: return launch_search<int64_t>(vec, keys, n, queries, q,
                                              ranks, tree, s);
        case 2: return launch_search<float>(vec, keys, n, queries, q, ranks,
                                            tree, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" int sorted_get_launch(int key_dtype, int val_bytes, int vec,
                                 const void* keys, const void* values,
                                 int64_t n, const void* queries, int64_t q,
                                 uint8_t* found, void* out, void* tree,
                                 void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (key_dtype) {
        case 0: return launch_get_values<int32_t>(val_bytes, vec, keys,
                                                  values, n, queries, q,
                                                  found, out, tree, s);
        case 1: return launch_get_values<int64_t>(val_bytes, vec, keys,
                                                  values, n, queries, q,
                                                  found, out, tree, s);
        case 2: return launch_get_values<float>(val_bytes, vec, keys, values,
                                                n, queries, q, found, out,
                                                tree, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
