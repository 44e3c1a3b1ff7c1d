// Kernel K5: flash attention forward (online softmax), GQA, causal.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel :33 / flash_attention_kernel :84, wrapped by
// ops.flash_attention and ops.flash_attention_bshd).  The TPU version runs
// a grid of (batch * head, q block, kv block) whose kv axis is sequential,
// carrying the float32 running max m, sum l and accumulator in VMEM
// scratch and feeding 128-wide tiles to the MXU.
//
// Both variants here compute exactly that function:
//   * softmax(q k^T / sqrt(D)) v with float32 scores, running max, sum and
//     accumulator; the output is written in the input type (float32 or
//     bf16, rounded to nearest even);
//   * GQA maps head h to kv head h / (H / KH);
//   * causal is top-left aligned (row >= col, as the reference); tiles
//     entirely above the diagonal are never loaded.  The reference's
//     dead-row guard is kept: a row whose running max is still the -1e30
//     mask value takes p = 0, corr = 1;
//   * ragged Sq and Skv are masked here: keys >= Skv score -1e30 in every
//     mode, so no padding and no fallback are needed;
//   * q, k, v and out are read and written through their strides, so the
//     model's [B, S, H, D] layout needs no transpose copy.
// What bounds it on the H100: operations, 4 B H D x (the (row, key) pairs
// the mask keeps) against the bf16 tensor-core peak.
//
// The launcher takes the variant by input, explicitly (the wrapper in
// kernels/flash_attention/kernel.py names it and counts it):
//   * flash_attention_wgmma_launch: bf16 with D in {64, 128}, the tensor-
//     core kernel below (namespace tc);
//   * flash_attention_launch: float32, or any other D, the SIMT kernel
//     (namespace simt), whose float32 products hold the float32-compute
//     path to 1e-5.
//
// --- tc: bf16, D in {64, 128}, on wgmma with TMA-fed K/V tiles ---------
//   * One block of 384 threads owns one (batch * head, 128-row q tile):
//     warpgroup 0 is the producer (one thread issues every TMA load, the
//     warpgroup gives its registers to the others with setmaxnreg), and
//     warpgroups 1 and 2 are consumers of 64 q rows each.
//   * Q is loaded once by TMA; K and V tiles of 64 keys flow through a
//     ring of kStages stages, each with a full and an empty mbarrier, so
//     the next tiles' loads overlap the current tile's math.  TMA
//     zero-fills rows past Sq and Skv; a zero key still scores 0, so keys
//     >= Skv are masked all the same.
//   * S = Q K^T is wgmma.m64n64k16 with A = Q and B = K from shared
//     memory, both K-major (D contiguous), in the 128-byte swizzle the
//     TMA boxes were written in.  S stays unscaled in float32; the scale
//     and log2(e) fold into one exp2 argument (q is never rounded to bf16
//     after scaling: 1/sqrt(128) is not a power of two).
//   * The online softmax runs on the accumulator fragments in registers:
//     each row's values sit in a quad of threads, so its max takes two
//     shuffles; m, l and the rescale of O use the float32 p.
//   * O += P V is two wgmma passes per k-step, A = P_hi = bf16(p) and
//     then A = P_lo = bf16(p - P_hi), from registers (the S fragment is
//     the A fragment), B = the V tile [keys, D], MN-major, so the
//     transpose bit is set.  Why split P: FlashAttention-2/3 round P once
//     to bf16, and at [1, 12, 2048, 128] causal that puts 4.5% of the
//     outputs (the ones near zero) outside this kernel's own check,
//     |got - ref| <= 1e-4 + 2^-8 |ref| against float32 attention_ref;
//     hi + lo carries p to ~16 bits and passes it.  The split costs 1.5x
//     the tensor-core work of plain FA2, which the bound above does not
//     count, so this design can reach at best ~1.5x that bound.
//   * Causal: only the tiles on the diagonal pay for the mask, and the
//     heaviest q tiles are issued first (blockIdx.y walks q tiles from
//     the last), so the triangle does not leave SMs idle in the last wave.
//   * Epilogue: O / max(l, 1e-30), rounded to bf16, stored through out's
//     strides; rows >= Sq are not stored.
// Where it can go wrong silently, and what guards it:
//   * TMA descriptors are built on the host per call (cuTensorMapEncode-
//     Tiled, reached through cudaGetDriverEntryPoint, so nothing links
//     -lcuda), from the tensors' strides: 4-D maps (D, S, heads, batch).
//     Global strides must be multiples of 16 bytes and the base 16-byte
//     aligned; the wrapper checks and raises.  The 128-byte swizzle takes
//     at most 128 bytes in a box's inner dimension, so at D = 128 every
//     tile is two boxes of 64 columns, and the wgmma descriptors use the
//     same swizzle (tiles sit on 1024-byte boundaries).
//   * A wrong wgmma descriptor (leading / stride byte offsets, swizzle) or
//     fragment-to-row map gives wrong numbers, not a crash: the tests and
//     chip_smoke.py hold D = 64 and 128, ragged lengths, causal with
//     Sq > Skv and GQA against attention_ref.
//   * Registers: O (64 x 128 f32) is 64 a consumer thread, S 32, P_hi and
//     P_lo 32; setmaxnreg gives consumers 232.  -Xptxas -v must show no
//     spills (chip_smoke.py prints it).
//   * The mask value: with exp2 and -1e30 the dead-row guard stays exact
//     (p = 0, corr = 1 while the row's max is the mask value).
//   * A barrier wait that never completes would hang the card: every wait
//     traps after ~10 s instead, so a fault is an error.
//
// Plain C interface, loaded with ctypes: each launcher returns
// cudaGetLastError() after its launch (or the error that refused it).
#include <cstdint>
#include <cuda.h>   // CUtensorMap and its enums (no -lcuda: see tc)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// --- simt: float32, or bf16 at any other D ------------------------------
// One block of 256 threads owns one (batch * head, 64-row q tile) and walks
// the kv tiles in a loop, the running state in registers: each thread owns
// 4 query rows x (4 score columns, D / 16 output columns).  K (transposed)
// and V tiles of 64 keys stream through shared memory, one after the other
// in one buffer, next to the scaled Q tile and the 64 x 64 tile of P; both
// products are scalar float32 FMAs (no tensor cores).
namespace simt {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kKS = kBK + 4;     // row stride of the transposed K tile
constexpr int kPS = kBK + 1;     // row stride of the P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

struct Strides {           // element strides of a [B, H, S, D] view
    int64_t b, h, s;
};

// JMAX: output columns per thread, D <= 16 * JMAX
template <typename T, int JMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int heads,
             int group, int sq, int skv, int d, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal) {
    extern __shared__ float smem[];
    const int qst = d + 4;                       // Q tile row stride
    float* q_tile = smem;                        // [kBQ][qst]
    float* kv_tile = q_tile + kBQ * qst;         // K^T [d][kKS] or V [kBK][d]
    float* p_tile = kv_tile + d * kKS;           // [kBQ][kPS]

    const int tid = threadIdx.x;
    const int ty = tid >> 4, tx = tid & 15;
    const int bh = blockIdx.y;
    const int b = bh / heads, h = bh % heads, kvh = h / group;
    const int q_lo = blockIdx.x * kBQ;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + kvh * ks.h;
    const T* vb = v + b * vs.b + kvh * vs.h;

    for (int e = tid; e < kBQ * d; e += kThreads) {
        const int r = e / d, c = e - r * d;
        const int row = q_lo + r;
        q_tile[r * qst + c] =
            row < sq ? to_float(qb[row * qs.s + c]) * scale : 0.f;
    }

    float m[4], l[4], acc[4][JMAX];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < JMAX; ++j) acc[i][j] = 0.f;
    }

    int n_tiles = (skv + kBK - 1) / kBK;
    if (causal) {
        const int last = (q_lo + kBQ - 1) / kBK + 1;   // tiles with k_lo <= last row
        n_tiles = last < n_tiles ? last : n_tiles;
    }
    for (int t = 0; t < n_tiles; ++t) {
        const int k_lo = t * kBK;
        __syncthreads();                 // the last tile's P and V are read
        for (int e = tid; e < kBK * d; e += kThreads) {
            const int r = e / d, c = e - r * d;
            const int key = k_lo + r;
            kv_tile[c * kKS + r] = key < skv ? to_float(kb[key * ks.s + c]) : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int c = 0; c < d; ++c) {
            const float4 kk = *reinterpret_cast<const float4*>(
                kv_tile + c * kKS + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float qv = q_tile[(ty * 4 + i) * qst + c];
                s[i][0] += qv * kk.x;
                s[i][1] += qv * kk.y;
                s[i][2] += qv * kk.z;
                s[i][3] += qv * kk.w;
            }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q_lo + ty * 4 + i;
            float mt = kNegInf;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int key = k_lo + tx * 4 + j;
                if (key >= skv || (causal && row < key)) s[i][j] = kNegInf;
                mt = fmaxf(mt, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
            const float m_new = fmaxf(m[i], mt);
            const bool dead = m_new <= kNegInf / 2;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = dead ? 0.f : expf(s[i][j] - m_new);
                p_tile[(ty * 4 + i) * kPS + tx * 4 + j] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float corr = dead ? 1.f : expf(m[i] - m_new);
            l[i] = l[i] * corr + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < JMAX; ++j) acc[i][j] *= corr;
        }
        __syncthreads();                 // K^T is read and P is written

        for (int e = tid; e < kBK * d; e += kThreads) {
            const int r = e / d, c = e - r * d;
            const int key = k_lo + r;
            kv_tile[r * d + c] = key < skv ? to_float(vb[key * vs.s + c]) : 0.f;
        }
        __syncthreads();

        for (int kk = 0; kk < kBK; ++kk) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = p_tile[(ty * 4 + i) * kPS + kk];
#pragma unroll
            for (int j = 0; j < JMAX; ++j) {
                const int c = tx + 16 * j;
                const float vv = c < d ? kv_tile[kk * d + c] : 0.f;
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
            }
        }
    }

    T* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q_lo + ty * 4 + i;
        if (row >= sq) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int c = tx + 16 * j;
            if (c < d) ob[row * os.s + c] = from_float<T>(acc[i][j] * inv);
        }
    }
}

template <typename T, int JMAX>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int heads, int kv_heads, int sq, int skv, int d,
           const int64_t* st, float scale, int causal, cudaStream_t stream) {
    const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
        vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
    const size_t smem =
        sizeof(float) * (kBQ * (d + 4) + d * kKS + kBQ * kPS);
    auto kernel = flash_kernel<T, JMAX>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), heads,
        heads / kv_heads, sq, skv, d, qs, ks, vs, os, scale, causal);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

namespace tc {

constexpr int kBQ = 128;         // q rows per block: two consumer warpgroups
constexpr int kBK = 64;          // keys per K / V tile
constexpr int kStages = 2;       // K / V ring depth
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int kBox = 64;         // bf16 columns in one 128-byte swizzled box
constexpr int kRowBytes = 128;   // one box row in shared memory
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // 384 x 168 in all
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct Layout {   // byte offsets in dynamic shared memory
    static constexpr int kQBytes = kBQ * D * 2;
    static constexpr int kTileBytes = kBK * D * 2;          // one K or V tile
    static constexpr int kK = kQBytes;                      // + stage * tile
    static constexpr int kV = kK + kStages * kTileBytes;
    static constexpr int kBar = kV + kStages * kTileBytes;  // q, full, empty
    static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
    static constexpr int kAlloc = kBytes + 1024;   // + slack to align
};

struct Strides {           // element strides of a [B, H, S, D] view
    int64_t b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA ----------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}
// Wait for the phase of the given parity to complete; trap after ~10 s
// (2^34 cycles) so that a barrier that never completes is an error, not a
// hang of the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    const long long t0 = clock64();
    while (true) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (clock64() - t0 > (1ll << 34)) __trap();
    }
}
// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at dst, completing on barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3), "r"(bar)
        : "memory");
}

// --- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1 in bits
// 62-63).  K-major tiles (Q, K): rows of 128 bytes, 8-row groups 1024 bytes
// apart (stride byte offset); the leading byte offset is unused.  MN-major
// tiles (V): the same 8-row groups along K (the keys), and the next 64
// columns of N (the second box at D = 128) one box further on (leading
// byte offset).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (four bf16x2
// per thread), B MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers (four bf16x2
// per thread), B MN-major in shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
    if constexpr (D == 64)
        wgmma_rs_n64(o, a, b);
    else
        wgmma_rs_n128(o, a, b);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, Strides os, int heads,
                   int group, int sq, int skv, float scale_log2, int causal) {
    using L = Layout<D>;
    constexpr int kBoxes = D / kBox;
    extern __shared__ uint8_t smem_raw[];
    // 128-byte swizzled tiles (TMA and wgmma alike) sit on 1024-byte
    // boundaries; the launcher allocates 1 KB of slack for this
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t q_full = base + L::kBar;
    const uint32_t full = q_full + 8, empty = full + 8 * kStages;

    const int bh = blockIdx.x;
    const int b = bh / heads, h = bh % heads, kvh = h / group;
    const int q_lo = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
    const int n_kv = (skv + kBK - 1) / kBK;
    // the K / V tiles rows up to row_hi read: causal stops at the tile
    // holding row_hi
    auto n_tiles = [&](int row_hi) {
        return causal ? min(n_kv, row_hi / kBK + 1) : n_kv;
    };

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 2 * 128);   // every consumer thread
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // producer: one thread issues every load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
            kProducerRegs));
        if (threadIdx.x != 0) return;
        mbar_expect_tx(q_full, L::kQBytes);
        for (int c = 0; c < kBoxes; ++c)
            tma_load(base + c * kBQ * kRowBytes, &tq, q_full, c * kBox, q_lo,
                     h, b);
        const int tiles = n_tiles(q_lo + kBQ - 1);
        for (int t = 0; t < tiles; ++t) {
            const int s = t % kStages;
            mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, 2 * L::kTileBytes);
            const uint32_t k_dst = base + L::kK + s * L::kTileBytes;
            const uint32_t v_dst = base + L::kV + s * L::kTileBytes;
            for (int c = 0; c < kBoxes; ++c) {
                tma_load(k_dst + c * kBK * kRowBytes, &tk, full + 8 * s,
                         c * kBox, t * kBK, kvh, b);
                tma_load(v_dst + c * kBK * kRowBytes, &tv, full + 8 * s,
                         c * kBox, t * kBK, kvh, b);
            }
        }
        return;
    }

    // consumers: warpgroup cw owns q rows row_lo .. row_lo + 63; this
    // thread holds rows r0 and r0 + 8 of the accumulator fragments
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int row_lo = q_lo + 64 * cw;
    const int r0 = row_lo + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);   // + 8 j: the columns of fragment j
    const int tiles = n_tiles(row_lo + 63);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    const uint32_t q_tile = base + 64 * cw * kRowBytes;
    mbar_wait(q_full, 0);
    for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        const int k_lo = t * kBK;
        const uint32_t k_tile = base + L::kK + s * L::kTileBytes;
        const uint32_t v_tile = base + L::kV + s * L::kTileBytes;
        mbar_wait(full + 8 * s, (t / kStages) & 1);

        // S = Q K^T: D / 16 k-steps of 32 bytes inside the swizzled boxes
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;   // within a box row
            wgmma_ss_n64(
                sc, smem_desc(q_tile + (kk / 4) * kBQ * kRowBytes + off, 16),
                smem_desc(k_tile + (kk / 4) * kBK * kRowBytes + off, 16),
                kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // fragment i: row r0 + 8 * ((i >> 1) & 1), key k_lo + 8 (i >> 2)
        // + col0 + (i & 1)
        const bool edge =
            k_lo + kBK > skv || (causal && k_lo + kBK - 1 > row_lo);
        if (edge) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int key = k_lo + 8 * (i >> 2) + col0 + (i & 1);
                const int row = r0 + 8 * ((i >> 1) & 1);
                if (key >= skv || (causal && key > row)) sc[i] = kNegInf;
            }
        }
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int i = 0; i < 32; ++i)
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float mc[2], corr[2], sum[2] = {0.f, 0.f};
        bool dead[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);
            dead[r] = m_new <= kNegInf / 2;
            mc[r] = dead[r] ? 0.f : m_new * scale_log2;
            corr[r] = dead[r] ? 1.f : exp2f(m[r] * scale_log2 - mc[r]);
            m[r] = m_new;
        }
        // P = exp2(S scale log2e - m scale log2e) in float32, split into
        // bf16 hi + lo A fragments: k-step kk of the P V product takes
        // fragments 8 kk .. 8 kk + 7 of S, two to a register
        uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = 8 * kk + 2 * j, r = j & 1;
                const float p0 =
                    dead[r] ? 0.f : exp2f(fmaf(sc[i], scale_log2, -mc[r]));
                const float p1 =
                    dead[r] ? 0.f : exp2f(fmaf(sc[i + 1], scale_log2, -mc[r]));
                sum[r] += p0 + p1;
                const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
                p_hi[kk][j] = bf16x2_bits(hi);
                p_lo[kk][j] = bf16x2_bits(__floats2bfloat162_rn(
                    p0 - __low2float(hi), p1 - __high2float(hi)));
            }
        }
        // l stays a per-thread partial sum of its columns (one quad
        // reduction at the end); corr is the same across the row
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

        // O += P_hi V + P_lo V: 4 k-steps of 16 keys = two 8-row groups
        fence_regs(o);
        wgmma_fence();
        constexpr uint32_t kNextBox = kBK * kRowBytes;   // V's columns 64+
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_pv<D>(o, p_hi[kk],
                        smem_desc(v_tile + kk * 16 * kRowBytes, kNextBox));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_pv<D>(o, p_lo[kk],
                        smem_desc(v_tile + kk * 16 * kRowBytes, kNextBox));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        mbar_arrive(empty + 8 * s);   // this stage's K and V are read
    }

    // epilogue: O / max(l, 1e-30) in bf16 through out's strides
    __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
        const int r = (i >> 1) & 1, row = r0 + 8 * r;
        if (row >= sq) continue;
        *reinterpret_cast<__nv_bfloat162*>(ob + row * os.s + 8 * (i >> 2) +
                                           col0) =
            __floats2bfloat162_rn(o[i] * l[r], o[i + 1] * l[r]);
    }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p)
                   : nullptr;
    }();
    return fn;
}

// A 4-D map (D, rows, heads, batch) of a bf16 [B, H, S, D] view with
// element strides st = (b, h, s), boxes of 64 columns x box_rows rows in
// the 128-byte swizzle; rows past `rows` read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d,
              int rows, int heads, int batch, const int64_t* st,
              int box_rows) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                   static_cast<cuuint64_t>(st[1]) * 2,
                                   static_cast<cuuint64_t>(st[0]) * 2};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox),
                               static_cast<cuuint32_t>(box_rows), 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int heads, int kv_heads, int sq, int skv, const int64_t* st,
           float scale, int causal, cudaStream_t stream) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    CUtensorMap tq, tk, tv;
    if (!make_map(encode, &tq, q, D, sq, heads, batch, st, kBQ) ||
        !make_map(encode, &tk, k, D, skv, kv_heads, batch, st + 3, kBK) ||
        !make_map(encode, &tv, v, D, skv, kv_heads, batch, st + 6, kBK))
        return static_cast<int>(cudaErrorInvalidValue);
    const Strides os{st[9], st[10], st[11]};
    const int smem = Layout<D>::kAlloc;
    auto kernel = flash_wgmma_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(batch * heads, (sq + kBQ - 1) / kBQ);
    kernel<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), os, heads,
        heads / kv_heads, sq, skv, scale * kLog2e, causal);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// dtype: 0 float32, 1 bfloat16.  strides: 12 int64, the (b, h, s) element
// strides of q, k, v and out in that order (d is contiguous).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int heads, int kv_heads, int sq,
                                      int skv, int d, const int64_t* strides,
                                      float scale, int causal, void* stream) {
    if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0 || d < 1 ||
        d > 256 || sq < 1 || skv < 1 ||
        static_cast<int64_t>(batch) * heads > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    using simt::launch;
    const auto s = static_cast<cudaStream_t>(stream);
    const bool wide = d > 128;
    switch (dtype) {
        case 0:
            return wide ? launch<float, 16>(q, k, v, out, batch, heads, kv_heads,
                                            sq, skv, d, strides, scale, causal, s)
                        : launch<float, 8>(q, k, v, out, batch, heads, kv_heads,
                                           sq, skv, d, strides, scale, causal, s);
        case 1:
            return wide ? launch<__nv_bfloat16, 16>(q, k, v, out, batch, heads,
                                                    kv_heads, sq, skv, d,
                                                    strides, scale, causal, s)
                        : launch<__nv_bfloat16, 8>(q, k, v, out, batch, heads,
                                                   kv_heads, sq, skv, d,
                                                   strides, scale, causal, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// bf16 q, k, v, out with D 64 or 128 (the wrapper checks the 16-byte
// alignment TMA needs: base pointers, and the (b, h, s) strides of q, k
// and v in bytes).  strides as flash_attention_launch.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out,
                                            int batch, int heads,
                                            int kv_heads, int sq, int skv,
                                            int d, const int64_t* strides,
                                            float scale, int causal,
                                            void* stream) {
    if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0 || sq < 1 ||
        skv < 1 || static_cast<int64_t>(sq + tc::kBQ - 1) / tc::kBQ > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 64:
            return tc::launch<64>(q, k, v, out, batch, heads, kv_heads, sq,
                                  skv, strides, scale, causal, s);
        case 128:
            return tc::launch<128>(q, k, v, out, batch, heads, kv_heads, sq,
                                   skv, strides, scale, causal, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// What the tensor-core kernel for head dim d holds per block: registers a
// thread at launch (before setmaxnreg moves them) and dynamic shared
// memory in bytes.  Returns a CUDA error code.
extern "C" int flash_attention_wgmma_info(int d, int* regs, int* smem) {
    cudaFuncAttributes attr;
    cudaError_t err;
    if (d == 64) {
        err = cudaFuncGetAttributes(&attr, tc::flash_wgmma_kernel<64>);
        *smem = tc::Layout<64>::kAlloc;
    } else if (d == 128) {
        err = cudaFuncGetAttributes(&attr, tc::flash_wgmma_kernel<128>);
        *smem = tc::Layout<128>::kAlloc;
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    *regs = attr.numRegs;
    return static_cast<int>(err);
}
