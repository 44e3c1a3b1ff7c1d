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
// the mask keeps) against the peak of the inputs' type (bf16 tensor cores;
// float32 67 TFLOP/s).
//
// The launcher takes the variant by input, explicitly (the wrapper in
// kernels/flash_attention/kernel.py names it and counts it):
//   * flash_attention_wgmma_launch: bf16 with D in {64, 128, 160}, the
//     tensor-core kernel below (namespace tc);
//   * flash_attention_launch: float32, or bf16 at any other D, the tf32x3
//     kernel (namespace tf32x3, flash_fwd_kernel): float32 on the tensor
//     cores in the 3xTF32 split, which holds the float32-compute path to
//     1e-5.
// (The backward's variants, tc and tf32x3, are described below.)
//
// --- tc: bf16, D in {64, 128, 160}, on wgmma with TMA-fed K/V tiles ----
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
//     after scaling: 1/sqrt(128) is not a power of two), taken by
//     ex2.approx.ftz (p under 2^-126 is 0).
//   * The online softmax runs on the accumulator fragments in registers:
//     each row's values sit in a quad of threads, so its max takes two
//     shuffles; m, l and the rescale of O use the float32 p.
//   * O += P V is two wgmma passes per k-step, A = P_hi = bf16(p) and
//     then A = P_lo = bf16(p - P_hi), from registers (the S fragment is
//     the A fragment), B = the V tile [keys, W], MN-major, so the
//     transpose bit is set, N = W = D padded to whole 64-column boxes
//     (n64, n128, n192).  Why split P: FlashAttention-2/3 round P once
//     to bf16, and at [1, 12, 2048, 128] causal that puts 4.5% of the
//     outputs (the ones near zero) outside this kernel's own check,
//     |got - ref| <= 1e-4 + 2^-8 |ref| against float32 attention_ref;
//     hi + lo carries p to ~16 bits and passes it.  The split costs 1.5x
//     the tensor-core work of plain FA2, which the bound above does not
//     count, so this design can reach at best ~1.5x that bound; ~1.4x
//     at D 160, where P V runs 192 columns for 160: (1 + 1.5 x 1.2) / 2.
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
//     at most 128 bytes in a box's inner dimension, so a tile is
//     ceil(D / 64) boxes of 64 columns (two at D 128, three at D 160),
//     and the wgmma descriptors use the same swizzle (tiles sit on
//     1024-byte boundaries).  D 160 pads: the maps keep their extent at
//     D, so TMA zero-fills the third box's columns 160-191 and never
//     reads past a row's D columns; it counts the whole box's bytes
//     toward complete_tx all the same, so the tiles' sizes and both
//     expect_tx counts use the padded width W (with D's own, the barrier
//     would never complete).  Q K^T stops at D / 16 k-steps, short of the
//     zero half; P V's zero columns give output columns that are never
//     stored.  (V's MN-major swizzled layout repeats in atoms of 64
//     columns, so N = 160 is not a layout its descriptor can express.)
//   * A wrong wgmma descriptor (leading / stride byte offsets, swizzle) or
//     fragment-to-row map gives wrong numbers, not a crash: the tests and
//     chip_smoke.py hold D = 64, 128 and 160, ragged lengths, causal with
//     Sq > Skv and GQA against attention_ref.
//   * Registers: O (64 x W f32) is W / 2 a consumer thread (96 at D
//     160), S 32, P_hi and P_lo 32.  setmaxnreg gives consumers 232 at
//     run time, but ptxas allocates them the launch's 168 all the same,
//     so at D 160 the softmax's exp2 is ex2.approx.ftz (exp2f's path for
//     subnormal results spilled there).  -Xptxas -v must show no spills
//     (chip_smoke.py prints it).  Shared memory at D 160: Q 48 KB, K and
//     V 24 KB a tile and stage, 145 KB with two stages.
//   * The mask value: with exp2 and -1e30 the dead-row guard stays exact
//     (p = 0, corr = 1 while the row's max is the mask value).
//   * A barrier wait that never completes would hang the card: every wait
//     traps after ~10 s instead, so a fault is an error.
//
// Both variants also write each row's log-sum-exp, lse = ln sum_j exp(S_ij
// scale) in float32 [B, H, Sq] (-inf for a dead row), which the backward
// takes.
//
// === The backward ========================================================
// Replaces the reference op's backward, _bwd (src/repro/kernels/
// flash_attention/ops.py:66), which on the TPU is XLA's fused pullback of
// attention_ref.  It computes the same gradients, in the FlashAttention-2
// equations from the saved out and lse: delta_i = sum_d dO_id O_id, P =
// exp(S scale - lse), dV = P^T dO, dP = dO V^T, dS = P o (dP - delta),
// dQ = scale dS K, dK = scale dS^T Q; GQA sums dK and dV over each KV
// head's group; masking, ragged lengths and strides as the forward.  What
// bounds it on the H100: operations, the function's five products, 10 B H
// D x the kept pairs, at the bf16 tensor-core peak.
//
// Three launches a call, in both variants: a preprocess (delta, and lse in
// base-2 units, into a [B * H, Sq padded to 64] float32 scratch; rows past
// Sq get lse2 = +inf, so a zero-filled q row has P = 0), a dK/dV pass (a
// block owns a KV tile of one KV head and walks its group's q tiles, under
// causal only those at or below the diagonal, accumulating dK and dV in
// registers) and a dQ pass (a block owns a q tile and walks the KV tiles up
// to the diagonal).  Each pass recomputes S and dP, so a kept pair costs 7
// products against the function's 5: the kernel can reach at best 1 / 1.4
// of the bound above.  What the recompute buys is determinism: every sum
// of dQ, dK and dV is taken inside one block in a fixed order, with no
// atomics, so two calls give bit-equal gradients (the training run's resume
// check holds the losses bit for bit).
//
// The dK/dV pass's grid is B x KH x (Skv / keys a block): at qwen2-1.5b's
// training shape, [4, 12/2, 2048, 128], 128 blocks of one SM each, one
// wave on 132 SMs, and under causal the first KV tile walks 16x the q
// tiles of the last, so the pass lasted as long as its heaviest block with
// the SMs half idle.  Where the grid is under one wave, the host splits
// each KV tile's (q head, q tile) steps over `splits` blocks (kernel.py,
// dkv_splits: the fewest that fill a wave; 2 at that shape, 256 blocks,
// the heaviest 96 steps of 64 q rows against a mean of ~99 an SM), each
// writing float32 partials, and a fourth launch
// (simt::flash_bwd_reduce_kernel) sums them in a fixed order; elsewhere
// (a full grid) nothing changes.  Blocks are launched heaviest first (the
// first KV tiles; the dQ pass's last q tiles).
//
// --- tc backward: bf16, D in {64, 128, 160}, on wgmma with TMA-fed tiles --
//   * 256 threads: two consumer warpgroups, no producer warpgroup (thread 0
//     issues the loads), so ptxas may give a thread 255 registers.
//   * dK/dV pass: S^T = K Q^T and dP^T = V dO^T (wgmma.m64n64, A = the K /
//     V rows, B = a 64-row Q / dO tile, both K-major from shared memory),
//     so that P^T and dS^T come out as register fragments that serve as A
//     of dV += P^T dO and dK += dS^T Q (B = the dO / Q tile, MN-major, N =
//     D padded to whole boxes): FlashAttention-3's arrangement.  A block
//     owns 128 keys (64 a warpgroup) at D 64 and 128; at D 160 the two
//     accumulators (96 floats each) do not fit one thread, so a block owns
//     64 keys, warpgroup 0 accumulating dV and warpgroup 1 dK (both form
//     S^T: 8 products a kept pair there, at N 192 for 160).
//   * dQ pass: S = Q K^T and dP = dO V^T, dS in registers as A of dQ += dS
//     K (B = the K tile, MN-major), like the forward's P V.  A block owns
//     128 q rows (64 a warpgroup), heaviest first.
//   * P and dS are rounded to bf16 once for their products, as
//     FlashAttention-2/3 and SDPA's backward do (chip_smoke.py holds the
//     gradients' rms distance from the float32 pullback to 1.25x SDPA's).
//   * Streamed tiles flow through a three-stage mbarrier ring (two in the
//     dQ pass at D 160, where three do not fit); the per-row lse2 and
//     delta of a q tile ride the same barrier as a 1-D bulk copy.
//     Gradients are written in bf16 through dq's, dk's and dv's strides.
// --- tf32x3 backward: float32, or bf16 at any other D --------------------
//   The same passes with every product on the tensor cores, mma.sync
//   m16n8k8 on tf32 operands in the 3xTF32 split (hi + lo of each operand,
//   three products summed in float32), so the float32 path holds 1e-5:
//   see namespace tf32x3.  What bounds it: the five products at the
//   float32 peak (67 TFLOP/s, the arithmetic it replaces), and at best the
//   same at 3x the dense tf32 rate (its own arithmetic).
//
// Plain C interface, loaded with ctypes: each launcher returns
// cudaGetLastError() after its launch (or the error that refused it).
#include <cstdint>
#include <cuda.h>   // CUtensorMap and its enums (no -lcuda: see tc)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// 2^x on the SFU, subnormal results flushed to 0 (a p below 2^-126 moves
// no output); exp2f's extra path for them spilled at D 160
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// --- simt: what the variants share, and two small kernels of the backward -
namespace simt {

constexpr int kThreads = 256;

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

// --- the backward ---------------------------------------------------------
// Preprocess, both variants: one warp a row of the [B * H, sq_pad] scratch
// (sq_pad = Sq rounded up to 64, so that every 64-row tile of it is whole
// and 256-byte aligned): delta = sum_d dO o O in float32, and lse2 = lse
// log2(e), the base-2 log-sum-exp the backward's exp2 takes.  Rows >= Sq,
// and a dead row's -inf, get lse2 = +inf (P = 0) and delta = 0.
constexpr int kPad = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const T* __restrict__ out,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ delta, float* __restrict__ lse2,
                      int heads, int sq, int sq_pad, int d, int64_t rows,
                      Strides os, Strides dos) {
    const int64_t gid = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                        threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (gid >= rows) return;
    const int bh = static_cast<int>(gid / sq_pad);
    const int row = static_cast<int>(gid % sq_pad);
    const int b = bh / heads, h = bh % heads;
    const float inf = __int_as_float(0x7f800000);
    if (row >= sq) {
        if (lane == 0) {
            delta[gid] = 0.f;
            lse2[gid] = inf;
        }
        return;
    }
    const T* o = out + b * os.b + h * os.h + row * os.s;
    const T* g = dout + b * dos.b + h * dos.h + row * dos.s;
    float sum = 0.f;
    for (int c = lane; c < d; c += 32) sum += to_float(o[c]) * to_float(g[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
        const float l = lse[static_cast<int64_t>(bh) * sq + row];
        delta[gid] = sum;
        lse2[gid] = l == -inf ? inf : l * 1.4426950408889634f;
    }
}

template <typename T>
int prep_launch(const void* out, const void* dout, const float* lse,
                float* delta, float* lse2, int batch, int heads, int sq,
                int d, Strides os, Strides dos, cudaStream_t stream) {
    const int sq_pad = (sq + kPad - 1) / kPad * kPad;
    const int64_t rows = static_cast<int64_t>(batch) * heads * sq_pad;
    const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    flash_bwd_prep_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(
        static_cast<const T*>(out), static_cast<const T*>(dout), lse, delta,
        lse2, heads, sq, sq_pad, d, rows, os, dos);
    return static_cast<int>(cudaGetLastError());
}

// The dK/dV pass's split (both backward variants): where the pass would
// fill less than one wave of the card, the host splits each KV tile's work
// over `splits` blocks (kernels/flash_attention/kernel.py, dkv_splits).
// Each writes its float32 partial dK (scaled) and dV to a scratch of
// [2][splits][B * KH][Skv][D] floats, and this kernel sums the partials in
// the fixed order 0 .. splits - 1 (no atomics: bit-equal twice) into dk
// and dv through their strides.
// One block of kReduceThreads a (KV row, dK or dV): blockIdx.x = b * KH
// * Skv + key, blockIdx.y = 0 (dK) or 1 (dV).
constexpr int kReduceThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
flash_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ dk,
                        T* __restrict__ dv, int splits, int kv_heads,
                        int skv, int d, int64_t n, Strides dks,
                        Strides dvs) {
    const bool is_v = blockIdx.y == 1;
    const int bkv = blockIdx.x / skv, key = blockIdx.x % skv;
    const int b = bkv / kv_heads, kvh = bkv % kv_heads;
    const Strides& s = is_v ? dvs : dks;
    const float* src = part + (is_v ? splits * n : 0) +
                       static_cast<int64_t>(blockIdx.x) * d;
    T* dst = (is_v ? dv : dk) + b * s.b + kvh * s.h + key * s.s;
    for (int c = threadIdx.x; c < d; c += kReduceThreads) {
        float sum = 0.f;
        for (int j = 0; j < splits; ++j) sum += src[j * n + c];
        dst[c] = from_float<T>(sum);
    }
}

template <typename T>
int reduce_launch(const float* part, void* dk, void* dv, int splits,
                  int batch, int kv_heads, int skv, int d, Strides dks,
                  Strides dvs, cudaStream_t stream) {
    const int64_t rows = static_cast<int64_t>(batch) * kv_heads * skv;
    if (rows > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
    flash_bwd_reduce_kernel<T><<<dim3(static_cast<unsigned>(rows), 2),
                                 kReduceThreads, 0, stream>>>(
        part, static_cast<T*>(dk), static_cast<T*>(dv), splits, kv_heads,
        skv, d, rows * d, dks, dvs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// --- tf32x3: float32, or bf16 at any other D, both directions ------------
// The backward first (the forward, flash_fwd_kernel, at the end of the
// namespace).  Every product on the tensor cores, mma.sync.m16n8k8 with tf32 operands,
// in the 3xTF32 split (the class of arithmetic PyTorch's float32 SDPA
// backward runs, CUTLASS's OpMultiplyAddFastF32): an operand x is hi =
// tf32(x), rounded to 10 mantissa bits (nearest even), and lo = tf32(x -
// hi); a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi with float32
// sums.  Each tf32 product is exact in float32, and hi + lo carries x to
// ~21 bits, so a product loses ~2^-21 of |a b|: the float32 limits hold
// (tests/test_torch_flash_backward.py emulates this arithmetic on the CPU
// and holds it to the card tests' 1e-5; one tf32 product misses them by
// 10-1000x).
//   * Fragments are read as floats from shared memory and split there.  A
//     tile row is D zero-padded to a bucket W (a multiple of the mma's k
//     of 8: 16, 32, 64, 96, 128, 160, 192 or 256), W + 4 floats apart, so
//     that every fragment load is free of bank conflicts (a stride of 4
//     mod 8 words puts the 32 lanes on 32 banks for both the row-major A
//     and B reads and the k-major B reads of the second products).
//   * The backward's transposes are only a choice of fragment loads.  S^T
//     = K Q^T, dP^T = V dO^T (dK/dV pass) and S = Q K^T, dP = dO V^T (dQ
//     pass) take A from the owned rows and B from the streamed tile's rows
//     (B[k][n] = tile[n][k]).  Their accumulators, P^T and dS^T (or dS),
//     serve directly as the A fragments of dV += P^T dO, dK += dS^T Q and
//     dQ += dS K: an accumulator holds columns 2t and 2t + 1 where an A
//     fragment wants t and t + 4, so the k index of those products is
//     permuted (k = t is tile row 2t, k = t + 4 row 2t + 1) and B is read
//     from rows 2t and 2t + 1 to match.  No P or dS goes through shared
//     memory.
//   * dK/dV pass: 256 threads, a block owns 128 keys (16 a warp, both sums)
//     or, at W > 128, 64 keys (warps 2i and 2i + 1 share 16: the even one
//     sums dV, the odd one dK); dQ pass: a block owns 128 q rows (64 at W
//     > 128), 16 a warp, heaviest first.  The streamed tiles (32 rows; 16
//     at W > 192) are double-buffered with cp.async (float32; bf16 is
//     converted on load, exactly: bf16 is a tf32 value), with a tile's
//     lse2 and delta beside it.
//   * The dK/dV pass splits as the tc one does (dkv_splits); every sum in
//     a fixed order, no atomics.
namespace tf32x3 {

using simt::Strides;
using simt::from_float;
using simt::to_float;

constexpr int kRows = 16;        // rows of a warp's slice (the mma's m)
constexpr int kKvThreads = 256;

template <int W> struct Shape {  // sizes in floats
    static constexpr int kLd = W + 4;                  // a tile row
    static constexpr bool kWide = W > 128;
    static constexpr int kOwn = kWide ? 64 : 128;      // owned rows a block
    static constexpr int kStream = W > 192 ? 16 : 32;  // streamed rows
    static constexpr int kQThreads = kOwn / kRows * 32;
    static constexpr int kKvStage = 2 * kStream * kLd + 2 * kStream;
    static constexpr int kKvFloats = 2 * kOwn * kLd + 2 * kKvStage;
    static constexpr int kQStage = 2 * kStream * kLd;
    static constexpr int kQFloats = 2 * kOwn * kLd + 2 * kQStage;
};

// x = hi + lo: hi = x rounded to tf32 (10 mantissa bits, nearest even),
// lo = x - hi exactly, handed to the tensor cores as it is: they read a
// tf32 operand's top 19 bits, so lo counts truncated to 10 mantissa bits
// (an error under 2^-21 |x|, beside 2^-22 |x| for rounding it: the
// emulation in tests/test_torch_flash_backward.py models exactly this)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    uint32_t u = __float_as_uint(x);
    u += 0xFFFu + ((u >> 13) & 1u);
    hi = u & 0xFFFFE000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// d[16 x 8] = a[16 x 8] b[8 x 8] + c, tf32 in, float32 out
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2], float c) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(c));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += the 3xTF32 product, the small terms first.  The three products are
// summed by the tensor cores from zero and then added to d in float32:
// the tensor cores round their sums toward zero, so a long sum kept in
// them (dK and dV run 12,288 q rows at the training shape) drifts by
// ~2^-23 a step, in one direction; measured on the card, 3.6e-5 relative
// rms on dK and dV, 16x SDPA's.  Added outside, each step's error is that
// of one rounded float32 add.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
    float t[4];
    mma(t, al, bh, 0.f);
    mma(t, ah, bl);
    mma(t, ah, bh);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// A fragment of rows r .. r + 15, columns c .. c + 7 of a tile (ld floats
// a row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
__device__ __forceinline__ void load_a(const float* tile, int ld, int r,
                                       int c, int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
    const float* p = tile + (r + g) * ld + c + t;
    split(p[0], hi[0], lo[0]);
    split(p[8 * ld], hi[1], lo[1]);
    split(p[4], hi[2], lo[2]);
    split(p[8 * ld + 4], hi[3], lo[3]);
}
// B fragment (k x n = 8 x 8) whose (k, n) is tile[n0 + n][k0 + k]: b0
// (t, g), b1 (t + 4, g)
__device__ __forceinline__ void load_b_rows(const float* tile, int ld, int n0,
                                            int k0, int g, int t,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
    const float* p = tile + (n0 + g) * ld + k0 + t;
    split(p[0], hi[0], lo[0]);
    split(p[4], hi[1], lo[1]);
}
// B fragment whose (k, n) is tile[k0 + perm(k)][n0 + n], perm(t) = 2t and
// perm(t + 4) = 2t + 1: the k order of an A fragment taken from an
// accumulator
__device__ __forceinline__ void load_b_cols(const float* tile, int ld, int k0,
                                            int n0, int g, int t,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
    const float* p = tile + (k0 + 2 * t) * ld + n0 + g;
    split(p[0], hi[0], lo[0]);
    split(p[ld], hi[1], lo[1]);
}
// the A fragment of an accumulator tile c (c0 (g, 2t), c1 (g, 2t + 1), c2
// (g + 8, 2t), c3 (g + 8, 2t + 1)) in the permuted k order
__device__ __forceinline__ void acc_to_a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
    split(c[0], hi[0], lo[0]);
    split(c[2], hi[1], lo[1]);
    split(c[1], hi[2], lo[2]);
    split(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
    asm volatile(
        "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
            static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
        "l"(src), "r"(bytes)
        : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows lo .. lo + rows - 1 (columns below d) of a [n, d] view with row
// stride rs into a tile of ld floats a row; rows >= n are zeros.  float32
// by cp.async (completing on the thread's next commit group), bf16
// converted on the way.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t rs, int lo, int rows,
                                          int n, int d, int warp, int warps,
                                          int lane) {
    for (int r = warp; r < rows; r += warps) {
        const int row = lo + r;
        const bool in = row < n;
        const T* s = src + (in ? row * rs : 0);
        for (int c = lane; c < d; c += 32) {
            if constexpr (sizeof(T) == 4)
                cp_async4(dst + r * ld + c, s + c, in ? 4 : 0);
            else
                dst[r * ld + c] = in ? to_float(s[c]) : 0.f;
        }
    }
}

template <typename T, int W>
__global__ void __launch_bounds__(kKvThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ delta,
                     const float* __restrict__ lse2, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ part,
                     int splits, int heads, int kv_heads, int sq, int sq_pad,
                     int skv, int d, Strides qs, Strides ks, Strides vs,
                     Strides dos, Strides dks, Strides dvs, float scale,
                     float scale_log2, int causal) {
    using S = Shape<W>;
    constexpr int kLd = S::kLd, kOwn = S::kOwn, kBr = S::kStream;
    constexpr int kNt = kBr / 8, kWt = W / 8;
    constexpr bool kPair = S::kWide;
    constexpr int kWarps = kKvThreads / 32;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* k_tile = smem;                         // [kOwn][kLd]
    float* v_tile = k_tile + kOwn * kLd;
    float* stages = v_tile + kOwn * kLd;          // Q, dO, lse2, delta

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int group = heads / kv_heads;
    const int split_j = blockIdx.x % splits, bkv = blockIdx.x / splits;
    const int b = bkv / kv_heads, kvh = bkv % kv_heads;
    const int k_lo = blockIdx.y * kOwn;
    const int n_q = (sq + kBr - 1) / kBr;
    // under causal, the q tiles from the one holding row k_lo (row >= key)
    const int qt0 = causal ? min(k_lo / kBr, n_q) : 0;
    const int per = n_q - qt0, total = group * per;
    // this block's share of the (head, q tile) steps: the larger shares
    // first
    const int base = total / splits, extra = total % splits;
    const int t_begin = split_j * base + min(split_j, extra);
    const int t_end = t_begin + base + (split_j < extra ? 1 : 0);

    for (int i = tid; i < S::kKvFloats / 4; i += kKvThreads)
        smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    load_rows(k_tile, kLd, k + b * ks.b + kvh * ks.h, ks.s, k_lo, kOwn, skv,
              d, warp, kWarps, lane);
    load_rows(v_tile, kLd, v + b * vs.b + kvh * vs.h, vs.s, k_lo, kOwn, skv,
              d, warp, kWarps, lane);
    cp_async_commit();
    auto issue = [&](int t) {
        float* st = stages + ((t - t_begin) & 1) * S::kKvStage;
        const int h = kvh * group + t / per, qt = qt0 + t % per;
        load_rows(st, kLd, q + b * qs.b + h * qs.h, qs.s, qt * kBr, kBr, sq,
                  d, warp, kWarps, lane);
        load_rows(st + kBr * kLd, kLd, dout + b * dos.b + h * dos.h, dos.s,
                  qt * kBr, kBr, sq, d, warp, kWarps, lane);
        if (tid < 2 * kBr) {
            const int64_t row = (static_cast<int64_t>(b) * heads + h) *
                                    sq_pad + qt * kBr + tid % kBr;
            cp_async4(st + 2 * kBr * kLd + tid,
                      (tid < kBr ? lse2 : delta) + row, 4);
        }
        cp_async_commit();
    };
    if (t_begin < t_end) issue(t_begin);

    // this warp's 16 keys: key0 + g and key0 + g + 8 of its fragments
    const int wr = kPair ? kRows * (warp / 2) : kRows * warp;
    const int key0 = k_lo + wr;
    const bool do_v = !kPair || warp % 2 == 0;
    const bool do_k = !kPair || warp % 2 == 1;
    constexpr int kAcc = kPair ? 1 : 2;
    float acc[kAcc][kWt][4];
#pragma unroll
    for (int a = 0; a < kAcc; ++a)
#pragma unroll
        for (int w = 0; w < kWt; ++w)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[a][w][i] = 0.f;
    float(&dva)[kWt][4] = acc[0];          // (in pairs one array, dV or
    float(&dka)[kWt][4] = acc[kAcc - 1];   //  dK by warp)

    for (int t = t_begin; t < t_end; ++t) {
        if (t + 1 < t_end) {
            issue(t + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* q_t = stages + ((t - t_begin) & 1) * S::kKvStage;
        const float* do_t = q_t + kBr * kLd;
        const float* l2 = do_t + kBr * kLd;
        const float* dl = l2 + kBr;
        const int q_lo = (qt0 + t % per) * kBr;
        // under causal, a q tile wholly above this warp's keys keeps no pair
        if (!causal || q_lo + kBr - 1 >= key0) {
            float st[kNt][4], dpt[kNt][4];
#pragma unroll
            for (int n = 0; n < kNt; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
            // S^T = K Q^T and dP^T = V dO^T over the W columns
#pragma unroll 2
            for (int kk = 0; kk < kWt; ++kk) {
                uint32_t ah[4], al[4], bh[2], bl[2];
                load_a(k_tile, kLd, wr, 8 * kk, g, t4, ah, al);
#pragma unroll
                for (int n = 0; n < kNt; ++n) {
                    load_b_rows(q_t, kLd, 8 * n, 8 * kk, g, t4, bh, bl);
                    mma3(st[n], ah, al, bh, bl);
                }
                if (do_k) {
                    load_a(v_tile, kLd, wr, 8 * kk, g, t4, ah, al);
#pragma unroll
                    for (int n = 0; n < kNt; ++n) {
                        load_b_rows(do_t, kLd, 8 * n, 8 * kk, g, t4, bh, bl);
                        mma3(dpt[n], ah, al, bh, bl);
                    }
                }
            }
            // P^T = exp2(S^T scale log2e - lse2[col]) and dS^T = P^T o
            // (dP^T - delta[col]) in place; keys >= Skv and, under causal,
            // key > row masked; q rows >= Sq have lse2 = +inf (P = 0)
#pragma unroll
            for (int n = 0; n < kNt; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int col = 8 * n + 2 * t4 + (i & 1);
                    const int key = key0 + g + 8 * (i >> 1);
                    float p = exp2f(st[n][i] * scale_log2 - l2[col]);
                    if (key >= skv || (causal && key > q_lo + col)) p = 0.f;
                    dpt[n][i] = p * (dpt[n][i] - dl[col]);
                    st[n][i] = p;
                }
            // dV += P^T dO and dK += dS^T Q: k = the tile's q rows
#pragma unroll
            for (int n = 0; n < kNt; ++n) {
                uint32_t ah[4], al[4], bh[2], bl[2];
                if (do_v) {
                    acc_to_a(st[n], ah, al);
#pragma unroll
                    for (int w = 0; w < kWt; ++w) {
                        load_b_cols(do_t, kLd, 8 * n, 8 * w, g, t4, bh, bl);
                        mma3(dva[w], ah, al, bh, bl);
                    }
                }
                if (do_k) {
                    acc_to_a(dpt[n], ah, al);
#pragma unroll
                    for (int w = 0; w < kWt; ++w) {
                        load_b_cols(q_t, kLd, 8 * n, 8 * w, g, t4, bh, bl);
                        mma3(dka[w], ah, al, bh, bl);
                    }
                }
            }
        }
        __syncthreads();   // this stage is read before it is refilled
    }
    cp_async_wait<0>();

    // dV and dK = scale dS^T Q: keys below Skv, columns below D; with
    // splits, this block's float32 partials
    const int64_t n_part = static_cast<int64_t>(gridDim.x / splits) * skv * d;
    float* pk = part + (static_cast<int64_t>(split_j) * (gridDim.x / splits) +
                        bkv) * skv * d;
    float* pv = pk + splits * n_part;
#pragma unroll
    for (int w = 0; w < kWt; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int key = key0 + g + 8 * (i >> 1);
            const int c = 8 * w + 2 * t4 + (i & 1);
            if (key >= skv || c >= d) continue;
            if (splits > 1) {
                if (do_v) pv[key * d + c] = dva[w][i];
                if (do_k) pk[key * d + c] = dka[w][i] * scale;
            } else {
                if (do_v)
                    dv[b * dvs.b + kvh * dvs.h + key * dvs.s + c] =
                        from_float<T>(dva[w][i]);
                if (do_k)
                    dk[b * dks.b + kvh * dks.h + key * dks.s + c] =
                        from_float<T>(dka[w][i] * scale);
            }
        }
}

template <typename T, int W>
__global__ void __launch_bounds__(Shape<W>::kQThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ delta,
                    const float* __restrict__ lse2, T* __restrict__ dq,
                    int heads, int group, int sq, int sq_pad, int skv, int d,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Strides dqs, float scale, float scale_log2, int causal) {
    using S = Shape<W>;
    constexpr int kLd = S::kLd, kOwn = S::kOwn, kBc = S::kStream;
    constexpr int kNt = kBc / 8, kWt = W / 8;
    constexpr int kWarps = S::kQThreads / 32;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* q_tile = smem;                         // [kOwn][kLd]
    float* do_tile = q_tile + kOwn * kLd;
    float* stages = do_tile + kOwn * kLd;         // K, V

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.x;
    const int b = bh / heads, h = bh % heads, kvh = h / group;
    const int q_lo = (gridDim.y - 1 - blockIdx.y) * kOwn;   // heaviest first
    const int n_kv = (skv + kBc - 1) / kBc;
    const int total =
        causal ? min(n_kv, (q_lo + kOwn - 1) / kBc + 1) : n_kv;
    const T* kb = k + b * ks.b + kvh * ks.h;
    const T* vb = v + b * vs.b + kvh * vs.h;

    for (int i = tid; i < S::kQFloats / 4; i += S::kQThreads)
        smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    load_rows(q_tile, kLd, q + b * qs.b + h * qs.h, qs.s, q_lo, kOwn, sq, d,
              warp, kWarps, lane);
    load_rows(do_tile, kLd, dout + b * dos.b + h * dos.h, dos.s, q_lo, kOwn,
              sq, d, warp, kWarps, lane);
    cp_async_commit();
    auto issue = [&](int t) {
        float* st = stages + (t & 1) * S::kQStage;
        load_rows(st, kLd, kb, ks.s, t * kBc, kBc, skv, d, warp, kWarps,
                  lane);
        load_rows(st + kBc * kLd, kLd, vb, vs.s, t * kBc, kBc, skv, d, warp,
                  kWarps, lane);
        cp_async_commit();
    };
    if (total > 0) issue(0);

    // this warp's rows r0 = q_lo + wr + g and r0 + 8
    const int wr = kRows * warp;
    const int r0 = q_lo + wr + g;
    const int64_t stat = static_cast<int64_t>(bh) * sq_pad;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // rows past Sq: P = 0
        const int row = r0 + 8 * r;
        l2[r] = row < sq ? lse2[stat + row] : __int_as_float(0x7f800000);
        dl[r] = row < sq ? delta[stat + row] : 0.f;
    }
    float dqa[kWt][4];
#pragma unroll
    for (int w = 0; w < kWt; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[w][i] = 0.f;

    for (int t = 0; t < total; ++t) {
        if (t + 1 < total) {
            issue(t + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* k_t = stages + (t & 1) * S::kQStage;
        const float* v_t = k_t + kBc * kLd;
        const int k_lo = t * kBc;
        if (!causal || k_lo <= q_lo + wr + kRows - 1) {
            float sc[kNt][4], dp[kNt][4];
#pragma unroll
            for (int n = 0; n < kNt; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
            // S = Q K^T and dP = dO V^T over the W columns
#pragma unroll 2
            for (int kk = 0; kk < kWt; ++kk) {
                uint32_t ah[4], al[4], bh2[2], bl[2];
                load_a(q_tile, kLd, wr, 8 * kk, g, t4, ah, al);
#pragma unroll
                for (int n = 0; n < kNt; ++n) {
                    load_b_rows(k_t, kLd, 8 * n, 8 * kk, g, t4, bh2, bl);
                    mma3(sc[n], ah, al, bh2, bl);
                }
                load_a(do_tile, kLd, wr, 8 * kk, g, t4, ah, al);
#pragma unroll
                for (int n = 0; n < kNt; ++n) {
                    load_b_rows(v_t, kLd, 8 * n, 8 * kk, g, t4, bh2, bl);
                    mma3(dp[n], ah, al, bh2, bl);
                }
            }
            // dS = P o (dP - delta) in place, P = exp2(S scale log2e -
            // lse2), masked as in the dK/dV pass
#pragma unroll
            for (int n = 0; n < kNt; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int r = i >> 1;
                    const int key = k_lo + 8 * n + 2 * t4 + (i & 1);
                    float p = exp2f(sc[n][i] * scale_log2 - l2[r]);
                    if (key >= skv || (causal && key > r0 + 8 * r)) p = 0.f;
                    dp[n][i] = p * (dp[n][i] - dl[r]);
                }
            // dQ += dS K: k = the tile's keys
#pragma unroll
            for (int n = 0; n < kNt; ++n) {
                uint32_t ah[4], al[4], bh2[2], bl[2];
                acc_to_a(dp[n], ah, al);
#pragma unroll
                for (int w = 0; w < kWt; ++w) {
                    load_b_cols(k_t, kLd, 8 * n, 8 * w, g, t4, bh2, bl);
                    mma3(dqa[w], ah, al, bh2, bl);
                }
            }
        }
        __syncthreads();   // this stage is read before it is refilled
    }
    cp_async_wait<0>();

    // dQ = scale dS K through dq's strides: rows below Sq, columns below D
    T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int w = 0; w < kWt; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = r0 + 8 * (i >> 1);
            const int c = 8 * w + 2 * t4 + (i & 1);
            if (row < sq && c < d)
                dqb[row * dqs.s + c] = from_float<T>(dqa[w][i] * scale);
        }
}

// strides: 24 int64, the (b, h, s) element strides of q, k, v, dout, out,
// dq, dk and dv in that order.  scratch: 2 x B x H x sq_pad floats (delta,
// then lse2); part: with splits > 1, 2 x splits x B x KH x Skv x D floats.
template <typename T, int W>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* scratch, float* part, int splits, int batch,
               int heads, int kv_heads, int sq, int skv, int d,
               const int64_t* st, float scale, int causal,
               cudaStream_t stream) {
    using S = Shape<W>;
    const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
        vs{st[6], st[7], st[8]}, dos{st[9], st[10], st[11]},
        os{st[12], st[13], st[14]}, dqs{st[15], st[16], st[17]},
        dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
    const int sq_pad = (sq + simt::kPad - 1) / simt::kPad * simt::kPad;
    float* delta = scratch;
    float* lse2 = scratch + static_cast<int64_t>(batch) * heads * sq_pad;
    int err = simt::prep_launch<T>(out, dout, lse, delta, lse2, batch, heads,
                                   sq, d, os, dos, stream);
    if (err != 0) return err;
    const float scale_log2 = scale * 1.4426950408889634f;

    auto dkv = flash_bwd_dkv_kernel<T, W>;
    const int kv_smem = static_cast<int>(sizeof(float)) * S::kKvFloats;
    cudaError_t e = cudaFuncSetAttribute(
        dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dkv<<<dim3(splits * batch * kv_heads, (skv + S::kOwn - 1) / S::kOwn),
          kKvThreads, kv_smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), delta, lse2,
        static_cast<T*>(dk), static_cast<T*>(dv), part, splits, heads,
        kv_heads, sq, sq_pad, skv, d, qs, ks, vs, dos, dks, dvs, scale,
        scale_log2, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (splits > 1) {
        err = simt::reduce_launch<T>(part, dk, dv, splits, batch, kv_heads,
                                     skv, d, dks, dvs, stream);
        if (err != 0) return err;
    }

    auto dqk = flash_bwd_dq_kernel<T, W>;
    const int q_smem = static_cast<int>(sizeof(float)) * S::kQFloats;
    e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dqk<<<dim3(batch * heads, (sq + S::kOwn - 1) / S::kOwn), S::kQThreads,
          q_smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), delta, lse2,
        static_cast<T*>(dq), heads, heads / kv_heads, sq, sq_pad, skv, d, qs,
        ks, vs, dos, dqs, scale, scale_log2, causal);
    return static_cast<int>(cudaGetLastError());
}

template <int W> int info(int which, int* regs, int* smem) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        which == 0
            ? cudaFuncGetAttributes(&attr, flash_bwd_dkv_kernel<float, W>)
            : cudaFuncGetAttributes(&attr, flash_bwd_dq_kernel<float, W>);
    *regs = attr.numRegs;
    *smem = static_cast<int>(sizeof(float)) *
            (which == 0 ? Shape<W>::kKvFloats : Shape<W>::kQFloats);
    return static_cast<int>(err);
}

// --- tf32x3 forward: float32, or bf16 at any other D ----------------------
// The same arithmetic as the backward's (mma.sync m16n8k8 tf32, 3xTF32),
// with each operand split once a block where the backward splits every
// fragment it loads (~21 clocks an mma there, measured on an H100).
//   * A block of FwdShape<W>::kThreads owns one (batch * head, kBQ-row q
//     tile), heaviest q tiles first under causal; warp w owns rows 16 w ..
//     16 w + 15 and walks the K / V tiles of kBK keys in a loop, its
//     running max m, sum l and output O (16 x W float32, W / 2 a thread)
//     in registers.
//   * Q is split once, as the block loads it, into hi / lo records in the
//     A-fragment order: a warp's k-step is two runs of 32 16-byte records
//     (a0, a1, then a2, a3, hi and lo each), two conflict-free 16-byte
//     loads a lane.
//   * K and V tiles come in by cp.async (16 bytes a copy where q, k, v and
//     d allow, else 4; bf16 is converted on load, exactly: bf16 is a tf32
//     value) into raw tiles W + 4 floats a row; all threads then split the
//     tile once into records in the B-fragment order of Q K^T (K) and of
//     P V with the permuted k (V): one 16-byte load a fragment, both
//     halves.  The next tile's copies are issued as soon as the split has
//     read the raw tiles, so they run under this tile's math: two stages,
//     the raw tiles filling while the records are read.
//   * S = Q K^T: the three products a k-step, S's sum kept in the tensor
//     cores (it runs over W <= 256 columns: the CPU emulation of this
//     arithmetic, tests/test_torch_flash_numerics.py, puts it at ~0.1 of
//     the float32 limit, round-toward-zero sums included), in two sets of
//     accumulators, the hi hi products and the small ones, added once a
//     tile (and twice the independent mma chains of one set).
//   * The online softmax as the tc kernel's: masks at -1e30 on the tiles
//     that need them, the row max over the quad by two shuffles, p =
//     2^(S scale log2e - m scale log2e) by ex2.approx.ftz, the dead-row
//     guard; l a per-thread partial sum, reduced over the quad at the end.
//   * O += P V: P split once in registers, its S fragment the A fragment
//     (k permuted, as the backward's); each of the W / 8 output columns'
//     eight-column tiles sums the tile's kBK / 8 k-steps x 3 products from
//     zero in the tensor cores, then O = O corr + that sum in float32: the
//     long sum over every key never stays in the tensor cores, whose sums
//     round toward zero.
//   * Epilogue: lse = (m scale log2e + log2 l) ln 2 (-inf for a dead row),
//     O / max(l, 1e-30) in the input type through out's strides.
// Budget a block (FwdShape; bytes of shared memory, all of it records and
// raw tiles: Q kBQ W 8, K and V kBK W 8 each, raw 2 kBK (W + 4) 4):
//     W 16 / 32 / 64: 128 rows, 64 keys; 43,008 / 83,968 / 165,888
//     W 96 / 128: 128 rows, 32 keys; 173,056 / 230,400
//     W 160: 128 rows, 16 keys; 225,792
//     W 192 / 256: 64 rows, 16 keys; 172,544 / 229,888
// (227 KB is 232,448.)  Registers a thread: O W / 2, S kBK / 2 twice, P's
// hi / lo kBK; ptxas must show no spills at W 64, 128 and 160 (on an
// H100: 242, 248 and 249 registers, none spilled; W 192 and 256 spill 56
// bytes).  flash_attention_tf32x3_info reports registers, shared memory
// and local memory; chip_smoke.py prints them.  Tile widths measured on
// the card: 64 keys beat 32 at W 64 by 6%; 16 lose to 32 at W 64 and 128;
// two blocks an SM of 64 rows (16 keys at W 128, 8 at 160) lose 10-30%.
// What bounds it: the two products, 4 B H D x the kept pairs, at the
// float32 peak (67 TFLOP/s, the arithmetic it replaces), and at best the
// same at 3x the dense tf32 rate (its own); mma.sync on tf32 reaches ~322
// TFLOP/s on an H100 (measured: 0.6 mma a clock an SM, ~25 clocks of
// latency), so 3x that work can take no less than 1.5x the 3x-tf32 bound.
template <int W> struct FwdShape {
    static constexpr int kBQ = W <= 160 ? 128 : 64;    // q rows a block
    static constexpr int kBK = W <= 64 ? 64 : W <= 128 ? 32 : 16;   // keys
    static constexpr int kWarps = kBQ / kRows;
    static constexpr int kThreads = 32 * kWarps;
    static constexpr int kKs = W / 8;     // k-steps of Q K^T, n-tiles of P V
    static constexpr int kNt = kBK / 8;   // n-tiles of Q K^T, k-steps of P V
    static constexpr int kLdr = W + 4;    // a raw tile row, floats
    static constexpr int kQWords = 2 * kBQ * W;        // hi and lo
    static constexpr int kKWords = 2 * kBK * W;        // K's, and V's
    static constexpr int kRawWords = kBK * kLdr;       // K's, and V's
    static constexpr int kBytes = 4 * (kQWords + 2 * kKWords + 2 * kRawWords);
    static constexpr int kSplit = kBK * W / 2 / kThreads;   // records a thread
    static_assert(kBytes <= 232448, "227 KB of shared memory a block");
    static_assert(kBK * W / 2 % kThreads == 0, "whole records a thread");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
    asm volatile(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
            static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
        "l"(src), "r"(bytes)
        : "memory");
}

// K or V rows lo .. lo + rows - 1 into a raw tile, as load_rows, 16 bytes a
// copy where vec says every row start is 16-byte aligned and d % 4 == 0
template <typename T>
__device__ __forceinline__ void load_raw(float* dst, int ld, const T* src,
                                         int64_t rs, int lo, int rows,
                                         int n, int d, int vec, int warp,
                                         int warps, int lane) {
    if constexpr (sizeof(T) == 4) {
        if (vec) {
            for (int r = warp; r < rows; r += warps) {
                const int row = lo + r;
                const bool in = row < n;
                const T* s = src + (in ? row * rs : 0);
                for (int c = 4 * lane; c < d; c += 128)
                    cp_async16(dst + r * ld + c, s + c, in ? 16 : 0);
            }
            return;
        }
    }
    load_rows(dst, ld, src, rs, lo, rows, n, d, warp, warps, lane);
}

template <typename T, int W>
__global__ void __launch_bounds__(FwdShape<W>::kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int heads, int group, int sq,
                 int skv, int d, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale_log2, int causal, int vec) {
    using S = FwdShape<W>;
    constexpr int kBQ = S::kBQ, kBK = S::kBK, kKs = S::kKs, kNt = S::kNt;
    constexpr int kLdr = S::kLdr, kThreads = S::kThreads;
    constexpr float kNegInf = -1e30f;
    extern __shared__ float4 smem4[];
    uint32_t* q_rec = reinterpret_cast<uint32_t*>(smem4);
    uint4* k_rec = reinterpret_cast<uint4*>(q_rec + S::kQWords);
    uint4* v_rec = reinterpret_cast<uint4*>(q_rec + S::kQWords + S::kKWords);
    float* k_raw = reinterpret_cast<float*>(q_rec + S::kQWords +
                                            2 * S::kKWords);
    float* v_raw = k_raw + S::kRawWords;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int bh = blockIdx.x;
    const int b = bh / heads, h = bh % heads, kvh = h / group;
    const int q_lo = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
    const int n_kv = (skv + kBK - 1) / kBK;
    const int tiles =
        causal ? min(n_kv, (q_lo + kBQ - 1) / kBK + 1) : n_kv;
    const T* kb = k + b * ks.b + kvh * ks.h;
    const T* vb = v + b * vs.b + kvh * vs.h;

    // the raw tiles' columns past d are never copied: zero them once
    for (int i = tid; i < 2 * S::kRawWords / 4; i += kThreads)
        reinterpret_cast<float4*>(k_raw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    auto issue = [&](int t) {
        load_raw(k_raw, kLdr, kb, ks.s, t * kBK, kBK, skv, d, vec, warp,
                 S::kWarps, lane);
        load_raw(v_raw, kLdr, vb, vs.s, t * kBK, kBK, skv, d, vec, warp,
                 S::kWarps, lane);
        cp_async_commit();
    };
    issue(0);

    // Q, split once into the A-fragment records: row r, column c is lane
    // (r % 8) 4 + c % 4's fragment register reg = (r % 16) / 8 + 2 ((c %
    // 8) / 4) of warp r / 16's k-step c / 8; a k-step is two runs of 32
    // 16-byte records (registers 0-1, then 2-3, hi and lo each), so each
    // run is one conflict-free 16-byte load a lane; rows >= Sq and columns
    // >= d are 0
    const T* qb = q + b * qs.b + h * qs.h;
    auto put_q = [&](int r, int c, float x) {
        uint32_t hi, lo;
        split(x, hi, lo);
        const int rr = r % kRows, cc = c % 8;
        const int ln = (rr % 8) * 4 + cc % 4, reg = rr / 8 + 2 * (cc / 4);
        *reinterpret_cast<uint2*>(
            q_rec + ((((r / kRows) * kKs + c / 8) * 2 + reg / 2) * 32 + ln) *
                        4 + 2 * (reg % 2)) = make_uint2(hi, lo);
    };
    bool q_vec = false;
    if constexpr (sizeof(T) == 4) q_vec = vec != 0;
    if (q_vec) {
#pragma unroll 4
        for (int e = tid; e < kBQ * W / 4; e += kThreads) {
            const int r = e / (W / 4), c = 4 * (e % (W / 4));
            const int row = q_lo + r;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (row < sq && c < d)
                x = *reinterpret_cast<const float4*>(
                    reinterpret_cast<const float*>(qb) + row * qs.s + c);
            put_q(r, c, x.x);
            put_q(r, c + 1, x.y);
            put_q(r, c + 2, x.z);
            put_q(r, c + 3, x.w);
        }
    } else {
#pragma unroll 4
        for (int e = tid; e < kBQ * W; e += kThreads) {
            const int r = e / W, c = e % W;
            const int row = q_lo + r;
            put_q(r, c, row < sq && c < d ? to_float(qb[row * qs.s + c])
                                          : 0.f);
        }
    }

    // this warp's rows r0 = q_lo + 16 warp + g and r0 + 8
    const int row_lo = q_lo + kRows * warp;
    const int r0 = row_lo + g;
    const uint4* qw =
        reinterpret_cast<const uint4*>(q_rec) + warp * kKs * 64 + lane;
    float o[kKs][4];
#pragma unroll
    for (int w = 0; w < kKs; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[w][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    for (int t = 0; t < tiles; ++t) {
        cp_async_wait<0>();
        __syncthreads();   // tile t is in; the last tile's records are read
        // split the tile once: K record (kk, n, lane) holds K[8 n + g][8 kk
        // + t4] and [.. + 4] (B of Q K^T); V record (kk, w, lane) holds V[8
        // kk + 2 t4][8 w + g] and the next row (B of P V, k permuted)
#pragma unroll
        for (int j = 0; j < S::kSplit; ++j) {
            const int rest = warp + j * S::kWarps;   // record e = 32 rest + lane
            const float* pk = k_raw + (8 * (rest % kNt) + g) * kLdr +
                              8 * (rest / kNt) + t4;
            uint4 rk;
            split(pk[0], rk.x, rk.y);
            split(pk[4], rk.z, rk.w);
            k_rec[32 * rest + lane] = rk;
            const float* pv = v_raw + (8 * (rest / kKs) + 2 * t4) * kLdr +
                              8 * (rest % kKs) + g;
            uint4 rv;
            split(pv[0], rv.x, rv.y);
            split(pv[kLdr], rv.z, rv.w);
            v_rec[32 * rest + lane] = rv;
        }
        __syncthreads();   // the records are ready, the raw tiles free
        if (t + 1 < tiles) issue(t + 1);
        const int k_lo = t * kBK;
        // under causal, a tile wholly above this warp's rows keeps nothing
        if (causal && k_lo > row_lo + kRows - 1) continue;

        // S = Q K^T over the W columns, in the tensor cores' sums
        float sb[kNt][4], ss[kNt][4];
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) sb[n][i] = ss[n][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKs; ++kk) {
            const uint4 a01 = qw[64 * kk], a23 = qw[64 * kk + 32];
            const uint32_t ah[4] = {a01.x, a01.z, a23.x, a23.z};
            const uint32_t al[4] = {a01.y, a01.w, a23.y, a23.w};
#pragma unroll
            for (int n = 0; n < kNt; ++n) {
                const uint4 bb = k_rec[(kk * kNt + n) * 32 + lane];
                const uint32_t bh[2] = {bb.x, bb.z}, bl[2] = {bb.y, bb.w};
                mma(ss[n], al, bh);
                mma(ss[n], ah, bl);
                mma(sb[n], ah, bh);
            }
        }
        // fragment (n, i): row r0 + 8 (i >> 1), key k_lo + 8 n + 2 t4 +
        // (i & 1)
        const bool edge =
            k_lo + kBK > skv || (causal && k_lo + kBK - 1 > row_lo);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float s = sb[n][i] + ss[n][i];
                if (edge) {
                    const int key = k_lo + 8 * n + 2 * t4 + (i & 1);
                    if (key >= skv || (causal && key > r0 + 8 * (i >> 1)))
                        s = kNegInf;
                }
                sb[n][i] = s;
                mx[i >> 1] = fmaxf(mx[i >> 1], s);
            }
        float mc[2], corr[2], sum[2] = {0.f, 0.f};
        bool dead[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);
            dead[r] = m_new <= kNegInf / 2;
            mc[r] = dead[r] ? 0.f : m_new * scale_log2;
            corr[r] = dead[r] ? 1.f : exp2_ftz(fmaf(m[r], scale_log2, -mc[r]));
            m[r] = m_new;
        }
        // P in float32, split into the A fragments of P V (acc_to_a)
        uint32_t ph[kNt][4], pl[kNt][4];
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = i >> 1;
                const float p =
                    dead[r] ? 0.f
                            : exp2_ftz(fmaf(sb[n][i], scale_log2, -mc[r]));
                sum[r] += p;
                sb[n][i] = p;
            }
            acc_to_a(sb[n], ph[n], pl[n]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];

        // O = O corr + P V, each eight-column tile's kBK keys summed from
        // zero in the tensor cores
#pragma unroll
        for (int w = 0; w < kKs; ++w) {
            float pv[4];
#pragma unroll
            for (int kk = 0; kk < kNt; ++kk) {
                const uint4 bb = v_rec[(kk * kKs + w) * 32 + lane];
                const uint32_t bh[2] = {bb.x, bb.z}, bl[2] = {bb.y, bb.w};
                if (kk == 0)
                    mma(pv, pl[kk], bh, 0.f);
                else
                    mma(pv, pl[kk], bh);
                mma(pv, ph[kk], bl);
                mma(pv, ph[kk], bh);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
                o[w][i] = fmaf(o[w][i], corr[i >> 1], pv[i]);
        }
    }
    cp_async_wait<0>();

    // the rows' log-sum-exp, then O / max(l, 1e-30) through out's strides,
    // rows below Sq and columns below D
    T* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = r0 + 8 * r;
        if (t4 == 0 && row < sq)
            lse[static_cast<int64_t>(bh) * sq + row] =
                m[r] <= kNegInf / 2
                    ? -__int_as_float(0x7f800000)
                    : (m[r] * scale_log2 + log2f(l[r])) * 0.6931471805599453f;
        l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int w = 0; w < kKs; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = r0 + 8 * (i >> 1);
            const int c = 8 * w + 2 * t4 + (i & 1);
            if (row < sq && c < d)
                ob[row * os.s + c] = from_float<T>(o[w][i] * l[i >> 1]);
        }
}

// strides: 12 int64, the (b, h, s) element strides of q, k, v and out.
// vec: q, k and v 16-byte aligned at every row (float32 only).
template <typename T, int W>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int heads, int kv_heads, int sq,
               int skv, int d, const int64_t* st, float scale, int causal,
               int vec, cudaStream_t stream) {
    using S = FwdShape<W>;
    const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
        vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
    const int64_t n_q = (static_cast<int64_t>(sq) + S::kBQ - 1) / S::kBQ;
    if (n_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = flash_fwd_kernel<T, W>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3(batch * heads, static_cast<unsigned>(n_q)), S::kThreads,
             S::kBytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, heads,
        heads / kv_heads, sq, skv, d, qs, ks, vs, os,
        scale * 1.4426950408889634f, causal, vec);
    return static_cast<int>(cudaGetLastError());
}

template <int W>
int fwd_info(int* regs, int* smem, int* local) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, flash_fwd_kernel<float, W>);
    *regs = attr.numRegs;
    *smem = FwdShape<W>::kBytes;
    *local = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(err);
}

// D's bucket: the W the kernels for head dim d are built at
__host__ __device__ constexpr int bucket(int d) {
    return d <= 16    ? 16
           : d <= 32  ? 32
           : d <= 64  ? 64
           : d <= 96  ? 96
           : d <= 128 ? 128
           : d <= 160 ? 160
           : d <= 192 ? 192
                      : 256;
}

}  // namespace tf32x3

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
constexpr float kLn2 = 0.6931471805599453f;

template <int D> struct Layout {   // byte offsets in dynamic shared memory
    // a row of every tile is D padded to whole boxes: TMA zero-fills the
    // columns past D and counts them toward the barrier's bytes all the same
    static constexpr int kBoxes = (D + kBox - 1) / kBox;
    static constexpr int kWidth = kBoxes * kBox;
    static constexpr int kQBytes = kBQ * kWidth * 2;
    static constexpr int kTileBytes = kBK * kWidth * 2;     // one K or V tile
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

// D[64 x 192] += A[64 x 16] B[16 x 192]: A in registers (four bf16x2
// per thread), B MN-major in shared memory (the transpose bit): three
// 64-column boxes, the leading byte offset apart
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O[64 x N] += P[64 x 16] V[16 x N] at the tile width N (D padded to
// whole boxes)
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
    static_assert(N == 64 || N == 128 || N == 192, "no wgmma_pv for N");
    if constexpr (N == 64)
        wgmma_rs_n64(o, a, b);
    else if constexpr (N == 128)
        wgmma_rs_n128(o, a, b);
    else
        wgmma_rs_n192(o, a, b);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   Strides os, int heads, int group, int sq, int skv,
                   float scale_log2, int causal) {
    using L = Layout<D>;
    constexpr int kBoxes = L::kBoxes, kWidth = L::kWidth;
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

    // O at the padded width: the columns past D stay 0 and are not stored
    float o[kWidth / 2];
#pragma unroll
    for (int i = 0; i < kWidth / 2; ++i) o[i] = 0.f;
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
        // (at D 160 the last two in box 2, short of its zero half)
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
            corr[r] = dead[r] ? 1.f : exp2_ftz(m[r] * scale_log2 - mc[r]);
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
                    dead[r] ? 0.f
                            : exp2_ftz(fmaf(sc[i], scale_log2, -mc[r]));
                const float p1 =
                    dead[r] ? 0.f
                            : exp2_ftz(fmaf(sc[i + 1], scale_log2, -mc[r]));
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
        for (int i = 0; i < kWidth / 2; ++i) o[i] *= corr[(i >> 1) & 1];

        // O += P_hi V + P_lo V: 4 k-steps of 16 keys = two 8-row groups
        fence_regs(o);
        wgmma_fence();
        constexpr uint32_t kNextBox = kBK * kRowBytes;   // V's next box
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_pv<kWidth>(
                o, p_hi[kk], smem_desc(v_tile + kk * 16 * kRowBytes, kNextBox));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_pv<kWidth>(
                o, p_lo[kk], smem_desc(v_tile + kk * 16 * kRowBytes, kNextBox));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        mbar_arrive(empty + 8 * s);   // this stage's K and V are read
    }

    // epilogue: the row's log-sum-exp, ln sum exp(S scale) = (m scale
    // log2e + log2 l) ln 2 (-inf for a dead row), then O / max(l, 1e-30)
    // in bf16 through out's strides, the columns below D only (fragment i
    // holds column 8 (i >> 2) + col0)
    __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = r0 + 8 * r;
        if (lane % 4 == 0 && row < sq)
            lse[static_cast<int64_t>(bh) * sq + row] =
                m[r] <= kNegInf / 2
                    ? -__int_as_float(0x7f800000)
                    : (m[r] * scale_log2 + log2f(l[r])) * kLn2;
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
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int batch, int heads, int kv_heads, int sq, int skv,
           const int64_t* st, float scale, int causal, cudaStream_t stream) {
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
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, os, heads,
        heads / kv_heads, sq, skv, scale * kLog2e, causal);
    return static_cast<int>(cudaGetLastError());
}

template <int D> int info(int* regs, int* smem) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, flash_wgmma_kernel<D>);
    *regs = attr.numRegs;
    *smem = Layout<D>::kAlloc;
    return static_cast<int>(err);
}

// --- the tensor-core backward (bf16, D in {64, 128, 160}) -----------------
// Two kernels after the preprocess (simt::prep_launch), 256 threads each:
// two consumer warpgroups and no producer warpgroup, so that ptxas may give
// a thread up to 255 registers (a 384-thread launch caps it at 168, which
// dK and dV's accumulators alone would fill).  Thread 0 issues every TMA
// load into a ring of stages (three where they fit), each with a full and
// an empty mbarrier.  With three, thread 0 refills the stage of the tile
// before the one just computed, which both warpgroups have released by
// then in all but the rarest case, so warpgroup 0's first warp does not
// wait for warpgroup 1 each tile; with two, the stage just computed.
constexpr int kBwdThreads = 256;
constexpr int kBwdRows = 64;      // rows of a streamed tile (q or keys)

template <int D> struct BwdLayout {   // byte offsets in dynamic shared memory
    static constexpr int kBoxes = (D + kBox - 1) / kBox;
    static constexpr int kWidth = kBoxes * kBox;
    static constexpr int kRow = kWidth * 2;   // bytes of a padded tile row
    // dK/dV: at D 160 one warpgroup accumulates dV and the other dK for
    // the same 64 keys (both would not fit one thread's registers: 2 x 96
    // floats); below, each warpgroup owns 64 keys and both sums
    static constexpr bool kSplit = D > 128;
    static constexpr int kKeys = kSplit ? 64 : 128;     // keys a dK/dV block
    // dK/dV pass: K and V [kKeys, W] once; a stage Q and dO [64, W]; then
    // a stage's lse2 and delta [64] floats each
    static constexpr int kKvK = 0;
    static constexpr int kKvV = kKeys * kRow;
    static constexpr int kKvStage = 2 * kKeys * kRow;
    static constexpr int kKvStageBytes = 2 * kBwdRows * kRow;
    static constexpr int kKvStages = 3;   // 195 KB at D 160
    static constexpr int kKvStats = kKvStage + kKvStages * kKvStageBytes;
    static constexpr int kKvBar = kKvStats + kKvStages * 2 * kBwdRows * 4;
    static constexpr int kKvAlloc = kKvBar + 8 * (1 + 2 * kKvStages) + 1024;
    // dQ pass: Q and dO [128, W] once; a stage K and V [64, W] (three
    // stages would take 241 KB at D 160)
    static constexpr int kQRows = 128;
    static constexpr int kQdO = kQRows * kRow;
    static constexpr int kQStage = 2 * kQRows * kRow;
    static constexpr int kQStageBytes = 2 * kBwdRows * kRow;
    static constexpr int kQStages = D > 128 ? 2 : 3;
    static constexpr int kQBar = kQStage + kQStages * kQStageBytes;
    static constexpr int kQAlloc = kQBar + 8 * (1 + 2 * kQStages) + 1024;
};

// After tile t of a ring of `stages` over `total` tiles is computed and
// released: thread 0 waits for the release of the tile `stages - 2`
// before it and refills that tile's stage with the tile `stages` after
// that.  (Tiles 0 .. stages - 1 are issued before the loop.)
template <int kStages, typename Issue>
__device__ __forceinline__ void refill(int t, int total, uint32_t empty,
                                       Issue&& issue) {
    const int r = t - (kStages - 2);
    if (threadIdx.x == 0 && r >= 0 && r + kStages < total) {
        mbar_wait(empty + 8 * (r % kStages), (r / kStages) & 1);
        issue(r + kStages);
    }
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into shared memory at dst, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
        : "memory");
}

// Rows row0 and row0 + 8 of a 64 x W accumulator (fragment i: row row0 +
// 8 ((i >> 1) & 1), column 8 (i >> 2) + col0 + (i & 1)), times mul, in
// bf16 at dst + row * row_stride: rows below `rows`, columns below D.
template <int D, int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N],
                                           __nv_bfloat16* dst,
                                           int64_t row_stride, int row0,
                                           int rows, int col0, float mul) {
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (row >= rows) continue;
        *reinterpret_cast<__nv_bfloat162*>(dst + row * row_stride +
                                           8 * (i >> 2) + col0) =
            __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    }
}

// The same rows in float32 into a [rows, D] partial at dst
template <int D, int N>
__device__ __forceinline__ void store_partial(const float (&acc)[N],
                                              float* dst, int row0, int rows,
                                              int col0, float mul) {
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (row >= rows) continue;
        *reinterpret_cast<float2*>(dst + row * D + 8 * (i >> 2) + col0) =
            make_float2(acc[i] * mul, acc[i + 1] * mul);
    }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ delta,
                     const float* __restrict__ lse2,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                     int splits, Strides dks, Strides dvs, int heads,
                     int kv_heads, int sq, int sq_pad, int skv,
                     float scale_log2, float scale, int causal) {
    using L = BwdLayout<D>;
    constexpr int kBoxes = L::kBoxes, kWidth = L::kWidth, kKeys = L::kKeys;
    constexpr bool kSplit = L::kSplit;
    constexpr int kStages = L::kKvStages;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint8_t* base_ptr = smem_raw + (base - raw);
    const uint32_t kv_full = base + L::kKvBar;
    const uint32_t full = kv_full + 8, empty = full + 8 * kStages;

    // blockIdx.x: the split j of KV head bkv (dkv_splits); blockIdx.y the
    // KV tile, the heaviest (under causal, the first) launched first
    const int split_j = blockIdx.x % splits, bkv = blockIdx.x / splits;
    const int b = bkv / kv_heads, kvh = bkv % kv_heads;
    const int group = heads / kv_heads;
    const int k_lo = blockIdx.y * kKeys;
    const int n_q = (sq + kBwdRows - 1) / kBwdRows;
    // under causal, the q tiles from the one holding row k_lo (row >= key)
    const int qt0 = causal ? min(k_lo / kBwdRows, n_q) : 0;
    const int per = n_q - qt0;
    // (head of the group, q tile) steps: this block's share of the group *
    // per, the larger shares first
    const int all = group * per;
    const int t_begin = split_j * (all / splits) + min(split_j, all % splits);
    const int total = all / splits + (split_j < all % splits ? 1 : 0);

    auto q_dst = [&](int s) {        // Q, then dO at + kBwdRows * kRow
        return base + L::kKvStage + s * L::kKvStageBytes;
    };
    auto stats = [&](int s) {        // lse2 [64], then delta [64]
        return L::kKvStats + s * 2 * kBwdRows * 4;
    };
    auto issue = [&](int t) {   // the block's step t
        const int s = t % kStages;
        const int h = kvh * group + (t_begin + t) / per;
        const int qt = qt0 + (t_begin + t) % per;
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, L::kKvStageBytes + 2 * kBwdRows * 4);
        for (int c = 0; c < kBoxes; ++c) {
            tma_load(q_dst(s) + c * kBwdRows * kRowBytes, &tq, bar,
                     c * kBox, qt * kBwdRows, h, b);
            tma_load(q_dst(s) + kBwdRows * L::kRow + c * kBwdRows * kRowBytes,
                     &tdo, bar, c * kBox, qt * kBwdRows, h, b);
        }
        const int64_t row =
            (static_cast<int64_t>(b) * heads + h) * sq_pad + qt * kBwdRows;
        bulk_load(base + stats(s), lse2 + row, kBwdRows * 4, bar);
        bulk_load(base + stats(s) + kBwdRows * 4, delta + row, kBwdRows * 4,
                  bar);
    };

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, kBwdThreads);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(kv_full, 2 * kKeys * L::kRow);
        for (int c = 0; c < kBoxes; ++c) {
            tma_load(base + L::kKvK + c * kKeys * kRowBytes, &tk, kv_full,
                     c * kBox, k_lo, kvh, b);
            tma_load(base + L::kKvV + c * kKeys * kRowBytes, &tv, kv_full,
                     c * kBox, k_lo, kvh, b);
        }
        for (int t = 0; t < min(total, kStages); ++t) issue(t);
    }
    __syncwarp();

    // warpgroup cw: keys kw_lo .. kw_lo + 63; this thread holds keys key0
    // and key0 + 8 of the S^T fragments, q columns col0 + 8 j (+ 1)
    const int cw = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int kw_lo = k_lo + (kSplit ? 0 : 64 * cw);
    const int key0 = kw_lo + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const bool do_v = !kSplit || cw == 0, do_k = !kSplit || cw == 1;
    constexpr int kAcc = kSplit ? 1 : 2;
    float acc[kAcc][kWidth / 2];
#pragma unroll
    for (int a = 0; a < kAcc; ++a)
#pragma unroll
        for (int i = 0; i < kWidth / 2; ++i) acc[a][i] = 0.f;
    float(&dva)[kWidth / 2] = acc[0];          // (at D 160 one array,
    float(&dka)[kWidth / 2] = acc[kAcc - 1];   //  dV or dK by warpgroup)
    const uint32_t k_tile =
        base + L::kKvK + (kSplit ? 0 : 64 * cw * kRowBytes);
    const uint32_t v_tile =
        base + L::kKvV + (kSplit ? 0 : 64 * cw * kRowBytes);
    constexpr uint32_t kNextBox = kBwdRows * kRowBytes;   // MN-major B boxes

    mbar_wait(kv_full, 0);
    for (int t = 0; t < total; ++t) {
        const int s = t % kStages;
        const int q_lo = (qt0 + (t_begin + t) % per) * kBwdRows;
        const uint32_t q_tile = q_dst(s);
        const uint32_t do_tile = q_tile + kBwdRows * L::kRow;
        mbar_wait(full + 8 * s, (t / kStages) & 1);
        // under causal, a q tile wholly above this warpgroup's keys keeps
        // no pair
        if (!causal || q_lo + kBwdRows - 1 >= kw_lo) {
            // S^T = K Q^T and dP^T = V dO^T: A = K / V rows (K-major), B =
            // the Q / dO tile (N = 64 q rows, K-major)
            float st[32], dpt[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
            fence_regs(st);
            fence_regs(dpt);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                wgmma_ss_n64(
                    st, smem_desc(k_tile + (kk / 4) * kKeys * kRowBytes + off,
                                  16),
                    smem_desc(q_tile + (kk / 4) * kBwdRows * kRowBytes + off,
                              16),
                    kk > 0);
            }
            if (do_k) {
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const uint32_t off = (kk % 4) * 32;
                    wgmma_ss_n64(
                        dpt,
                        smem_desc(v_tile + (kk / 4) * kKeys * kRowBytes + off,
                                  16),
                        smem_desc(
                            do_tile + (kk / 4) * kBwdRows * kRowBytes + off,
                            16),
                        kk > 0);
                }
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(st);
            fence_regs(dpt);

            // P^T = exp2(S^T scale log2e - lse2[col]) and dS^T = P^T o
            // (dP^T - delta[col]), each rounded once to bf16 as the A
            // fragments of the products (k-step kk: fragments 8 kk .. 8 kk
            // + 7, two to a register).  Keys >= Skv and, under causal,
            // key > row are masked; q rows >= Sq have lse2 = +inf (P = 0)
            const float* l2 =
                reinterpret_cast<const float*>(base_ptr + stats(s));
            const float* dl = l2 + kBwdRows;
            const bool edge = kw_lo + 64 > skv ||
                              (causal && kw_lo + 63 > q_lo);
            uint32_t pa[4][4], dsa[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int i = 8 * kk + 2 * j;
                    const int c = 16 * kk + 8 * (j >> 1) + col0;
                    const int key = key0 + 8 * (j & 1);
                    float p0 = exp2_ftz(fmaf(st[i], scale_log2, -l2[c]));
                    float p1 =
                        exp2_ftz(fmaf(st[i + 1], scale_log2, -l2[c + 1]));
                    if (edge) {
                        if (key >= skv || (causal && key > q_lo + c))
                            p0 = 0.f;
                        if (key >= skv || (causal && key > q_lo + c + 1))
                            p1 = 0.f;
                    }
                    pa[kk][j] = bf16x2_bits(__floats2bfloat162_rn(p0, p1));
                    dsa[kk][j] = bf16x2_bits(__floats2bfloat162_rn(
                        p0 * (dpt[i] - dl[c]), p1 * (dpt[i + 1] - dl[c + 1])));
                }
            }

            // dV += P^T dO and dK += dS^T Q: B = the dO / Q tile [64 q
            // rows, W], MN-major (the transpose bit), N = W
            fence_regs(dva);
            fence_regs(dka);
            wgmma_fence();
            if (do_v) {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_pv<kWidth>(
                        dva, pa[kk],
                        smem_desc(do_tile + kk * 16 * kRowBytes, kNextBox));
            }
            if (do_k) {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_pv<kWidth>(
                        dka, dsa[kk],
                        smem_desc(q_tile + kk * 16 * kRowBytes, kNextBox));
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(dva);
            fence_regs(dka);
        }
        mbar_arrive(empty + 8 * s);   // this stage's tiles are read
        refill<kStages>(t, total, empty, issue);
        __syncwarp();
    }

    // dV, and dK = scale dS^T Q, in bf16 through their strides: keys
    // below Skv, columns below D; with splits, this block's float32
    // partials ([2][splits][B * KH][Skv][D], simt::flash_bwd_reduce_kernel)
    if (splits > 1) {
        const int64_t n_part =
            static_cast<int64_t>(gridDim.x / splits) * skv * D;
        float* pk = part + (static_cast<int64_t>(split_j) *
                                (gridDim.x / splits) + bkv) * skv * D;
        if (do_v)
            store_partial<D>(dva, pk + splits * n_part, key0, skv, col0, 1.f);
        if (do_k) store_partial<D>(dka, pk, key0, skv, col0, scale);
        return;
    }
    if (do_v)
        store_rows<D>(dva, dv + b * dvs.b + kvh * dvs.h, dvs.s, key0, skv,
                      col0, 1.f);
    if (do_k)
        store_rows<D>(dka, dk + b * dks.b + kvh * dks.h, dks.s, key0, skv,
                      col0, scale);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ delta,
                    const float* __restrict__ lse2,
                    __nv_bfloat16* __restrict__ dq, Strides dqs, int heads,
                    int group, int sq, int sq_pad, int skv, float scale_log2,
                    float scale, int causal) {
    using L = BwdLayout<D>;
    constexpr int kBoxes = L::kBoxes, kWidth = L::kWidth;
    constexpr int kRows = L::kQRows;
    constexpr int kStages = L::kQStages;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_full = base + L::kQBar;
    const uint32_t full = q_full + 8, empty = full + 8 * kStages;

    const int bh = blockIdx.x;
    const int b = bh / heads, h = bh % heads, kvh = h / group;
    const int q_lo = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
    const int n_kv = (skv + kBwdRows - 1) / kBwdRows;
    const int total =
        causal ? min(n_kv, (q_lo + kRows - 1) / kBwdRows + 1) : n_kv;

    auto kv_dst = [&](int s) {       // K, then V at + kBwdRows * kRow
        return base + L::kQStage + s * L::kQStageBytes;
    };
    auto issue = [&](int t) {
        const int s = t % kStages;
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, L::kQStageBytes);
        for (int c = 0; c < kBoxes; ++c) {
            tma_load(kv_dst(s) + c * kBwdRows * kRowBytes, &tk, bar, c * kBox,
                     t * kBwdRows, kvh, b);
            tma_load(kv_dst(s) + kBwdRows * L::kRow +
                         c * kBwdRows * kRowBytes,
                     &tv, bar, c * kBox, t * kBwdRows, kvh, b);
        }
    };

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, kBwdThreads);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(q_full, 2 * kRows * L::kRow);
        for (int c = 0; c < kBoxes; ++c) {
            tma_load(base + c * kRows * kRowBytes, &tq, q_full, c * kBox,
                     q_lo, h, b);
            tma_load(base + L::kQdO + c * kRows * kRowBytes, &tdo, q_full,
                     c * kBox, q_lo, h, b);
        }
        for (int t = 0; t < min(total, kStages); ++t) issue(t);
    }
    __syncwarp();

    // warpgroup cw: q rows row_lo .. row_lo + 63; this thread holds rows
    // r0 and r0 + 8, key columns col0 + 8 j (+ 1)
    const int cw = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int row_lo = q_lo + 64 * cw;
    const int r0 = row_lo + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const int64_t stat = static_cast<int64_t>(bh) * sq_pad;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        l2[r] = row < sq ? lse2[stat + row] : __int_as_float(0x7f800000);
        dl[r] = row < sq ? delta[stat + row] : 0.f;
    }
    float dqa[kWidth / 2];
#pragma unroll
    for (int i = 0; i < kWidth / 2; ++i) dqa[i] = 0.f;
    const uint32_t q_tile = base + 64 * cw * kRowBytes;
    const uint32_t do_tile = base + L::kQdO + 64 * cw * kRowBytes;
    constexpr uint32_t kNextBox = kBwdRows * kRowBytes;

    mbar_wait(q_full, 0);
    for (int t = 0; t < total; ++t) {
        const int s = t % kStages;
        const int k_lo = t * kBwdRows;
        const uint32_t k_tile = kv_dst(s);
        const uint32_t v_tile = k_tile + kBwdRows * L::kRow;
        mbar_wait(full + 8 * s, (t / kStages) & 1);
        if (!causal || k_lo <= row_lo + 63) {
            // S = Q K^T and dP = dO V^T: A = the Q / dO rows (K-major), B
            // = the K / V tile (N = 64 keys, K-major)
            float sc[32], dp[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
            fence_regs(sc);
            fence_regs(dp);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                wgmma_ss_n64(
                    sc, smem_desc(q_tile + (kk / 4) * kRows * kRowBytes + off,
                                  16),
                    smem_desc(k_tile + (kk / 4) * kBwdRows * kRowBytes + off,
                              16),
                    kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t off = (kk % 4) * 32;
                wgmma_ss_n64(
                    dp, smem_desc(do_tile + (kk / 4) * kRows * kRowBytes + off,
                                  16),
                    smem_desc(v_tile + (kk / 4) * kBwdRows * kRowBytes + off,
                              16),
                    kk > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(sc);
            fence_regs(dp);

            // dS = P o (dP - delta), P = exp2(S scale log2e - lse2), masked
            // as in the dK/dV pass, rounded once to bf16 A fragments
            const bool edge = k_lo + kBwdRows > skv ||
                              (causal && k_lo + kBwdRows - 1 > row_lo);
            uint32_t dsa[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int i = 8 * kk + 2 * j, r = j & 1;
                    const int row = r0 + 8 * r;
                    const int key = k_lo + 16 * kk + 8 * (j >> 1) + col0;
                    float p0 = exp2_ftz(fmaf(sc[i], scale_log2, -l2[r]));
                    float p1 = exp2_ftz(fmaf(sc[i + 1], scale_log2, -l2[r]));
                    if (edge) {
                        if (key >= skv || (causal && key > row)) p0 = 0.f;
                        if (key + 1 >= skv || (causal && key + 1 > row))
                            p1 = 0.f;
                    }
                    dsa[kk][j] = bf16x2_bits(__floats2bfloat162_rn(
                        p0 * (dp[i] - dl[r]), p1 * (dp[i + 1] - dl[r])));
                }
            }

            // dQ += dS K: B = the K tile [64 keys, W], MN-major
            fence_regs(dqa);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_pv<kWidth>(
                    dqa, dsa[kk],
                    smem_desc(k_tile + kk * 16 * kRowBytes, kNextBox));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(dqa);
        }
        mbar_arrive(empty + 8 * s);   // this stage's K and V are read
        refill<kStages>(t, total, empty, issue);
        __syncwarp();
    }

    // dQ = scale dS K in bf16 through dq's strides: rows below Sq
    store_rows<D>(dqa, dq + b * dqs.b + h * dqs.h, dqs.s, r0, sq, col0,
                  scale);
}

// strides as tf32x3::launch_bwd's (q, k, v and dout's TMA-ready); scratch:
// 2 x B x H x sq_pad floats (delta, then lse2); part: with splits > 1, 2 x
// splits x B x KH x Skv x D floats
template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* scratch, float* part, int splits, int batch,
               int heads, int kv_heads, int sq, int skv, const int64_t* st,
               float scale, int causal, cudaStream_t stream) {
    using L = BwdLayout<D>;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    // the dK/dV pass streams 64-row Q / dO tiles past kKeys-row K / V; the
    // dQ pass streams 64-row K / V tiles past 128-row Q / dO
    CUtensorMap q64, do64, k_kv, v_kv, q128, do128, k64, v64;
    if (!make_map(encode, &q64, q, D, sq, heads, batch, st, kBwdRows) ||
        !make_map(encode, &do64, dout, D, sq, heads, batch, st + 9,
                  kBwdRows) ||
        !make_map(encode, &k_kv, k, D, skv, kv_heads, batch, st + 3,
                  L::kKeys) ||
        !make_map(encode, &v_kv, v, D, skv, kv_heads, batch, st + 6,
                  L::kKeys) ||
        !make_map(encode, &q128, q, D, sq, heads, batch, st, L::kQRows) ||
        !make_map(encode, &do128, dout, D, sq, heads, batch, st + 9,
                  L::kQRows) ||
        !make_map(encode, &k64, k, D, skv, kv_heads, batch, st + 3,
                  kBwdRows) ||
        !make_map(encode, &v64, v, D, skv, kv_heads, batch, st + 6,
                  kBwdRows))
        return static_cast<int>(cudaErrorInvalidValue);
    const Strides os{st[12], st[13], st[14]}, dqs{st[15], st[16], st[17]},
        dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]},
        dos{st[9], st[10], st[11]};
    const int sq_pad = (sq + simt::kPad - 1) / simt::kPad * simt::kPad;
    float* delta = scratch;
    float* lse2 = scratch + static_cast<int64_t>(batch) * heads * sq_pad;
    int err = simt::prep_launch<__nv_bfloat16>(
        out, dout, lse, delta, lse2, batch, heads, sq, D,
        simt::Strides{os.b, os.h, os.s}, simt::Strides{dos.b, dos.h, dos.s},
        stream);
    if (err != 0) return err;
    const float scale_log2 = scale * kLog2e;

    auto dkv = flash_bwd_dkv_kernel<D>;
    cudaError_t e = cudaFuncSetAttribute(
        dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kKvAlloc);
    if (e != cudaSuccess) return static_cast<int>(e);
    dkv<<<dim3(splits * batch * kv_heads, (skv + L::kKeys - 1) / L::kKeys),
          kBwdThreads, L::kKvAlloc, stream>>>(
        q64, k_kv, v_kv, do64, delta, lse2,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        part, splits, dks, dvs, heads, kv_heads, sq, sq_pad, skv, scale_log2,
        scale, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (splits > 1) {
        err = simt::reduce_launch<__nv_bfloat16>(
            part, dk, dv, splits, batch, kv_heads, skv, D,
            simt::Strides{dks.b, dks.h, dks.s},
            simt::Strides{dvs.b, dvs.h, dvs.s}, stream);
        if (err != 0) return err;
    }

    auto dqk = flash_bwd_dq_kernel<D>;
    e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kQAlloc);
    if (e != cudaSuccess) return static_cast<int>(e);
    dqk<<<dim3(batch * heads, (sq + L::kQRows - 1) / L::kQRows), kBwdThreads,
          L::kQAlloc, stream>>>(
        q128, k64, v64, do128, delta, lse2, static_cast<__nv_bfloat16*>(dq),
        dqs, heads, heads / kv_heads, sq, sq_pad, skv, scale_log2, scale,
        causal);
    return static_cast<int>(cudaGetLastError());
}

template <int D> int bwd_info(int which, int* regs, int* smem) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        which == 0 ? cudaFuncGetAttributes(&attr, flash_bwd_dkv_kernel<D>)
                   : cudaFuncGetAttributes(&attr, flash_bwd_dq_kernel<D>);
    *regs = attr.numRegs;
    *smem = which == 0 ? BwdLayout<D>::kKvAlloc : BwdLayout<D>::kQAlloc;
    return static_cast<int>(err);
}

}  // namespace tc

// The forward's tf32x3 kernel for D's bucket (float32, or bf16 at any D)
template <typename T>
int tf32x3_fwd_dispatch(const void* q, const void* k, const void* v,
                        void* out, float* lse, int batch, int heads,
                        int kv_heads, int sq, int skv, int d,
                        const int64_t* st, float scale, int causal, int vec,
                        cudaStream_t s) {
#define FA_TF32X3_FWD(W)                                                   \
    case W:                                                                \
        return tf32x3::launch_fwd<T, W>(q, k, v, out, lse, batch, heads,   \
                                        kv_heads, sq, skv, d, st, scale,   \
                                        causal, vec, s);
    switch (tf32x3::bucket(d)) {
        FA_TF32X3_FWD(16)
        FA_TF32X3_FWD(32)
        FA_TF32X3_FWD(64)
        FA_TF32X3_FWD(96)
        FA_TF32X3_FWD(128)
        FA_TF32X3_FWD(160)
        FA_TF32X3_FWD(192)
        FA_TF32X3_FWD(256)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FA_TF32X3_FWD
}

// dtype: 0 float32, 1 bfloat16.  strides: 12 int64, the (b, h, s) element
// strides of q, k, v and out in that order (d is contiguous).  lse: float32
// [B, H, Sq], contiguous.  The tf32x3 kernel (namespace tf32x3, forward).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int batch, int heads, int kv_heads,
                                      int sq, int skv, int d,
                                      const int64_t* strides, float scale,
                                      int causal, void* stream) {
    if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0 || d < 1 ||
        d > 256 || sq < 1 || skv < 1 ||
        static_cast<int64_t>(batch) * heads > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: {
            // 16-byte copies where every row of q, k and v starts on 16 bytes
            bool vec = d % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16 == 0;
            for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 4 == 0;
            return tf32x3_fwd_dispatch<float>(q, k, v, out, lse, batch, heads,
                                              kv_heads, sq, skv, d, strides,
                                              scale, causal, vec, s);
        }
        case 1:
            return tf32x3_fwd_dispatch<__nv_bfloat16>(
                q, k, v, out, lse, batch, heads, kv_heads, sq, skv, d,
                strides, scale, causal, 0, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// bf16 q, k, v, out with D 64, 128 or 160 (the wrapper checks the 16-byte
// alignment TMA needs: base pointers, and the (b, h, s) strides of q, k
// and v in bytes).  strides and lse as flash_attention_launch.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out,
                                            float* lse, int batch, int heads,
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
            return tc::launch<64>(q, k, v, out, lse, batch, heads, kv_heads,
                                  sq, skv, strides, scale, causal, s);
        case 128:
            return tc::launch<128>(q, k, v, out, lse, batch, heads, kv_heads,
                                   sq, skv, strides, scale, causal, s);
        case 160:
            return tc::launch<160>(q, k, v, out, lse, batch, heads, kv_heads,
                                   sq, skv, strides, scale, causal, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The backward, three launches (delta and lse2, dK/dV, dQ), four with
// splits > 1 (the partials' sum after dK/dV): dq, dk and dv of the forward
// whose out and lse are given, from the output gradient dout (q's shape
// and dtype).  strides: 24 int64, the (b, h, s) element strides of q, k,
// v, dout, out, dq, dk and dv in that order.  scratch: 2 x B x H x sq_pad
// floats, sq_pad = Sq rounded up to 64; part: with splits > 1, 2 x splits
// x B x KH x Skv x D floats (else unused).  dtype as
// flash_attention_launch: float32, or bf16 at any D (tf32x3).
template <typename T>
int tf32x3_dispatch(const void* q, const void* k, const void* v,
                    const void* out, const float* lse, const void* dout,
                    void* dq, void* dk, void* dv, float* scratch, float* part,
                    int splits, int batch, int heads, int kv_heads, int sq,
                    int skv, int d, const int64_t* st, float scale,
                    int causal, cudaStream_t s) {
#define FA_TF32X3(W)                                                       \
    case W:                                                                \
        return tf32x3::launch_bwd<T, W>(q, k, v, out, lse, dout, dq, dk,   \
                                        dv, scratch, part, splits, batch,  \
                                        heads, kv_heads, sq, skv, d, st,   \
                                        scale, causal, s);
    switch (tf32x3::bucket(d)) {
        FA_TF32X3(16)
        FA_TF32X3(32)
        FA_TF32X3(64)
        FA_TF32X3(96)
        FA_TF32X3(128)
        FA_TF32X3(160)
        FA_TF32X3(192)
        FA_TF32X3(256)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FA_TF32X3
}

extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* scratch, float* part, int splits, int batch, int heads,
    int kv_heads, int sq, int skv, int d, const int64_t* strides,
    float scale, int causal, void* stream) {
    if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0 || d < 1 ||
        d > 256 || sq < 1 || skv < 1 || splits < 1 ||
        (splits > 1 && part == nullptr) ||
        static_cast<int64_t>(batch) * heads > 65535 ||
        static_cast<int64_t>(splits) * batch * kv_heads > 2147483647 ||
        (skv + 63) / 64 > 65535 || (sq + 63) / 64 > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0:
            return tf32x3_dispatch<float>(q, k, v, out, lse, dout, dq, dk, dv,
                                          scratch, part, splits, batch, heads,
                                          kv_heads, sq, skv, d, strides,
                                          scale, causal, s);
        case 1:
            return tf32x3_dispatch<__nv_bfloat16>(
                q, k, v, out, lse, dout, dq, dk, dv, scratch, part, splits,
                batch, heads, kv_heads, sq, skv, d, strides, scale, causal,
                s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The tensor-core backward: bf16 with D 64, 128 or 160; q, k, v and dout
// 16-byte aligned for TMA (the wrapper checks).  Arguments as
// flash_attention_bwd_launch's, without the dtype.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* out,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* scratch, float* part, int splits, int batch, int heads,
    int kv_heads, int sq, int skv, int d, const int64_t* strides,
    float scale, int causal, void* stream) {
    if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0 || sq < 1 ||
        skv < 1 || splits < 1 || (splits > 1 && part == nullptr) ||
        static_cast<int64_t>(batch) * heads > 65535 ||
        static_cast<int64_t>(splits) * batch * kv_heads > 2147483647 ||
        (skv + 63) / 64 > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 64:
            return tc::launch_bwd<64>(q, k, v, out, lse, dout, dq, dk, dv,
                                      scratch, part, splits, batch, heads,
                                      kv_heads, sq, skv, strides, scale,
                                      causal, s);
        case 128:
            return tc::launch_bwd<128>(q, k, v, out, lse, dout, dq, dk, dv,
                                       scratch, part, splits, batch, heads,
                                       kv_heads, sq, skv, strides, scale,
                                       causal, s);
        case 160:
            return tc::launch_bwd<160>(q, k, v, out, lse, dout, dq, dk, dv,
                                       scratch, part, splits, batch, heads,
                                       kv_heads, sq, skv, strides, scale,
                                       causal, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// What the tensor-core kernel for head dim d holds per block: registers a
// thread at launch (before setmaxnreg moves them) and dynamic shared
// memory in bytes.  Returns a CUDA error code.
extern "C" int flash_attention_wgmma_info(int d, int* regs, int* smem) {
    switch (d) {
        case 64: return tc::info<64>(regs, smem);
        case 128: return tc::info<128>(regs, smem);
        case 160: return tc::info<160>(regs, smem);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The same for the tensor-core backward's dK/dV (which 0) and dQ (which
// 1) kernels.
extern "C" int flash_attention_bwd_wgmma_info(int d, int which, int* regs,
                                              int* smem) {
    switch (d) {
        case 64: return tc::bwd_info<64>(which, regs, smem);
        case 128: return tc::bwd_info<128>(which, regs, smem);
        case 160: return tc::bwd_info<160>(which, regs, smem);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// What the tf32x3 forward for head dim d (float32 inputs) holds: registers
// a thread, dynamic shared memory a block in bytes, and local memory a
// thread in bytes (spills; 0 when none).  Returns a CUDA error code.
extern "C" int flash_attention_tf32x3_info(int d, int* regs, int* smem,
                                           int* local) {
    switch (d < 1 || d > 256 ? 0 : tf32x3::bucket(d)) {
        case 16: return tf32x3::fwd_info<16>(regs, smem, local);
        case 32: return tf32x3::fwd_info<32>(regs, smem, local);
        case 64: return tf32x3::fwd_info<64>(regs, smem, local);
        case 96: return tf32x3::fwd_info<96>(regs, smem, local);
        case 128: return tf32x3::fwd_info<128>(regs, smem, local);
        case 160: return tf32x3::fwd_info<160>(regs, smem, local);
        case 192: return tf32x3::fwd_info<192>(regs, smem, local);
        case 256: return tf32x3::fwd_info<256>(regs, smem, local);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The same for the tf32x3 backward's dK/dV (which 0) and dQ (which 1)
// kernels built for head dim d (float32 inputs).
extern "C" int flash_attention_bwd_tf32x3_info(int d, int which, int* regs,
                                               int* smem) {
    switch (d < 1 || d > 256 ? 0 : tf32x3::bucket(d)) {
        case 16: return tf32x3::info<16>(which, regs, smem);
        case 32: return tf32x3::info<32>(which, regs, smem);
        case 64: return tf32x3::info<64>(which, regs, smem);
        case 96: return tf32x3::info<96>(which, regs, smem);
        case 128: return tf32x3::info<128>(which, regs, smem);
        case 160: return tf32x3::info<160>(which, regs, smem);
        case 192: return tf32x3::info<192>(which, regs, smem);
        case 256: return tf32x3::info<256>(which, regs, smem);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
