// Kernel K5: flash attention forward (online softmax), GQA, causal.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_kernel, wrapped by ops.flash_attention
// and ops.flash_attention_bshd).  The TPU version runs a grid of
// (batch * head, q block, kv block) whose kv axis is sequential, carrying
// the float32 running max m, sum l and accumulator in VMEM scratch and
// feeding 128-wide tiles to the MXU.  Here:
//   * one block of 256 threads owns one (batch * head, 64-row q tile) and
//     walks the kv tiles in a loop, so the running state stays in
//     registers: each thread owns 4 query rows x (4 score columns,
//     D / 16 output columns);
//   * K (transposed) and V tiles of 64 keys stream through shared memory,
//     one after the other in one buffer, next to the scaled Q tile and the
//     64 x 64 tile of probabilities P;
//   * scores, max, sum and accumulator are float32 whatever the input
//     type; the output is written in the input type (float32 or bf16,
//     rounded to nearest even);
//   * GQA maps head h to kv head h / (H / KH);
//   * causal (top-left aligned, row >= col, as the reference) stops at the
//     last tile that touches the diagonal: tiles entirely above it are
//     never loaded.  The reference's dead-row guard is kept: a row whose
//     running max is still the -1e30 mask value takes p = 0, corr = 1;
//   * ragged Sq and Skv are masked here: keys >= Skv score -1e30 in every
//     mode, so no padding and no fallback are needed;
//   * q, k, v and out are read and written through their strides, so the
//     model's [B, S, H, D] layout needs no transpose copy.
//
// What bounds it on the H100: operations, 4 B H Sq Skv D (halved when
// causal) against the bf16 tensor-core peak.  This first version computes
// both products with scalar float32 FMAs from shared memory and uses no
// tensor cores, so it runs far from that bound; mma / wgmma tiles are the
// next step.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() after its launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

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
