// The MoE combine as a gather: y[t] = sum_j w[t, e_j] out[slot(t, j)].
//
// Replaces no Pallas kernel: the reference's combine is XLA's scatter-add
// (`.at[].add`, src/repro/models/moe.py:92-95), which the port first ran
// as a bf16 `index_add_` over every [E, C] capacity slot.  Here each token
// reads only the rows of the slots that took it, so neither the padding
// slots nor the dropped assignments cost a byte, and each output row is
// written once, with no atomics.
//
// Inputs (route's, as moe_ffn has them): out [E, C, D] (bf16, fp16 or
// float32, the expert outputs), combine_w [T, E] float32 (the gates),
// gate_idx [T, k] int64 (each token's experts), token_ids [E, C] int64 and
// gathered_mask [E, C] float32 (each slot's token, 0 where padding).
//
// Two kernels, after a memset of the slot map [T, k] int32 to -1:
//
//   1. slot_map_kernel: one thread a slot; a slot that holds a token t of
//      expert e finds j with gate_idx[t, j] == e and writes slot(t, j) =
//      e C + s.  An assignment no slot took stays -1.
//   2. combine_kernel: each token's row of y, from its k slots in the
//      order j = 0..k-1, summed in float32 registers with the float32
//      gate as it is (not rounded to bf16 first), rounded once on the
//      store.  The order is fixed, so two calls are bit-equal.
//
// What bounds it on the H100: bytes.  A token reads its kept rows (D x 2
// bytes each in bf16: 2 KB at granite's D 1,024), writes one row, and
// reads a few bytes of indices and gates: at 3.35 TB/s that is ~0.1 us a
// token for granite's top-8.  So the design keeps many bytes in flight:
// a thread owns R 16-byte vectors of a row (neighbouring lanes on
// neighbouring addresses) and issues the loads of G = 8 / R slots at once
// before it sums any of them, 8 loads of 16 bytes a thread.  R is chosen
// from k and D by the wrapper (kernel.py, vectors_a_thread): R = 8 / k
// rounded down to a power of two, halved until it divides the row's
// vectors, so a top-2 model
// (phi3.5-moe) keeps as many loads in flight as a top-8 one.  A token is
// D x size / 16 / R threads of 256-thread blocks: 128 threads at granite's
// shape (two tokens a block), 128 at phi3.5-moe's D 4,096 and R 4.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() after its launches (or the memset's error).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 8;     // 16-byte row loads a thread keeps in flight

// 16 bytes of T <-> N floats.
template <typename T> struct Pack;

template <> struct Pack<float> {
    static constexpr int N = 4;
    __device__ static void fma(float* acc, float w, uint4 v) {
        acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
        acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
        acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
        acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
    }
    __device__ static uint4 pack(const float* a) {
        return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                          __float_as_uint(a[2]), __float_as_uint(a[3]));
    }
};

// bf16: element 2i is the low half of word i; widening is a shift.
template <> struct Pack<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static void fma2(float* acc, float w, uint32_t x) {
        acc[0] = fmaf(w, __uint_as_float(x << 16), acc[0]);
        acc[1] = fmaf(w, __uint_as_float(x & 0xffff0000u), acc[1]);
    }
    __device__ static void fma(float* acc, float w, uint4 v) {
        fma2(acc, w, v.x);
        fma2(acc + 2, w, v.y);
        fma2(acc + 4, w, v.z);
        fma2(acc + 6, w, v.w);
    }
    __device__ static uint32_t pack2(float lo, float hi) {
        return static_cast<uint32_t>(
                   __bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
               (static_cast<uint32_t>(
                    __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
    }
    __device__ static uint4 pack(const float* a) {
        return make_uint4(pack2(a[0], a[1]), pack2(a[2], a[3]),
                          pack2(a[4], a[5]), pack2(a[6], a[7]));
    }
};

template <> struct Pack<__half> {
    static constexpr int N = 8;
    __device__ static void fma2(float* acc, float w, uint32_t x) {
        acc[0] = fmaf(w, __half2float(__ushort_as_half(
                             static_cast<unsigned short>(x & 0xffffu))),
                      acc[0]);
        acc[1] = fmaf(w, __half2float(__ushort_as_half(
                             static_cast<unsigned short>(x >> 16))),
                      acc[1]);
    }
    __device__ static void fma(float* acc, float w, uint4 v) {
        fma2(acc, w, v.x);
        fma2(acc + 2, w, v.y);
        fma2(acc + 4, w, v.z);
        fma2(acc + 6, w, v.w);
    }
    __device__ static uint32_t pack2(float lo, float hi) {
        return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(lo))) |
               (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(hi)))
                << 16);
    }
    __device__ static uint4 pack(const float* a) {
        return make_uint4(pack2(a[0], a[1]), pack2(a[2], a[3]),
                          pack2(a[4], a[5]), pack2(a[6], a[7]));
    }
};

__device__ __forceinline__ int64_t ldg64(const int64_t* p) {
    return __ldg(reinterpret_cast<const long long*>(p));
}

__global__ void __launch_bounds__(kThreads)
slot_map_kernel(const int64_t* __restrict__ token_ids,
                const float* __restrict__ gathered_mask,
                const int64_t* __restrict__ gate_idx, int64_t n_slots, int c,
                int k, int32_t* __restrict__ slot_map) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) +
                      threadIdx.x;
    if (i >= n_slots || __ldg(gathered_mask + i) == 0.0f) return;
    const int64_t t = ldg64(token_ids + i);
    const int64_t e = i / c;
    const int64_t* g = gate_idx + t * k;
    for (int j = 0; j < k; ++j) {
        if (ldg64(g + j) == e) {
            slot_map[t * k + j] = static_cast<int32_t>(i);
            return;
        }
    }
}

// A thread owns vectors lane, lane + P, ..., lane + (R - 1) P of token
// tok's row, P = vecs / R the threads a token.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const uint4* __restrict__ out,
               const float* __restrict__ combine_w,
               const int32_t* __restrict__ slot_map, int64_t n_tokens,
               int n_experts, int c, int vecs, int k,
               uint4* __restrict__ y) {
    constexpr int N = Pack<T>::N;
    constexpr int G = kLoads / R;          // slots a round
    const int per_token = vecs / R;
    const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) +
                      threadIdx.x;
    const int64_t tok = i / per_token;
    if (tok >= n_tokens) return;
    const int lane = static_cast<int>(i - tok * per_token);
    const int32_t* map = slot_map + tok * k;
    const float* w_row = combine_w + tok * n_experts;
    float acc[R][N];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int n = 0; n < N; ++n) acc[r][n] = 0.0f;
    }
    for (int j0 = 0; j0 < k; j0 += G) {
        int32_t s[G];
        float w[G];
        uint4 v[G][R];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            s[g] = j0 + g < k ? __ldg(map + j0 + g) : -1;
        }
        // every row load of the round issued before any sum
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (s[g] >= 0) {
                w[g] = __ldg(w_row + s[g] / c);
                const uint4* row = out + static_cast<int64_t>(s[g]) * vecs +
                                   lane;
#pragma unroll
                for (int r = 0; r < R; ++r) v[g][r] = __ldg(row + r * per_token);
            }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (s[g] >= 0) {
#pragma unroll
                for (int r = 0; r < R; ++r) Pack<T>::fma(acc[r], w[g], v[g][r]);
            }
        }
    }
    uint4* dst = y + tok * vecs + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[r * per_token] = Pack<T>::pack(acc[r]);
}

template <typename T, int R>
void launch_combine(const void* out, const float* combine_w,
                    const int32_t* slot_map, int64_t t, int e, int c,
                    int vecs, int k, void* y, cudaStream_t st) {
    const int64_t threads = t * (vecs / R);
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    combine_kernel<T, R><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(out), combine_w, slot_map, t, e, c, vecs,
        k, static_cast<uint4*>(y));
}

template <typename T>
void launch_combine(int r, const void* out, const float* combine_w,
                    const int32_t* slot_map, int64_t t, int e, int c,
                    int vecs, int k, void* y, cudaStream_t st) {
    switch (r) {
        case 8: launch_combine<T, 8>(out, combine_w, slot_map, t, e, c,
                                     vecs, k, y, st); break;
        case 4: launch_combine<T, 4>(out, combine_w, slot_map, t, e, c,
                                     vecs, k, y, st); break;
        case 2: launch_combine<T, 2>(out, combine_w, slot_map, t, e, c,
                                     vecs, k, y, st); break;
        default: launch_combine<T, 1>(out, combine_w, slot_map, t, e, c,
                                      vecs, k, y, st); break;
    }
}

}  // namespace

// dtype: 0 float32, 1 bf16, 2 fp16 (out's and y's); r: the 16-byte
// vectors a thread owns (1, 2, 4 or 8, dividing D x size / 16).
// slot_map: T k int32 of scratch.  Returns the first CUDA error, 0 if
// none.
extern "C" int moe_combine_launch(const void* out, int dtype,
                                  const float* combine_w,
                                  const int64_t* gate_idx,
                                  const int64_t* token_ids,
                                  const float* gathered_mask, int64_t t,
                                  int e, int c, int d, int k, int r,
                                  int32_t* slot_map, void* y, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(
        slot_map, 0xff, static_cast<size_t>(t) * k * sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t n_slots = static_cast<int64_t>(e) * c;
    slot_map_kernel<<<static_cast<unsigned>((n_slots + kThreads - 1) /
                                            kThreads),
                      kThreads, 0, st>>>(token_ids, gathered_mask, gate_idx,
                                         n_slots, c, k, slot_map);
    const int size = dtype == 0 ? 4 : 2;
    const int vecs = d * size / 16;
    if (dtype == 0) {
        launch_combine<float>(r, out, combine_w, slot_map, t, e, c, vecs, k,
                              y, st);
    } else if (dtype == 1) {
        launch_combine<__nv_bfloat16>(r, out, combine_w, slot_map, t, e, c,
                                      vecs, k, y, st);
    } else {
        launch_combine<__half>(r, out, combine_w, slot_map, t, e, c, vecs, k,
                               y, st);
    }
    return static_cast<int>(cudaGetLastError());
}
