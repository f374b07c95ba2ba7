// The fused EdgeConv neighbour gather-reduce, for Hopper (sm_90a).
//
// Replaces scripts/prof/prof_fused_gather.py:pallas_gather_max (P5, kernel
// body _kernel), which computes out[b, n, f] = max_k a[b, idx[b, n, k], f]
// without storing the (B, N, k, F) neighbour tensor, and the XLA gather +
// reductions of fissure_segmentation_tpu/ops/fused_edge.py:_gather_reduce
// and fused_edge_eval that the TPU kernel was meant to fuse. For a
// (B, N, C) table `a` (float32 or bfloat16, C <= 256) and indices (B, N, K)
// int32 it returns, per (b, n, c) and over k = 0 .. K - 1 in order:
//
//   want 0 ("max"):     max
//   want 1 ("extrema"): max, min
//   want 2 ("all"):     max, min, argmax, argmin (int32, the FIRST slot of
//                       the extremum), and the float32 sum s1 and sum of
//                       squares s2, each added from 0 in k order with
//                       __fadd_rn / __fmul_rn (the library is built with
//                       -fmad=false)
//
// max and min are in a's dtype. A NaN wins a comparison against a number and
// loses against an earlier NaN, so max, min and their slots propagate the
// first NaN as jnp.max and jnp.argmax do. Row of a neighbour: the flat index
// f = b * N + idx, with f += B * N once if f < 0 and then clamped into
// [0, B * N), as the JAX package's flat gather (`x.reshape(B*N, C)[f]`)
// normalises and clamps it. The plain version (kernels/gather_reduce.py:
// gather_reduce_plain) runs the same comparisons and roundings in the same
// order, so the two are bit-equal in every output.
//
// What bounds it: it must read `a` and idx once and write the outputs once
// (at B=32, N=2048, K=40, C=64 in float32 and want 2: 0.13 GB, 0.04 ms at
// 3.35 TB/s). It reads each row of `a` K times, but a cloud's table (N * C
// values, 512 KB in float32 at N=2048, C=64) stays in the 50 MB L2, so the
// K-fold re-reads are L2 traffic, not device-memory traffic.
//
// Design: one warp per point (b, n). The lanes read the point's K indices
// 32 at a time (one coalesced load), each computes its flat row, and the
// rows are broadcast with __shfl_sync. Lane l owns channels [l * CPL,
// l * CPL + CPL) (CPL = 1, 2, 4 or 8, the least with 32 * CPL >= C), read
// as one 2- to 32-byte vector when C is a multiple of CPL and `a` is
// aligned to it; GR_UNROLL rows are loaded before any is reduced, so that
// several loads are in flight. The running max/min/slots/sums live in
// registers; nothing is staged in shared memory (TMA staging of the table
// and tuning are later work).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define GR_WARPS 8      // points per block: one warp each
#define GR_MAX_C 256    // 32 lanes x 8 channels
#define GR_UNROLL 4     // rows loaded before they are reduced

template <typename T, int CPL>
struct alignas(sizeof(T) * CPL) Pack {
    T v[CPL];
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);   // exact: v came from a bfloat16
}

// v[i] = row[c0 + i] for the channels this lane owns (0 past C)
template <typename T, int CPL>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int c0,
                                         int c, bool vec, float* v) {
    if (vec) {
        if (c0 < c) {
            const Pack<T, CPL> p =
                *reinterpret_cast<const Pack<T, CPL>*>(row + c0);
#pragma unroll
            for (int i = 0; i < CPL; ++i) v[i] = to_f32<T>(p.v[i]);
        } else {
#pragma unroll
            for (int i = 0; i < CPL; ++i) v[i] = 0.0f;
        }
    } else {
#pragma unroll
        for (int i = 0; i < CPL; ++i)
            v[i] = c0 + i < c ? to_f32<T>(row[c0 + i]) : 0.0f;
    }
}

template <typename U, int CPL>
__device__ __forceinline__ void store_row(U* __restrict__ row, int c0, int c,
                                          bool vec, const U* v) {
    if (vec) {
        if (c0 < c) {
            Pack<U, CPL> p;
#pragma unroll
            for (int i = 0; i < CPL; ++i) p.v[i] = v[i];
            *reinterpret_cast<Pack<U, CPL>*>(row + c0) = p;
        }
    } else {
#pragma unroll
        for (int i = 0; i < CPL; ++i)
            if (c0 + i < c) row[c0 + i] = v[i];
    }
}

// x replaces the running extremum e iff it is beyond it, or x is the first
// NaN (x != x) while e is still a number
__device__ __forceinline__ bool beats_max(float x, float e) {
    return x > e || (x != x && e == e);
}
__device__ __forceinline__ bool beats_min(float x, float e) {
    return x < e || (x != x && e == e);
}

template <typename T, int CPL, int WANT>
__global__ void __launch_bounds__(GR_WARPS * 32)
gather_reduce_kernel(const T* __restrict__ a, const int32_t* __restrict__ idx,
                     T* __restrict__ mx_out, T* __restrict__ mn_out,
                     int32_t* __restrict__ am_out,
                     int32_t* __restrict__ amn_out,
                     float* __restrict__ s1_out, float* __restrict__ s2_out,
                     long long points, int n, int kk, int c, bool vec) {
    const long long p =
        (long long)blockIdx.x * GR_WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (p >= points) return;   // warp-uniform: the shuffles stay full
    const long long base = (p / n) * (long long)n;
    const int c0 = lane * CPL;
    float mx[CPL], mn[CPL], s1[CPL], s2[CPL];
    int am[CPL], amn[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
        mx[i] = -INFINITY;
        mn[i] = INFINITY;
        am[i] = amn[i] = 0;
        s1[i] = s2[i] = 0.0f;
    }
    const int32_t* ip = idx + p * (long long)kk;
    for (int k0 = 0; k0 < kk; k0 += 32) {
        const int cnt = min(32, kk - k0);
        long long row = 0;
        if (lane < cnt) {
            long long f = base + ip[k0 + lane];
            if (f < 0) f += points;
            row = f < 0 ? 0 : (f >= points ? points - 1 : f);
        }
        for (int j = 0; j < cnt; j += GR_UNROLL) {
            float v[GR_UNROLL][CPL];
#pragma unroll
            for (int u = 0; u < GR_UNROLL; ++u) {
                const long long r =
                    __shfl_sync(0xffffffffu, row, j + u < cnt ? j + u : j);
                load_row<T, CPL>(a + r * c, c0, c, vec, v[u]);
            }
#pragma unroll
            for (int u = 0; u < GR_UNROLL; ++u) {
                if (j + u >= cnt) break;
                const int k = k0 + j + u;
#pragma unroll
                for (int i = 0; i < CPL; ++i) {
                    const float x = v[u][i];
                    if (beats_max(x, mx[i])) {
                        mx[i] = x;
                        am[i] = k;
                    }
                    if (WANT >= 1 && beats_min(x, mn[i])) {
                        mn[i] = x;
                        amn[i] = k;
                    }
                    if (WANT == 2) {
                        s1[i] = __fadd_rn(s1[i], x);
                        s2[i] = __fadd_rn(s2[i], __fmul_rn(x, x));
                    }
                }
            }
        }
    }
    const long long o = p * (long long)c;
    T t[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) t[i] = from_f32<T>(mx[i]);
    store_row<T, CPL>(mx_out + o, c0, c, vec, t);
    if (WANT >= 1) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) t[i] = from_f32<T>(mn[i]);
        store_row<T, CPL>(mn_out + o, c0, c, vec, t);
    }
    if (WANT == 2) {
        store_row<int32_t, CPL>(am_out + o, c0, c, vec, am);
        store_row<int32_t, CPL>(amn_out + o, c0, c, vec, amn);
        store_row<float, CPL>(s1_out + o, c0, c, vec, s1);
        store_row<float, CPL>(s2_out + o, c0, c, vec, s2);
    }
}

template <typename T, int CPL>
static void launch(const void* a, const int32_t* idx, void* mx, void* mn,
                   int32_t* am, int32_t* amn, float* s1, float* s2,
                   long long points, int n, int kk, int c, int want,
                   cudaStream_t st) {
    const T* ap = (const T*)a;
    // a vector per lane needs every row start aligned to it; the outputs
    // are fresh allocations with the same row length
    const bool vec = c % CPL == 0 &&
                     (uintptr_t)a % (sizeof(T) * CPL) == 0;
    const dim3 grid((unsigned int)((points + GR_WARPS - 1) / GR_WARPS));
    const dim3 block(GR_WARPS * 32);
    if (want == 0)
        gather_reduce_kernel<T, CPL, 0><<<grid, block, 0, st>>>(
            ap, idx, (T*)mx, (T*)mn, am, amn, s1, s2, points, n, kk, c, vec);
    else if (want == 1)
        gather_reduce_kernel<T, CPL, 1><<<grid, block, 0, st>>>(
            ap, idx, (T*)mx, (T*)mn, am, amn, s1, s2, points, n, kk, c, vec);
    else
        gather_reduce_kernel<T, CPL, 2><<<grid, block, 0, st>>>(
            ap, idx, (T*)mx, (T*)mn, am, amn, s1, s2, points, n, kk, c, vec);
}

template <typename T>
static void launch_c(const void* a, const int32_t* idx, void* mx, void* mn,
                     int32_t* am, int32_t* amn, float* s1, float* s2,
                     long long points, int n, int kk, int c, int want,
                     cudaStream_t st) {
    if (c <= 32)
        launch<T, 1>(a, idx, mx, mn, am, amn, s1, s2, points, n, kk, c, want, st);
    else if (c <= 64)
        launch<T, 2>(a, idx, mx, mn, am, amn, s1, s2, points, n, kk, c, want, st);
    else if (c <= 128)
        launch<T, 4>(a, idx, mx, mn, am, amn, s1, s2, points, n, kk, c, want, st);
    else
        launch<T, 8>(a, idx, mx, mn, am, amn, s1, s2, points, n, kk, c, want, st);
}

// a: (b * n, c) float32 (bf16 == 0) or bfloat16 (bf16 == 1); idx: (b * n,
// kk) int32; mx (and mn for want >= 1): (b * n, c) in a's dtype; am, amn
// int32 and s1, s2 float32, (b * n, c), for want == 2 (else may be null).
// All contiguous device memory; launches on `stream`, does not synchronise.
// Returns the cudaError_t.
extern "C" int fseg_gather_reduce(const void* a, const void* idx, void* mx,
                                  void* mn, void* am, void* amn, void* s1,
                                  void* s2, int b, int n, int kk, int c,
                                  int want, int bf16, void* stream) {
    if (b < 1 || n < 1 || kk < 1 || c < 1 || c > GR_MAX_C || want < 0 ||
        want > 2)
        return (int)cudaErrorInvalidValue;
    const long long points = (long long)b * n;
    if ((points + GR_WARPS - 1) / GR_WARPS > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int32_t* ip = (const int32_t*)idx;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        launch_c<__nv_bfloat16>(a, ip, mx, mn, (int32_t*)am, (int32_t*)amn,
                                (float*)s1, (float*)s2, points, n, kk, c,
                                want, st);
    else
        launch_c<float>(a, ip, mx, mn, (int32_t*)am, (int32_t*)amn,
                        (float*)s1, (float*)s2, points, n, kk, c, want, st);
    return (int)cudaGetLastError();
}
