// The bin pass of the approximate top-k, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package selects approximately with
// lax.approx_max_k / lax.approx_min_k, which XLA lowers on the TPU to its
// ApproxTopK custom call (a PartialReduce), not to a Pallas kernel. This is
// that algorithm's first stage, the one that touches every input: for rows
// of n scores, split each row into L bins, element i going to bin i mod L
// (the row padded to L * R with -inf, or +inf for the minimum, and read as
// an (R, L) matrix reduced over its first axis), and keep each bin's
// extremum and the index of its first occurrence. The exact top-k of the
// L winners (ops/approx_topk.py) finishes the selection.
//
// What bounds it: each input is read once and each winner written once
// (value and int32 index), a handful of comparisons a byte, so it is bound
// by bytes: 67 MB in for the 256^3 detector (L = 524 288, R = 32), 537 MB
// in and 268 MB out for the kNN rows of the --knn_recall 0.9 training
// step (32 * 2048 rows of 2048, L = 512, R = 4).
//
// Design: one thread a bin, in a grid-stride loop over (row, bin); the
// threads of a warp own neighbouring bins of one row, so every one of
// their R loads is one coalesced 128-byte line (f32) or 64-byte line
// (bf16). The loop over the bin's R elements is unrolled so its loads are
// in flight together. The comparison is strict, so among equal values the
// lower index wins, and NaN never replaces a winner (the callers' scores
// hold no NaN; kernels/approx_topk.py says so). Values are stored as the
// winner's own bits, so the kernel is bit-equal to its plain version
// (kernels/approx_topk.py:bin_extrema_plain).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BIN_THREADS 256

template <typename T>
struct Bits;

template <>
struct Bits<float> {
    static __device__ __forceinline__ float value(float v) { return v; }
    static __device__ __forceinline__ float fill(bool largest) {
        return largest ? -INFINITY : INFINITY;
    }
};

// bfloat16 carried as its 16 raw bits: the float with the same high half
template <>
struct Bits<uint16_t> {
    static __device__ __forceinline__ float value(uint16_t v) {
        return __uint_as_float(((uint32_t)v) << 16);
    }
    static __device__ __forceinline__ uint16_t fill(bool largest) {
        return largest ? (uint16_t)0xff80u : (uint16_t)0x7f80u;
    }
};

template <typename T, bool LARGEST>
__global__ void __launch_bounds__(BIN_THREADS)
bin_extrema(const T* __restrict__ x, T* __restrict__ vals,
            int32_t* __restrict__ idx, long long rows, long long n,
            long long L, int R) {
    const long long total = rows * L;
    const long long step = (long long)gridDim.x * BIN_THREADS;
    for (long long t = (long long)blockIdx.x * BIN_THREADS + threadIdx.x;
         t < total; t += step) {
        const long long row = t / L;
        const long long b = t - row * L;
        const T* xr = x + row * n;
        // the bin's elements below n: b, b + L, ..., b + (m - 1) L
        const long long left = n - b;
        const int m = left <= 0 ? 0
                    : (int)min((long long)R, (left + L - 1) / L);
        T best_raw = m > 0 ? xr[b] : Bits<T>::fill(LARGEST);
        float best = Bits<T>::value(best_raw);
        long long best_i = b;
#pragma unroll 8
        for (int j = 1; j < m; ++j) {
            const long long i = b + (long long)j * L;
            const T raw = xr[i];
            const float v = Bits<T>::value(raw);
            if (LARGEST ? (v > best) : (v < best)) {
                best = v;
                best_raw = raw;
                best_i = i;
            }
        }
        vals[t] = best_raw;
        idx[t] = (int32_t)best_i;
    }
}

template <typename T>
static int launch(const void* x, void* vals, void* idx, long long rows,
                  long long n, long long L, int R, int largest,
                  cudaStream_t s) {
    const long long total = rows * L;
    long long blocks = (total + BIN_THREADS - 1) / BIN_THREADS;
    // a resident grid: 132 SMs x 8 blocks of 256 threads, looped over
    blocks = blocks < 132 * 8 ? blocks : 132 * 8;
    if (largest)
        bin_extrema<T, true><<<(unsigned)blocks, BIN_THREADS, 0, s>>>(
            (const T*)x, (T*)vals, (int32_t*)idx, rows, n, L, R);
    else
        bin_extrema<T, false><<<(unsigned)blocks, BIN_THREADS, 0, s>>>(
            (const T*)x, (T*)vals, (int32_t*)idx, rows, n, L, R);
    return (int)cudaGetLastError();
}

// x (rows, n) contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// writes vals (rows, L) in x's type and idx (rows, L) int32. Requires
// L * R >= n and n < 2^31.
extern "C" int fseg_bin_extrema(const void* x, void* vals, void* idx,
                                long long rows, long long n, long long L,
                                int R, int largest, int bf16, void* stream) {
    if (rows < 1 || n < 1 || L < 1 || R < 1 || L * (long long)R < n ||
        n > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return launch<uint16_t>(x, vals, idx, rows, n, L, R, largest, s);
    return launch<float>(x, vals, idx, rows, n, L, R, largest, s);
}
