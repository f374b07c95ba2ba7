// The approximate top-k on Hopper (sm_90a): the fused row selection and
// the bin pass.
//
// Replaces no TPU kernel: the JAX package selects approximately with
// lax.approx_max_k / lax.approx_min_k, which XLA lowers on the TPU to its
// ApproxTopK custom call (a PartialReduce), not to a Pallas kernel, and
// exactly with lax.top_k. The algorithm is ApproxTopK's: for rows of n
// scores, split each row into L bins, element i going to bin i mod L (the
// row padded to L * R with -inf, or +inf for the minimum, and read as an
// (R, L) matrix reduced over its first axis), keep each bin's extremum and
// the index of its first occurrence, and take the exact top-k of the L
// winners ordered by (value, index): values descending for the largest,
// ascending for the smallest, ties to the lower index. At R = 1 (L = n)
// that is the exact top-k with stable ties.
//
// Two entry points:
//   * fseg_select_rows (k <= 128) does all of it in one pass. One warp a
//     row; the lanes own neighbouring bins, VEC of them each (4 f32 or 8
//     bf16: every load of a bin is one 16-byte vector a lane, one full
//     coalesced line a warp), and a bin's R loads are issued together,
//     SEL_UNROLL at a time. A lane reduces its bins in registers; each
//     winner becomes one 64-bit key, its value's bits made monotone
//     (negative values flipped, -0.0 first made +0.0 so the two compare
//     equal; inverted for the largest) above its index, so one unsigned
//     compare is the (value, index) order, for negative values too (the
//     self-loop diagonal pinned to -1, rounding's small negatives). The
//     warp keeps the k smallest keys in K1's threshold-filtered sorted list
//     (warp_select.cuh): a key costs work only when it passes the k-th. A
//     key that passes waits in the warp's 64-key buffer in shared memory,
//     and 32 waiting are merged into the list at once (a bitonic sort and
//     merge, about 8 instructions a key), where K1 inserts one at a time
//     (about 40 shuffles and compares a key; prof/design_sweep.py --parts
//     sel times both); the threshold is refreshed at each merge. The
//     kernel writes k values (the winners' own bits, read back at their
//     indices) and k indices a row; no winner reaches device memory and
//     nothing is sorted.
//   * fseg_bin_extrema (for k > 128: the keypoint detectors' 20 000 of
//     256^3) writes every bin's winner; ops/approx_topk.py sorts them. A
//     thread reduces VEC neighbouring bins with 16-byte vector loads, eight
//     in flight, and stores them as vectors.
// Both take the vectors only where the rows and the bins are whole vectors
// (n and L multiples of VEC, 16-byte aligned pointers); elsewhere a lane or
// thread owns one bin and loads one element at a time.
//
// What bounds it: bytes. Each input is read once; the fused selection
// writes k values and indices a row (the kNN rows of the --knn_recall 0.9
// step, 32 * 2048 rows of 2048 -> 40: 537 MB in f32, 31 MB out), the bin
// pass every winner (67 MB in for the 256^3 detector, L = 524 288,
// R = 32). The fused selection's compares, ballots and shuffles for the
// keys that pass the threshold are what it spends beyond that (PERF.md).
//
// The comparisons are strict, so among equal values the lower index wins,
// and NaN never replaces a winner (the callers' scores hold no NaN;
// kernels/approx_topk.py says so). Both entry points are bit-equal to their
// plain versions (kernels/approx_topk.py: select_rows_plain,
// bin_extrema_plain).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_select.cuh"  // sort32, merge, insert, kth

#define BIN_THREADS 256
#define BIN_UNROLL 8       // a bin's loads in flight together (bin pass)
#define SEL_WARPS 8        // rows a block of the fused selection
#define SEL_MAX_K 128
#define SEL_UNROLL 2       // a bin's loads in flight together (selection)

template <typename T>
struct Bits;

template <>
struct Bits<float> {
    static __device__ __forceinline__ float value(float v) { return v; }
    static __device__ __forceinline__ float raw(float v) { return v; }
};

// bfloat16 carried as its 16 raw bits: the float with the same high half
template <>
struct Bits<uint16_t> {
    static __device__ __forceinline__ float value(uint16_t v) {
        return __uint_as_float(((uint32_t)v) << 16);
    }
    static __device__ __forceinline__ uint16_t raw(float v) {
        return (uint16_t)(__float_as_uint(v) >> 16);
    }
};

// VEC neighbouring elements of T in one load, read out as floats
template <typename T, int VEC>
struct Vec;

template <typename T>
struct Vec<T, 1> {
    typedef T raw;
    static __device__ __forceinline__ raw load(const T* p) { return __ldg(p); }
    static __device__ __forceinline__ float at(const raw& r, int) {
        return Bits<T>::value(r);
    }
};

__device__ __forceinline__ unsigned word(const uint4& r, int w) {
    return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

template <>
struct Vec<float, 4> {
    typedef uint4 raw;
    static __device__ __forceinline__ raw load(const float* p) {
        return __ldg(reinterpret_cast<const uint4*>(p));
    }
    static __device__ __forceinline__ float at(const raw& r, int e) {
        return __uint_as_float(word(r, e));
    }
    static __device__ __forceinline__ raw pack(const float (&v)[4]) {
        return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                          __float_as_uint(v[2]), __float_as_uint(v[3]));
    }
};

template <>
struct Vec<uint16_t, 8> {
    typedef uint4 raw;
    static __device__ __forceinline__ raw load(const uint16_t* p) {
        return __ldg(reinterpret_cast<const uint4*>(p));
    }
    static __device__ __forceinline__ float at(const raw& r, int e) {
        const unsigned w = word(r, e >> 1);   // element 2w low, 2w + 1 high
        return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    }
    static __device__ __forceinline__ raw pack(const float (&v)[8]) {
        unsigned w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            w[q] = (__float_as_uint(v[2 * q]) >> 16) |
                   (__float_as_uint(v[2 * q + 1]) & 0xffff0000u);
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
};

// Elements of bin b below n: b, b + L, ..., b + (m - 1) L.
__device__ __forceinline__ int bin_size(long long b, long long n,
                                        long long L, int R) {
    return b >= n ? 0 : (int)min((long long)R, (n - b + L - 1) / L);
}

// The extrema of the VEC bins b0 ... b0 + VEC - 1 of row xr, all m
// elements long (m >= 1), and j of each one's first occurrence (its index
// is b0 + e + j L). UNROLL loads are issued before any is compared.
template <typename T, int VEC, bool LARGEST, int UNROLL>
__device__ __forceinline__ void reduce_bins(const T* __restrict__ xr,
                                            long long b0, long long L, int m,
                                            float (&best)[VEC],
                                            int (&jb)[VEC]) {
    for (int j0 = 0; j0 < m; j0 += UNROLL) {
        typename Vec<T, VEC>::raw r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (j0 + u < m) r[u] = Vec<T, VEC>::load(xr + b0 + (j0 + u) * L);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (j0 + u >= m) break;
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                const float v = Vec<T, VEC>::at(r[u], e);
                if (j0 + u == 0 || (LARGEST ? v > best[e] : v < best[e])) {
                    best[e] = v;
                    jb[e] = j0 + u;
                }
            }
        }
    }
}

// ---- the fused row selection ---------------------------------------------

// One unsigned compare of two keys is the (value, index) order of the
// selection: the value's bits made monotone, inverted for the largest.
template <bool LARGEST>
__device__ __forceinline__ u64 order_key(float v, unsigned i) {
    const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));  // -0.0 -> +0.0
    unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    if (LARGEST) o = ~o;
    return ((u64)o << 32) | i;
}

template <typename T, int VEC, int LL, bool LARGEST>
__global__ void __launch_bounds__(SEL_WARPS * 32)
select_rows(const T* __restrict__ x, T* __restrict__ out_v,
            void* __restrict__ out_i, long long rows, int n, int L, int R,
            int k, int idx64) {
    const int lane = threadIdx.x & 31;
    const long long row =
        (long long)blockIdx.x * SEL_WARPS + (threadIdx.x >> 5);
    // each warp's keys that passed the threshold, waiting to be merged
    __shared__ u64 wait_s[SEL_WARPS][64];
    if (row >= rows) return;  // the whole warp: no shuffle is left waiting
    u64* wait = wait_s[threadIdx.x >> 5];
    int nw = 0;  // keys waiting, the same on every lane
    const unsigned below = (1u << lane) - 1u;
    const T* xr = x + row * n;
    u64 list[LL];
#pragma unroll
    for (int r = 0; r < LL; ++r) list[r] = ~0ull;
    u64 th = ~0ull;
    const int kr = (k - 1) >> 5, kl = (k - 1) & 31;

    for (int c0 = 0; c0 < L; c0 += 32 * VEC) {
        const int b0 = c0 + lane * VEC;
        // bins past L are none; bins past n are empty (padding only) and
        // never among the k best, as k <= min(n, L) bins hold an element
        const int m = b0 < L ? bin_size(b0, n, L, R) : 0;
        float best[VEC] = {};
        int jb[VEC] = {};
        reduce_bins<T, VEC, LARGEST, SEL_UNROLL>(xr, b0, L, m, best, jb);
        u64 kv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
            kv[e] = m > 0 ? order_key<LARGEST>(
                                best[e], (unsigned)(b0 + e + jb[e] * L))
                          : ~0ull;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            // a key below the threshold waits in the warp's buffer; 32
            // waiting are merged into the list at once (a bitonic sort and
            // merge over shuffles) and the threshold refreshed
            const bool pass = kv[e] < th;
            const unsigned ballot = __ballot_sync(KNN_FULL, pass);
            if (pass) wait[nw + __popc(ballot & below)] = kv[e];
            nw += __popc(ballot);
            if (nw >= 32) {
                __syncwarp();
                const u64 v = wait[lane], rest = wait[lane + 32];
                __syncwarp();
                nw -= 32;
                if (lane < nw) wait[lane] = rest;
                merge<LL>(list, sort32(v, lane), lane);
                th = kth<LL>(list, kr, kl);
            }
        }
    }
    if (nw > 0) {  // the last few waiting
        __syncwarp();
        merge<LL>(list, sort32(lane < nw ? wait[lane] : ~0ull, lane), lane);
    }
    const long long o = row * k;
#pragma unroll
    for (int r = 0; r < LL; ++r) {
        const int p = r * 32 + lane;
        if (p < k) {
            const unsigned i = (unsigned)list[r];
            out_v[o + p] = xr[i];
            if (idx64)
                static_cast<long long*>(out_i)[o + p] = (long long)i;
            else
                static_cast<int32_t*>(out_i)[o + p] = (int32_t)i;
        }
    }
}

template <typename T, int VEC, int LL>
static int launch_select(const void* x, void* vals, void* idx,
                         long long rows, int n, int L, int R, int k,
                         int largest, int idx64, cudaStream_t s) {
    const unsigned blocks = (unsigned)((rows + SEL_WARPS - 1) / SEL_WARPS);
    if (largest)
        select_rows<T, VEC, LL, true><<<blocks, SEL_WARPS * 32, 0, s>>>(
            (const T*)x, (T*)vals, idx, rows, n, L, R, k, idx64);
    else
        select_rows<T, VEC, LL, false><<<blocks, SEL_WARPS * 32, 0, s>>>(
            (const T*)x, (T*)vals, idx, rows, n, L, R, k, idx64);
    return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int select_by_k(const void* x, void* vals, void* idx, long long rows,
                       int n, int L, int R, int k, int largest, int idx64,
                       cudaStream_t s) {
    if (k <= 32)
        return launch_select<T, VEC, 1>(x, vals, idx, rows, n, L, R, k,
                                        largest, idx64, s);
    if (k <= 64)
        return launch_select<T, VEC, 2>(x, vals, idx, rows, n, L, R, k,
                                        largest, idx64, s);
    return launch_select<T, VEC, 4>(x, vals, idx, rows, n, L, R, k, largest,
                                    idx64, s);
}

// n and L whole vectors of VEC elements and x 16-byte aligned: every
// vector of a bin group lies wholly below n or wholly past it
static bool whole_vectors(const void* x, long long n, long long L, int vec) {
    return n % vec == 0 && L % vec == 0 && ((uintptr_t)x & 15) == 0;
}

// x (rows, n) contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1); writes
// vals (rows, k) in x's type and idx (rows, k), int64 (idx64 = 1) or
// int32: each row's k best bin winners in the selection's order. Requires
// L * R >= n, n < 2^31 and 1 <= k <= min(128, n, L).
extern "C" int fseg_select_rows(const void* x, void* vals, void* idx,
                                long long rows, long long n, long long L,
                                int R, int k, int largest, int bf16,
                                int idx64, void* stream) {
    if (rows < 1 || n < 1 || L < 1 || R < 1 || L * (long long)R < n ||
        n > 0x7fffffffLL || L > 0x7fffffffLL || k < 1 || k > SEL_MAX_K ||
        k > n || k > L || (rows + SEL_WARPS - 1) / SEL_WARPS > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int ni = (int)n, li = (int)L;
    if (bf16)
        return whole_vectors(x, n, L, 8)
                   ? select_by_k<uint16_t, 8>(x, vals, idx, rows, ni, li, R,
                                              k, largest, idx64, s)
                   : select_by_k<uint16_t, 1>(x, vals, idx, rows, ni, li, R,
                                              k, largest, idx64, s);
    return whole_vectors(x, n, L, 4)
               ? select_by_k<float, 4>(x, vals, idx, rows, ni, li, R, k,
                                       largest, idx64, s)
               : select_by_k<float, 1>(x, vals, idx, rows, ni, li, R, k,
                                       largest, idx64, s);
}

// ---- the bin pass ----------------------------------------------------------

// Bin group t: VEC neighbouring bins of one row, reduced by one thread and
// stored as vectors where VEC > 1. An empty bin (past n) keeps the fill
// and its first index, as the padded plain version does.
template <typename T, int VEC, bool LARGEST>
__global__ void __launch_bounds__(BIN_THREADS)
bin_extrema(const T* __restrict__ x, T* __restrict__ vals,
            int32_t* __restrict__ idx, long long rows, long long n,
            long long L, int R) {
    const long long groups = L / VEC;
    const long long total = rows * groups;
    const long long step = (long long)gridDim.x * BIN_THREADS;
    for (long long t = (long long)blockIdx.x * BIN_THREADS + threadIdx.x;
         t < total; t += step) {
        const long long row = t / groups;
        const long long b0 = (t - row * groups) * VEC;
        const int m = bin_size(b0, n, L, R);
        float best[VEC];
        int jb[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            best[e] = LARGEST ? -INFINITY : INFINITY;
            jb[e] = 0;
        }
        reduce_bins<T, VEC, LARGEST, BIN_UNROLL>(x + row * n, b0, L, m, best,
                                                 jb);
        const long long o = row * L + b0;
        if constexpr (VEC == 1) {
            vals[o] = Bits<T>::raw(best[0]);
            idx[o] = (int32_t)(b0 + (long long)jb[0] * L);
        } else {
            *reinterpret_cast<uint4*>(vals + o) = Vec<T, VEC>::pack(best);
#pragma unroll
            for (int q = 0; q < VEC / 4; ++q) {
                const long long i0 = b0 + 4 * q;
                reinterpret_cast<int4*>(idx + o)[q] = make_int4(
                    (int)(i0 + (long long)jb[4 * q] * L),
                    (int)(i0 + 1 + (long long)jb[4 * q + 1] * L),
                    (int)(i0 + 2 + (long long)jb[4 * q + 2] * L),
                    (int)(i0 + 3 + (long long)jb[4 * q + 3] * L));
            }
        }
    }
}

template <typename T, int VEC>
static int launch_bins(const void* x, void* vals, void* idx, long long rows,
                       long long n, long long L, int R, int largest,
                       cudaStream_t s) {
    const long long total = rows * (L / VEC);
    long long blocks = (total + BIN_THREADS - 1) / BIN_THREADS;
    // a resident grid: 132 SMs x 8 blocks of 256 threads, looped over
    blocks = blocks < 132 * 8 ? blocks : 132 * 8;
    if (largest)
        bin_extrema<T, VEC, true><<<(unsigned)blocks, BIN_THREADS, 0, s>>>(
            (const T*)x, (T*)vals, (int32_t*)idx, rows, n, L, R);
    else
        bin_extrema<T, VEC, false><<<(unsigned)blocks, BIN_THREADS, 0, s>>>(
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
    const bool out16 = ((uintptr_t)vals & 15) == 0 &&
                       ((uintptr_t)idx & 15) == 0;
    if (bf16)
        return out16 && whole_vectors(x, n, L, 8)
                   ? launch_bins<uint16_t, 8>(x, vals, idx, rows, n, L, R,
                                              largest, s)
                   : launch_bins<uint16_t, 1>(x, vals, idx, rows, n, L, R,
                                              largest, s);
    return out16 && whole_vectors(x, n, L, 4)
               ? launch_bins<float, 4>(x, vals, idx, rows, n, L, R, largest,
                                       s)
               : launch_bins<float, 1>(x, vals, idx, rows, n, L, R, largest,
                                       s);
}
