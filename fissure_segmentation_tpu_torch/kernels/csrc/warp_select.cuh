// The warp's threshold-filtered sorted list of 64-bit keys, shared by K1
// (knn.cu) and the approximate top-k's row selection (approx_topk.cu).
//
// A warp keeps the smallest keys seen so far as one sorted list of
// 32 * L entries, entry e in register e / 32 of lane e % 32. Keys are
// unsigned 64-bit: one compare gives the order, so the list is exact with
// ties and does not depend on the order keys are seen in. `sort32` and
// `merge` add a whole round of 32 keys (one a lane) at once; `insert` adds
// one key; `kth` reads the threshold, entry kk - 1, on every lane.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define KNN_FULL 0xffffffffu

typedef unsigned long long u64;

__device__ __forceinline__ u64 shfl64(u64 v, int src) {
    const unsigned lo = __shfl_sync(KNN_FULL, (unsigned)v, src);
    const unsigned hi = __shfl_sync(KNN_FULL, (unsigned)(v >> 32), src);
    return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 shfl_xor64(u64 v, int mask) {
    const unsigned lo = __shfl_xor_sync(KNN_FULL, (unsigned)v, mask);
    const unsigned hi = __shfl_xor_sync(KNN_FULL, (unsigned)(v >> 32), mask);
    return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a < b ? b : a; }

// Bitonic sort of the warp's 32 keys (one a lane), ascending by lane.
__device__ __forceinline__ u64 sort32(u64 v, int lane) {
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            const u64 o = shfl_xor64(v, j);
            const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
            v = keep_min ? umin64(v, o) : umax64(v, o);
        }
    }
    return v;
}

// Merge 32 sorted keys (one a lane) into the sorted list, keeping its
// 32 * L smallest: the list's last row against the keys reversed gives a
// bitonic sequence holding them (min(A[i], B[31 - i])), which a bitonic
// merge sorts; L is a power of two.
template <int L>
__device__ __forceinline__ void merge(u64 (&list)[L], u64 sorted, int lane) {
    list[L - 1] = umin64(list[L - 1], shfl64(sorted, 31 - lane));
#pragma unroll
    for (int jr = L / 2; jr > 0; jr >>= 1) {  // partners in another row
#pragma unroll
        for (int r = 0; r < L; ++r) {
            if ((r & jr) == 0) {
                const u64 a = list[r], b = list[r + jr];
                list[r] = umin64(a, b);
                list[r + jr] = umax64(a, b);
            }
        }
    }
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) {  // partners in another lane
#pragma unroll
        for (int r = 0; r < L; ++r) {
            const u64 o = shfl_xor64(list[r], j);
            list[r] = (lane & j) == 0 ? umin64(list[r], o)
                                      : umax64(list[r], o);
        }
    }
}

// Insert `key` (not in the list) into the sorted list: entry p keeps its
// value if it is below the key, else takes the key if entry p - 1 is below
// it (or p == 0), else takes entry p - 1.
template <int L>
__device__ __forceinline__ void insert(u64 (&list)[L], u64 key, int lane) {
    u64 left[L];  // entry p - 1 of every entry p (lane 0: the row above)
#pragma unroll
    for (int r = 0; r < L; ++r) left[r] = shfl64(list[r], (lane + 31) & 31);
#pragma unroll
    for (int r = L - 1; r >= 0; --r) {
        const u64 prev = lane == 0 ? left[r > 0 ? r - 1 : 0] : left[r];
        const bool first = lane == 0 && r == 0;
        if (list[r] > key) list[r] = (first || prev < key) ? key : prev;
    }
}

// The list's entry kk - 1 (row kr, lane kl), on every lane.
template <int L>
__device__ __forceinline__ u64 kth(const u64 (&list)[L], int kr, int kl) {
    u64 v = list[0];
#pragma unroll
    for (int r = 1; r < L; ++r) v = kr == r ? list[r] : v;
    return shfl64(v, kl);
}
