// K1: fused brute-force kNN within each point cloud, for Hopper (sm_90a).
//
// Replaces fissure_segmentation_tpu/ops/pallas/knn.py:knn_pallas (kernel
// bodies _knn_kernel and _knn_kernel_single). Same contract: for x (B, N, C)
// float32, C <= 8, every query's kk nearest keys of its own cloud by
// d = sum_c (q_c - k_c)^2 in channel order, ascending, ties to the LOWER key
// index (lax.top_k's stable order); the N x N distance matrix never reaches
// device memory. self_loop handling (drop column 0) is the wrapper's.
//
// What bounds it: at the path's shapes (5 x 2048 x 3, kk=41 for the DGCNN
// graph; 3 x 8192 x 3, kk=30 for the PSR normals) it reads a few hundred KB
// and does B*N^2*C*3 flops plus the per-query selection, so it is bound by
// instruction issue, not bytes — and the selection, not the distances,
// dominates: while a query's list is still filling, almost every key is an
// insert, and a warp pays for an insert whenever any of its 32 queries
// makes one.
//
// Design: S adjacent lanes of a warp share one query (S = 1, 2, 4 or 8,
// chosen on the host so the launch has enough warps to hide latency); keys
// stream through shared memory in tiles that every thread of the block
// reads, and lane s of a query scans the keys j = s, s+S, s+2S, ... Each
// lane keeps a sorted (distance, index) list of KK >= kk entries in
// REGISTERS: KK is a compile-time bucket (32/48/64/128) and the insert is a
// fully unrolled, branch-free compare-and-shift, so no list entry is ever
// addressed with a runtime index (which would put the list in local
// memory; the first version did that and ran ~10x slower than the plain
// version). A lane sees its keys in ascending index order, so rejecting an
// equal distance and inserting after equal entries keeps its list in
// lexicographic (distance, index) order. The S lists are then merged with
// warp shuffles: kk times, the lexicographic minimum of the S list heads is
// emitted and its lane pops it. Keeping the KK >= kk smallest per lane and
// merging is exact, ties included.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic and
// the library is also built with -fmad=false, so no a*b+c is contracted to
// an FMA. The distances are then bit-identical to the plain PyTorch version
// (kernels/knn.py:knn_plain), and so are the indices, ties included.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KNN_MAX_C 8
#define KNN_MAX_KK 128
#define KNN_THREADS 128
#define KNN_TILE 512  // keys per shared-memory tile: 512 * 8 * 4 B = 16 KB

// Insert (d, j) into the sorted list; j exceeds every index in the list.
// Entry i takes entry i-1 if that one is greater than d, else d itself if
// entry i is greater than d, else stays; entries equal to d stay ahead.
template <int KK>
__device__ __forceinline__ void insert_sorted(float (&bd)[KK], int (&bi)[KK],
                                              float d, int j) {
#pragma unroll
    for (int i = KK - 1; i > 0; --i) {
        const bool shift = bd[i - 1] > d;
        const bool place = !shift && bd[i] > d;
        bd[i] = shift ? bd[i - 1] : (place ? d : bd[i]);
        bi[i] = shift ? bi[i - 1] : (place ? j : bi[i]);
    }
    if (bd[0] > d) {
        bd[0] = d;
        bi[0] = j;
    }
}

template <int KK, int S>
__global__ void __launch_bounds__(KNN_THREADS)
knn_kernel(const float* __restrict__ x, int32_t* __restrict__ out_idx,
           float* __restrict__ out_dist, int n, int c, int kk) {
    constexpr int QPB = KNN_THREADS / S;  // queries per block
    __shared__ float tile[KNN_TILE * KNN_MAX_C];
    const int b = blockIdx.y;
    const int sub = threadIdx.x % S;
    const int q = blockIdx.x * QPB + threadIdx.x / S;
    const bool active = q < n;  // ragged last block: load tiles, emit nothing
    const float* xb = x + (size_t)b * n * c;

    float qv[KNN_MAX_C];
#pragma unroll
    for (int ch = 0; ch < KNN_MAX_C; ++ch)
        qv[ch] = (active && ch < c) ? xb[(size_t)q * c + ch] : 0.0f;

    float bd[KK];
    int bi[KK];
#pragma unroll
    for (int i = 0; i < KK; ++i) {
        bd[i] = INFINITY;
        bi[i] = 0;
    }

    for (int t0 = 0; t0 < n; t0 += KNN_TILE) {
        const int tn = min(KNN_TILE, n - t0);
        __syncthreads();  // previous tile fully consumed
        for (int e = threadIdx.x; e < tn * c; e += KNN_THREADS)
            tile[e] = xb[(size_t)t0 * c + e];
        __syncthreads();
        if (!active) continue;
        for (int j = sub; j < tn; j += S) {
            const float* kp = tile + j * c;
            float d = 0.0f;
#pragma unroll
            for (int ch = 0; ch < KNN_MAX_C; ++ch) {
                if (ch < c) {
                    const float diff = __fsub_rn(qv[ch], kp[ch]);
                    d = __fadd_rn(d, __fmul_rn(diff, diff));
                }
            }
            if (d < bd[KK - 1]) insert_sorted<KK>(bd, bi, d, t0 + j);
        }
    }
    const size_t row = ((size_t)b * n + q) * kk;
    if (S == 1) {
        if (!active) return;
#pragma unroll
        for (int i = 0; i < KK; ++i) {
            if (i < kk) {
                out_idx[row + i] = bi[i];
                out_dist[row + i] = bd[i];
            }
        }
        return;
    }
    // merge: every lane of the warp takes part in the shuffles (inactive
    // lanes hold all-INFINITY lists); key indices are unique across the S
    // lists, so exactly one lane holds the winning head
    for (int i = 0; i < kk; ++i) {
        float md = bd[0];
        int mi = bi[0];
#pragma unroll
        for (int off = 1; off < S; off <<= 1) {
            const float od = __shfl_xor_sync(0xffffffffu, md, off);
            const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
            if (od < md || (od == md && oi < mi)) {
                md = od;
                mi = oi;
            }
        }
        const bool pop = bd[0] == md && bi[0] == mi;
#pragma unroll
        for (int e = 0; e < KK - 1; ++e) {
            bd[e] = pop ? bd[e + 1] : bd[e];
            bi[e] = pop ? bi[e + 1] : bi[e];
        }
        if (pop) bd[KK - 1] = INFINITY;
        if (active && sub == 0) {
            out_idx[row + i] = mi;
            out_dist[row + i] = md;
        }
    }
}

template <int KK>
static void launch(const float* x, int32_t* idx, float* dist, int b, int n,
                   int c, int kk, int split, cudaStream_t stream) {
    const int qpb = KNN_THREADS / split;
    const dim3 grid((n + qpb - 1) / qpb, b);
    switch (split) {
        case 1: knn_kernel<KK, 1><<<grid, KNN_THREADS, 0, stream>>>(x, idx, dist, n, c, kk); break;
        case 2: knn_kernel<KK, 2><<<grid, KNN_THREADS, 0, stream>>>(x, idx, dist, n, c, kk); break;
        case 4: knn_kernel<KK, 4><<<grid, KNN_THREADS, 0, stream>>>(x, idx, dist, n, c, kk); break;
        default: knn_kernel<KK, 8><<<grid, KNN_THREADS, 0, stream>>>(x, idx, dist, n, c, kk); break;
    }
}

// Lanes per query: double while the launch has fewer than 2^16 threads and
// every lane still sees at least kk keys.
static int pick_split(int b, int n, int kk) {
    int split = 1;
    while (split < 8 && (long long)b * n * split < 65536 &&
           n / (2 * split) >= kk)
        split *= 2;
    return split;
}

// x: (b, n, c) float32, idx: (b, n, kk) int32, dist: (b, n, kk) float32, all
// contiguous device memory; launches on `stream`, does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fseg_knn_f32(const void* x, void* idx, void* dist, int b,
                            int n, int c, int kk, void* stream) {
    if (b < 1 || b > 65535 || n < 1 || c < 1 || c > KNN_MAX_C || kk < 1 ||
        kk > KNN_MAX_KK || kk > n)
        return (int)cudaErrorInvalidValue;
    const float* xp = (const float*)x;
    int32_t* ip = (int32_t*)idx;
    float* dp = (float*)dist;
    cudaStream_t s = (cudaStream_t)stream;
    const int split = pick_split(b, n, kk);
    if (kk <= 32)
        launch<32>(xp, ip, dp, b, n, c, kk, split, s);
    else if (kk <= 48)
        launch<48>(xp, ip, dp, b, n, c, kk, split, s);
    else if (kk <= 64)
        launch<64>(xp, ip, dp, b, n, c, kk, split, s);
    else
        launch<KNN_MAX_KK>(xp, ip, dp, b, n, c, kk, split, s);
    return (int)cudaGetLastError();
}
