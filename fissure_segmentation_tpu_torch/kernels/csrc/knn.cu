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
// serving graph; 32 x 2048 x 3 for the training step's; 3 x 8192 x 3,
// kk=30 for the PSR normals) it reads a few hundred KB and does
// B*N^2*C*3 flops plus the per-query selection, so it is bound by
// instruction issue, not bytes, and the selection, not the distances, is
// what costs (PERF.md).
//
// Design: threshold-filtered warp selection (after FAISS's WarpSelect,
// Johnson, Douze and Jegou, "Billion-scale similarity search with GPUs").
//   * One warp a query. The block's queries share the cloud, staged in
//     shared memory channel-major (conflict-free for any C): the whole
//     cloud when it fits KNN_SMEM_CLOUD (no barrier after the load), else
//     tiles of that size in turn.
//   * Keys. (d, j) packs into one 64-bit key, d's float bits high (d >= 0,
//     never -0.0, so its bits order it) and j low: one unsigned compare is
//     the lexicographic (d, j) order, so the result is exact with ties and
//     does not depend on the order keys are seen in.
//   * The warp keeps the kk smallest keys so far as one sorted list of 32 * L
//     entries, entry e in register e / 32 of lane e % 32 (warp_select.cuh,
//     shared with the approximate top-k's selection). A round is 32 keys, one
//     a lane; every lane tests its key against the threshold, the kk-th entry,
//     in one compare, and __ballot_sync counts the survivors. Many survivors
//     (early in the scan, KNN_MERGE_MIN or more) are merged at once: a bitonic
//     sort of the round over shuffles, then a bitonic merge with the list that
//     keeps its 32 * L smallest. A few (later, where the threshold has fallen)
//     are inserted one at a time: each entry compares itself with the key and
//     takes the key, its left neighbour (one shuffle) or stays. Either way the
//     threshold is refreshed at once, so a warp pays for a key only when it
//     enters the list.
//   * Whole-cloud scans start at the block's first query (rounded down to
//     32) and wrap, so a cloud stored in spatial order fills the list with
//     near keys first and the threshold falls fast; the order of the scan
//     does not change the result.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic and
// the library is also built with -fmad=false, so no a*b+c is contracted to
// an FMA. The distances are then bit-identical to the plain PyTorch version
// (kernels/knn.py:knn_plain), and so are the indices, ties included.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_select.cuh"  // sort32, merge, insert, kth

#define KNN_MAX_C 8
#define KNN_MAX_KK 128
#define KNN_SMEM_CLOUD (192 * 1024)  // bytes of cloud a block stages
#define KNN_BATCH 4                  // keys a lane computes before testing
// survivors of a round from which they are merged, not inserted one by
// one (the fastest of 2 to 12 at the path's shapes on the card; PERF.md)
#define KNN_MERGE_MIN 8

template <int C, int L>
__global__ void __launch_bounds__(1024)
knn_kernel(const float* __restrict__ x, int32_t* __restrict__ out_idx,
           float* __restrict__ out_dist, int n, int kk, int tile) {
    extern __shared__ float xs[];  // (C, tile) channel-major
    const int lane = threadIdx.x & 31;
    const int q0 = blockIdx.x * (blockDim.x >> 5);
    const int q = q0 + (threadIdx.x >> 5);
    const int b = blockIdx.y;
    const bool active = q < n;  // ragged last block: load tiles, emit nothing
    const float* xb = x + (size_t)b * n * C;

    float qv[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
        qv[ch] = active ? xb[(size_t)q * C + ch] : 0.0f;
    u64 list[L];
#pragma unroll
    for (int r = 0; r < L; ++r) list[r] = ~0ull;
    u64 th = ~0ull;
    const int kr = (kk - 1) >> 5, kl = (kk - 1) & 31;

    for (int t0 = 0; t0 < n; t0 += tile) {
        const int tn = min(tile, n - t0);
        if (t0 > 0) __syncthreads();  // the previous tile fully scanned
        for (int e = threadIdx.x; e < tn * C; e += blockDim.x) {
            const int j = e / C;
            xs[(e - j * C) * tn + j] = xb[(size_t)t0 * C + e];
        }
        __syncthreads();
        if (!active) continue;
        const int rot = tn == n ? (q0 & ~31) : 0;
        for (int e0 = 0; e0 < tn; e0 += 32 * KNN_BATCH) {
            u64 kv[KNN_BATCH];
#pragma unroll
            for (int u = 0; u < KNN_BATCH; ++u) {
                const int e = e0 + u * 32 + lane;
                kv[u] = ~0ull;
                if (e < tn) {
                    int jl = e + rot;
                    if (jl >= tn) jl -= tn;
                    float d = 0.0f;
#pragma unroll
                    for (int ch = 0; ch < C; ++ch) {
                        const float diff = __fsub_rn(qv[ch], xs[ch * tn + jl]);
                        d = __fadd_rn(d, __fmul_rn(diff, diff));
                    }
                    kv[u] = ((u64)__float_as_uint(d) << 32) |
                            (unsigned)(t0 + jl);
                }
            }
#pragma unroll
            for (int u = 0; u < KNN_BATCH; ++u) {
                unsigned pend = __ballot_sync(KNN_FULL, kv[u] < th);
                if (__popc(pend) >= KNN_MERGE_MIN) {
                    merge<L>(list, sort32(kv[u] < th ? kv[u] : ~0ull, lane),
                             lane);
                    th = kth<L>(list, kr, kl);
                    continue;
                }
                while (pend) {
                    const int src = __ffs(pend) - 1;
                    insert<L>(list, shfl64(kv[u], src), lane);
                    th = kth<L>(list, kr, kl);
                    pend &= ~(1u << src) & __ballot_sync(KNN_FULL, kv[u] < th);
                }
            }
        }
    }
    if (!active) return;
    const size_t row = ((size_t)b * n + q) * kk;
#pragma unroll
    for (int r = 0; r < L; ++r) {
        const int p = r * 32 + lane;
        if (p < kk) {
            out_idx[row + p] = (int32_t)(unsigned)list[r];
            out_dist[row + p] = __uint_as_float((unsigned)(list[r] >> 32));
        }
    }
}

template <int C, int L>
static int launch(const float* x, int32_t* idx, float* dist, int b, int n,
                  int kk, cudaStream_t stream) {
    const size_t cloud = (size_t)n * C * sizeof(float);
    const int tile = cloud <= KNN_SMEM_CLOUD
                         ? n
                         : (int)(KNN_SMEM_CLOUD / (C * sizeof(float)));
    const size_t smem = (size_t)tile * C * sizeof(float);
    // enough warps a block that the blocks an SM holds by shared memory
    // still bring at least 32 warps
    const int threads = smem <= 112 * 1024 ? 512 : 1024;
    static bool opted_in = false;
    if (!opted_in) {
        const cudaError_t err = cudaFuncSetAttribute(
            knn_kernel<C, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            KNN_SMEM_CLOUD);
        if (err != cudaSuccess) return (int)err;
        opted_in = true;
    }
    const int qpb = threads / 32;
    const dim3 grid((n + qpb - 1) / qpb, b);
    knn_kernel<C, L><<<grid, threads, smem, stream>>>(x, idx, dist, n, kk,
                                                      tile);
    return (int)cudaGetLastError();
}

template <int C>
static int launch_rows(const float* x, int32_t* idx, float* dist, int b,
                       int n, int kk, cudaStream_t stream) {
    if (kk <= 32) return launch<C, 1>(x, idx, dist, b, n, kk, stream);
    if (kk <= 64) return launch<C, 2>(x, idx, dist, b, n, kk, stream);
    return launch<C, 4>(x, idx, dist, b, n, kk, stream);
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
    switch (c) {
        case 1: return launch_rows<1>(xp, ip, dp, b, n, kk, s);
        case 2: return launch_rows<2>(xp, ip, dp, b, n, kk, s);
        case 3: return launch_rows<3>(xp, ip, dp, b, n, kk, s);
        case 4: return launch_rows<4>(xp, ip, dp, b, n, kk, s);
        case 5: return launch_rows<5>(xp, ip, dp, b, n, kk, s);
        case 6: return launch_rows<6>(xp, ip, dp, b, n, kk, s);
        case 7: return launch_rows<7>(xp, ip, dp, b, n, kk, s);
        default: return launch_rows<8>(xp, ip, dp, b, n, kk, s);
    }
}
