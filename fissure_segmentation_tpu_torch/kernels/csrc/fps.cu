// K5: masked farthest-point sampling for Hopper (sm_90a): one thread block,
// or one cluster of up to 8 blocks, per cloud.
//
// Replaces fissure_segmentation_tpu/ops/pallas/fps.py:fps_pallas (kernel
// body _fps_kernel). Same contract: for points (B, N, C) float32, C <= 8,
// and a validity mask (B, N), select m indices per cloud:
//   * the first is the first valid point (0 if no point is valid);
//   * each step computes d_j = sum_c (p_j,c - p_last,c)^2 summed in channel
//     order from 0, min_d_j = min(min_d_j, d_j), score_j = valid_j ? min_d_j
//     : -inf, and takes the FIRST index of the maximal score.
// With fewer valid points than m the selections repeat, as in the JAX
// package. The result is bit-equal to the plain PyTorch loop
// (kernels/fps.py:fps_plain) and to both JAX versions.
//
// What bounds it: the m - 1 steps depend on each other (step i needs the
// point chosen at step i - 1), and each step ends in an argmax over the
// whole cloud. Bytes (N * (C * 4 + 1) read, m * 4 written) and flops (3 C N
// per step) are tiny at the path's shapes, so the kernel is bound by the
// latency of one step times m - 1, and by the instructions a step issues
// on one SM.
//
// Design (the earlier kernel, with the points in shared memory and two
// (float, int) shuffle trees a step, spent 2.5 us a step, 83 % of it in the
// distance pass; PERF.md has the split of its step):
//   * Registers. Thread t of cluster rank r owns the ITEMS consecutive
//     points r * T * ITEMS + t * ITEMS + [0, ITEMS): their coordinates and
//     running minima are loaded into registers once, so the distance pass
//     touches no memory. Invalid points and the padding past N carry a
//     running minimum of -inf, which fminf keeps, so the score is the
//     minimum itself: no validity test in the loop.
//   * Keys. A score is -inf or >= 0 (a sum of squares, never -0.0), so its
//     float bits compared as signed ints order it exactly. Points are
//     owned in index order (thread, then warp, then cluster rank), so the
//     first-occurrence argmax is: each thread's best with a strict '>' in
//     ascending order, then per warp one __reduce_max_sync of the keys and
//     the lowest lane holding the maximum (__ballot_sync, __ffs).
//   * Winner record. The winning lane writes (key, index, coordinates) into
//     a double-buffered shared slot (every block of the cluster gets it,
//     through distributed shared memory). After the one barrier a step
//     (__syncthreads, or barrier.cluster for a cluster), every warp reduces
//     the slots the same way (slot order is index order) and reads the next
//     point's coordinates from the winning slot: no dependent load of the
//     point from the cloud.
//   * The double buffer makes one barrier a step enough: a warp writes step
//     i + 2's buffer (step i's) only after every thread has passed step
//     i + 1's barrier, i.e. has finished reading step i's slots.
//   * Clusters hold clouds too large for one block's registers (up to 8
//     blocks on 8 SMs). They do not pay for a cloud one block holds: the
//     cluster barrier and the remote slot stores cost about 0.6 us a step
//     more (measured, PERF.md).
//
// Rounding: explicit round-to-nearest intrinsics, and the library is built
// with -fmad=false, so d is rounded exactly like the plain version's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define FPS_MAX_C 8
#define FPS_MAX_THREADS 1024
#define FPS_MAX_CLUSTER 8
#define FPS_MAX_SLOTS (FPS_MAX_CLUSTER * FPS_MAX_THREADS / 32)
#define FPS_FULL 0xffffffffu

// Threads a block may have for (C, ITEMS): 1024 while the points' registers
// (ITEMS * (C + 1)) leave room within 64 a thread, else 512.
template <int C, int ITEMS>
struct FpsShape {
    static constexpr int max_threads =
        ITEMS * (C + 1) <= 32 ? FPS_MAX_THREADS : FPS_MAX_THREADS / 2;
};

template <int C>
struct Slots {
    int key[2][FPS_MAX_SLOTS];
    int idx[2][FPS_MAX_SLOTS];
    float pt[2][FPS_MAX_SLOTS][C];
};

// One selection: every thread passes its best (key, index, coordinates);
// every thread returns the cloud's first-occurrence maximum's index and
// coordinates.
template <int C>
__device__ __forceinline__ int fps_select(Slots<C>& sl, int key, int idx,
                                          const float (&pt)[C],
                                          float (&win)[C], int buf, int rank,
                                          int cs) {
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const int mk = __reduce_max_sync(FPS_FULL, key);
    const int wl = __ffs(__ballot_sync(FPS_FULL, key == mk)) - 1;
    const int slot = rank * nwarps + (threadIdx.x >> 5);
    if (lane == wl) {
        if (cs == 1) {
            sl.key[buf][slot] = mk;
            sl.idx[buf][slot] = idx;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) sl.pt[buf][slot][ch] = pt[ch];
        } else {
            cg::cluster_group cl = cg::this_cluster();
            for (int r = 0; r < cs; ++r) {
                Slots<C>* rs = cl.map_shared_rank(&sl, r);
                rs->key[buf][slot] = mk;
                rs->idx[buf][slot] = idx;
#pragma unroll
                for (int ch = 0; ch < C; ++ch) rs->pt[buf][slot][ch] = pt[ch];
            }
        }
    }
    if (cs == 1)
        __syncthreads();
    else
        cg::this_cluster().sync();
    // lane l reduces the slots [l * per, (l + 1) * per) in ascending order
    const int nslots = cs * nwarps;
    const int per = (nslots + 31) >> 5;
    const int s0 = lane * per, s1 = min(s0 + per, nslots);
    int lk = INT_MIN, ls = 0;
    for (int s = s0; s < s1; ++s) {
        const int k = sl.key[buf][s];
        if (k > lk) {
            lk = k;
            ls = s;
        }
    }
    const int gk = __reduce_max_sync(FPS_FULL, lk);
    const int gl = __ffs(__ballot_sync(FPS_FULL, lk == gk)) - 1;
    const int ws = __shfl_sync(FPS_FULL, ls, gl);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) win[ch] = sl.pt[buf][ws][ch];
    return sl.idx[buf][ws];
}

template <int C, int ITEMS>
__global__ void __launch_bounds__(FpsShape<C, ITEMS>::max_threads)
fps_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
           int32_t* __restrict__ out, int n, int m, int cs) {
    __shared__ Slots<C> sl;
    const int rank = cs == 1 ? 0 : (int)cg::this_cluster().block_rank();
    const int b = blockIdx.x / cs;
    const float* xb = x + (size_t)b * n * C;
    const uint8_t* vb = valid + (size_t)b * n;
    const int base = (rank * blockDim.x + threadIdx.x) * ITEMS;

    float p[ITEMS][C];
    float md[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
        const int j = base + it;
        const bool in = j < n;
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
            p[it][ch] = in ? xb[(size_t)j * C + ch] : 0.0f;
        md[it] = in && vb[j] ? INFINITY : -INFINITY;
    }
    if (cs > 1) cg::this_cluster().sync();  // every block has started

    // the first valid point: the first maximum of md (+inf valid, -inf not)
    float lp[C];
    int bi = base;
    float bv = md[0];
    float bc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) bc[ch] = p[0][ch];
#pragma unroll
    for (int it = 1; it < ITEMS; ++it) {
        if (md[it] > bv) {
            bv = md[it];
            bi = base + it;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) bc[ch] = p[it][ch];
        }
    }
    int last =
        fps_select<C>(sl, __float_as_int(bv), bi, bc, lp, 0, rank, cs);
    const bool writer = rank == 0 && threadIdx.x == 0;
    if (writer) out[(size_t)b * m] = last;

    for (int step = 1; step < m; ++step) {
#pragma unroll
        for (int it = 0; it < ITEMS; ++it) {
            float d = 0.0f;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) {
                const float diff = __fsub_rn(p[it][ch], lp[ch]);
                d = __fadd_rn(d, __fmul_rn(diff, diff));
            }
            md[it] = fminf(md[it], d);
        }
        bv = md[0];
        bi = base;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) bc[ch] = p[0][ch];
#pragma unroll
        for (int it = 1; it < ITEMS; ++it) {
            if (md[it] > bv) {
                bv = md[it];
                bi = base + it;
#pragma unroll
                for (int ch = 0; ch < C; ++ch) bc[ch] = p[it][ch];
            }
        }
        last = fps_select<C>(sl, __float_as_int(bv), bi, bc, lp, step & 1,
                             rank, cs);
        if (writer) out[(size_t)b * m + step] = last;
    }
}

template <int C, int ITEMS>
static int launch(const float* x, const uint8_t* v, int32_t* out, int b,
                  int n, int m, int threads, int cs, cudaStream_t stream) {
    if (cs == 1) {
        fps_kernel<C, ITEMS><<<b, threads, 0, stream>>>(x, v, out, n, m, 1);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(b * cs);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, fps_kernel<C, ITEMS>, x, v, out, n, m, cs);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <int C>
static int launch_items(const float* x, const uint8_t* v, int32_t* out,
                        int b, int n, int m, int threads, int items, int cs,
                        cudaStream_t stream) {
    switch (items) {
        case 2: return launch<C, 2>(x, v, out, b, n, m, threads, cs, stream);
        case 4: return launch<C, 4>(x, v, out, b, n, m, threads, cs, stream);
        case 8: return launch<C, 8>(x, v, out, b, n, m, threads, cs, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

static int max_threads(int c, int items) {
    return items * (c + 1) <= 32 ? FPS_MAX_THREADS : FPS_MAX_THREADS / 2;
}

// The launch shape for a cloud of n points (the fastest of every shape
// that covers the path's clouds, measured on the card; PERF.md): one block
// while its registers hold the cloud, else a cluster of blocks of about
// 2048 points each (up to 8); then the most points a thread that still
// leave 256 threads a block (8 warps), else 2. The shape never exceeds
// FpsShape's thread limit and always covers n <= 8 * 8 * 512 points.
static void pick(int n, int c, int* threads, int* items, int* cs) {
    const int cap = 8 * max_threads(c, 8);
    *cs = n <= cap ? 1 : min(FPS_MAX_CLUSTER, (n + 2047) / 2048);
    const int chunk = (n + *cs - 1) / *cs;
    *items = 2;
    for (int it = 8; it > 2; it /= 2) {
        if ((chunk + it - 1) / it >= 256) {
            *items = it;
            break;
        }
    }
    *threads = ((chunk + *items - 1) / *items + 31) / 32 * 32;
}

// x: (b, n, c) float32, valid: (b, n) uint8 (0/1), out: (b, m) int32, all
// contiguous device memory; launches on `stream`, does not synchronise.
// n up to 32768 (a cluster of 8 blocks of 512 threads x 8 points). Returns
// the cudaError_t of the launch (0 on success).
extern "C" int fseg_fps_f32(const void* x, const void* valid, void* out,
                            int b, int n, int c, int m, void* stream) {
    if (b < 1 || n < 1 || c < 1 || c > FPS_MAX_C || m < 1)
        return (int)cudaErrorInvalidValue;
    int t, it, cs;
    pick(n, c, &t, &it, &cs);
    if ((long long)t * it * cs < n || (long long)b * cs > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    const float* xp = (const float*)x;
    const uint8_t* vp = (const uint8_t*)valid;
    int32_t* op = (int32_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (c) {
        case 1: return launch_items<1>(xp, vp, op, b, n, m, t, it, cs, s);
        case 2: return launch_items<2>(xp, vp, op, b, n, m, t, it, cs, s);
        case 3: return launch_items<3>(xp, vp, op, b, n, m, t, it, cs, s);
        case 4: return launch_items<4>(xp, vp, op, b, n, m, t, it, cs, s);
        case 5: return launch_items<5>(xp, vp, op, b, n, m, t, it, cs, s);
        case 6: return launch_items<6>(xp, vp, op, b, n, m, t, it, cs, s);
        case 7: return launch_items<7>(xp, vp, op, b, n, m, t, it, cs, s);
        default: return launch_items<8>(xp, vp, op, b, n, m, t, it, cs, s);
    }
}
