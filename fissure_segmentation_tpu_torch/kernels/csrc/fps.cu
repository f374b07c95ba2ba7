// K5: masked farthest-point sampling, one thread block per cloud, for
// Hopper (sm_90a).
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
// point chosen at step i - 1), and each step ends in a block-wide argmax.
// Bytes (N * (C * 4 + 1) read, m * 4 written) and flops (3 C N per step)
// are tiny at the path's shapes, so the kernel is bound by the latency of
// m - 1 dependent block reductions, each a few hundred cycles: about m
// times (the per-thread distance pass + 5 warp shuffles + one
// __syncthreads + a read of the warp results).
//
// Design: one block per cloud (the TPU kernel's grid over B), so B blocks
// run side by side on B SMs. Thread t owns the points t, t + T, t + 2T, ...
// (ITEMS of them; ITEMS is a compile-time bucket so the per-point running
// minimum and validity stay in registers). The coordinates are staged
// channel-major in shared memory when they fit in 46 KB, otherwise read
// from global memory, where they stay L1/L2-resident. Per step every thread
// reads the last point's coordinates (a broadcast), updates its points and
// keeps its own (score, index) best, scanning its points in ascending index
// order with a strict '>' so the first index wins a tie; a butterfly of warp
// shuffles gives every lane its warp's best; lane 0 writes it to one of two
// shared buffers (alternating by step), one __syncthreads, and every warp
// then reduces the warp results itself, so all threads know the next point
// without a second barrier. The comparator is (v > v') || (v == v' && i <
// i'), which is the first-occurrence argmax over the whole cloud. The
// double buffer makes the single barrier enough: a warp can write step
// i + 1's buffer only after every warp has passed step i's barrier, and it
// writes step i + 2's (the same buffer as step i's) only after every warp
// has passed step i + 1's barrier, i.e. has finished reading step i's.
//
// Rounding: explicit round-to-nearest intrinsics, and the library is built
// with -fmad=false, so d is rounded exactly like the plain version's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FPS_MAX_C 8
#define FPS_MAX_THREADS 1024
#define FPS_MAX_WARPS (FPS_MAX_THREADS / 32)
// dynamic shared memory for the staged coordinates; the static buffers
// (512 B) and the rest stay within the 48 KB a launch gets by default
#define FPS_SMEM_LIMIT (46 * 1024)
#define FPS_NO_INDEX 0x7fffffff  // loses every tie to a real index

struct Best {
    float v;
    int i;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
    return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, b.v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, b.i, off);
        if (better(ov, oi, b.v, b.i)) {
            b.v = ov;
            b.i = oi;
        }
    }
    return b;
}

// Block-wide first-occurrence argmax of the threads' (v, i) pairs; every
// thread returns the winner's index. `buf` alternates between calls.
__device__ __forceinline__ int block_argmax(Best b, float* wv, int* wi,
                                            int nwarps) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    b = warp_best(b);
    if (lane == 0) {
        wv[warp] = b.v;
        wi[warp] = b.i;
    }
    __syncthreads();
    Best r = {-INFINITY, FPS_NO_INDEX};
    if (lane < nwarps) {
        r.v = wv[lane];
        r.i = wi[lane];
    }
    return warp_best(r).i;
}

template <int ITEMS>
__global__ void __launch_bounds__(FPS_MAX_THREADS)
fps_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
           int32_t* __restrict__ out, int n, int c, int m, int use_smem) {
    extern __shared__ float smem_pts[];  // (c, n) channel-major, if used
    __shared__ float wv[2][FPS_MAX_WARPS];
    __shared__ int wi[2][FPS_MAX_WARPS];
    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const int nthreads = blockDim.x;
    const int nwarps = (nthreads + 31) >> 5;
    const float* xb = x + (size_t)b * n * c;
    const uint8_t* vb = valid + (size_t)b * n;

    // where point j's channel ch lives: pts[j * sp + ch * sc]
    const float* pts = xb;
    int sp = c, sc = 1;
    if (use_smem) {
        for (int e = t; e < n * c; e += nthreads)
            smem_pts[(e % c) * n + e / c] = xb[e];
        pts = smem_pts;
        sp = 1;
        sc = n;
    }

    static_assert(ITEMS <= 32, "validity bits are one uint32_t");
    uint32_t ok = 0;  // bit it: point t + it * nthreads is valid
    float min_d[ITEMS];
    Best own = {-INFINITY, FPS_NO_INDEX};
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
        const int j = t + it * nthreads;
        const bool v = j < n && vb[j] != 0;
        ok |= (uint32_t)v << it;
        min_d[it] = INFINITY;
        // first valid point: argmax of valid (0/1), first occurrence
        if (j < n && better(v ? 1.0f : 0.0f, j, own.v, own.i)) {
            own.v = v ? 1.0f : 0.0f;
            own.i = j;
        }
    }
    int last = block_argmax(own, wv[0], wi[0], nwarps);  // syncs smem_pts too
    if (t == 0) out[(size_t)b * m] = last;

    for (int step = 1; step < m; ++step) {
        float lp[FPS_MAX_C];
#pragma unroll
        for (int ch = 0; ch < FPS_MAX_C; ++ch)
            lp[ch] = ch < c ? pts[(size_t)last * sp + (size_t)ch * sc] : 0.0f;
        Best best = {-INFINITY, FPS_NO_INDEX};
#pragma unroll
        for (int it = 0; it < ITEMS; ++it) {
            const int j = t + it * nthreads;
            if (j < n) {
                float d = 0.0f;
#pragma unroll
                for (int ch = 0; ch < FPS_MAX_C; ++ch) {
                    if (ch < c) {
                        const float diff = __fsub_rn(
                            pts[(size_t)j * sp + (size_t)ch * sc], lp[ch]);
                        d = __fadd_rn(d, __fmul_rn(diff, diff));
                    }
                }
                min_d[it] = fminf(min_d[it], d);
                const float score = (ok >> it) & 1u ? min_d[it] : -INFINITY;
                if (better(score, j, best.v, best.i)) {
                    best.v = score;
                    best.i = j;
                }
            }
        }
        last = block_argmax(best, wv[step & 1], wi[step & 1], nwarps);
        if (t == 0) out[(size_t)b * m + step] = last;
    }
}

template <int ITEMS>
static void launch(const float* x, const uint8_t* v, int32_t* out, int b,
                   int n, int c, int m, cudaStream_t stream) {
    int threads = (n + ITEMS - 1) / ITEMS;
    threads = ((threads + 31) / 32) * 32;
    const size_t bytes = (size_t)n * c * sizeof(float);
    const int use_smem = bytes <= FPS_SMEM_LIMIT;
    fps_kernel<ITEMS><<<b, threads, use_smem ? bytes : 0, stream>>>(
        x, v, out, n, c, m, use_smem);
}

// x: (b, n, c) float32, valid: (b, n) uint8 (0/1), out: (b, m) int32, all
// contiguous device memory; launches on `stream`, does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fseg_fps_f32(const void* x, const void* valid, void* out,
                            int b, int n, int c, int m, void* stream) {
    if (b < 1 || n < 1 || n > 32 * FPS_MAX_THREADS || c < 1 ||
        c > FPS_MAX_C || m < 1)
        return (int)cudaErrorInvalidValue;
    const float* xp = (const float*)x;
    const uint8_t* vp = (const uint8_t*)valid;
    int32_t* op = (int32_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    // about 8 points a thread up to 8192 points, then wider buckets
    if (n <= 8 * FPS_MAX_THREADS)
        launch<8>(xp, vp, op, b, n, c, m, s);
    else if (n <= 16 * FPS_MAX_THREADS)
        launch<16>(xp, vp, op, b, n, c, m, s);
    else
        launch<32>(xp, vp, op, b, n, c, m, s);
    return (int)cudaGetLastError();
}
