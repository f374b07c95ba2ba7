// Streaming column sums, for Hopper (sm_90a): the card's counterparts of the
// Pallas streaming probes under scripts/prof/.
//
// Replaces
//   * prof_scatter_floor.py:make with k_stream (P1), prof_scatter_clean.py:
//     stream_floor (P2), prof_scatter_alt.py:pallas_blockspec (P3) and
//     prof_stream_bw.py:stream (P4) -> stream_sum_kernel: the column sums
//     of a (R, L) view of the scatter's payload, read with plain 16-byte
//     vector loads;
//   * prof_scatter_alt.py:manual_reduce (P3), a manual nbuf-deep async-DMA
//     ring -> stream_async_kernel: the same sums, each block's tiles of
//     `chunk` rows brought into shared memory by an nbuf-deep ring of
//     bulk asynchronous copies (cp.async.bulk, the 1-D form of the Tensor
//     Memory Accelerator), each completing on its own mbarrier.
// Both ask the TPU probes' question of this card: how fast can it stream
// the scatter's payload (32, 81 920, 64) bf16, 335.5 MB?
//
// Output: (L,) float32 column sums of g (float32 or bfloat16). Each block
// writes its partial row of L sums; finish_kernel then adds the partials of
// every column in block order. Inside a thread, a block and the final pass
// the order of the additions is fixed, so the result is deterministic. Its
// rounding: every value reaches the result through at most `depth` float32
// additions (a thread's own sequence, then one add per thread of its column
// group, then one per block; kernels/stream.py:depth counts them), so the
// sum is within gamma_depth * sum|g| of the exact column sum.
//
// What bounds them: the bytes of g, read once (0.1 ms for 335.5 MB at 3.35
// TB/s); one add per element is far below the float32 rate.
//
// Layout: a 16-byte vector holds V = 16 / sizeof(T) consecutive values of
// one row (L % V == 0), so the view is a flat sequence of R * L / V vectors,
// vector j covering columns (j % G) * V .. + V with G = L / V column groups.
// G divides the block size (256), so in stream_sum_kernel's grid-stride loop
// a thread always meets the same column group (tid % G), and in the async
// kernel thread tid reads rows tid / G, tid / G + 256 / G, ... of each tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define ST_THREADS 256
#define ST_MAX_NBUF 16

template <typename T>
struct Vec16;   // the V values of one 16-byte vector, as float
template <>
struct Vec16<float> {
    static constexpr int V = 4;
    static __device__ __forceinline__ void add(float* acc, const uint4& u) {
        acc[0] = __fadd_rn(acc[0], __uint_as_float(u.x));
        acc[1] = __fadd_rn(acc[1], __uint_as_float(u.y));
        acc[2] = __fadd_rn(acc[2], __uint_as_float(u.z));
        acc[3] = __fadd_rn(acc[3], __uint_as_float(u.w));
    }
};
template <>
struct Vec16<__nv_bfloat16> {
    static constexpr int V = 8;
    static __device__ __forceinline__ void add(float* acc, const uint4& u) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // a bfloat16 is the high half of the float32 with its bits
            acc[2 * i] = __fadd_rn(acc[2 * i], __uint_as_float(w[i] << 16));
            acc[2 * i + 1] =
                __fadd_rn(acc[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u));
        }
    }
};

// The block's partial column sums from each thread's acc (column group
// tid % g, row lane tid / g), added in row-lane order; red: ST_THREADS * V
// floats of shared memory.
template <int V>
__device__ __forceinline__ void block_partial(const float* acc, float* red,
                                              float* __restrict__ part, int l,
                                              int g) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < V; ++i) red[tid * V + i] = acc[i];
    __syncthreads();
    const int lanes = ST_THREADS / g;
    for (int col = tid; col < l; col += ST_THREADS) {
        const int cg = col / V, e = col % V;
        float s = 0.0f;
        for (int r = 0; r < lanes; ++r) s = __fadd_rn(s, red[(r * g + cg) * V + e]);
        part[(long long)blockIdx.x * l + col] = s;
    }
}

template <typename T>
__global__ void __launch_bounds__(ST_THREADS)
stream_sum_kernel(const uint4* __restrict__ g, float* __restrict__ part,
                  long long vectors, int l) {
    constexpr int V = Vec16<T>::V;
    __shared__ float red[ST_THREADS * V];
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    const long long stride = (long long)gridDim.x * ST_THREADS;
    long long j = (long long)blockIdx.x * ST_THREADS + threadIdx.x;
#pragma unroll 4
    for (; j < vectors; j += stride) Vec16<T>::add(acc, __ldcs(g + j));
    block_partial<V>(acc, red, part, l, l / V);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}

// Tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... of `chunk` rows; the
// i-th of them goes to ring slot i % nbuf and completes phase (i / nbuf) & 1
// of that slot's mbarrier. Thread 0 keeps nbuf copies in flight: it refills
// a slot after the barrier that follows every thread's reads of it.
template <typename T>
__global__ void __launch_bounds__(ST_THREADS)
stream_async_kernel(const char* __restrict__ g, float* __restrict__ part,
                    long long rows, int l, int chunk, int nbuf) {
    constexpr int V = Vec16<T>::V;
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ __align__(8) uint64_t bar[ST_MAX_NBUF];
    __shared__ float red[ST_THREADS * V];
    const int tid = threadIdx.x;
    const int gcols = l / V;
    const long long row_bytes = (long long)l * sizeof(T);
    const long long tile_bytes = (long long)chunk * row_bytes;
    const long long tiles = (rows + chunk - 1) / chunk;
    const long long mine =
        tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    if (tid == 0) {
        for (int s = 0; s < nbuf; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         :: "r"(smem_addr(&bar[s])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    auto load_tile = [&](long long i) {
        const long long t = blockIdx.x + i * gridDim.x;
        const long long r0 = t * chunk;
        const long long nr = rows - r0 < chunk ? rows - r0 : chunk;
        const int s = (int)(i % nbuf);
        bulk_load(ring + s * tile_bytes, g + r0 * row_bytes,
                  (uint32_t)(nr * row_bytes), &bar[s]);
    };
    if (tid == 0)
        for (long long i = 0; i < nbuf && i < mine; ++i) load_tile(i);

    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    const int cg = tid % gcols;
    const int lanes = ST_THREADS / gcols;
    for (long long i = 0; i < mine; ++i) {
        const int s = (int)(i % nbuf);
        const long long t = blockIdx.x + i * gridDim.x;
        const long long nr =
            rows - t * chunk < chunk ? rows - t * chunk : chunk;
        wait_parity(&bar[s], (uint32_t)((i / nbuf) & 1));
        const uint4* tile = reinterpret_cast<const uint4*>(ring + s * tile_bytes);
        for (long long r = tid / gcols; r < nr; r += lanes)
            Vec16<T>::add(acc, tile[r * gcols + cg]);
        __syncthreads();   // every read of slot s is done
        if (tid == 0 && i + nbuf < mine) {
            // order those (generic) reads before the (async) refill
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            load_tile(i + nbuf);
        }
    }
    block_partial<V>(acc, red, part, l, gcols);
}

// out[col] = sum over blocks b of part[b, col], in block order
__global__ void finish_kernel(const float* __restrict__ part,
                              float* __restrict__ out, int blocks, int l) {
    for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < l;
         col += gridDim.x * blockDim.x) {
        float s = 0.0f;
#pragma unroll 8
        for (int b = 0; b < blocks; ++b)
            s = __fadd_rn(s, part[(long long)b * l + col]);
        out[col] = s;
    }
}

static bool bad_view(const void* g, long long rows, int l, int elem) {
    const int v = 16 / elem;
    return rows < 1 || l < v || l % v != 0 || ST_THREADS % (l / v) != 0 ||
           (uintptr_t)g % 16 != 0;
}

static int finish(const float* part, float* out, int blocks, int l,
                  cudaStream_t st) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish_kernel<<<(l + ST_THREADS - 1) / ST_THREADS, ST_THREADS, 0, st>>>(
        part, out, blocks, l);
    return (int)cudaGetLastError();
}

// g: (rows, l) float32 (bf16 == 0) or bfloat16 (bf16 == 1), contiguous and
// 16-byte aligned, l a multiple of the 16-byte vector with 256 % (l / V) ==
// 0; part: (blocks, l) float32 scratch; out: (l,) float32. Launches on
// `stream` and does not synchronise; returns the cudaError_t.
extern "C" int fseg_stream_sum(const void* g, void* part, void* out,
                               long long rows, int l, int bf16, int blocks,
                               void* stream) {
    const int elem = bf16 ? 2 : 4;
    if (bad_view(g, rows, l, elem) || blocks < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long vectors = rows * (long long)l * elem / 16;
    if (bf16)
        stream_sum_kernel<__nv_bfloat16><<<blocks, ST_THREADS, 0, st>>>(
            (const uint4*)g, (float*)part, vectors, l);
    else
        stream_sum_kernel<float><<<blocks, ST_THREADS, 0, st>>>(
            (const uint4*)g, (float*)part, vectors, l);
    return finish((const float*)part, (float*)out, blocks, l, st);
}

// The same sums through the copy ring: `chunk` rows a tile, `nbuf` slots
// (nbuf * chunk * l * elem bytes of dynamic shared memory, at most 200 KB).
extern "C" int fseg_stream_sum_async(const void* g, void* part, void* out,
                                     long long rows, int l, int bf16,
                                     int chunk, int nbuf, int blocks,
                                     void* stream) {
    const int elem = bf16 ? 2 : 4;
    const long long smem = (long long)nbuf * chunk * l * elem;
    if (bad_view(g, rows, l, elem) || blocks < 1 || chunk < 1 || nbuf < 1 ||
        nbuf > ST_MAX_NBUF || smem > 200 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (bf16) {
        err = cudaFuncSetAttribute(stream_async_kernel<__nv_bfloat16>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        stream_async_kernel<__nv_bfloat16><<<blocks, ST_THREADS, smem, st>>>(
            (const char*)g, (float*)part, rows, l, chunk, nbuf);
    } else {
        err = cudaFuncSetAttribute(stream_async_kernel<float>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        stream_async_kernel<float><<<blocks, ST_THREADS, smem, st>>>(
            (const char*)g, (float*)part, rows, l, chunk, nbuf);
    }
    return finish((const float*)part, (float*)out, blocks, l, st);
}
