// Streaming column sums, for Hopper (sm_90a): the card's counterparts of the
// Pallas streaming probes under scripts/prof/.
//
// Replaces
//   * prof_scatter_floor.py:make with k_stream (P1), prof_scatter_clean.py:
//     stream_floor (P2), prof_scatter_alt.py:pallas_blockspec (P3) and
//     prof_stream_bw.py:stream (P4) -> stream_sum_kernel: the column sums
//     of a (R, L) view of the scatter's payload, read with streaming 16-byte
//     vector loads;
//   * prof_scatter_alt.py:manual_reduce (P3), a manual nbuf-deep async-DMA
//     ring -> stream_async_kernel: the same sums, each block's tiles of
//     `chunk` rows brought into shared memory by an nbuf-deep ring of bulk
//     asynchronous copies (cp.async.bulk, the 1-D form of the Tensor Memory
//     Accelerator) that one producer warp keeps full.
// Both ask the TPU probes' question of this card: how fast can it stream
// the scatter's payload (32, 81 920, 64) bf16, 335.5 MB?
//
// What bounds them: the bytes of g, read once (0.1 ms for 335.5 MB at 3.35
// TB/s); one add per element is far below the float32 rate. So the design
// is about keeping enough bytes in flight on every SM and paying nothing
// after the last byte arrives:
//   * one launch a call: each block writes its partial row of L sums, and
//     the blocks add those rows themselves through a fixed two-level tree
//     of tickets (finish_sums): the last block of each group of ST_GROUP
//     blocks adds its group's rows in block order, and the last of those
//     adds the groups' rows in group order (and, if asked, the L sums into
//     one total). The tickets live in a per-stream counter array that the
//     finishing blocks set back to 0, so consecutive calls on one stream
//     share it and calls on two streams never do (kernels/stream.py);
//   * stream_sum_kernel: a grid of as many blocks as the card holds at
//     once (at most ST_BLOCKS_PER_SM an SM), the 4 KB units dealt to the
//     blocks in turn so that the grid sweeps the array front to back; a
//     thread issues ST_UNROLL independent 16-byte loads (L1::no_allocate,
//     L2 evict-first) before its first add, with no bound test inside a
//     strip and a separate tail;
//   * stream_async_kernel: warp-specialised; the producer warp's lane 0
//     fills ring slot s and arms its `full` mbarrier with the slot's bytes
//     (expect_tx), and refills it as soon as every consumer warp has
//     arrived on its `empty` mbarrier; no block-wide barrier per tile.
//
// Order of the additions, so the result is deterministic and its rounding
// bounded (kernels/stream.py:depth counts it; stream.py:replay replays it):
// a thread's own sequence into V float32 accumulators (one per column of
// its 16-byte vector), in increasing vector order; inside a warp a
// butterfly over the row lanes that share a column group (every lane ends
// with the same bits); across warps a sum in warp order; then the groups'
// and the final tree, each a sum in block (group) order; every sum starts
// from 0. Every value reaches the result through at most `depth` float32
// additions, so the sum is within gamma_depth * sum|g| of the exact one.
//
// Layout: a 16-byte vector holds V = 16 / sizeof(T) consecutive values of
// one row (L % V == 0), so the view is a flat sequence of R * L / V vectors,
// vector j covering columns (j % G) * V .. + V with G = L / V column groups.
// G divides the 256 threads that read (a power of two), so a thread that
// reads vectors tid + 256 k always meets column group tid % G.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define ST_THREADS 256          // threads that read and add
#define ST_WARPS (ST_THREADS / 32)
#define ST_UNROLL 8             // 16-byte loads in flight a thread
#define ST_BLOCKS_PER_SM 4      // stream_sum_kernel's cap
#define ST_ASYNC_BLOCKS_PER_SM 7   // 7 x 288 threads fit an SM's 2048
#define ST_MAX_NBUF 16
#define ST_COPY (1 << 20)       // bytes a bulk copy moves at most
#define ST_GROUP 16             // blocks a first-level finisher adds
#define ST_COUNTERS 256         // ints of the per-stream ticket array
#define ST_SPIN_LIMIT (1u << 24)   // mbarrier tries before a trap

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

__device__ __forceinline__ uint64_t evict_first_policy() {
    uint64_t pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(pol));
    return pol;
}

// a read-once 16-byte load: not kept in L1, first out of L2
__device__ __forceinline__ uint4 load_stream(const uint4* p, uint64_t pol) {
    uint4 v;
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3},"
        " [%4], %5;\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
    return v;
}

// the ST_THREADS threads that read (not the producer warp)
__device__ __forceinline__ void readers_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(ST_THREADS) : "memory");
}

// The block's partial column sums into prow[0 .. l) from each thread's acc
// (column group tid % g, row lane tid / g): a butterfly inside each warp
// over its 32 / g row lanes (g < 32), then the warps in order; red:
// ST_THREADS * V floats of shared memory.
template <int V>
__device__ __forceinline__ void block_partial(float* acc, float* red,
                                              float* __restrict__ prow, int l,
                                              int g, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    for (int off = 16; off >= g; off >>= 1) {
#pragma unroll
        for (int i = 0; i < V; ++i)
            acc[i] = __fadd_rn(acc[i],
                               __shfl_xor_sync(0xffffffffu, acc[i], off));
    }
    if (lane < g) {
#pragma unroll
        for (int i = 0; i < V; ++i) red[(warp * 32 + lane) * V + i] = acc[i];
    }
    readers_sync();
    // warp w holds column group cg (in lane cg % 32) where w * 32 and cg
    // agree modulo g in their multiples of 32
    for (int col = tid; col < l; col += ST_THREADS) {
        const int cg = col / V, e = col % V, base = cg & ~31;
        float s = 0.0f;
        for (int w = 0; w < ST_WARPS; ++w)
            if ((w * 32) % g == base)
                s = __fadd_rn(s, red[(w * 32 + (cg & 31)) * V + e]);
        prow[col] = s;
    }
}

// a ticket: one more at *c, returning the count before it; acq_rel at the
// card's scope, so the block's rows (ordered before it by the block's
// barrier) are visible to the block that draws the last ticket, and that
// block sees every row drawn before it
__device__ __forceinline__ int ticket(int* c) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(c) : "memory");
    return old;
}

__device__ __forceinline__ void add4(float4& s, const float4& x) {
    s.x = __fadd_rn(s.x, x.x);
    s.y = __fadd_rn(s.y, x.y);
    s.z = __fadd_rn(s.z, x.z);
    s.w = __fadd_rn(s.w, x.w);
}

// The one-launch finish. part: (blocks + groups, l) float32, the blocks'
// rows then the groups' (16-byte aligned); cnt: the stream's tickets
// (groups + 1 ints, 0 on entry and on exit); out: (l,), 16-byte aligned;
// total: a float, or null.
__device__ __forceinline__ void finish_sums(float* __restrict__ part,
                                            int* __restrict__ cnt,
                                            float* __restrict__ out,
                                            float* __restrict__ total, int l,
                                            int tid) {
    __shared__ int last;
    const int blocks = gridDim.x;
    const int groups = (blocks + ST_GROUP - 1) / ST_GROUP;
    const int grp = blockIdx.x / ST_GROUP, first = grp * ST_GROUP;
    const int size = blocks - first < ST_GROUP ? blocks - first : ST_GROUP;
    readers_sync();             // the block's row, before its ticket
    if (tid == 0) last = ticket(&cnt[grp]) == size - 1;
    readers_sync();
    if (!last) return;
    if (tid == 0) cnt[grp] = 0;
    // four neighbouring columns a thread (l % 4 == 0, rows 16-byte aligned)
    const int l4 = l / 4;
    const float4* rows4 = reinterpret_cast<const float4*>(part);
    float4* grow =
        reinterpret_cast<float4*>(part) + (long long)(blocks + grp) * l4;
    for (int c = tid; c < l4; c += ST_THREADS) {
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 16
        for (int b = 0; b < size; ++b)
            add4(s, __ldcg(rows4 + (long long)(first + b) * l4 + c));
        grow[c] = s;
    }
    readers_sync();
    if (tid == 0) last = ticket(&cnt[groups]) == groups - 1;
    readers_sync();
    if (!last) return;
    if (tid == 0) cnt[groups] = 0;
    for (int c = tid; c < l4; c += ST_THREADS) {
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 16
        for (int q = 0; q < groups; ++q)
            add4(s, __ldcg(rows4 + (long long)(blocks + q) * l4 + c));
        reinterpret_cast<float4*>(out)[c] = s;
    }
    if (total == nullptr) return;
    readers_sync();
    if (tid < 32) {             // columns tid, tid + 32, ..., then a butterfly
        float s = 0.0f;
        for (int col = tid; col < l; col += 32) s = __fadd_rn(s, out[col]);
        for (int off = 16; off >= 1; off >>= 1)
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
        if (tid == 0) *total = s;
    }
}

// Units of ST_THREADS vectors (4 KB) are dealt to the blocks in turn:
// block b takes units b, b + blocks, b + 2 blocks, ..., ST_UNROLL of them
// at a time, so the grid sweeps the array front to back; the last block
// also takes the vectors past the last whole unit.
template <typename T>
__global__ void __launch_bounds__(ST_THREADS, ST_BLOCKS_PER_SM)
stream_sum_kernel(const uint4* __restrict__ g, float* __restrict__ part,
                  int* __restrict__ cnt, float* __restrict__ out,
                  float* __restrict__ total, long long vectors, int l) {
    constexpr int V = Vec16<T>::V;
    __shared__ float red[ST_THREADS * V];
    const int tid = threadIdx.x;
    const uint64_t pol = evict_first_policy();
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    const long long units = vectors / ST_THREADS;
    const long long step = gridDim.x;
    long long u = blockIdx.x;
    for (; u + (ST_UNROLL - 1) * step < units; u += ST_UNROLL * step) {
        const uint4* p = g + u * ST_THREADS + tid;
        uint4 v[ST_UNROLL];
#pragma unroll
        for (int k = 0; k < ST_UNROLL; ++k)
            v[k] = load_stream(p + k * step * ST_THREADS, pol);
#pragma unroll
        for (int k = 0; k < ST_UNROLL; ++k) Vec16<T>::add(acc, v[k]);
    }
    for (; u < units; u += step)
        Vec16<T>::add(acc, load_stream(g + u * ST_THREADS + tid, pol));
    if (blockIdx.x == gridDim.x - 1 && units * ST_THREADS + tid < vectors)
        Vec16<T>::add(acc, load_stream(g + units * ST_THREADS + tid, pol));
    block_partial<V>(acc, red, part + (long long)blockIdx.x * l, l, l / V,
                     tid);
    finish_sums(part, cnt, out, total, l, tid);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// wait for the completion of the phase of parity `parity`; a ring that
// never completes traps instead of hanging the card
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0, tries = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
        if (++tries == ST_SPIN_LIMIT) __trap();
    }
}

// arm `bar` with `bytes` and copy them from src to dst in pieces of at
// most ST_COPY bytes, each completing on `bar`; L2 evict-first
__device__ __forceinline__ void bulk_load(unsigned char* dst, const char* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t pol) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    for (uint32_t off = 0; off < bytes; off += ST_COPY) {
        const uint32_t n = bytes - off < ST_COPY ? bytes - off : ST_COPY;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
            :: "r"(smem_addr(dst + off)), "l"(src + off), "r"(n),
               "r"(smem_addr(bar)), "l"(pol)
            : "memory");
    }
}

// Tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... of `chunk` rows; the
// i-th of them goes to ring slot i % nbuf and completes phase (i / nbuf) & 1
// of full[slot]; its readers complete the same phase of empty[slot] (one
// arrival a reading warp), which the producer waits for before fill
// i + nbuf. Threads 0 .. ST_THREADS - 1 read; the last warp produces.
template <typename T>
__global__ void __launch_bounds__(ST_THREADS + 32, 4)
stream_async_kernel(const char* __restrict__ g, float* __restrict__ part,
                    int* __restrict__ cnt, float* __restrict__ out,
                    float* __restrict__ total, long long rows, int l,
                    int chunk, int nbuf) {
    constexpr int V = Vec16<T>::V;
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ __align__(8) uint64_t full[ST_MAX_NBUF];
    __shared__ __align__(8) uint64_t empty[ST_MAX_NBUF];
    __shared__ float red[ST_THREADS * V];
    const int tid = threadIdx.x;
    const int gcols = l / V;
    const long long row_bytes = (long long)l * sizeof(T);
    const long long tile_bytes = (long long)chunk * row_bytes;
    const long long tiles = (rows + chunk - 1) / chunk;
    const long long mine =
        tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    if (tid == 0) {
        for (int s = 0; s < nbuf; ++s) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         :: "r"(smem_addr(&full[s])) : "memory");
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                         :: "r"(smem_addr(&empty[s])), "n"(ST_WARPS)
                         : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= ST_THREADS) {    // the producer warp: lane 0 issues
        if (tid == ST_THREADS) {
            const uint64_t pol = evict_first_policy();
            for (long long i = 0; i < mine; ++i) {
                const int s = (int)(i % nbuf);
                if (i >= nbuf)
                    wait_parity(&empty[s], (uint32_t)((i / nbuf + 1) & 1));
                // order the readers' (generic) reads of the slot before
                // the (async) refill
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                const long long r0 = (blockIdx.x + i * gridDim.x) * chunk;
                const long long nr = rows - r0 < chunk ? rows - r0 : chunk;
                bulk_load(ring + s * tile_bytes, g + r0 * row_bytes,
                          (uint32_t)(nr * row_bytes), &full[s], pol);
            }
        }
        return;
    }

    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (long long i = 0; i < mine; ++i) {
        const int s = (int)(i % nbuf);
        const long long r0 = (blockIdx.x + i * gridDim.x) * chunk;
        const int n = (int)((rows - r0 < chunk ? rows - r0 : chunk) * gcols);
        wait_parity(&full[s], (uint32_t)((i / nbuf) & 1));
        const uint4* tile =
            reinterpret_cast<const uint4*>(ring + s * tile_bytes);
#pragma unroll 4
        for (int j = tid; j < n; j += ST_THREADS) Vec16<T>::add(acc, tile[j]);
        __syncwarp();
        if ((tid & 31) == 0)
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                         :: "r"(smem_addr(&empty[s])) : "memory");
    }
    block_partial<V>(acc, red, part + (long long)blockIdx.x * l, l, gcols,
                     tid);
    finish_sums(part, cnt, out, total, l, tid);
}

static bool bad_view(const void* g, long long rows, int l, int elem) {
    const int v = 16 / elem;
    return rows < 1 || l < v || l % v != 0 || ST_THREADS % (l / v) != 0 ||
           (uintptr_t)g % 16 != 0;
}

static bool bad_grid(int blocks, const void* part, const void* out) {
    return blocks < 1 ||
           (blocks + ST_GROUP - 1) / ST_GROUP + 1 > ST_COUNTERS ||
           (uintptr_t)part % 16 != 0 || (uintptr_t)out % 16 != 0;
}

// Blocks of stream_sum_kernel (chunk == 0) or of stream_async_kernel at
// (chunk, nbuf) that one SM of the current device holds at once, capped;
// a negative cudaError_t on failure.
extern "C" int fseg_stream_occupancy(int l, int bf16, int chunk, int nbuf) {
    const int elem = bf16 ? 2 : 4;
    int n = 0;
    cudaError_t err;
    if (chunk == 0) {
        err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, stream_sum_kernel<__nv_bfloat16>, ST_THREADS, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, stream_sum_kernel<float>, ST_THREADS, 0);
        if (err != cudaSuccess) return -(int)err;
        return n < ST_BLOCKS_PER_SM ? n : ST_BLOCKS_PER_SM;
    }
    const size_t smem = (size_t)nbuf * chunk * l * elem;
    if (bf16) {
        err = cudaFuncSetAttribute(stream_async_kernel<__nv_bfloat16>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, stream_async_kernel<__nv_bfloat16>, ST_THREADS + 32, smem);
    } else {
        err = cudaFuncSetAttribute(stream_async_kernel<float>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, stream_async_kernel<float>, ST_THREADS + 32, smem);
    }
    if (err != cudaSuccess) return -(int)err;
    return n < ST_ASYNC_BLOCKS_PER_SM ? n : ST_ASYNC_BLOCKS_PER_SM;
}

// g: (rows, l) float32 (bf16 == 0) or bfloat16 (bf16 == 1), contiguous and
// 16-byte aligned, l a multiple of the 16-byte vector with 256 % (l / V) ==
// 0; part: (blocks + ceil(blocks / ST_GROUP), l) float32 scratch, 16-byte
// aligned; cnt: the stream's ST_COUNTERS ints, all 0; out: (l,) float32,
// 16-byte aligned; total: one float32 (the sum of out) or null. One launch
// on `stream`, no synchronisation; returns the cudaError_t.
extern "C" int fseg_stream_sum(const void* g, void* part, void* cnt,
                               void* out, void* total, long long rows, int l,
                               int bf16, int blocks, void* stream) {
    const int elem = bf16 ? 2 : 4;
    if (bad_view(g, rows, l, elem) || bad_grid(blocks, part, out))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long vectors = rows * (long long)l * elem / 16;
    if (bf16)
        stream_sum_kernel<__nv_bfloat16><<<blocks, ST_THREADS, 0, st>>>(
            (const uint4*)g, (float*)part, (int*)cnt, (float*)out,
            (float*)total, vectors, l);
    else
        stream_sum_kernel<float><<<blocks, ST_THREADS, 0, st>>>(
            (const uint4*)g, (float*)part, (int*)cnt, (float*)out,
            (float*)total, vectors, l);
    return (int)cudaGetLastError();
}

// The same sums through the copy ring: `chunk` rows a tile, `nbuf` slots
// (nbuf * chunk * l * elem bytes of dynamic shared memory, at most 200 KB).
extern "C" int fseg_stream_sum_async(const void* g, void* part, void* cnt,
                                     void* out, void* total, long long rows,
                                     int l, int bf16, int chunk, int nbuf,
                                     int blocks, void* stream) {
    const int elem = bf16 ? 2 : 4;
    const long long smem = (long long)nbuf * chunk * l * elem;
    if (bad_view(g, rows, l, elem) || bad_grid(blocks, part, out) ||
        chunk < 1 || nbuf < 1 || nbuf > ST_MAX_NBUF || smem > 200 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (bf16) {
        err = cudaFuncSetAttribute(stream_async_kernel<__nv_bfloat16>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        stream_async_kernel<__nv_bfloat16>
            <<<blocks, ST_THREADS + 32, smem, st>>>(
                (const char*)g, (float*)part, (int*)cnt, (float*)out,
                (float*)total, rows, l, chunk, nbuf);
    } else {
        err = cudaFuncSetAttribute(stream_async_kernel<float>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        stream_async_kernel<float><<<blocks, ST_THREADS + 32, smem, st>>>(
            (const char*)g, (float*)part, (int*)cnt, (float*)out,
            (float*)total, rows, l, chunk, nbuf);
    }
    return (int)cudaGetLastError();
}
