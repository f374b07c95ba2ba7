// K2-K4: the EdgeConv scatter kernels (gather backward), for Hopper (sm_90a).
//
// Replaces fissure_segmentation_tpu/ops/pallas/scatter.py:
//   K2a scatter_add_mm2 and K2b scatter_add_mm -> scatter_rows_kernel
//       out[b, idx[b, e], :] += g[b, e, :]          (f32 or bf16 payload)
//   K3  scatter_add_routed                      -> scatter_routed_kernel
//       out[b, idx[b, n, kstar[b, n, c]], c]   += s[b, n, c]
//       out[b, idx[b, n, k], C + c] (every k)  += p[b, n, c]
//   K4  scatter_count                           -> count_kernel
//       out[b, m] = #{e : idx[b, e] == m}
// All outputs are float32. A target outside [0, n_rows) is dropped, as JAX's
// scatter drops it.
//
// The TPU kernels turn the scatter into one-hot matmuls (the MXU was idle
// and XLA's scatter serialised); the two-level n_lo/n_hi split, the hi/lo
// bf16 split of f32 payloads and the k-major tile order are all workarounds
// for the MXU and VMEM. None of it carries over. Here the scatter is a
// gather over the TRANSPOSED graph: the wrapper (kernels/scatter.py) sorts
// the edge ids by target row with a stable sort, so every row's incoming
// edges lie contiguously in ascending edge order (`order`, with row r's
// range [ptr[r], ptr[r+1])), and then
//
//   * K2/K3: one warp per target row walks its incoming edges and sums the
//     payload rows into registers, lane l owning channels l, l+32, ...; each
//     output element is summed by one thread in ascending edge order, so the
//     result is deterministic (no float atomics) and the same on every run;
//   * K3 builds each edge's payload from the node fields on the fly: edge
//     e = (n, k) contributes s[n, c] to channel c only where kstar[n, c] == k,
//     and p[n, c] to channel C + c always, so the (B, N, K, 2C) routed
//     payload never exists in device memory;
//   * K4 is an integer histogram (integer atomics are exact and order-free),
//     converted to float32 (exact below 2^24).
//
// What bounds them: K2 reads every payload row once (671 MB of f32 at the
// DGCNN train step, B=32, E=81 920, C=64) in 256-byte rows at random row
// addresses, so it is bound by device-memory bandwidth; K3 reads three
// (B, N, C) node fields, K times each, mostly from L2, and writes (B, N, 2C);
// K4 is bound by atomic throughput on B * n_rows counters.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SCATTER_WARPS 8     // rows per block: one warp each
#define SCATTER_MAX_C 256   // channels a lane set covers: 8 per lane
#define COUNT_THREADS 256

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// out[r, :] = sum over j in [ptr[r], ptr[r+1]) of g[order[j], :], j ascending
template <typename T, int CPL>
__global__ void __launch_bounds__(SCATTER_WARPS * 32)
scatter_rows_kernel(const T* __restrict__ g, const int64_t* __restrict__ order,
                    const int64_t* __restrict__ ptr, float* __restrict__ out,
                    long long rows, int c) {
    const long long r =
        (long long)blockIdx.x * SCATTER_WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (r >= rows) return;
    float acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0.0f;
    const int64_t j1 = ptr[r + 1];
#pragma unroll 4
    for (int64_t j = ptr[r]; j < j1; ++j) {
        const T* src = g + order[j] * (int64_t)c;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
            const int ch = lane + 32 * i;
            if (ch < c) acc[i] = __fadd_rn(acc[i], to_f32<T>(src[ch]));
        }
    }
    float* dst = out + r * (long long)c;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
        const int ch = lane + 32 * i;
        if (ch < c) dst[ch] = acc[i];
    }
}

// Row r's incoming edges are flat edge ids fe = node * kk + slot, node the
// flat (b * N + n) source; channel c adds s[node, c] iff kstar[node, c] ==
// slot, channel C + c adds p[node, c].
template <typename T, int CPL>
__global__ void __launch_bounds__(SCATTER_WARPS * 32)
scatter_routed_kernel(const int32_t* __restrict__ kstar,
                      const T* __restrict__ s, const T* __restrict__ p,
                      const int64_t* __restrict__ order,
                      const int64_t* __restrict__ ptr, float* __restrict__ out,
                      long long rows, int kk, int c) {
    const long long r =
        (long long)blockIdx.x * SCATTER_WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (r >= rows) return;
    float as[CPL], ap[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
        as[i] = 0.0f;
        ap[i] = 0.0f;
    }
    const int64_t j1 = ptr[r + 1];
#pragma unroll 2
    for (int64_t j = ptr[r]; j < j1; ++j) {
        const int64_t fe = order[j];
        const int64_t node = fe / kk;
        const int slot = (int)(fe - node * kk);
        const int64_t base = node * (int64_t)c;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
            const int ch = lane + 32 * i;
            if (ch < c) {
                ap[i] = __fadd_rn(ap[i], to_f32<T>(p[base + ch]));
                if (kstar[base + ch] == slot)
                    as[i] = __fadd_rn(as[i], to_f32<T>(s[base + ch]));
            }
        }
    }
    float* dst = out + r * 2LL * c;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
        const int ch = lane + 32 * i;
        if (ch < c) {
            dst[ch] = as[i];
            dst[c + ch] = ap[i];
        }
    }
}

__global__ void __launch_bounds__(COUNT_THREADS)
count_kernel(const int32_t* __restrict__ idx, int32_t* __restrict__ cnt,
             long long total, long long e, int n_rows) {
    const long long t = (long long)blockIdx.x * COUNT_THREADS + threadIdx.x;
    if (t >= total) return;
    const int m = idx[t];
    if (m >= 0 && m < n_rows) atomicAdd(&cnt[(t / e) * n_rows + m], 1);
}

__global__ void __launch_bounds__(COUNT_THREADS)
to_float_kernel(const int32_t* __restrict__ cnt, float* __restrict__ out,
                long long n) {
    const long long t = (long long)blockIdx.x * COUNT_THREADS + threadIdx.x;
    if (t < n) out[t] = (float)cnt[t];
}

static unsigned int row_blocks(long long rows) {
    return (unsigned int)((rows + SCATTER_WARPS - 1) / SCATTER_WARPS);
}

template <typename T>
static void launch_rows(const void* g, const int64_t* order, const int64_t* ptr,
                        float* out, long long rows, int c, cudaStream_t st) {
    const dim3 grid(row_blocks(rows)), block(SCATTER_WARPS * 32);
    const T* gp = (const T*)g;
    if (c <= 32)
        scatter_rows_kernel<T, 1><<<grid, block, 0, st>>>(gp, order, ptr, out, rows, c);
    else if (c <= 64)
        scatter_rows_kernel<T, 2><<<grid, block, 0, st>>>(gp, order, ptr, out, rows, c);
    else if (c <= 128)
        scatter_rows_kernel<T, 4><<<grid, block, 0, st>>>(gp, order, ptr, out, rows, c);
    else
        scatter_rows_kernel<T, 8><<<grid, block, 0, st>>>(gp, order, ptr, out, rows, c);
}

template <typename T>
static void launch_routed(const int32_t* kstar, const void* s, const void* p,
                          const int64_t* order, const int64_t* ptr, float* out,
                          long long rows, int kk, int c, cudaStream_t st) {
    const dim3 grid(row_blocks(rows)), block(SCATTER_WARPS * 32);
    const T* sp = (const T*)s;
    const T* pp = (const T*)p;
    if (c <= 32)
        scatter_routed_kernel<T, 1><<<grid, block, 0, st>>>(kstar, sp, pp, order, ptr, out, rows, kk, c);
    else if (c <= 64)
        scatter_routed_kernel<T, 2><<<grid, block, 0, st>>>(kstar, sp, pp, order, ptr, out, rows, kk, c);
    else if (c <= 128)
        scatter_routed_kernel<T, 4><<<grid, block, 0, st>>>(kstar, sp, pp, order, ptr, out, rows, kk, c);
    else
        scatter_routed_kernel<T, 8><<<grid, block, 0, st>>>(kstar, sp, pp, order, ptr, out, rows, kk, c);
}

static bool bad_rows(long long rows) {
    return rows < 1 || row_blocks(rows) > 0x7fffffffu;
}

// K2. g: (rows_in, c) payload rows (float32 if bf16 == 0, bfloat16 if 1);
// order: int64 edge ids sorted by target row; ptr: (rows + 1) int64 row
// offsets into order; out: (rows, c) float32. All contiguous device memory;
// launches on `stream`, does not synchronise. Returns the cudaError_t.
extern "C" int fseg_scatter_rows(const void* g, const void* order,
                                 const void* ptr, void* out, long long rows,
                                 int c, int bf16, void* stream) {
    if (bad_rows(rows) || c < 1 || c > SCATTER_MAX_C)
        return (int)cudaErrorInvalidValue;
    const int64_t* op = (const int64_t*)order;
    const int64_t* pp = (const int64_t*)ptr;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        launch_rows<__nv_bfloat16>(g, op, pp, (float*)out, rows, c, st);
    else
        launch_rows<float>(g, op, pp, (float*)out, rows, c, st);
    return (int)cudaGetLastError();
}

// K3. kstar: (nodes, c) int32; s, p: (nodes, c) float32 or bfloat16; edge
// ids in `order` are node * kk + slot; out: (rows, 2c) float32.
extern "C" int fseg_scatter_routed(const void* kstar, const void* s,
                                   const void* p, const void* order,
                                   const void* ptr, void* out, long long rows,
                                   int kk, int c, int bf16, void* stream) {
    if (bad_rows(rows) || kk < 1 || c < 1 || c > SCATTER_MAX_C)
        return (int)cudaErrorInvalidValue;
    const int32_t* kp = (const int32_t*)kstar;
    const int64_t* op = (const int64_t*)order;
    const int64_t* pp = (const int64_t*)ptr;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        launch_routed<__nv_bfloat16>(kp, s, p, op, pp, (float*)out, rows, kk, c, st);
    else
        launch_routed<float>(kp, s, p, op, pp, (float*)out, rows, kk, c, st);
    return (int)cudaGetLastError();
}

// K4. idx: (b, e) int32; cnt: (b, n_rows) int32 scratch; out: (b, n_rows)
// float32.
extern "C" int fseg_scatter_count(const void* idx, void* cnt, void* out,
                                  int b, long long e, int n_rows,
                                  void* stream) {
    if (b < 1 || e < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long cells = (long long)b * n_rows;
    cudaError_t err = cudaMemsetAsync(cnt, 0, cells * sizeof(int32_t), st);
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)b * e;
    count_kernel<<<(unsigned int)((total + COUNT_THREADS - 1) / COUNT_THREADS),
                   COUNT_THREADS, 0, st>>>((const int32_t*)idx, (int32_t*)cnt,
                                           total, e, n_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    to_float_kernel<<<(unsigned int)((cells + COUNT_THREADS - 1) / COUNT_THREADS),
                      COUNT_THREADS, 0, st>>>((const int32_t*)cnt,
                                              (float*)out, cells);
    return (int)cudaGetLastError();
}
