// K2-K4: the EdgeConv scatter kernels (gather backward), and the graph
// transpose that K2 and K3 walk, for Hopper (sm_90a).
//
// Replaces fissure_segmentation_tpu/ops/pallas/scatter.py:
//   K2a scatter_add_mm2 and K2b scatter_add_mm -> scatter_rows_kernel
//       out[b, idx[b, e], :] += g[b, e, :]          (f32 or bf16 payload)
//   K3  scatter_add_routed                      -> scatter_routed_kernel
//       out[b, idx[b, n, kstar[b, n, c]], c]   += s[b, n, c]
//       out[b, idx[b, n, k], C + c] (every k)  += p[b, n, c]
//   K4  scatter_count                           -> count_hist,
//       out[b, m] = #{e : idx[b, e] == m}           count_from_ptr
// All outputs are float32. A target outside [0, n_rows) is dropped, as JAX's
// scatter drops it.
//
// The TPU kernels turn the scatter into one-hot matmuls (the MXU was idle
// and XLA's scatter serialised); the two-level n_lo/n_hi split, the hi/lo
// bf16 split of f32 payloads and the k-major tile order are all workarounds
// for the MXU and VMEM. None of it carries over. Here the scatter is a
// gather over the TRANSPOSED graph (order, ptr): every row's incoming edges
// lie contiguously in ascending edge order in `order`, row r's range being
// [ptr[r], ptr[r+1]); dropped edges follow the last row. Then
//
//   * K2/K3: each output row is summed by one group of lanes in ascending
//     edge order, one thread per output element, so the result is
//     deterministic (no float atomics) and the same on every run;
//   * K3 builds each edge's payload from the node fields on the fly: edge
//     e = (n, k) contributes s[n, c] to channel c only where kstar[n, c] == k,
//     and p[n, c] to channel C + c always, so the (B, N, K, 2C) routed
//     payload never exists in device memory;
//   * K4 is an integer histogram (integer atomics are exact and order-free),
//     converted to float32 (exact below 2^24). Where the caller holds the
//     transpose, the in-degrees are already there: row r's is ptr[r + 1] -
//     ptr[r] (a batch's last row ends where the next batch's rows start,
//     the last batch's at the first dropped edge), and count_from_ptr
//     writes their differences, 4 rows a thread in 16-byte stores, without
//     reading idx. Otherwise count_hist histograms idx in one launch: a
//     cluster of P blocks a batch element (P <= 8, so that B * P blocks
//     fill the SMs about once) streams the batch's edges in 16-byte loads,
//     each block counting its 1/P of them into its own n_rows counters in
//     shared memory; after a cluster barrier block r sums the P blocks'
//     counters of its 1/P of the rows through distributed shared memory
//     and stores them as float32. No memset, no float pass, no atomic in
//     device memory. Where n_rows counters do not fit in a block's shared
//     memory (HIST_SMEM_MAX, 51 200 rows), count_kernel adds into int32
//     counters in device memory (a memset first, a float pass after).
//
// The transpose is a stable counting sort in four launches. The edges of
// each batch element are cut into J chunks of consecutive edges; one warp
// owns a chunk and a row of counters cnt[chunk][0..n_rows] (n_rows counts
// the dropped edges), kept in shared memory while it walks.
//   (1) count: the warp counts its chunk's targets (integer atomics on its
//       counters: a count needs no order);
//   (2) columns: per (b, target), the J chunks' counts become exclusive
//       prefixes, and their total the row's in-degree;
//   (3) scan: one block a batch element turns its in-degrees into row
//       offsets (batch b's rows start at b * E minus the dropped edges of
//       the batches before it) and places its dropped edges after the last
//       row;
//   (4) fill: the warp adds each target's offset to its counters and walks
//       its chunk 32 edges at a time; __match_any_sync finds the lanes with
//       the same target; each writes its edge id at counter + (the lanes
//       below it with the same target), and the highest of them advances
//       the counter by their number.
// Edges reach each row in ascending id: chunk by chunk, step by step, lane
// by lane. No sort and no float atomic is involved; (order, ptr) equal a
// stable sort's (kernels/scatter.py:transpose_plain). The fill is a chain
// of dependent counter updates (a match, a load and a store every 32
// edges), so it is latency-bound: the counters sit in shared memory (in
// device memory where n_rows + 1 of them do not fit), the targets of 8
// steps are loaded at once, and J is large enough for several warps an SM.
//
// What bounds them: K2 reads every payload row once (671 MB of f32 at the
// DGCNN train step, B=32, E=81 920, C=64) in 256-byte rows at random row
// addresses, so it is bound by device-memory bandwidth. A group of lanes
// owns a row of the output, each lane a 16-byte vector of channels (4 f32
// or 8 bf16); the group loads up to one edge id per lane with one coalesced
// load, hands them out by shuffle, and keeps SCATTER_INFLIGHT payload rows
// in flight before it adds them, in edge order, so the walk is not one
// dependent load at a time. Payloads whose rows are not 16-byte multiples
// (C = 33, say) take one channel a lane. K4 is bound by atomic throughput
// on B * n_rows counters in count_kernel; count_hist reads 10.5 MB of
// targets at the train step (32, 81 920) and is bound by that stream and
// one launch, count_from_ptr (0.52 MB) by its launch.
//
// K3 reads three (B, N, C) node fields K times each. Its unique bytes are
// few (0.03 ms at the train step), but the unstaged kernel (scatter_routed_
// kernel, one warp a row, one edge at a time) fetched for every edge the
// source's whole int32 kstar row and its p row from L2: its routing half
// alone took 0.287 of 0.318 ms, its dense half alone 0.164 (PERF.md, the
// split). The staged kernel (scatter_routed_staged) takes those re-reads
// out of L2: a block owns a batch element and a channel slice (8 f32 or 16
// bf16 channels) and copies the slices of p and s (cp.async) and of kstar
// as uint8 of all the cloud's nodes into shared memory (144 KB in f32 at N
// = 2048), then walks its rows' edges over the shared transpose, two lanes
// a row. Each row's range is loaded a row ahead and its edge ids a batch
// of 8 ahead (branch-free, clamped); a batch's (node, slot) pairs are
// shuffled out first and all its p and kstar reads issued together before
// any add. What bounds it then is the latency of that chain with one block
// an SM (24 or 20 warps, as the registers allow) and the rows' uneven
// in-degrees within a warp; shared-memory bandwidth is not (every edge
// reading one node saves a fifth). Clouds whose slices do not fit, or K >
// 255 (uint8 slots), keep the unstaged kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define SCATTER_WARPS 8       // K3: rows per block, one warp each
#define SCATTER_THREADS 256   // K2: threads per block
#define SCATTER_INFLIGHT 4    // K2: payload rows a group loads before adding
#define SCATTER_MAX_C 256
#define COUNT_THREADS 256
#define HIST_THREADS 512      // K4 histogram: threads a block
#define HIST_MAX_CLUSTER 8    // K4 histogram: blocks a batch element, at most
#define HIST_SMEM_MAX (200 * 1024)  // K4 histogram: counters' bytes, at most
#define HIST_UNROLL 4         // K4 histogram: 16-byte loads in flight a thread
#define TR_CHUNK 2048         // transpose: edges a warp walks (at most)
#define TR_WARPS 4            // transpose: chunks (warps) a block, at most
#define TR_SMEM (200 * 1024)  // transpose: shared memory for counters
#define TR_CNT_CAP (1LL << 24)  // transpose: counters, at most (64 MB)
#define TR_UNROLL 8           // transpose: steps whose targets load together
#define SCAN_THREADS 512
#define SCAN_ITEMS 4

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// ---- the transpose ------------------------------------------------------

// Chunks per batch element: ceil(e / TR_CHUNK), cut so that the counters
// (b * J * (n_rows + 1) int32) stay under TR_CNT_CAP, and at least one.
static long long tr_chunks(int b, long long e, int n_rows) {
    long long j = (e + TR_CHUNK - 1) / TR_CHUNK;
    const long long cap = TR_CNT_CAP / ((long long)b * (n_rows + 1));
    if (j > cap) j = cap;
    return j < 1 ? 1 : j;
}

// One warp a chunk, its counters in shared memory where they fit (in_smem;
// else in place in cnt). FILL = false: count targets into the chunk's row
// of cnt. FILL = true: that row holds the chunk's exclusive prefix per
// target, to which the walk first adds the target's offset (offs); it then
// walks the chunk in order and writes each edge id at counter + rank.
template <bool FILL>
__global__ void __launch_bounds__(TR_WARPS * 32)
transpose_walk(const int32_t* __restrict__ idx, int32_t* cnt,
               const int32_t* __restrict__ offs, int32_t* __restrict__ order,
               int b, long long e, int n_rows, long long nj, int in_smem) {
    extern __shared__ int32_t run_s[];
    const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long w = (long long)blockIdx.x * (blockDim.x / 32) + wib;
    if (w >= b * nj) return;                // warp-uniform; no block barrier
    const int bb = (int)(w / nj);
    const long long width = n_rows + 1;
    int32_t* row = cnt + w * width;
    int32_t* run = in_smem ? run_s + wib * width : row;
    for (long long k = lane; k < width; k += 32) {
        if (FILL)   // the target's offset: its row's, or bb's dropped edges'
            run[k] = row[k] + offs[k < n_rows ? (long long)bb * n_rows + k
                                              : (long long)b * n_rows + bb];
        else if (in_smem)
            run[k] = 0;
    }
    __syncwarp();
    const long long ch = (e + nj - 1) / nj;
    const long long e0 = (w % nj) * ch;
    const long long e1 = e0 + ch < e ? e0 + ch : e;
    const int32_t* src = idx + (long long)bb * e;
    if constexpr (!FILL) {  // counting needs no order: integer atomics
#pragma unroll 8
        for (long long ei = e0 + lane; ei < e1; ei += 32) {
            const int t = src[ei];
            atomicAdd(run + (t >= 0 && t < n_rows ? t : n_rows), 1);
        }
        __syncwarp();
        if (in_smem)
            for (long long k = lane; k < width; k += 32) row[k] = run[k];
        return;
    }
    const unsigned below = (1u << lane) - 1;
    for (long long s0 = e0; s0 < e1; s0 += 32 * TR_UNROLL) {
        int key[TR_UNROLL];  // the next TR_UNROLL steps' targets, loaded
#pragma unroll               // together: off the counters' dependent chain
        for (int u = 0; u < TR_UNROLL; ++u) {
            const long long ei = s0 + 32 * u + lane;
            key[u] = -1;                    // inactive lanes match each other
            if (ei < e1) {
                const int t = src[ei];
                key[u] = t >= 0 && t < n_rows ? t : n_rows;
            }
        }
#pragma unroll
        for (int u = 0; u < TR_UNROLL; ++u) {
            const long long ei = s0 + 32 * u + lane;
            const bool act = ei < e1;
            const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
            const int cur = act ? run[key[u]] : 0;
            if (act)
                order[cur + __popc(peers & below)] =
                    (int32_t)((long long)bb * e + ei);
            __syncwarp();
            if (act && lane == 31 - __clz(peers))
                run[key[u]] = cur + __popc(peers);
            __syncwarp();
        }
    }
}

// Per (bb, key): the J chunks' counts -> exclusive prefixes in place; the
// total goes to deg[bb * n_rows + key], or for the dropped key to
// deg[b * n_rows + bb].
__global__ void __launch_bounds__(COUNT_THREADS)
transpose_columns(int32_t* __restrict__ cnt, int32_t* __restrict__ deg, int b,
                  int n_rows, long long nj) {
    const long long t = (long long)blockIdx.x * COUNT_THREADS + threadIdx.x;
    const long long width = n_rows + 1;
    if (t >= b * width) return;
    const long long bb = t / width;
    const int key = (int)(t - bb * width);
    int32_t* col = cnt + bb * nj * width + key;
    int s = 0;
    for (long long j0 = 0; j0 < nj; j0 += 8) {  // 8 loads in flight
        int v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
            v[u] = j0 + u < nj ? col[(j0 + u) * width] : 0;
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (j0 + u < nj) {
                col[(j0 + u) * width] = s;
                s += v[u];
            }
    }
    deg[key < n_rows ? bb * n_rows + key : (long long)b * n_rows + bb] = s;
}

// The exclusive prefix of x over the block's threads in thread order, and
// the block's total. Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int x, int* total) {
    __shared__ int ws[SCAN_THREADS / 32 + 1];
    const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
    }
    if (lane == 31) ws[wid] = incl;
    __syncthreads();
    if (wid == 0) {
        const int v = lane < SCAN_THREADS / 32 ? ws[lane] : 0;
        int wi = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, wi, o);
            if (lane >= o) wi += u;
        }
        if (lane < SCAN_THREADS / 32) ws[lane] = wi - v;
        if (lane == 31) ws[SCAN_THREADS / 32] = wi;
    }
    __syncthreads();
    const int r = ws[wid] + incl - x;
    *total = ws[SCAN_THREADS / 32];
    __syncthreads();                        // ws is reused by the next call
    return r;
}

// One block a batch element bb: the offsets of its rows and of its dropped
// edges. Batch bb's rows start after the valid edges of the batches before
// it, bb * e minus their dropped ones; the dropped edges all follow the
// last row, batch by batch. deg: the b * n_rows in-degrees, then the b
// dropped counts; ptr: b * n_rows row offsets, b dropped offsets, b * e.
__global__ void __launch_bounds__(SCAN_THREADS)
transpose_scan(const int32_t* __restrict__ deg, int32_t* __restrict__ ptr,
               int b, long long e, int n_rows) {
    const int bb = blockIdx.x, tid = threadIdx.x;
    const long long rows = (long long)b * n_rows;
    int drop_before = 0, drop_all = 0;
    for (int i = tid; i < b; i += SCAN_THREADS) {
        const int v = deg[rows + i];
        drop_all += v;
        if (i < bb) drop_before += v;
    }
    int before, all;
    block_scan(drop_before, &before);
    block_scan(drop_all, &all);
    if (tid == 0) {
        ptr[rows + bb] = (int)(b * e - all + before);
        if (bb == b - 1) ptr[rows + b] = (int)(b * e);
    }
    int carry = (int)(bb * e - before);
    const int32_t* in = deg + (long long)bb * n_rows;
    int32_t* out = ptr + (long long)bb * n_rows;
    for (int base = 0; base < n_rows; base += SCAN_THREADS * SCAN_ITEMS) {
        const int i0 = base + tid * SCAN_ITEMS;
        int v[SCAN_ITEMS], tsum = 0;
#pragma unroll
        for (int i = 0; i < SCAN_ITEMS; ++i) {
            v[i] = i0 + i < n_rows ? in[i0 + i] : 0;
            tsum += v[i];
        }
        int tile;
        int run = carry + block_scan(tsum, &tile);
#pragma unroll
        for (int i = 0; i < SCAN_ITEMS; ++i) {
            if (i0 + i < n_rows) out[i0 + i] = run;
            run += v[i];
        }
        carry += tile;
    }
}

// ---- K2 -----------------------------------------------------------------

// VEC payload elements as one load: 16 bytes (4 f32, 8 bf16) or 1 element.
template <typename T, int VEC> struct Vec;
template <typename T> struct Vec<T, 1> {
    T v;
    __device__ __forceinline__ void load(const T* p) { v = __ldg(p); }
    __device__ __forceinline__ void add_to(float* acc) const {
        acc[0] = __fadd_rn(acc[0], to_f32<T>(v));
    }
};
template <> struct Vec<float, 4> {
    float4 v;
    __device__ __forceinline__ void load(const float* p) {
        v = __ldg(reinterpret_cast<const float4*>(p));
    }
    __device__ __forceinline__ void add_to(float* acc) const {
        acc[0] = __fadd_rn(acc[0], v.x);
        acc[1] = __fadd_rn(acc[1], v.y);
        acc[2] = __fadd_rn(acc[2], v.z);
        acc[3] = __fadd_rn(acc[3], v.w);
    }
};
template <> struct Vec<__nv_bfloat16, 8> {
    uint4 v;
    __device__ __forceinline__ void load(const __nv_bfloat16* p) {
        v = __ldg(reinterpret_cast<const uint4*>(p));
    }
    __device__ __forceinline__ void add_to(float* acc) const {
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
            acc[2 * i] = __fadd_rn(acc[2 * i], __uint_as_float(u[i] << 16));
            acc[2 * i + 1] =
                __fadd_rn(acc[2 * i + 1], __uint_as_float(u[i] & 0xffff0000u));
        }
    }
};

// out[r, :] = sum over j in [ptr[r], ptr[r+1]) of g[order[j], :], j
// ascending. A group of L lanes owns row r; lane gl owns the VEC-element
// vectors q = v * L + gl (v < V) of the row.
template <typename T, int VEC, int L, int V>
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_rows_kernel(const T* __restrict__ g, const int32_t* __restrict__ order,
                    const int32_t* __restrict__ ptr, float* __restrict__ out,
                    long long rows, int c) {
    const long long r =
        ((long long)blockIdx.x * SCATTER_THREADS + threadIdx.x) / L;
    if (r >= rows) return;                  // the whole group returns
    const int lane = threadIdx.x % 32, gl = lane % L;
    const unsigned gmask =
        L == 32 ? 0xffffffffu : ((1u << L) - 1) << (lane & ~(L - 1));
    float acc[V][VEC];
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[v][i] = 0.0f;
    const int j1 = ptr[r + 1];
    for (int base = ptr[r]; base < j1; base += L) {
        const int m = j1 - base < L ? j1 - base : L;
        const int mine = gl < m ? order[base + gl] : 0;
        for (int t = 0; t < m; t += SCATTER_INFLIGHT) {
            Vec<T, VEC> val[SCATTER_INFLIGHT][V];
#pragma unroll
            for (int u = 0; u < SCATTER_INFLIGHT; ++u) {
                const int src = __shfl_sync(gmask, mine, t + u, L);
                if (t + u < m) {
                    const T* row = g + (long long)src * c;
#pragma unroll
                    for (int v = 0; v < V; ++v) {
                        const int ch = (v * L + gl) * VEC;
                        if (ch < c) val[u][v].load(row + ch);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < SCATTER_INFLIGHT; ++u) {
                if (t + u < m) {
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        if ((v * L + gl) * VEC < c) val[u][v].add_to(acc[v]);
                }
            }
        }
    }
    float* dst = out + r * (long long)c;
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const int ch = (v * L + gl) * VEC;
        if (ch >= c) continue;
        if constexpr (VEC == 1) {
            dst[ch] = acc[v][0];
        } else {
#pragma unroll
            for (int i = 0; i < VEC; i += 4)
                *reinterpret_cast<float4*>(dst + ch + i) = make_float4(
                    acc[v][i], acc[v][i + 1], acc[v][i + 2], acc[v][i + 3]);
        }
    }
}

// Row r's incoming edges are flat edge ids fe = node * kk + slot, node the
// flat (b * N + n) source; channel c adds s[node, c] iff kstar[node, c] ==
// slot, channel C + c adds p[node, c].
template <typename T, int CPL>
__global__ void __launch_bounds__(SCATTER_WARPS * 32)
scatter_routed_kernel(const int32_t* __restrict__ kstar,
                      const T* __restrict__ s, const T* __restrict__ p,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ ptr, float* __restrict__ out,
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
    const int j1 = ptr[r + 1];
#pragma unroll 2
    for (int j = ptr[r]; j < j1; ++j) {
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

// ---- K3, staged --------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

// 16, 8 or 4 bytes of shared memory at a 32-bit shared-window address
__device__ __forceinline__ uint4 lds16(unsigned addr) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
    return v;
}
__device__ __forceinline__ uint2 lds8(unsigned addr) {
    uint2 v;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(v.x), "=r"(v.y) : "r"(addr));
    return v;
}
__device__ __forceinline__ uint32_t lds4(unsigned addr) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
}

// the VEC = 16 / sizeof(T) payload values of a 16-byte vector as float32
__device__ __forceinline__ void unpack16(const uint4 q, float* w, float) {
    w[0] = __uint_as_float(q.x);
    w[1] = __uint_as_float(q.y);
    w[2] = __uint_as_float(q.z);
    w[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack16(const uint4 q, float* w,
                                         __nv_bfloat16) {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is a 16-bit shift
        w[2 * i] = __uint_as_float(u[i] << 16);
        w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
}

// The routing bytes of a lane's VEC channels: 4 (float32) or 8 (bfloat16)
// uint8 slots, and the lanes among them equal to `slot` as byte masks.
template <int VEC> struct Route;
template <> struct Route<4> {
    uint32_t v;
    __device__ __forceinline__ void load(unsigned addr) { v = lds4(addr); }
    __device__ __forceinline__ uint32_t hits(uint32_t rep, int) const {
        return __vcmpeq4(v, rep);
    }
};
template <> struct Route<8> {
    uint2 v;
    __device__ __forceinline__ void load(unsigned addr) { v = lds8(addr); }
    __device__ __forceinline__ uint32_t hits(uint32_t rep, int half) const {
        return __vcmpeq4(half ? v.y : v.x, rep);
    }
};

// One block: batch element b, the channel slice [c0, c0 + SC) (SC = 8
// float32 or 16 bfloat16 channels: 32-byte rows of p and s), output rows
// [r0, r1) of b. The slices of p and s and kstar as uint8 (255 where it is
// no slot) of all of b's nodes are copied into shared memory once. A row's
// incoming edges all come from b's nodes, so the walk then reads only
// shared memory and the edge ids. Two lanes own a row, each a 16-byte
// vector of VEC channels; they load RS_IDS edge ids each at once
// (coalesced), turn each into (node, slot) once, hand them out by shuffle,
// and read the 2 * RS_IDS edges' vectors before adding any, in edge order.
#define RS_SROW 32                   // bytes of a staged p (and s) row
#define RS_LPR 2                     // lanes a row: 2 x 16 bytes = RS_SROW
// warps a block: as many as each dtype's registers allow with one block an
// SM (float32 payloads take 77 a thread, bfloat16 93)
#define RS_WARPS(T) (sizeof(T) == 4 ? 24 : 20)
#define RS_ROWS(T) (RS_WARPS(T) * 32 / RS_LPR)   // rows a block takes at once
#define RS_IDS 4                     // edge ids a lane loads at once
#define RS_SMEM_MAX (220 * 1024)     // N * (2 * RS_SROW + SC) at most

// Edge ids order[j + u * RS_LPR + gl] (u < RS_IDS) of a row ending at j1,
// reads past j1 clamped to its last edge: no branch between the loads.
__device__ __forceinline__ void fetch_ids(const int32_t* __restrict__ order,
                                          int j, int j1, int gl, int* v) {
#pragma unroll
    for (int u = 0; u < RS_IDS; ++u)
        v[u] = __ldg(order + min(j + u * RS_LPR + gl, j1 - 1));
}

template <typename T>
__global__ void __launch_bounds__(RS_WARPS(T) * 32)
scatter_routed_staged(const int32_t* __restrict__ kstar,
                      const T* __restrict__ s, const T* __restrict__ p,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ ptr, float* __restrict__ out,
                      int n, int n_rows, int kk, int c, int nslice, int parts,
                      bool vec) {
    constexpr int VEC = 16 / sizeof(T);      // channels a lane
    constexpr int SC = RS_SROW / sizeof(T);  // channels a slice
    extern __shared__ __align__(16) unsigned char rs_smem[];
    T* sp = reinterpret_cast<T*>(rs_smem);
    T* ss = sp + (size_t)n * SC;
    uint8_t* sk = reinterpret_cast<uint8_t*>(ss + (size_t)n * SC);
    const int part = blockIdx.x % parts;
    const int cs = (blockIdx.x / parts) % nslice;
    const int b = blockIdx.x / (parts * nslice);
    const int c0 = cs * SC;
    const long long node0 = (long long)b * n;   // b's first flat node

    for (int q = threadIdx.x; q < n * RS_LPR; q += RS_WARPS(T) * 32) {
        const int nd = q / RS_LPR, off = (q % RS_LPR) * VEC, ch = c0 + off;
        const long long g = (node0 + nd) * c + ch;
        T* dp = sp + nd * SC + off;
        T* ds = ss + nd * SC + off;
        if (vec) {
            cp_async16(dp, ch < c ? p + g : p, ch < c ? 16 : 0);
            cp_async16(ds, ch < c ? s + g : s, ch < c ? 16 : 0);
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                dp[i] = ch + i < c ? p[g + i] : T(0.0f);
                ds[i] = ch + i < c ? s[g + i] : T(0.0f);
            }
        }
    }
    for (int q = threadIdx.x; q < n * SC; q += RS_WARPS(T) * 32) {
        const int nd = q / SC, ch = c0 + q % SC;
        const int v = ch < c ? kstar[(node0 + nd) * c + ch] : -1;
        sk[q] = v >= 0 && v < kk ? (uint8_t)v : (uint8_t)255;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    const int lane = threadIdx.x % 32, gl = lane % RS_LPR;
    const unsigned gmask = ((1u << RS_LPR) - 1) << (lane - gl);
    const int off = gl * VEC, c1 = c0 + off;   // the lane's channels
    // the lane's p vector and kstar bytes of node 0, shared window
    const unsigned p_s = (unsigned)__cvta_generic_to_shared(sp) + gl * 16;
    const unsigned k_s = (unsigned)__cvta_generic_to_shared(sk) + off;
    const int fe0 = (int)(node0 * kk);         // b's first edge id
    const float inv_k = 1.0f / (float)kk;
    const int per = (n_rows + parts - 1) / parts;
    const int r0 = part * per, r1 = min(n_rows, r0 + per);
    const int32_t* bptr = ptr + (long long)b * n_rows;
    // the next row's range is loaded a row ahead, the next RS_LPR *
    // RS_IDS edge ids a batch ahead (clamped reads, no branch), so that
    // their latency hides behind the current batch
    int rr = r0 + threadIdx.x / RS_LPR;
    int ja = 0, jb = 0;
    if (rr < r1) {
        ja = bptr[rr];
        jb = bptr[rr + 1];
    }
    for (; rr < r1; rr += RS_ROWS(T)) {
        const long long row = (long long)b * n_rows + rr;
        const int j0 = ja, j1 = jb;
        if (rr + RS_ROWS(T) < r1) {
            ja = bptr[rr + RS_ROWS(T)];
            jb = bptr[rr + RS_ROWS(T) + 1];
        }
        float as[VEC], ap[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) as[i] = ap[i] = 0.0f;
        int ids[RS_IDS];
        if (j0 < j1) fetch_ids(order, j0, j1, gl, ids);
        for (int base = j0; base < j1; base += RS_LPR * RS_IDS) {
            const int m = min(RS_LPR * RS_IDS, j1 - base);
            int raw[RS_IDS];
#pragma unroll
            for (int u = 0; u < RS_IDS; ++u) raw[u] = ids[u];
            if (base + RS_LPR * RS_IDS < j1)
                fetch_ids(order, base + RS_LPR * RS_IDS, j1, gl, ids);
            // edge id -> node * 256 + slot: the quotient by kk from a float
            // product (the local id is below 2^20), corrected by one
            uint32_t mine[RS_IDS];
#pragma unroll
            for (int u = 0; u < RS_IDS; ++u) {
                const int fl = raw[u] - fe0;
                int nd = __float2int_rz(__int2float_rn(fl) * inv_k);
                int sl = fl - nd * kk;
                if (sl < 0) {
                    --nd;
                    sl += kk;
                } else if (sl >= kk) {
                    ++nd;
                    sl -= kk;
                }
                mine[u] = (uint32_t)nd << 8 | (uint32_t)sl;
            }
            // all the batch's (node, slot) first, then all its reads (an
            // edge past m reads edge 0's node and is not added): the reads
            // go out together instead of one shuffle and load at a time
            uint32_t ns[RS_LPR * RS_IDS];
#pragma unroll
            for (int e = 0; e < RS_LPR * RS_IDS; ++e)
                ns[e] = __shfl_sync(gmask, mine[e / RS_LPR], e % RS_LPR,
                                    RS_LPR);
            uint4 pv[RS_LPR * RS_IDS];
            Route<VEC> kb[RS_LPR * RS_IDS];
#pragma unroll
            for (int e = 0; e < RS_LPR * RS_IDS; ++e) {
                const int nd = (int)((e < m ? ns[e] : ns[0]) >> 8);
                pv[e] = lds16(p_s + nd * RS_SROW);
                kb[e].load(k_s + nd * SC);
            }
            asm volatile("" ::: "memory");   // the reads stay ahead
#pragma unroll
            for (int e = 0; e < RS_LPR * RS_IDS; ++e) {
                if (e >= m) break;
                float w[VEC];
                unpack16(pv[e], w, T());
#pragma unroll
                for (int i = 0; i < VEC; ++i) ap[i] = __fadd_rn(ap[i], w[i]);
                const uint32_t rep = (ns[e] & 255u) * 0x01010101u;
                const int nd = (int)(ns[e] >> 8);
#pragma unroll
                for (int h = 0; h < VEC / 4; ++h) {
                    const uint32_t hit = kb[e].hits(rep, h);
                    if (hit == 0) continue;
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        if (hit >> (8 * i) & 1u)
                            as[4 * h + i] = __fadd_rn(
                                as[4 * h + i],
                                to_f32<T>(ss[nd * SC + off + 4 * h + i]));
                }
            }
        }
        if (c1 >= c) continue;
        float* dst = out + row * 2LL * c;
        if (c % 4 == 0 && c1 + VEC <= c) {   // whole 16-byte vectors
#pragma unroll
            for (int i = 0; i < VEC; i += 4) {
                *reinterpret_cast<float4*>(dst + c1 + i) =
                    make_float4(as[i], as[i + 1], as[i + 2], as[i + 3]);
                *reinterpret_cast<float4*>(dst + c + c1 + i) =
                    make_float4(ap[i], ap[i + 1], ap[i + 2], ap[i + 3]);
            }
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
                if (c1 + i < c) {
                    dst[c1 + i] = as[i];
                    dst[c + c1 + i] = ap[i];
                }
        }
    }
}

// bytes of shared memory the staged K3 needs for clouds of n nodes
// The current device's SMs, asked once a device.
static cudaError_t sm_count(int* sms) {
    static int counts[64] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && counts[dev] > 0) {
        *sms = counts[dev];
        return cudaSuccess;
    }
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < 64) counts[dev] = *sms;
    return err;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, once a device (a bit of *allowed each).
template <typename F>
static cudaError_t allow_smem(F* kernel, int bytes,
                              unsigned long long* allowed) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < 64 && (*allowed >> dev & 1ull)))
        return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess && dev < 64) *allowed |= 1ull << dev;
    return err;
}

template <typename T>
static long long routed_smem(int n) {
    return (long long)n * (2 * RS_SROW + RS_SROW / (int)sizeof(T));
}

template <typename T>
static int launch_routed_staged(const int32_t* kstar, const void* s,
                                const void* p, const int32_t* order,
                                const int32_t* ptr, float* out, int b, int n,
                                int n_rows, int kk, int c, cudaStream_t st) {
    constexpr int SC = RS_SROW / sizeof(T);
    const int smem = (int)routed_smem<T>(n);
    static unsigned long long allowed = 0;   // a bit a device
    int sms = 0;
    cudaError_t err = allow_smem(scatter_routed_staged<T>, RS_SMEM_MAX,
                                 &allowed);
    if (err == cudaSuccess) err = sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    const int nslice = (c + SC - 1) / SC;
    // one block an SM fits: where batch x slices leave SMs idle, each block
    // also takes a share of the rows, at least one pass of its lanes
    const long long groups = (long long)b * nslice;
    long long parts = sms / groups;
    const long long most = (n_rows + RS_ROWS(T) - 1) / RS_ROWS(T);
    if (parts > most) parts = most;
    if (parts < 1) parts = 1;
    if (groups * parts > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bool vec = c % (16 / (int)sizeof(T)) == 0 &&
                     ((uintptr_t)s | (uintptr_t)p) % 16 == 0;
    scatter_routed_staged<T><<<(unsigned)(groups * parts), RS_WARPS(T) * 32,
                               smem, st>>>(
        kstar, (const T*)s, (const T*)p, order, ptr, out, n, n_rows, kk, c,
        nslice, (int)parts, vec);
    return (int)cudaGetLastError();
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

__device__ __forceinline__ void hist_add(int32_t* h, int t, int n_rows) {
    if ((unsigned)t < (unsigned)n_rows) atomicAdd(h + t, 1);
}

__device__ __forceinline__ void hist_add4(int32_t* h, int4 q, int n_rows) {
    hist_add(h, q.x, n_rows);
    hist_add(h, q.y, n_rows);
    hist_add(h, q.z, n_rows);
    hist_add(h, q.w, n_rows);
}

// K4 in one launch. A cluster of `parts` blocks a batch element bb (rank
// r = blockIdx.x % parts; one block where parts = 1); each block counts its
// 1/parts of the batch's 16-byte vectors of targets into n_rows int32
// counters in shared memory (the last rank also the < 4 targets before the
// first 16-byte boundary and after the last whole vector), then, after the
// cluster barrier, writes rows [n_rows * r / parts, n_rows * (r + 1) /
// parts) of out as the sums of the parts' counters, read through
// distributed shared memory. A second barrier keeps every block's counters
// alive until the others have read them.
__global__ void __launch_bounds__(HIST_THREADS)
count_hist(const int32_t* __restrict__ idx, float* __restrict__ out,
           long long e, int n_rows, int parts) {
    extern __shared__ int32_t hist_s[];
    const int tid = threadIdx.x;
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const long long bb = blockIdx.x / parts;
    for (int i = tid; i < n_rows; i += HIST_THREADS) hist_s[i] = 0;
    __syncthreads();
    const int32_t* src = idx + bb * e;
    long long head = (long long)((16 - ((uintptr_t)src & 15)) & 15) / 4;
    if (head > e) head = e;
    const long long nv = (e - head) / 4;
    const int4* vec = reinterpret_cast<const int4*>(src + head);
    const long long v1 = nv * (rank + 1) / parts;
    long long v = nv * rank / parts + tid;
    for (; v + (HIST_UNROLL - 1) * HIST_THREADS < v1;
         v += HIST_UNROLL * HIST_THREADS) {
        int4 q[HIST_UNROLL];   // the loads first, all in flight together
#pragma unroll
        for (int u = 0; u < HIST_UNROLL; ++u)
            q[u] = __ldg(vec + v + u * HIST_THREADS);
#pragma unroll
        for (int u = 0; u < HIST_UNROLL; ++u) hist_add4(hist_s, q[u], n_rows);
    }
    for (; v < v1; v += HIST_THREADS) hist_add4(hist_s, __ldg(vec + v), n_rows);
    if (rank == parts - 1) {
        const long long tail = head + nv * 4;
        if (tid < head) hist_add(hist_s, src[tid], n_rows);
        if (tid < e - tail) hist_add(hist_s, src[tail + tid], n_rows);
    }
    cl.sync();
    const int r1 = (int)((long long)n_rows * (rank + 1) / parts);
    float* dst = out + bb * n_rows;
    for (int i = (int)((long long)n_rows * rank / parts) + tid; i < r1;
         i += HIST_THREADS) {
        int sum = 0;
        for (int q = 0; q < parts; ++q) sum += cl.map_shared_rank(hist_s, q)[i];
        dst[i] = (float)sum;
    }
    cl.sync();
}

// K4 from the transpose's row offsets: out[i] = ptr[i + 1] - ptr[i] for
// the rows flat rows, 4 a thread; 16-byte loads and stores where `vec`
// (ptr and out 16-byte aligned).
__global__ void __launch_bounds__(COUNT_THREADS)
count_from_ptr(const int32_t* __restrict__ ptr, float* __restrict__ out,
               long long rows, int vec) {
    const long long i0 =
        ((long long)blockIdx.x * COUNT_THREADS + threadIdx.x) * 4;
    if (i0 >= rows) return;
    if (vec && i0 + 4 <= rows) {
        const int4 p = __ldg(reinterpret_cast<const int4*>(ptr + i0));
        const int p4 = __ldg(ptr + i0 + 4);
        *reinterpret_cast<float4*>(out + i0) =
            make_float4((float)(p.y - p.x), (float)(p.z - p.y),
                        (float)(p.w - p.z), (float)(p4 - p.w));
        return;
    }
    for (long long i = i0; i < i0 + 4 && i < rows; ++i)
        out[i] = (float)(ptr[i + 1] - ptr[i]);
}

// Blocks a batch element for count_hist: B * P about the SMs, 1 <= P <=
// HIST_MAX_CLUSTER. Measured (prof/design_sweep.py --parts k4): within
// 0.6 us of the best forced P at B = 1 ... 32, and 0.8-3.5 us faster than
// one block a batch element.
static int hist_parts(int b, int sms) {
    const int p = sms / b;
    return p < 1 ? 1 : p > HIST_MAX_CLUSTER ? HIST_MAX_CLUSTER : p;
}

static int launch_hist(const int32_t* idx, float* out, int b, long long e,
                       int n_rows, cudaStream_t st) {
    static unsigned long long allowed = 0;
    int sms = 0;
    cudaError_t err = allow_smem(count_hist, HIST_SMEM_MAX, &allowed);
    if (err == cudaSuccess) err = sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    const int parts = hist_parts(b, sms);
    const int smem = n_rows * (int)sizeof(int32_t);
    if ((long long)b * parts > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(b * parts));
    cfg.blockDim = dim3(HIST_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = parts;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, count_hist, idx, out, e, n_rows, parts);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

static unsigned int row_blocks(long long rows) {
    return (unsigned int)((rows + SCATTER_WARPS - 1) / SCATTER_WARPS);
}

template <typename T, int VEC, int L, int V>
static void launch_rows_lv(const T* g, const int32_t* order,
                           const int32_t* ptr, float* out, long long rows,
                           int c, cudaStream_t st) {
    const long long blocks = (rows * L + SCATTER_THREADS - 1) / SCATTER_THREADS;
    scatter_rows_kernel<T, VEC, L, V><<<(unsigned)blocks, SCATTER_THREADS, 0,
                                        st>>>(g, order, ptr, out, rows, c);
}

// L lanes a row, the smallest power of two that covers the row's vectors,
// at most 32; V vectors a lane.
template <typename T, int VEC, int V>
static void launch_rows_v(const T* g, const int32_t* order,
                          const int32_t* ptr, float* out, long long rows,
                          int c, int nvec, cudaStream_t st) {
    if (nvec <= 1)
        launch_rows_lv<T, VEC, 1, V>(g, order, ptr, out, rows, c, st);
    else if (nvec <= 2)
        launch_rows_lv<T, VEC, 2, V>(g, order, ptr, out, rows, c, st);
    else if (nvec <= 4)
        launch_rows_lv<T, VEC, 4, V>(g, order, ptr, out, rows, c, st);
    else if (nvec <= 8)
        launch_rows_lv<T, VEC, 8, V>(g, order, ptr, out, rows, c, st);
    else if (nvec <= 16)
        launch_rows_lv<T, VEC, 16, V>(g, order, ptr, out, rows, c, st);
    else
        launch_rows_lv<T, VEC, 32, V>(g, order, ptr, out, rows, c, st);
}

template <typename T>
static void launch_rows(const void* gv, const int32_t* order,
                        const int32_t* ptr, float* out, long long rows, int c,
                        cudaStream_t st) {
    const T* g = (const T*)gv;
    constexpr int VEC = 16 / sizeof(T);
    if ((c * sizeof(T)) % 16 == 0 && ((uintptr_t)gv % 16) == 0) {
        const int nvec = c / VEC;           // f32: <= 64, bf16: <= 32
        if (nvec <= 32)
            launch_rows_v<T, VEC, 1>(g, order, ptr, out, rows, c, nvec, st);
        else
            launch_rows_lv<T, VEC, 32, 2>(g, order, ptr, out, rows, c, st);
    } else if (c <= 32) {                   // one channel a lane
        launch_rows_v<T, 1, 1>(g, order, ptr, out, rows, c, c, st);
    } else if (c <= 64) {
        launch_rows_lv<T, 1, 32, 2>(g, order, ptr, out, rows, c, st);
    } else if (c <= 128) {
        launch_rows_lv<T, 1, 32, 4>(g, order, ptr, out, rows, c, st);
    } else {
        launch_rows_lv<T, 1, 32, 8>(g, order, ptr, out, rows, c, st);
    }
}

template <typename T>
static void launch_routed(const int32_t* kstar, const void* s, const void* p,
                          const int32_t* order, const int32_t* ptr, float* out,
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

// The int32 counters the transpose of (b, e) targets over n_rows rows needs
// as scratch (`cnt` of fseg_graph_transpose).
extern "C" long long fseg_transpose_scratch(int b, long long e, int n_rows) {
    if (b < 1 || e < 0 || n_rows < 1) return -1;
    return (long long)b * tr_chunks(b, e, n_rows) * (n_rows + 1);
}

// The graph's transpose. idx: (b, e) int32 targets; cnt: the scratch of
// fseg_transpose_scratch; deg: (b * n_rows + b) int32 scratch; ptr: (b *
// n_rows + b + 1) int32, of which the first b * n_rows + 1 are the row
// offsets into `order`; order: (b * e) int32 flat edge ids sorted by
// target row, ties in ascending id, dropped edges last. b * e and b *
// n_rows + b must stay below 2^31 (the wrapper checks).
extern "C" int fseg_graph_transpose(const void* idx, void* cnt, void* deg,
                                    void* ptr, void* order, int b, long long e,
                                    int n_rows, void* stream) {
    if (b < 1 || e < 0 || n_rows < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long nj = tr_chunks(b, e, n_rows);
    const long long width = n_rows + 1;
    // warps a block: up to TR_WARPS whose counters fit in TR_SMEM; above
    // 51 199 rows none fits, and the counters stay in cnt
    const long long fit = TR_SMEM / (width * 4);
    const int in_smem = fit >= 1;
    const int wpb = !in_smem ? TR_WARPS : fit < TR_WARPS ? (int)fit : TR_WARPS;
    const int smem = in_smem ? (int)(wpb * width * 4) : 0;
    cudaError_t err;
    if (!in_smem) {
        err = cudaMemsetAsync(cnt, 0, b * nj * width * 4, st);
        if (err != cudaSuccess) return (int)err;
    }
    err = cudaFuncSetAttribute(transpose_walk<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TR_SMEM);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(transpose_walk<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   TR_SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned walk_blocks = (unsigned)((b * nj + wpb - 1) / wpb);
    const int32_t* ip = (const int32_t*)idx;
    int32_t* cp = (int32_t*)cnt;
    int32_t* dp = (int32_t*)deg;
    int32_t* pp = (int32_t*)ptr;
    int32_t* op = (int32_t*)order;
    transpose_walk<false><<<walk_blocks, wpb * 32, smem, st>>>(
        ip, cp, pp, op, b, e, n_rows, nj, in_smem);
    transpose_columns<<<(unsigned)((b * width + COUNT_THREADS - 1) /
                                   COUNT_THREADS), COUNT_THREADS, 0, st>>>(
        cp, dp, b, n_rows, nj);
    transpose_scan<<<b, SCAN_THREADS, 0, st>>>(dp, pp, b, e, n_rows);
    transpose_walk<true><<<walk_blocks, wpb * 32, smem, st>>>(
        ip, cp, pp, op, b, e, n_rows, nj, in_smem);
    return (int)cudaGetLastError();
}

// K2. g: (rows_in, c) payload rows (float32 if bf16 == 0, bfloat16 if 1);
// order: int32 edge ids sorted by target row; ptr: (rows + 1) int32 row
// offsets into order; out: (rows, c) float32. All contiguous device memory;
// launches on `stream`, does not synchronise. Returns the cudaError_t.
extern "C" int fseg_scatter_rows(const void* g, const void* order,
                                 const void* ptr, void* out, long long rows,
                                 int c, int bf16, void* stream) {
    if (rows < 1 || rows * 32 / SCATTER_THREADS > 0x7fffffffLL || c < 1 ||
        c > SCATTER_MAX_C)
        return (int)cudaErrorInvalidValue;
    const int32_t* op = (const int32_t*)order;
    const int32_t* pp = (const int32_t*)ptr;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        launch_rows<__nv_bfloat16>(g, op, pp, (float*)out, rows, c, st);
    else
        launch_rows<float>(g, op, pp, (float*)out, rows, c, st);
    return (int)cudaGetLastError();
}

// K3. kstar: (b * n, c) int32; s, p: (b * n, c) float32 or bfloat16; edge
// ids in `order` (int32, as for K2) are node * kk + slot, node = b' * n +
// n' the flat source, and every edge into a row of batch element b' comes
// from one of b''s nodes; ptr: (b * n_rows + 1); out: (b * n_rows, 2c)
// float32. Clouds whose slices fit in shared memory, with kk <= 255, take
// the staged kernel; the others the one that reads device memory.
extern "C" int fseg_scatter_routed(const void* kstar, const void* s,
                                   const void* p, const void* order,
                                   const void* ptr, void* out, int b, int n,
                                   int n_rows, int kk, int c, int bf16,
                                   void* stream) {
    const long long rows = (long long)b * n_rows;
    if (b < 1 || n < 1 || bad_rows(rows) || kk < 1 || c < 1 ||
        c > SCATTER_MAX_C || (long long)b * n * kk >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const int32_t* kp = (const int32_t*)kstar;
    const int32_t* op = (const int32_t*)order;
    const int32_t* pp = (const int32_t*)ptr;
    cudaStream_t st = (cudaStream_t)stream;
    if (kk <= 255 && bf16 &&
        routed_smem<__nv_bfloat16>(n) <= RS_SMEM_MAX)
        return launch_routed_staged<__nv_bfloat16>(
            kp, s, p, op, pp, (float*)out, b, n, n_rows, kk, c, st);
    if (kk <= 255 && !bf16 && routed_smem<float>(n) <= RS_SMEM_MAX)
        return launch_routed_staged<float>(kp, s, p, op, pp, (float*)out, b,
                                           n, n_rows, kk, c, st);
    if (bf16)
        launch_routed<__nv_bfloat16>(kp, s, p, op, pp, (float*)out, rows, kk, c, st);
    else
        launch_routed<float>(kp, s, p, op, pp, (float*)out, rows, kk, c, st);
    return (int)cudaGetLastError();
}

// K4. idx: (b, e) int32; out: (b, n_rows) float32. Where n_rows int32
// counters fit in HIST_SMEM_MAX, count_hist in one launch (cnt unused,
// may be null); above, cnt: (b, n_rows) int32 scratch for count_kernel.
extern "C" int fseg_scatter_count(const void* idx, void* cnt, void* out,
                                  int b, long long e, int n_rows,
                                  void* stream) {
    if (b < 1 || e < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if ((long long)n_rows * (long long)sizeof(int32_t) <= HIST_SMEM_MAX)
        return launch_hist((const int32_t*)idx, (float*)out, b, e, n_rows,
                           st);
    if (cnt == nullptr) return (int)cudaErrorInvalidValue;
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

// K4 from the transpose. ptr: (rows + 1) int32 row offsets (the `ptr` of
// fseg_graph_transpose, rows = b * n_rows); out: (rows) float32 in-degrees.
extern "C" int fseg_count_from_ptr(const void* ptr, void* out,
                                   long long rows, void* stream) {
    const long long blocks = (rows + 4LL * COUNT_THREADS - 1) /
                             (4LL * COUNT_THREADS);
    if (rows < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int vec = (((uintptr_t)ptr | (uintptr_t)out) & 15) == 0;
    count_from_ptr<<<(unsigned)blocks, COUNT_THREADS, 0,
                     (cudaStream_t)stream>>>((const int32_t*)ptr, (float*)out,
                                             rows, vec);
    return (int)cudaGetLastError();
}
