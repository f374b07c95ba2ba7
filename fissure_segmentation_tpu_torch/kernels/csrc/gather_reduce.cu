// The fused EdgeConv neighbour gather-reduce, for Hopper (sm_90a).
//
// Replaces scripts/prof/prof_fused_gather.py:pallas_gather_max (P5, kernel
// body _kernel), which computes out[b, n, f] = max_k a[b, idx[b, n, k], f]
// without storing the (B, N, k, F) neighbour tensor, and the XLA gather +
// reductions of fissure_segmentation_tpu/ops/fused_edge.py:_gather_reduce
// and fused_edge_eval that the TPU kernel was meant to fuse. For a
// (B, N, C) table `a` (float32 or bfloat16, C <= 256) and indices (B, N, K)
// int32 it returns, per (b, n, c) and over k = 0 .. K - 1 in order:
//
//   want 0 ("max"):     max
//   want 1 ("extrema"): max, min
//   want 2 ("all"):     max, min, argmax, argmin (int32, the FIRST slot of
//                       the extremum), and the float32 sum s1 and sum of
//                       squares s2, each added from 0 in k order with
//                       __fadd_rn / __fmul_rn (the library is built with
//                       -fmad=false)
//
// max and min are in a's dtype. A NaN wins a comparison against a number and
// loses against an earlier NaN, so max, min and their slots propagate the
// first NaN as jnp.max and jnp.argmax do. Row of a neighbour: the flat index
// f = b * N + idx, with f += B * N once if f < 0 and then clamped into
// [0, B * N), as the JAX package's flat gather (`x.reshape(B*N, C)[f]`)
// normalises and clamps it. The plain version (kernels/gather_reduce.py:
// gather_reduce_plain) runs the same comparisons and roundings in the same
// order, so the two are bit-equal in every output.
//
// What bounds it: it must read `a` and idx once and write the outputs once
// (at B=32, N=2048, K=40, C=64 in float32 and want 2: 0.13 GB, 0.04 ms at
// 3.35 TB/s), but it reads every row of `a` K times: 671 MB of rows at
// that shape. A cloud's table (512 KB in float32) stays in the 50 MB L2, so
// the unstaged kernel below, which fetched each row from L2, spent half its
// time on those reads (0.095 of 0.177 ms; PERF.md, the split) and the rest
// on the reductions: per value and slot two compares with their selects
// and, for want 2, a multiply and two adds, which bit-equality keeps apart
// (no FMA). So the reads have to leave L2, and then the arithmetic bounds
// it: about 12 instructions a value and slot, 0.07 ms at that shape on 132
// SMs x 128 lanes.
//
// Design (gather_reduce_staged). A block owns one cloud b and a 64-byte
// channel slice (16 float32 or 32 bfloat16 channels) and copies the slice
// of all N points into shared memory with 16-byte cp.async copies (zero
// fill past C; one element at a time where rows are not 16-byte
// multiples): 128 KB at N = 2048, so the K-fold re-reads come from shared
// memory. A warp then takes 8 points at a time, 4 lanes a point, each lane
// one 16-byte vector of the slice row, and walks the point's slots in k
// order, so the sums keep their order. Its steps are 16 slots of 8 points:
// the next step's index rows are loaded (branch-free, clamped; a half-warp
// a point) while the current one is reduced, the first while the slice
// arrives; a step's rows are read from shared memory GS_UNROLL at a time
// before any is reduced (a compiler barrier keeps them ahead; for max
// and min alone no branch falls between them: a slot past the step's end
// repeats the group's first row, which changes no extremum). Where the
// slice holds no NaN, the comparisons are plain x > e and x < e, and max
// and min alone ("max", "extrema") are one FMNMX a value where it holds no
// -0.0 either (fmaxf keeps either of two equal zeros). Warps a block: as
// many as each (dtype, want)'s registers allow (16-32). A neighbour row
// that the flat-row clamp sends into another cloud is read from device
// memory (a warp-uniform slow path). Where clouds x slices are fewer than
// the SMs, each block also takes a share of the points: the staged route
// (each block stages the whole slice for itself) up to GS_MAX_PARTS blocks
// a slice (staged_parts, a measured model); past it (the serving
// ensemble's 5 clouds x 4 slices) the staged route at more blocks a slice
// or the cluster route, whichever a model in microseconds finds faster
// (fseg_gather_reduce_route). In the cluster route the blocks of a slice
// form thread-block clusters of up to GC_MAX_P; each block copies 1/P of
// the slice from device memory into every block of its cluster, boxes of
// GC_BOX rows of a tensor map multicast by the Tensor Memory Accelerator
// (cp.async.bulk.tensor .multicast::cluster, completing on each block's
// mbarrier), so the slice leaves L2 once a cluster; its rows must be
// 16-byte multiples. The cluster size and the clusters a slice come from
// the same model, over the clusters that fit at once. A cloud of more
// than GS_MAX_N points, whose
// slice does not fit, takes the unstaged kernel (gather_reduce_kernel):
// one warp per point, the lanes reading the point's indices 32 at a time
// and each row's channels from device memory (L2), GR_UNROLL rows in
// flight.
#include <cuda.h>   // CUtensorMap (its encoder is looked up at run time)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#define GR_WARPS 8      // points per block: one warp each
#define GR_MAX_C 256    // 32 lanes x 8 channels
#define GR_UNROLL 4     // rows loaded before they are reduced

template <typename T, int CPL>
struct alignas(sizeof(T) * CPL) Pack {
    T v[CPL];
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);   // exact: v came from a bfloat16
}

// v[i] = row[c0 + i] for the channels this lane owns (0 past C)
template <typename T, int CPL>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int c0,
                                         int c, bool vec, float* v) {
    if (vec) {
        if (c0 < c) {
            const Pack<T, CPL> p =
                *reinterpret_cast<const Pack<T, CPL>*>(row + c0);
#pragma unroll
            for (int i = 0; i < CPL; ++i) v[i] = to_f32<T>(p.v[i]);
        } else {
#pragma unroll
            for (int i = 0; i < CPL; ++i) v[i] = 0.0f;
        }
    } else {
#pragma unroll
        for (int i = 0; i < CPL; ++i)
            v[i] = c0 + i < c ? to_f32<T>(row[c0 + i]) : 0.0f;
    }
}

template <typename U, int CPL>
__device__ __forceinline__ void store_row(U* __restrict__ row, int c0, int c,
                                          bool vec, const U* v) {
    if (vec) {
        if (c0 < c) {
            Pack<U, CPL> p;
#pragma unroll
            for (int i = 0; i < CPL; ++i) p.v[i] = v[i];
            *reinterpret_cast<Pack<U, CPL>*>(row + c0) = p;
        }
    } else {
#pragma unroll
        for (int i = 0; i < CPL; ++i)
            if (c0 + i < c) row[c0 + i] = v[i];
    }
}

// x replaces the running extremum e iff it is beyond it, or x is the first
// NaN (x != x) while e is still a number
__device__ __forceinline__ bool beats_max(float x, float e) {
    return !(x <= e) && e == e;   // x > e, or x NaN; never once e is NaN
}
__device__ __forceinline__ bool beats_min(float x, float e) {
    return !(x >= e) && e == e;
}

// ---- the unstaged kernel: clouds whose slice does not fit in shared memory --

// One warp a point (b, n); lane l owns channels [l * CPL, l * CPL + CPL)
// (CPL = 1, 2, 4 or 8, the least with 32 * CPL >= C), read from device
// memory as one vector where C is a multiple of CPL and `a` is aligned.
template <typename T, int CPL, int WANT>
__global__ void __launch_bounds__(GR_WARPS * 32)
gather_reduce_kernel(const T* __restrict__ a, const int32_t* __restrict__ idx,
                     T* __restrict__ mx_out, T* __restrict__ mn_out,
                     int32_t* __restrict__ am_out,
                     int32_t* __restrict__ amn_out,
                     float* __restrict__ s1_out, float* __restrict__ s2_out,
                     long long points, int n, int kk, int c, bool vec) {
    const long long p =
        (long long)blockIdx.x * GR_WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (p >= points) return;   // warp-uniform: the shuffles stay full
    const long long base = (p / n) * (long long)n;
    const int c0 = lane * CPL;
    float mx[CPL], mn[CPL], s1[CPL], s2[CPL];
    int am[CPL], amn[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
        mx[i] = -INFINITY;
        mn[i] = INFINITY;
        am[i] = amn[i] = 0;
        s1[i] = s2[i] = 0.0f;
    }
    const int32_t* ip = idx + p * (long long)kk;
    for (int k0 = 0; k0 < kk; k0 += 32) {
        const int cnt = min(32, kk - k0);
        long long row = 0;
        if (lane < cnt) {
            long long f = base + ip[k0 + lane];
            if (f < 0) f += points;
            row = f < 0 ? 0 : (f >= points ? points - 1 : f);
        }
        for (int j = 0; j < cnt; j += GR_UNROLL) {
            float v[GR_UNROLL][CPL];
#pragma unroll
            for (int u = 0; u < GR_UNROLL; ++u) {
                const long long r =
                    __shfl_sync(0xffffffffu, row, j + u < cnt ? j + u : j);
                load_row<T, CPL>(a + r * c, c0, c, vec, v[u]);
            }
#pragma unroll
            for (int u = 0; u < GR_UNROLL; ++u) {
                if (j + u >= cnt) break;
                const int k = k0 + j + u;
#pragma unroll
                for (int i = 0; i < CPL; ++i) {
                    const float x = v[u][i];
                    if (beats_max(x, mx[i])) {
                        mx[i] = x;
                        am[i] = k;
                    }
                    if (WANT >= 1 && beats_min(x, mn[i])) {
                        mn[i] = x;
                        amn[i] = k;
                    }
                    if (WANT == 2) {
                        s1[i] = __fadd_rn(s1[i], x);
                        s2[i] = __fadd_rn(s2[i], __fmul_rn(x, x));
                    }
                }
            }
        }
    }
    const long long o = p * (long long)c;
    T t[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) t[i] = from_f32<T>(mx[i]);
    store_row<T, CPL>(mx_out + o, c0, c, vec, t);
    if (WANT >= 1) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) t[i] = from_f32<T>(mn[i]);
        store_row<T, CPL>(mn_out + o, c0, c, vec, t);
    }
    if (WANT == 2) {
        store_row<int32_t, CPL>(am_out + o, c0, c, vec, am);
        store_row<int32_t, CPL>(amn_out + o, c0, c, vec, amn);
        store_row<float, CPL>(s1_out + o, c0, c, vec, s1);
        store_row<float, CPL>(s2_out + o, c0, c, vec, s2);
    }
}

// ---- the staged kernel and its cluster route --------------------------------

// One block: cloud b, a channel slice [c0, c0 + SC) of ROW = GS_ROW bytes
// a point (SC = ROW / sizeof(T) channels), points [n0, n1) of the cloud. The
// slice of all N points is brought into shared memory once; a warp then
// takes PPW = GS_PPW points at a time, LPP = GS_LPP lanes a point, each lane
// one 16-byte vector (VEC channels) of the slice row, and walks the point's
// slots in k order. A neighbour row outside cloud b (an index that the
// flat-row clamp sends into another cloud) is read from device memory.
#define GS_ROW 64                  // bytes of a staged row, at most
#define GS_LPP 4                   // lanes a point at GS_ROW: 4 x 16 bytes
#define GS_PPW 8                   // points a warp takes at GS_ROW
#define GS_MAX_WARPS 32            // warps a block, at most (staged_warps)
#define GS_SLOTS 16                // slots whose rows a warp stages at once
#define GS_IDX_PITCH 20            // staged slots a point: 16-byte rows
#define GS_IDX_BYTES(nw, ppw) ((nw) * (ppw) * GS_IDX_PITCH * 4)
#define GS_MAX_N 3200              // 200 KB of slice: N * GS_ROW
#define GS_MAX_PARTS 4             // blocks a slice of the staged route
#define GS_UNROLL 4                // rows read before they are reduced
#define GC_MAX_P 16                // blocks a cluster, at most (> 8: non-portable)
#define GC_BAR_BYTES 80            // the cluster route's mbarriers and flags
#define GC_BOX 64                  // rows a tensor-map box (multicast copy)
#define GC_SPIN_LIMIT (1u << 26)   // mbarrier tries before a trap
// the few-cloud route model's (fseg_gather_reduce_route), microseconds,
// fitted to prof/design_sweep.py --parts grc on an H100 (PERF.md)
#define GC_SLOT_US 6.1e-4          // a point's slot on a slice, one block
#define GC_FIXED_US 7.5            // a cluster block's fixed part
#define GS_FIXED_US 4.0            // a staged block's fixed part
#define GS_ROW_US 3.0e-3           // a staged row, copied by every block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes of shared memory at a 32-bit shared-window address
__device__ __forceinline__ uint4 lds16(unsigned addr) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
    return v;
}

// the same shared-window address in the block of cluster rank `rank`
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

// relaxed: what a peer must see first (an mbarrier's init) is released by
// fence.mbarrier_init, and the data by the mbarriers; a release here would
// wait for every load in flight (the index prefetch)
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// wait for phase `parity` of the mbarrier at `bar` (acquiring what the
// cluster's arrivals released); one that never completes traps instead of
// hanging the card
__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
    unsigned done = 0, tries = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
            "[%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (++tries == GC_SPIN_LIMIT) __trap();
    }
}

// the VEC = 16 / sizeof(T) channels of a 16-byte vector as float32
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

// A NaN, or for max and min alone a -0.0, among the 16 bytes of q? (there
// fmaxf and fminf, which keep either of two equal zeros, would not keep the
// first one seen as x > e and x < e do; a bfloat16 NaN: exponent all ones,
// mantissa not zero)
template <typename T, int WANT>
__device__ __forceinline__ bool special16(const uint4 q) {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
    bool s = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if (sizeof(T) == 4) {
            s |= (u[i] & 0x7fffffffu) > 0x7f800000u;
            if (WANT < 2) s |= u[i] == 0x80000000u;
        } else {
            s |= (u[i] & 0x7fffu) > 0x7f80u ||
                 (u[i] & 0x7fff0000u) > 0x7f800000u;
            if (WANT < 2)
                s |= (u[i] & 0xffffu) == 0x8000u || (u[i] >> 16) == 0x8000u;
        }
    }
    return s;
}

// The index rows of a warp's step: points pg + lane / GS_SLOTS + 2 i (i <
// PPW / 2; clamped to n1 - 1), slot k0 + lane % GS_SLOTS (clamped to kk -
// 1): each half-warp reads one point's slots, coalesced, no branch.
template <int PPW>
__device__ __forceinline__ void fetch_rows(const int32_t* __restrict__ idx,
                                           long long cloud, int kk, int lane,
                                           int n1, int pg, int k0, int* v) {
    const int s = k0 + min(lane % GS_SLOTS, kk - k0 - 1);
    const int p0 = pg + lane / GS_SLOTS;
#pragma unroll
    for (int i = 0; i < PPW / 2; ++i) {
        const int p2 = min(p0 + 2 * i, n1 - 1);
        v[i] = __ldg(idx + (cloud + p2) * (long long)kk + s);
    }
}

// Reduce a step's cnt staged slots (`mine`: the point's rows, GS_UNROLL at
// a time read as 16-byte index vectors) into the lane's VEC channels, in k
// order from slot k0. FAR: some row may lie outside the cloud (a negative
// entry) and is read from device memory. SPECIAL: the slice may hold a NaN,
// or a -0.0 where max and min are reduced alone (else max and min alone are
// fmaxf and fminf, and with the slots x > e and x < e, which decide as
// beats_max and beats_min would).
template <typename T, int WANT, int ROW, bool FAR, bool SPECIAL>
__device__ __forceinline__ void reduce_step(
        const T* __restrict__ a, const int32_t* mine, unsigned lane_s, int c,
        int c1, int cnt, int k0, float* mx, float* mn, int* am, int* amn,
        float* s1, float* s2) {
    constexpr int VEC = 16 / sizeof(T);
    for (int t = 0; t < cnt; t += GS_UNROLL) {
        int rs[GS_UNROLL];
#pragma unroll
        for (int u = 0; u < GS_UNROLL; u += 4) {
            const int4 r4 = *reinterpret_cast<const int4*>(mine + t + u);
            rs[u] = u == 0 || t + u < cnt ? r4.x : rs[0];
            rs[u + 1] = t + u + 1 < cnt ? r4.y : rs[0];
            rs[u + 2] = t + u + 2 < cnt ? r4.z : rs[0];
            rs[u + 3] = t + u + 3 < cnt ? r4.w : rs[0];
        }
        float w[GS_UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < GS_UNROLL; ++u) {
            const int r = rs[u];
            if (!FAR || r >= 0) {
                unpack16(lds16(lane_s + r * ROW), w[u], T());
            } else {
                const T* row = a + (long long)(-(r + 1)) * c;
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    w[u][i] = c1 + i < c ? to_f32<T>(row[c1 + i]) : 0.0f;
            }
        }
        asm volatile("" ::: "memory");   // the reads stay ahead
        // max and min alone reduce every row of the group, with no branch
        // between the reads: a slot past the step's end repeats the
        // group's first row, which moves no extremum (it was seen); the
        // sums stop at the step's end
        const int lim = cnt - t;           // slots of this group in range
#pragma unroll
        for (int u = 0; u < GS_UNROLL; ++u) {
            if (WANT == 2 && u >= lim) break;
            const int k = k0 + t + u;
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                const float x = w[u][i];
                if (!SPECIAL && WANT < 2) {   // one FMNMX a value
                    mx[i] = fmaxf(mx[i], x);
                    if (WANT == 1) mn[i] = fminf(mn[i], x);
                    continue;
                }
                // without a NaN in sight the comparisons are plain ones
                if (SPECIAL ? beats_max(x, mx[i]) : x > mx[i]) {
                    mx[i] = x;
                    am[i] = k;
                }
                if (WANT >= 1 && (SPECIAL ? beats_min(x, mn[i]) : x < mn[i])) {
                    mn[i] = x;
                    amn[i] = k;
                }
                if (WANT == 2) {
                    s1[i] = __fadd_rn(s1[i], x);
                    s2[i] = __fadd_rn(s2[i], __fmul_rn(x, x));
                }
            }
        }
    }
}

// CL: the `parts` blocks of a cloud slice form parts / csize thread-block
// clusters of csize (rank = part % csize), and the slice leaves L2 once a
// cluster instead of once a block: each block copies its rows [rr0, rr1)
// (its rank's 1 / csize of them, in whole boxes; its points are its
// part's) as boxes of GC_BOX rows of a 3-D tensor map over a, multicast
// into every block of the cluster (cp.async.bulk.tensor .multicast::
// cluster, completing on each block's mbarrier); rows must be 16-byte
// multiples and `a` 16-byte aligned (the tensor map's), else the call takes
// the staged kernel (launch_routed). Each block scans its own rows for a
// NaN (or -0.0) and stores its flag into every block with an asynchronous
// store (st.async) that completes on that block's second mbarrier, so no
// block scans the whole slice and no cluster barrier waits for the flags.
// Otherwise (the staged route) each of the `parts` blocks copies and scans
// the whole slice for itself.
template <typename T, int WANT, int NW, bool CL>
__global__ void __launch_bounds__(NW * 32)
gather_reduce_staged(const T* __restrict__ a, const int32_t* __restrict__ idx,
                     T* __restrict__ mx_out, T* __restrict__ mn_out,
                     int32_t* __restrict__ am_out,
                     int32_t* __restrict__ amn_out,
                     float* __restrict__ s1_out, float* __restrict__ s2_out,
                     int bsz, int n, int kk, int c, int nslice, int parts,
                     int csize, bool vec,
                     const __grid_constant__ CUtensorMap tmap) {
    constexpr int VEC = 16 / sizeof(T);      // channels a lane
    constexpr int LPP = GS_LPP;              // lanes a point
    constexpr int ROW = GS_ROW;              // bytes of a staged row
    constexpr int PPW = GS_PPW;              // points a warp takes at a time
    constexpr int SC = ROW / sizeof(T);      // channels a slice
    static_assert(ROW == 16 * LPP && PPW * LPP == 32, "GS_ROW, GS_LPP");
    static_assert(GS_SLOTS == 16, "a half-warp stages one point's slots");
    // the slice's rows in shared memory: n, or under CL n rounded up to
    // whole boxes (the rows past n are zero)
    const int nrow = CL ? (n + GC_BOX - 1) / GC_BOX * GC_BOX : n;
    extern __shared__ __align__(128) unsigned char gs_smem[];
    T* slice = reinterpret_cast<T*>(gs_smem);
    int32_t* sidx = reinterpret_cast<int32_t*>(gs_smem + (size_t)nrow * ROW);
    // CL: the mbarriers of the slice's rows (`bar`) and of the blocks'
    // flags (`fbar`: a NaN or -0.0 among each block's rows, `spec` below)
    unsigned char* tail = gs_smem + (size_t)nrow * ROW + GS_IDX_BYTES(NW, PPW);
    const unsigned bar = smem_u32(tail), fbar = bar + 8;
    int* flags = reinterpret_cast<int*>(tail + 16);
    const int part = blockIdx.x % parts;
    const int cs = (blockIdx.x / parts) % nslice;
    const int b = blockIdx.x / (parts * nslice);
    const int c0 = cs * SC;
    const long long cloud = (long long)b * n;     // first flat row of b
    const long long points = (long long)bsz * n;
    const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int per = (n + parts - 1) / parts;
    const int n0 = min(n, part * per), n1 = min(n, n0 + per);
    // CL: the rank in the cluster, and the rows [rr0, rr1) this block
    // copies into every block of the cluster, in whole boxes
    const int crank = part % csize;
    const int rper = (nrow / GC_BOX + csize - 1) / csize * GC_BOX;
    const int rr0 = min(nrow, crank * rper), rr1 = min(nrow, rr0 + rper);
    if (CL && threadIdx.x == 0) {   // armed before any peer may send
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(bar) : "memory");
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(fbar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        // every block's (its own too) 4-byte flag
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(fbar), "r"(4 * csize) : "memory");
        // the whole slice, every block's boxes
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"((unsigned)(nrow * ROW)) : "memory");
    }
    // The warp's steps: point groups of PPW points, each in chunks of
    // GS_SLOTS slots; the next step's index rows are loaded while the
    // current step is reduced (the first step's while the slice arrives),
    // so their latency is hidden.
    int pg = n0 + wib * PPW, k0 = 0;
    int nxt[PPW / 2];
    if (pg < n1) fetch_rows<PPW>(idx, cloud, kk, lane, n1, pg, 0, nxt);

    bool spec = false;   // a NaN, or for max and min alone a -0.0
    if (!CL) {
        // the whole slice copied by this block: 16-byte asynchronous
        // copies (zero fill past C), or one element at a time where rows
        // are not 16-byte multiples
        for (int q = threadIdx.x; q < n * LPP; q += NW * 32) {
            const int pt = q / LPP, ch = c0 + (q % LPP) * VEC;
            T* dst = slice + pt * SC + (q % LPP) * VEC;
            const T* src = a + (cloud + pt) * c + ch;
            if (vec) {
                cp_async16(dst, ch < c ? src : a, ch < c ? 16 : 0);
            } else {
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    dst[i] = ch + i < c ? src[i] : from_f32<T>(0.0f);
            }
        }
    } else {
        // once every peer's mbarrier is armed, boxes of rows [rr0, rr1)
        // into every block of the cluster (zero past C and past n)
        cluster_arrive();
        cluster_wait();
        const unsigned short all = (unsigned short)((1u << csize) - 1);
        for (int r = rr0 + GC_BOX * (int)threadIdx.x; r < rr1;
             r += GC_BOX * NW * 32)
            asm volatile(
                "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
                "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3, "
                "%4}], [%5], %6;\n"
                :: "r"(smem_u32(slice) + r * ROW),
                   "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(c0), "r"(r),
                   "r"(b), "r"(bar), "h"(all)
                : "memory");
        wait_parity(bar, 0);   // the slice, own rows too, is in
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (CL) {
        // this block's rows [rr0, min(rr1, n)) scanned, its flag stored
        // into every block's flags[crank] by an asynchronous store that
        // completes on that block's fbar (no fence waits for the loads in
        // flight); every flag is in once its phase completes
        for (int q = rr0 * LPP + threadIdx.x; q < min(rr1, n) * LPP;
             q += NW * 32)
            spec |= special16<T, WANT>(
                *reinterpret_cast<const uint4*>(slice + q * VEC));
        const int own = __syncthreads_or(spec);
        if ((int)threadIdx.x < csize) {
            asm volatile(
                "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 "
                "[%0], %1, [%2];\n"
                :: "r"(mapa(smem_u32(flags + crank), threadIdx.x)),
                   "r"(own), "r"(mapa(fbar, threadIdx.x))
                : "memory");
        }
        wait_parity(fbar, 0);
        spec = false;
        for (int i = 0; i < csize; ++i) spec |= flags[i] != 0;
        // every copy into this block is done; the wait at the end keeps
        // each block until every block is here, so no copy from it is left
        cluster_arrive();
    } else {   // the whole slice scanned
        for (int q = threadIdx.x; q < n * LPP; q += NW * 32)
            spec |= special16<T, WANT>(
                *reinterpret_cast<const uint4*>(slice + q * VEC));
        spec = __syncthreads_or(spec);
    }

    const int j = lane / LPP, q = lane % LPP;         // point, vector
    const int c1 = c0 + q * VEC;                      // the lane's channels
    const int sl = lane % GS_SLOTS;                   // the slot it stages
    int32_t* wsidx = sidx + wib * PPW * GS_IDX_PITCH;
    const int32_t* mine = wsidx + j * GS_IDX_PITCH;
    const unsigned lane_s = smem_u32(slice) + q * 16;  // row 0's vector
    float mx[VEC], mn[VEC], s1[VEC], s2[VEC];
    int am[VEC], amn[VEC];
    while (pg < n1) {
        const int cpg = pg, ck0 = k0, cnt = min(GS_SLOTS, kk - k0);
        int cur[PPW / 2];
#pragma unroll
        for (int i = 0; i < PPW / 2; ++i) cur[i] = nxt[i];
        k0 += GS_SLOTS;
        if (k0 >= kk) {
            k0 = 0;
            pg += NW * PPW;
        }
        if (pg < n1) fetch_rows<PPW>(idx, cloud, kk, lane, n1, pg, k0, nxt);
        const int pn = cpg + j;
        const bool act = pn < n1;
        if (ck0 == 0) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                mx[i] = -INFINITY;
                mn[i] = INFINITY;
                am[i] = amn[i] = 0;
                s1[i] = s2[i] = 0.0f;
            }
        }
        // the step's slots as the local row in cloud b, or -(flat row + 1)
        // where the flat-row clamp leaves the cloud; `far`: any such slot
        __syncwarp();
        bool out = false;
#pragma unroll
        for (int i = 0; i < PPW / 2; ++i) {
            const int jj = lane / GS_SLOTS + 2 * i;
            int loc = cur[i];
            if ((unsigned)loc >= (unsigned)n) {   // not a row of b as it is
                long long f = cloud + loc;
                if (f < 0) f += points;
                f = f < 0 ? 0 : (f >= points ? points - 1 : f);
                const long long l = f - cloud;
                loc = l >= 0 && l < n ? (int)l : (int)(-f - 1);
            }
            out |= loc < 0 && sl < cnt && cpg + jj < n1;
            if (sl < cnt) wsidx[jj * GS_IDX_PITCH + sl] = loc;
        }
        const bool far = __any_sync(0xffffffffu, out);
        __syncwarp();
        if (act && !far && !spec)
            reduce_step<T, WANT, ROW, false, false>(
                a, mine, lane_s, c, c1, cnt, ck0, mx, mn, am, amn, s1, s2);
        else if (act)
            reduce_step<T, WANT, ROW, true, true>(
                a, mine, lane_s, c, c1, cnt, ck0, mx, mn, am, amn, s1, s2);
        if (!act || c1 >= c || ck0 + GS_SLOTS < kk) continue;
        const long long o = (cloud + pn) * (long long)c;
        const bool ovec = vec && c1 + VEC <= c;
        T tv[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) tv[i] = from_f32<T>(mx[i]);
        store_row<T, VEC>(mx_out + o, c1, c, ovec, tv);
        if (WANT >= 1) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) tv[i] = from_f32<T>(mn[i]);
            store_row<T, VEC>(mn_out + o, c1, c, ovec, tv);
        }
        if (WANT == 2) {
            store_row<int32_t, VEC>(am_out + o, c1, c, ovec, am);
            store_row<int32_t, VEC>(amn_out + o, c1, c, ovec, amn);
            store_row<float, VEC>(s1_out + o, c1, c, ovec, s1);
            store_row<float, VEC>(s2_out + o, c1, c, ovec, s2);
        }
    }
    if (CL) cluster_wait();
}

// Warps a block: as many as the registers of each (dtype, want) allow with
// one block an SM (float32 "all" takes 74 a thread, bfloat16 "all" 114).
template <typename T, int WANT>
constexpr int staged_warps() {
    return WANT == 0 || (WANT == 1 && sizeof(T) == 4) ? 32
           : WANT == 1 || sizeof(T) == 4              ? 24
                                                      : 16;
}

// rows of 16-byte multiples from a 16-byte aligned table: the staged
// copies' vectors and the cluster route's tensor map
template <typename T>
static bool vec16(const void* a, int c) {
    return c % (16 / (int)sizeof(T)) == 0 && (uintptr_t)a % 16 == 0;
}

// cuTensorMapEncodeTiled, looked up once through the runtime (the library
// links no -lcuda)
typedef CUresult (*TensorMapEncode)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static cudaError_t tensor_map_encoder(TensorMapEncode* out) {
    static TensorMapEncode fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || p == nullptr)
            return cudaErrorNotSupported;
        fn = reinterpret_cast<TensorMapEncode>(p);
    }
    *out = fn;
    return cudaSuccess;
}

// The cluster route's tensor map over a, seen as (c, n, b) (channels
// innermost): boxes of sc channels x GC_BOX rows of one cloud, zero outside
// the tensor (past C, past n).
template <typename T>
static cudaError_t slice_map(const void* a, int b, int n, int c, int sc,
                             CUtensorMap* m) {
    TensorMapEncode encode;
    const cudaError_t err = tensor_map_encoder(&encode);
    if (err != cudaSuccess) return err;
    const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)n, (cuuint64_t)b};
    const cuuint64_t strides[2] = {(cuuint64_t)c * sizeof(T),
                                   (cuuint64_t)n * c * sizeof(T)};
    const cuuint32_t box[3] = {(cuuint32_t)sc, GC_BOX, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    const CUresult r = encode(
        m, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        3, const_cast<void*>(a), dims, strides, box, step,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A staged kernel's launch: its function, the shared memory it takes at n
// points, and the configuration of a call (the cluster dimension under CL).
// The first use on a device allows the shared memory of GS_MAX_N points and,
// under CL, clusters above 8 blocks.
template <typename T, int WANT, bool CL>
struct Staged {
    static constexpr int NW = staged_warps<T, WANT>();
    static constexpr int SC = GS_ROW / (int)sizeof(T);
    static_assert(NW <= GS_MAX_WARPS, "GS_MAX_WARPS bounds the shared memory");

    static auto kernel() { return &gather_reduce_staged<T, WANT, NW, CL>; }

    static int smem(int n) {
        const int rows = CL ? (n + GC_BOX - 1) / GC_BOX * GC_BOX : n;
        return rows * GS_ROW + GS_IDX_BYTES(NW, GS_PPW) +
               (CL ? GC_BAR_BYTES : 0);
    }

    static cudaError_t config(int b, int n, int c, int parts, int csize,
                              cudaStream_t st, cudaLaunchConfig_t* cfg,
                              cudaLaunchAttribute* attr) {
        static unsigned long long allowed = 0;   // a bit a device
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        if (dev >= 64 || !(allowed >> dev & 1ull)) {
            err = cudaFuncSetAttribute(
                kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                smem(GS_MAX_N));
            if (err == cudaSuccess && CL)
                err = cudaFuncSetAttribute(
                    kernel(), cudaFuncAttributeNonPortableClusterSizeAllowed,
                    1);
            if (err != cudaSuccess) return err;
            if (dev < 64) allowed |= 1ull << dev;
        }
        const long long blocks = (long long)b * ((c + SC - 1) / SC) * parts;
        if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
        *cfg = {};
        cfg->gridDim = dim3((unsigned)blocks);
        cfg->blockDim = dim3(NW * 32);
        cfg->dynamicSmemBytes = smem(n);
        cfg->stream = st;
        if (CL) {
            attr[0].id = cudaLaunchAttributeClusterDimension;
            attr[0].val.clusterDim.x = csize;
            attr[0].val.clusterDim.y = 1;
            attr[0].val.clusterDim.z = 1;
            cfg->attrs = attr;
            cfg->numAttrs = 1;
        }
        return cudaSuccess;
    }

    static int launch(const void* a, const int32_t* idx, void* mx, void* mn,
                      int32_t* am, int32_t* amn, float* s1, float* s2, int b,
                      int n, int kk, int c, int parts, int csize,
                      cudaStream_t st) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cudaError_t err = config(b, n, c, parts, csize, st, &cfg, attr);
        if (err != cudaSuccess) {
            cudaGetLastError();
            return (int)err;
        }
        const bool vec = vec16<T>(a, c);
        CUtensorMap tmap;   // the cluster route's boxes (unused elsewhere)
        memset(&tmap, 0, sizeof(tmap));
        if (CL) err = slice_map<T>(a, b, n, c, SC, &tmap);
        if (err != cudaSuccess) {
            cudaGetLastError();
            return (int)err;
        }
        err = cudaLaunchKernelEx(&cfg, kernel(), (const T*)a, idx, (T*)mx,
                                 (T*)mn, am, amn, s1, s2, b, n, kk, c,
                                 (c + SC - 1) / SC, parts, csize, vec, tmap);
        const cudaError_t last = cudaGetLastError();   // read and cleared
        return (int)(err != cudaSuccess ? err : last);
    }

    // clusters of csize blocks that fit on the device at once (0: none)
    static cudaError_t clusters(int b, int n, int c, int csize, int* out) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cudaError_t err = config(b, n, c, csize, csize, 0, &cfg, attr);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveClusters(out, (const void*)kernel(),
                                                 &cfg);
        if (err != cudaSuccess) cudaGetLastError();   // not left behind
        return err;
    }
};

// the staged kernels by (dtype, want): the staged route, and the cluster
// route where rows are 16-byte multiples and `a` is 16-byte aligned (the
// tensor map's boxes); else its call takes the staged kernel at its parts
template <typename T, int WANT>
static int launch_routed(int route, const void* a, const int32_t* idx,
                         void* mx, void* mn, int32_t* am, int32_t* amn,
                         float* s1, float* s2, int b, int n, int kk, int c,
                         int parts, int csize, cudaStream_t st) {
    if (route == 1 || !vec16<T>(a, c))
        return Staged<T, WANT, false>::launch(
            a, idx, mx, mn, am, amn, s1, s2, b, n, kk, c, parts, 1, st);
    return Staged<T, WANT, true>::launch(
        a, idx, mx, mn, am, amn, s1, s2, b, n, kk, c, parts, csize, st);
}

template <typename T>
static cudaError_t clusters_want(int want, int b, int n, int c, int csize,
                                 int* out) {
    if (want == 0)
        return Staged<T, 0, true>::clusters(b, n, c, csize, out);
    if (want == 1)
        return Staged<T, 1, true>::clusters(b, n, c, csize, out);
    return Staged<T, 2, true>::clusters(b, n, c, csize, out);
}

// Blocks a cloud slice is split into by the staged route (each stages the
// whole slice and takes a share of its points): the count that minimises
// waves x (stage + the share of the work), the staging taken as 1/40 of a
// whole slice's work (PERF.md, the batch sweep: about 3 of 124 us at (32,
// 2048, 40, 64) f32 "extrema"); at least 128 points a block.
static int staged_parts(long long groups, int sms, int n) {
    const long long most = (n + 127) / 128;
    long long best = 1;
    double cost = 1e300;
    for (long long p = 1; p <= most && p <= 64; ++p) {
        const long long waves = (groups * p + sms - 1) / sms;
        const double t = (double)waves * (1.0 + 40.0 / (double)p);
        if (t < cost - 1e-9) {
            cost = t;
            best = p;
        }
    }
    return (int)best;
}

static cudaError_t sm_count(int* sms) {
    static int counts[64] = {0};   // the SMs of each device, once
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

// Waves of `blocks` blocks where `fit` fit on the device at once.
static long long waves(long long blocks, long long fit) {
    return (blocks + fit - 1) / fit;
}

// The route of a (b, n, kk, c) call on the current device, as {route,
// parts, csize}: route 0, the unstaged kernel (n > GS_MAX_N: the slice does
// not fit); route 1, the staged kernel, `parts` blocks a 64-byte slice;
// route 2, the cluster route, `parts` blocks a slice in parts / csize
// clusters of csize blocks, each cluster copying the slice once. Many
// clouds take the staged route at staged_parts' split where it is at most
// GS_MAX_PARTS. Fewer clouds (the serving ensemble's 5) take the faster, by
// a model in microseconds, of the staged kernel at 1 .. `most` blocks a
// slice, waves x (GS_FIXED_US + n GS_ROW_US + n kk GC_SLOT_US / parts), and
// the cluster route at every (csize, clusters a slice), waves x
// (GC_FIXED_US + n kk GC_SLOT_US / parts): waves from the SMs (one staged
// block an SM) or from the clusters of that size that fit at once
// (cudaOccupancyMaxActiveClusters: a cluster stays inside one GPC, so 5
// clusters of 3 fill a GPC of 16 SMs that holds 2 of 6); the fixed parts
// (launch, the slice's arrival, the scan, the cluster's barriers and
// flags) are absolute, so a short call (DPSR-Net's single cloud of 1024
// points and 20 slots) weighs them against little work; the staged kernel
// on a tie; clusters of 2 or more, the larger on a tie (less copying); at
// least 128 points a block. Rows that are not 16-byte multiples take the
// staged kernel (no tensor map). Fitted to the sweep's staged and cluster
// times at 1-14 clouds of 2048 points and DPSR-Net's 1 and 5 of 1024: the
// clouds of 2048 take the cluster route, DPSR-Net's calls the staged
// kernel at 8 and 6 blocks a slice, each the fastest measured but for (1,
// 1024) (5.6 us at 16 blocks a slice, below 128 points a block). Returns
// the cudaError_t of the device queries.
extern "C" int fseg_gather_reduce_route(int b, int n, int kk, int c,
                                        int want, int bf16, int* out) {
    out[0] = out[1] = out[2] = 0;
    if (b < 1 || n < 1 || kk < 1 || c < 1 || c > GR_MAX_C || want < 0 ||
        want > 2)
        return (int)cudaErrorInvalidValue;
    if (n > GS_MAX_N) return 0;
    int sms = 0;
    cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    const int sc = GS_ROW / (bf16 ? 2 : 4);
    const long long groups = (long long)b * ((c + sc - 1) / sc);
    const int most = (n + 127) / 128;   // blocks a slice, at most
    out[0] = out[2] = 1;
    out[1] = staged_parts(groups, sms, n);
    if (out[1] <= GS_MAX_PARTS) return 0;
    const double work = (double)n * kk * GC_SLOT_US;   // a slice, one block
    double cost = 1e300;
    for (int p = 1; p <= most; ++p) {
        const double t = (double)waves(groups * p, sms) *
                         (GS_FIXED_US + n * GS_ROW_US + work / p);
        if (t < cost - 1e-9) {
            cost = t;
            out[1] = p;
        }
    }
    if (c % (16 / (bf16 ? 2 : 4)) != 0) return 0;   // no tensor map
    for (int p = GC_MAX_P < most ? GC_MAX_P : most; p >= 2; --p) {
        int fit = 0;
        err = bf16 ? clusters_want<__nv_bfloat16>(want, b, n, c, p, &fit)
                   : clusters_want<float>(want, b, n, c, p, &fit);
        if (err != cudaSuccess) return (int)err;
        for (int q = 1; fit > 0 && q * p <= most; ++q) {
            const double t = (double)waves(groups * q, fit) *
                             (GC_FIXED_US + work / (q * p));
            if (t < cost - 1e-9) {
                cost = t;
                out[0] = 2;
                out[1] = q * p;
                out[2] = p;
            }
        }
    }
    return 0;
}

template <typename T, int CPL>
static void launch(const void* a, const int32_t* idx, void* mx, void* mn,
                   int32_t* am, int32_t* amn, float* s1, float* s2,
                   long long points, int n, int kk, int c, int want,
                   cudaStream_t st) {
    const T* ap = (const T*)a;
    // a vector per lane needs every row start aligned to it; the outputs
    // are fresh allocations with the same row length
    const bool vec = c % CPL == 0 &&
                     (uintptr_t)a % (sizeof(T) * CPL) == 0;
    const dim3 grid((unsigned int)((points + GR_WARPS - 1) / GR_WARPS));
    const dim3 block(GR_WARPS * 32);
    if (want == 0)
        gather_reduce_kernel<T, CPL, 0><<<grid, block, 0, st>>>(
            ap, idx, (T*)mx, (T*)mn, am, amn, s1, s2, points, n, kk, c, vec);
    else if (want == 1)
        gather_reduce_kernel<T, CPL, 1><<<grid, block, 0, st>>>(
            ap, idx, (T*)mx, (T*)mn, am, amn, s1, s2, points, n, kk, c, vec);
    else
        gather_reduce_kernel<T, CPL, 2><<<grid, block, 0, st>>>(
            ap, idx, (T*)mx, (T*)mn, am, amn, s1, s2, points, n, kk, c, vec);
}

template <typename T>
static void launch_c(const void* a, const int32_t* idx, void* mx, void* mn,
                     int32_t* am, int32_t* amn, float* s1, float* s2,
                     long long points, int n, int kk, int c, int want,
                     cudaStream_t st) {
    if (c <= 32)
        launch<T, 1>(a, idx, mx, mn, am, amn, s1, s2, points, n, kk, c, want, st);
    else if (c <= 64)
        launch<T, 2>(a, idx, mx, mn, am, amn, s1, s2, points, n, kk, c, want, st);
    else if (c <= 128)
        launch<T, 4>(a, idx, mx, mn, am, amn, s1, s2, points, n, kk, c, want, st);
    else
        launch<T, 8>(a, idx, mx, mn, am, amn, s1, s2, points, n, kk, c, want, st);
}

template <typename T>
static int launch_want(int route, const void* a, const int32_t* idx,
                       void* mx, void* mn, int32_t* am, int32_t* amn,
                       float* s1, float* s2, int b, int n, int kk, int c,
                       int want, int parts, int csize, cudaStream_t st) {
    if (want == 0)
        return launch_routed<T, 0>(route, a, idx, mx, mn, am, amn, s1, s2, b,
                                   n, kk, c, parts, csize, st);
    if (want == 1)
        return launch_routed<T, 1>(route, a, idx, mx, mn, am, amn, s1, s2, b,
                                   n, kk, c, parts, csize, st);
    return launch_routed<T, 2>(route, a, idx, mx, mn, am, amn, s1, s2, b, n,
                               kk, c, parts, csize, st);
}

// a: (b * n, c) float32 (bf16 == 0) or bfloat16 (bf16 == 1); idx: (b * n,
// kk) int32; mx (and mn for want >= 1): (b * n, c) in a's dtype; am, amn
// int32 and s1, s2 float32, (b * n, c), for want == 2 (else may be null).
// All contiguous device memory; launches on `stream`, does not synchronise.
// (route, parts, csize): fseg_gather_reduce_route's answer for (b, n, c,
// want, bf16) on this device. Returns the cudaError_t: a cluster launch
// that is refused returns its error, it never runs another kernel instead.
extern "C" int fseg_gather_reduce(const void* a, const void* idx, void* mx,
                                  void* mn, void* am, void* amn, void* s1,
                                  void* s2, int b, int n, int kk, int c,
                                  int want, int bf16, int route, int parts,
                                  int csize, void* stream) {
    if (b < 1 || n < 1 || kk < 1 || c < 1 || c > GR_MAX_C || want < 0 ||
        want > 2 || route < 0 || route > 2)
        return (int)cudaErrorInvalidValue;
    if (route > 0 && (n > GS_MAX_N || parts < 1 || parts > 64 ||
                      csize < 1 || parts % csize != 0 ||
                      (route == 1 && csize != 1) || csize > GC_MAX_P))
        return (int)cudaErrorInvalidValue;
    const long long points = (long long)b * n;
    if ((points + GR_WARPS - 1) / GR_WARPS > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int32_t* ip = (const int32_t*)idx;
    cudaStream_t st = (cudaStream_t)stream;
    if (route > 0 && bf16)
        return launch_want<__nv_bfloat16>(
            route, a, ip, mx, mn, (int32_t*)am, (int32_t*)amn, (float*)s1,
            (float*)s2, b, n, kk, c, want, parts, csize, st);
    if (route > 0)
        return launch_want<float>(route, a, ip, mx, mn, (int32_t*)am,
                                  (int32_t*)amn, (float*)s1, (float*)s2, b,
                                  n, kk, c, want, parts, csize, st);
    if (bf16)
        launch_c<__nv_bfloat16>(a, ip, mx, mn, (int32_t*)am, (int32_t*)amn,
                                (float*)s1, (float*)s2, points, n, kk, c,
                                want, st);
    else
        launch_c<float>(a, ip, mx, mn, (int32_t*)am, (int32_t*)amn,
                        (float*)s1, (float*)s2, points, n, kk, c, want, st);
    return (int)cudaGetLastError();
}
