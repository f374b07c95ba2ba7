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
// the next step's index rows are loaded (branch-free, clamped) while the
// current one is reduced, the first while the slice arrives; a step's rows
// are read from shared memory GS_UNROLL at a time before any is reduced (a
// compiler barrier keeps them ahead). Where the slice holds no NaN, the
// comparisons are plain x > e and x < e. Warps a block: as many as each
// (dtype, want)'s registers allow (16-32). A neighbour row that the flat-row
// clamp sends into another cloud is read from device memory (a warp-uniform
// slow path). Where clouds x slices are fewer than the SMs, each block also
// takes a share of the points and stages the slice for itself; the split
// comes from a measured model (staged_parts), and where it would exceed 4
// blocks a slice (the serving ensemble's 5 clouds x 4 slices) the unstaged
// kernel below, faster there, runs instead. So does a cloud of more than
// GS_MAX_N points, whose slice does not fit. The unstaged kernel
// (gather_reduce_kernel): one warp per point, the lanes reading the
// point's indices 32 at a time and each row's channels from device memory
// (L2), GR_UNROLL rows in flight.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

// ---- the staged kernel ------------------------------------------------------

// One block: cloud b, the channel slice [c0, c0 + GS_SC) (GS_SC = 16 float32
// or 32 bfloat16 channels: a 64-byte row a point), points [n0, n1) of the
// cloud. The slice of all N points is copied into shared memory once; a
// warp then takes GS_PPW points at a time, GS_LPP lanes a point, each lane
// one 16-byte vector (GS_VEC channels) of the slice row, and walks the
// point's slots in k order. A neighbour row outside cloud b (an index that
// the flat-row clamp sends into another cloud) is read from device memory.
#define GS_ROW 64                  // bytes of a staged row
#define GS_LPP 4                   // lanes a point: 4 x 16 bytes = GS_ROW
#define GS_PPW 8                   // points a warp takes at a time
#define GS_MAX_WARPS 32            // warps a block, at most (staged_warps)
#define GS_SLOTS 16                // slots whose rows a warp stages at once
#define GS_IDX_PITCH 20            // staged slots a point: 16-byte rows
#define GS_IDX_BYTES(nw) ((nw) * GS_PPW * GS_IDX_PITCH * 4)
#define GS_MAX_N 3200              // 200 KB of slice: N * GS_ROW
#define GS_MAX_PARTS 4             // blocks a cloud slice, at most
#define GS_UNROLL 4                // rows read before they are reduced

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

// 16 bytes of shared memory at a 32-bit shared-window address
__device__ __forceinline__ uint4 lds16(unsigned addr) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
    return v;
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

// The index rows of points pg .. pg + GS_PPW - 1 (clamped to n1 - 1),
// slots k0 + lane (clamped to kk - 1): one coalesced row a point, no branch.
__device__ __forceinline__ void fetch_rows(const int32_t* __restrict__ idx,
                                           long long cloud, int kk, int lane,
                                           int n1, int pg, int k0, int* v) {
    const int s = k0 + min(lane, kk - k0 - 1);
#pragma unroll
    for (int jj = 0; jj < GS_PPW; ++jj) {
        const int p2 = min(pg + jj, n1 - 1);
        v[jj] = __ldg(idx + (cloud + p2) * (long long)kk + s);
    }
}

// Reduce a step's cnt staged slots (`mine`: the point's rows, GS_UNROLL at
// a time read as 16-byte index vectors) into the lane's VEC channels, in k
// order from slot k0. FAR: some row may lie outside the cloud (a negative
// entry) and is read from device memory. NANS: a value may be NaN (else
// x > e and x < e decide as beats_max and beats_min would).
template <typename T, int WANT, bool FAR, bool NANS>
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
                unpack16(lds16(lane_s + r * GS_ROW), w[u], T());
            } else {
                const T* row = a + (long long)(-(r + 1)) * c;
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    w[u][i] = c1 + i < c ? to_f32<T>(row[c1 + i]) : 0.0f;
            }
        }
        asm volatile("" ::: "memory");   // the reads stay ahead
        const int lim = cnt - t;           // slots of this group in range
#pragma unroll
        for (int u = 0; u < GS_UNROLL; ++u) {
            if (u >= lim) break;
            const int k = k0 + t + u;
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                const float x = w[u][i];
                // without a NaN in sight the comparisons are plain ones
                if (NANS ? beats_max(x, mx[i]) : x > mx[i]) {
                    mx[i] = x;
                    am[i] = k;
                }
                if (WANT >= 1 && (NANS ? beats_min(x, mn[i]) : x < mn[i])) {
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

template <typename T, int WANT, int NW>
__global__ void __launch_bounds__(NW * 32)
gather_reduce_staged(const T* __restrict__ a, const int32_t* __restrict__ idx,
                     T* __restrict__ mx_out, T* __restrict__ mn_out,
                     int32_t* __restrict__ am_out,
                     int32_t* __restrict__ amn_out,
                     float* __restrict__ s1_out, float* __restrict__ s2_out,
                     int bsz, int n, int kk, int c, int nslice, int parts,
                     bool vec) {
    constexpr int VEC = 16 / sizeof(T);      // channels a lane
    constexpr int SC = GS_ROW / sizeof(T);   // channels a slice
    extern __shared__ __align__(16) unsigned char gs_smem[];
    T* slice = reinterpret_cast<T*>(gs_smem);
    int32_t* sidx = reinterpret_cast<int32_t*>(gs_smem + (size_t)n * GS_ROW);
    const int part = blockIdx.x % parts;
    const int cs = (blockIdx.x / parts) % nslice;
    const int b = blockIdx.x / (parts * nslice);
    const int c0 = cs * SC;
    const long long cloud = (long long)b * n;     // first flat row of b
    const long long points = (long long)bsz * n;
    const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int per = (n + parts - 1) / parts;
    const int n0 = part * per, n1 = min(n, n0 + per);
    // The warp's steps: point groups of GS_PPW points, each in chunks of
    // GS_SLOTS slots; the next step's index rows are loaded while the
    // current step is reduced (the first step's while the slice arrives),
    // so their latency is hidden.
    int pg = n0 + wib * GS_PPW, k0 = 0;
    int nxt[GS_PPW];
    if (pg < n1) fetch_rows(idx, cloud, kk, lane, n1, pg, 0, nxt);

    // the slice of the cloud's N rows: 16-byte asynchronous copies (zero
    // fill past C), or one element at a time where rows are not 16-byte
    // multiples
    for (int q = threadIdx.x; q < n * GS_LPP; q += NW * 32) {
        const int pt = q / GS_LPP, ch = c0 + (q % GS_LPP) * VEC;
        T* dst = slice + pt * SC + (q % GS_LPP) * VEC;
        const T* src = a + (cloud + pt) * c + ch;
        if (vec) {
            cp_async16(dst, ch < c ? src : a, ch < c ? 16 : 0);
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
                dst[i] = ch + i < c ? src[i] : from_f32<T>(0.0f);
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // any NaN in the slice? (a bfloat16 NaN: exponent all ones, mantissa
    // not zero)
    bool nan = false;
    for (int q = threadIdx.x; q < n * GS_LPP; q += NW * 32) {
        const uint4 v = *reinterpret_cast<const uint4*>(slice + q * VEC);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (sizeof(T) == 4)
                nan |= (u[i] & 0x7fffffffu) > 0x7f800000u;
            else
                nan |= (u[i] & 0x7fffu) > 0x7f80u ||
                       (u[i] & 0x7fff0000u) > 0x7f800000u;
        }
    }
    nan = __syncthreads_or(nan);

    const int j = lane / GS_LPP, q = lane % GS_LPP;   // point, vector
    const int c1 = c0 + q * VEC;                      // the lane's channels
    int32_t* wsidx = sidx + wib * GS_PPW * GS_IDX_PITCH;
    const int32_t* mine = wsidx + j * GS_IDX_PITCH;
    const unsigned lane_s =   // the lane's vector of row 0, shared window
        (unsigned)__cvta_generic_to_shared(slice) + q * 16;
    float mx[VEC], mn[VEC], s1[VEC], s2[VEC];
    int am[VEC], amn[VEC];
    while (pg < n1) {
        const int cpg = pg, ck0 = k0, cnt = min(GS_SLOTS, kk - k0);
        int cur[GS_PPW];
#pragma unroll
        for (int jj = 0; jj < GS_PPW; ++jj) cur[jj] = nxt[jj];
        k0 += GS_SLOTS;
        if (k0 >= kk) {
            k0 = 0;
            pg += NW * GS_PPW;
        }
        if (pg < n1) fetch_rows(idx, cloud, kk, lane, n1, pg, k0, nxt);
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
        for (int jj = 0; jj < GS_PPW; ++jj) {
            long long f = cloud + cur[jj];
            if (f < 0) f += points;
            f = f < 0 ? 0 : (f >= points ? points - 1 : f);
            const long long loc = f - cloud;
            const bool in = loc >= 0 && loc < n;
            out |= !in && lane < cnt && cpg + jj < n1;
            if (lane < cnt)
                wsidx[jj * GS_IDX_PITCH + lane] =
                    in ? (int32_t)loc : (int32_t)(-f - 1);
        }
        const bool far = __any_sync(0xffffffffu, out);
        __syncwarp();
        if (act && !far && !nan)
            reduce_step<T, WANT, false, false>(a, mine, lane_s, c, c1, cnt,
                                               ck0, mx, mn, am, amn, s1, s2);
        else if (act)
            reduce_step<T, WANT, true, true>(a, mine, lane_s, c, c1, cnt,
                                             ck0, mx, mn, am, amn, s1, s2);
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
}

template <typename T, int WANT, int NW>
static int launch_staged(const void* a, const int32_t* idx, void* mx,
                         void* mn, int32_t* am, int32_t* amn, float* s1,
                         float* s2, int b, int n, int kk, int c, int parts,
                         cudaStream_t st) {
    static_assert(NW <= GS_MAX_WARPS, "GS_MAX_WARPS bounds the shared memory");
    constexpr int SC = GS_ROW / sizeof(T);
    auto kern = gather_reduce_staged<T, WANT, NW>;
    const int smem = n * GS_ROW + GS_IDX_BYTES(NW);
    // the most this kernel takes, allowed once a device
    static unsigned long long allowed = 0;   // a bit a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !(allowed >> dev & 1ull)) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            GS_MAX_N * GS_ROW + GS_IDX_BYTES(NW));
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) allowed |= 1ull << dev;
    }
    const int nslice = (c + SC - 1) / SC;
    const bool vec = c % (16 / (int)sizeof(T)) == 0 &&
                     (uintptr_t)a % 16 == 0;
    kern<<<(unsigned)((long long)b * nslice * parts), NW * 32, smem, st>>>(
        (const T*)a, idx, (T*)mx, (T*)mn, am, amn, s1, s2, b, n, kk, c,
        nslice, parts, vec);
    return (int)cudaGetLastError();
}

// Blocks a cloud slice is split into (each stages the whole slice and
// takes a share of its points): the count that minimises waves x (stage +
// the share of the work), the staging taken as 1/40 of a whole slice's
// work (PERF.md, the batch sweep: about 3 of 124 us at (32, 2048, 40, 64)
// f32 "extrema"). 0 where the best
// split exceeds GS_MAX_PARTS: there the unstaged kernel was faster (the
// serving ensemble's 5 clouds x 4 slices: 6 parts).
static int staged_parts(long long groups, int sms, int n) {
    const long long most = (n + 127) / 128;   // 128 points a block at least
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
    return best <= GS_MAX_PARTS ? (int)best : 0;
}

// Warps a block: as many as the registers of each (dtype, want) allow with
// one block an SM (float32 "all" takes 74 a thread, bfloat16 "all" 114).
template <typename T, int WANT>
constexpr int staged_warps() {
    return WANT == 0 || (WANT == 1 && sizeof(T) == 4) ? 32
           : WANT == 1 || sizeof(T) == 4              ? 24
                                                      : 16;
}

template <typename T>
static int launch_staged_want(const void* a, const int32_t* idx, void* mx,
                              void* mn, int32_t* am, int32_t* amn, float* s1,
                              float* s2, int b, int n, int kk, int c,
                              int want, int parts, cudaStream_t st) {
    if (want == 0)
        return launch_staged<T, 0, staged_warps<T, 0>()>(
            a, idx, mx, mn, am, amn, s1, s2, b, n, kk, c, parts, st);
    if (want == 1)
        return launch_staged<T, 1, staged_warps<T, 1>()>(
            a, idx, mx, mn, am, amn, s1, s2, b, n, kk, c, parts, st);
    return launch_staged<T, 2, staged_warps<T, 2>()>(
        a, idx, mx, mn, am, amn, s1, s2, b, n, kk, c, parts, st);
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

// Blocks each cloud slice of a (b, n, c) table is split into by the staged
// kernel, 0 where the unstaged kernel runs instead (the slice does not fit, or
// clouds x slices are too few for the SMs: staged_parts), or minus the
// cudaError_t of the device query.
extern "C" int fseg_gather_reduce_parts(int b, int n, int c, int bf16) {
    if (n > GS_MAX_N) return 0;
    static int sm_counts[64] = {0};   // the SMs of each device, once
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev < 64 && sm_counts[dev] > 0) {
        sms = sm_counts[dev];
    } else if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err == cudaSuccess && dev < 64) sm_counts[dev] = sms;
    }
    if (err != cudaSuccess) return -(int)err;
    const int sc = GS_ROW / (bf16 ? 2 : 4);
    return staged_parts((long long)b * ((c + sc - 1) / sc), sms, n);
}

// a: (b * n, c) float32 (bf16 == 0) or bfloat16 (bf16 == 1); idx: (b * n,
// kk) int32; mx (and mn for want >= 1): (b * n, c) in a's dtype; am, amn
// int32 and s1, s2 float32, (b * n, c), for want == 2 (else may be null).
// All contiguous device memory; launches on `stream`, does not synchronise.
// Returns the cudaError_t.
extern "C" int fseg_gather_reduce(const void* a, const void* idx, void* mx,
                                  void* mn, void* am, void* amn, void* s1,
                                  void* s2, int b, int n, int kk, int c,
                                  int want, int bf16, void* stream) {
    if (b < 1 || n < 1 || kk < 1 || c < 1 || c > GR_MAX_C || want < 0 ||
        want > 2)
        return (int)cudaErrorInvalidValue;
    const long long points = (long long)b * n;
    if ((points + GR_WARPS - 1) / GR_WARPS > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int32_t* ip = (const int32_t*)idx;
    cudaStream_t st = (cudaStream_t)stream;
    // the staged kernel where the cloud's slice fits in shared memory and
    // clouds x slices keep enough of the SMs busy
    const int parts = fseg_gather_reduce_parts(b, n, c, bf16);
    if (parts < 0) return -parts;
    if (parts > 0 && bf16)
        return launch_staged_want<__nv_bfloat16>(
            a, ip, mx, mn, (int32_t*)am, (int32_t*)amn, (float*)s1,
            (float*)s2, b, n, kk, c, want, parts, st);
    if (parts > 0)
        return launch_staged_want<float>(a, ip, mx, mn, (int32_t*)am,
                                         (int32_t*)amn, (float*)s1,
                                         (float*)s2, b, n, kk, c, want, parts,
                                         st);
    if (bf16)
        launch_c<__nv_bfloat16>(a, ip, mx, mn, (int32_t*)am, (int32_t*)amn,
                                (float*)s1, (float*)s2, points, n, kk, c,
                                want, st);
    else
        launch_c<float>(a, ip, mx, mn, (int32_t*)am, (int32_t*)amn,
                        (float*)s1, (float*)s2, points, n, kk, c, want, st);
    return (int)cudaGetLastError();
}
