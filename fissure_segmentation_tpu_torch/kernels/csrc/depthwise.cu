// K6: 3x3x3 depthwise convolution, stride 1, SAME zero padding, channel-last,
// for Hopper (sm_90a).
//
// Replaces fissure_segmentation_tpu/ops/pallas/depthwise.py:depthwise_conv3
// (kernel body _dw_kernel) and depthwise_conv3_ring (_dw_ring_kernel), which
// compute the same function: for x (B, D, H, W, C) and w (3, 3, 3, C), both
// float32 or both bfloat16,
//   y[b, z, y, x, c] = sum over (dz, dy, dx), in that lexicographic order, of
//                      x[b, z + dz - 1, y + dy - 1, x + dx - 1, c] * w[dz, dy, dx, c]
// with every tap outside the volume read as zero, accumulated in float32 from
// 0 and rounded once to x's dtype. That is the depthwise layer of
// MobileNetASPP's stride-1 inverted residuals (models/seg_cnn.py).
//
// Rounding: each step is acc = acc + tap * w with explicit round-to-nearest
// intrinsics, the library is built with -fmad=false, and a padded tap is
// multiplied as a zero (not skipped), so the result is bit-equal to the plain
// PyTorch version (kernels/depthwise.py:depthwise_conv3_plain), which pads
// once with zeros and does the same 27 multiply-adds in the same order.
//
// What bounds it: one float32 output costs 27 multiplies and 27 adds and, at
// the least, one read of x and one write of y (8 bytes in float32, 4 in
// bfloat16): 6.75 operations a byte in float32, under the card's float32
// ridge of 67e12 / 3.35e12 = 20. So the kernel is bound by device memory:
// the least time is (x + y + w bytes) / 3.35 TB/s, 0.96 ms for the path's
// largest layer (1, 128, 128, 128, 192) in float32. The arithmetic is
// close behind: bit-equality forbids FMA, so each product and each sum is
// an instruction of its own, and 54 an output at 132 SMs x 128 lanes x
// 1.98 GHz take 0.65 ms at that layer (and the same in bfloat16, whose
// bytes take 0.48 ms). So the kernel has to keep both the memory and the
// float32 pipes busy, and a bfloat16 layer gains less than half its time.
//
// Design. A block owns a TH x TW tile of (H, W) and a slice of CS
// channels, and marches along D over one run of planes. Each input plane
// of the tile, with its one-voxel halo, comes from device memory into
// shared memory with 16-byte cp.async copies (4 float32 or 8 bfloat16
// channels a copy, channels the fastest index); a copy that falls outside
// the volume, in (D, H or W), is a zero fill, so padded taps are zeros in
// shared memory and are multiplied like any other. ST stages: the copy of
// plane p + ST - 1 is in flight while plane p is used. So every input
// voxel is read from device memory about once (the halo rows and columns
// of neighbouring tiles mostly from L2), not 27 times through L1/L2.
//
// A thread owns 4 channels of a run of RW outputs along W. Its channels'
// 27 weights stay in registers (27 x 4 floats; 8 bfloat16 channels a
// thread would need 216 registers for them, so bfloat16 threads also own
// 4 channels, as 8-byte shared-memory reads). For each of the plane's
// three rows it reads the RW + 2 inputs once and uses each for up to three
// outputs and three planes of output.
//
// Summation order while marching. Output plane o takes its taps from
// input planes o - 1 (dz = 0), o (dz = 1) and o + 1 (dz = 2). The thread
// keeps three rotating accumulators: input plane p adds its dz = 0 products
// to a fresh accumulator (output p + 1, set to 0 first), its dz = 1
// products to output p's, and its dz = 2 products to output p - 1's, which
// is then complete and stored. Within a plane the products go in (dy, dx)
// order. So each output still receives its 27 products in (dz, dy, dx)
// order, from 0, each rounded as the plain version rounds it: bit-equal.
// The rotation is unrolled by 3, so the accumulators stay in registers.
//
// Shapes whose channel rows are not 16-byte multiples (C = 5, 33 in
// float32, C % 8 != 0 in bfloat16) cannot be copied in 16-byte pieces; they
// take a simple kernel (one thread per 4 W-voxels x channel, taps straight
// from device memory, the same order of additions). The tile, slice, run
// and stage count are one launch shape for every layer, from a sweep on
// the card (PERF.md). The TPU kernels' z-plane BlockSpec triple and DMA
// ring are the TPU's formulations of the same streaming and are not
// carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DW_THREADS 256
#define DW_TW 4  // the simple kernel: outputs along W per thread
#define DW_TARGET_BLOCKS 1056  // split D until this many blocks (8 an SM)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// ---- the simple kernel (channel rows that are not 16-byte multiples) ----

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
depthwise_simple(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int d, int h, int wd, int c,
                 long long total) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= total) return;
    const int nrun = (wd + DW_TW - 1) / DW_TW;
    const int ch = (int)(g % c);
    long long r = g / c;
    const int x0 = (int)(r % nrun) * DW_TW;
    r /= nrun;
    const int yy = (int)(r % h);
    r /= h;
    const int zz = (int)(r % d);
    const long long b = r / d;

    const size_t sh = (size_t)wd * c;  // strides of H and D, in elements
    const size_t sd = (size_t)h * sh;
    const T* xb = x + (size_t)b * d * sd + ch;

    float acc[DW_TW];
#pragma unroll
    for (int t = 0; t < DW_TW; ++t) acc[t] = 0.0f;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
        const int z = zz + dz - 1;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
            const int yv = yy + dy - 1;
            const bool row_in = z >= 0 && z < d && yv >= 0 && yv < h;
            const T* row = xb + (row_in ? (size_t)z * sd + (size_t)yv * sh : 0);
            float v[DW_TW + 2];
#pragma unroll
            for (int j = 0; j < DW_TW + 2; ++j) {
                const int xv = x0 + j - 1;
                v[j] = row_in && xv >= 0 && xv < wd
                           ? to_f32(row[(size_t)xv * c]) : 0.0f;
            }
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
                const float wt = to_f32(w[((dz * 3 + dy) * 3 + dx) * c + ch]);
#pragma unroll
                for (int t = 0; t < DW_TW; ++t)
                    acc[t] = __fadd_rn(acc[t], __fmul_rn(v[t + dx], wt));
            }
        }
    }
    T* out = y + (size_t)b * d * sd + (size_t)zz * sd + (size_t)yy * sh + ch;
#pragma unroll
    for (int t = 0; t < DW_TW; ++t)
        if (x0 + t < wd) out[(size_t)(x0 + t) * c] = from_f32<T>(acc[t]);
}

// ---- the tiled kernel ------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void load4(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(q.x << 16);      // bf16 -> f32: a 16-bit shift
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<uint32_t*>(&lo);
    q.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
}

template <int R>
struct Role {  // which of the three accumulators a plane starts
    static constexpr int value = R;
};

template <typename T, int CS, int TH, int TW, int RW, int ST>
struct Tile {
    static constexpr int CG = CS / 4;               // threads along C
    static constexpr int NT = CG * (TW / RW) * TH;  // threads a block
    static constexpr int EPC = 16 / sizeof(T);      // elements a copy
    static constexpr int PH = TH + 2, PW = TW + 2;  // the tile with halo
    // a pixel's channels in shared memory, padded off multiples of 128
    // bytes so that neighbouring runs fall in other banks
    static constexpr int PS = (CS * sizeof(T)) % 128 ? CS + EPC : CS;
    static constexpr int PLANE = PH * PW * PS;      // elements a stage
    static constexpr int SMEM = ST * PLANE * sizeof(T);
    static_assert(CS % EPC == 0 && CS % 4 == 0 && TW % RW == 0, "tile");
};

template <typename T, int CS, int TH, int TW, int RW, int ST>
__global__ void __launch_bounds__((Tile<T, CS, TH, TW, RW, ST>::NT), 1)
depthwise_tiled(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, int d, int h, int wd, int c, int zlen) {
    using G = Tile<T, CS, TH, TW, RW, ST>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);

    const int tiles_w = (wd + TW - 1) / TW;
    const int y0 = (blockIdx.x / tiles_w) * TH;
    const int x0 = (blockIdx.x % tiles_w) * TW;
    const int c0 = blockIdx.y * CS;
    const int nz = (d + zlen - 1) / zlen;
    const int bb = blockIdx.z / nz;
    const int z0 = (blockIdx.z % nz) * zlen;
    const int z1 = z0 + zlen < d ? z0 + zlen : d;
    const int tid = threadIdx.x;
    const int cg = tid % G::CG;
    const int run = (tid / G::CG) % (TW / RW);
    const int ty = tid / (G::CG * (TW / RW));
    const int ch = c0 + 4 * cg;
    const bool ch_ok = ch < c;  // c % 4 == 0: a thread's 4 are all in or out

    float wr[27][4];
#pragma unroll
    for (int k = 0; k < 27; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i)
            wr[k][i] = ch_ok ? to_f32(w[k * c + ch + i]) : 0.0f;

    const long long sh = (long long)wd * c, sd = (long long)h * sh;
    const T* xb = x + (long long)bb * d * sd;
    T* yb = y + (long long)bb * d * sd;
    const int np = z1 - z0 + 2;  // input planes z0 - 1 .. z1

    // input plane p (z = z0 - 1 + p) -> stage p % ST, zero-filled outside
    auto issue = [&](int p) {
        const int z = z0 - 1 + p;
        const bool zin = z >= 0 && z < d;
        if (p >= np) {       // past the run: an empty group keeps the count
            asm volatile("cp.async.commit_group;\n" ::: "memory");
            return;
        }
        T* dst = sm + (p % ST) * G::PLANE;
        constexpr int CPP = CS / G::EPC;
        for (int k = tid; k < G::PH * G::PW * CPP; k += G::NT) {
            const int q = k % CPP, pix = k / CPP;
            const int gy = y0 - 1 + pix / G::PW, gx = x0 - 1 + pix % G::PW;
            const int gc = c0 + q * G::EPC;
            const bool ok = zin && gy >= 0 && gy < h && gx >= 0 && gx < wd &&
                            gc < c;
            const T* src =
                ok ? xb + z * sd + gy * sh + (long long)gx * c + gc : x;
            cp_async16(dst + pix * G::PS + q * G::EPC, src, ok ? 16 : 0);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    float acc[3][RW][4];
    // input plane p: its dz = 0 products start accumulator R = p % 3
    // (output plane p of the run), dz = 1 go to output p - 1's (MID), dz = 2
    // complete output p - 2's (LAST)
    auto plane = [&](int p, auto role) {
        constexpr int R = decltype(role)::value;
        constexpr int MID = (R + 2) % 3, LAST = (R + 1) % 3;
        asm volatile("cp.async.wait_group %0;\n" :: "n"(ST - 2) : "memory");
        __syncthreads();     // plane p landed; stage (p - 1) % ST is free
        issue(p + ST - 1);
        const T* pl = sm + (p % ST) * G::PLANE;
#pragma unroll
        for (int t = 0; t < RW; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[R][t][i] = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
            float v[RW + 2][4];
#pragma unroll
            for (int j = 0; j < RW + 2; ++j)
                load4(pl + ((ty + dy) * G::PW + run * RW + j) * G::PS + 4 * cg,
                      v[j]);
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
                const int k = dy * 3 + dx;
#pragma unroll
                for (int t = 0; t < RW; ++t)
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float a = v[t + dx][i];
                        acc[R][t][i] =
                            __fadd_rn(acc[R][t][i], __fmul_rn(a, wr[k][i]));
                        acc[MID][t][i] = __fadd_rn(
                            acc[MID][t][i], __fmul_rn(a, wr[9 + k][i]));
                        acc[LAST][t][i] = __fadd_rn(
                            acc[LAST][t][i], __fmul_rn(a, wr[18 + k][i]));
                    }
            }
        }
        const int gy = y0 + ty;
        if (p >= 2 && ch_ok && gy < h) {  // output plane z0 + p - 2 is done
            T* out = yb + (z0 + p - 2) * sd + gy * sh + ch;
#pragma unroll
            for (int t = 0; t < RW; ++t) {
                const int gx = x0 + run * RW + t;
                if (gx < wd) store4(out + (long long)gx * c, acc[LAST][t]);
            }
        }
    };

#pragma unroll
    for (int p = 0; p < ST - 1; ++p) issue(p);
    for (int p = 0; p < np; p += 3) {
        plane(p, Role<0>());
        if (p + 1 < np) plane(p + 1, Role<1>());
        if (p + 2 < np) plane(p + 2, Role<2>());
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int CS, int TH, int TW, int RW, int ST>
static int launch_tiled(const T* x, const T* w, T* y, int b, int d, int h,
                        int wd, int c, cudaStream_t s) {
    using G = Tile<T, CS, TH, TW, RW, ST>;
    auto kern = depthwise_tiled<T, CS, TH, TW, RW, ST>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return (int)err;
    const long long tiles =
        (long long)((h + TH - 1) / TH) * ((wd + TW - 1) / TW);
    const long long slices = (c + CS - 1) / CS;
    // split D into runs until there are DW_TARGET_BLOCKS blocks
    const long long per_run = tiles * slices * b;
    long long nz = (DW_TARGET_BLOCKS + per_run - 1) / per_run;
    if (nz > d) nz = d;
    if (nz < 1) nz = 1;
    const int zlen = (int)((d + nz - 1) / nz);
    nz = (d + zlen - 1) / zlen;
    if (tiles > 0x7fffffffLL || slices > 65535 || b * nz > 65535)
        return (int)cudaErrorInvalidValue;
    kern<<<dim3((unsigned)tiles, (unsigned)slices, (unsigned)(b * nz)), G::NT,
           G::SMEM, s>>>(x, w, y, d, h, wd, c, zlen);
    return (int)cudaGetLastError();
}

// ---- the weight gradient (the backward's wgrad) ---------------------------
//
// dw[dz, dy, dx, c] = sum over (b, z, y, x) of
//                     x[b, z + dz - 1, y + dy - 1, x + dx - 1, c] * g[b, z, y, x, c]
// for x and the output gradient g (B, D, H, W, C) float32, with taps outside
// the volume read as zero: the training step's gradient of K6's taps. It
// replaces no TPU kernel: the JAX package trains these layers with XLA's
// grouped convolution and has no Pallas backward (ops/pallas/depthwise.py:
// 1-26); the result is held against XLA's gradient in the CPU tests and
// against the float64 plain version on the card.
//
// What bounds it: every voxel of x and of g is read at least once, 8 bytes a
// voxel and channel, and each takes 27 multiply-adds (54 operations): 6.75
// operations a byte, under the float32 ridge of 20, so device memory bounds
// it: 2 x 4 x B D H W C bytes over 3.35 TB/s, 1.6 ms at (32, 48^3, 192).
//
// Design (simple and deterministic). Pass 1: a block owns WG_CH = 32
// channels (threadIdx.x, one a thread, so a warp reads 128 contiguous bytes
// of a voxel) and a run of `rows_per_block` rows (b, z, y) of the volume,
// which its WG_ROWS = 8 thread rows take in turn (thread row t takes rows
// r0 + t, r0 + t + 8, ...: neighbouring rows at once, which share 2 of
// their 3 input rows in L1). A thread keeps the 27 partial sums of its
// channel in registers and marches along W with a three-column window of
// the 9 input rows its output row reads, so each step loads 9 inputs and
// one g, and does 27 fused multiply-adds (one rounding each). The block
// then sums its 8 thread rows in a fixed order through shared memory and
// writes 27 x 32 partials to the workspace, row blockIdx.y. Pass 2: one
// thread a (tap, channel) sums the partials of every block row in order.
// No float atomics: the result is the same from run to run. A term passes
// through at most rows_per_thread x W + WG_ROWS + n_parts - 1 additions
// (`depth` in kernels/depthwise.py), which bounds the rounding: gamma_depth
// x sum |x g| of the exact sum.
#define WG_CH 32
#define WG_ROWS 8

__global__ void __launch_bounds__(WG_CH * WG_ROWS)
depthwise_wgrad_partial(const float* __restrict__ x,
                        const float* __restrict__ g,
                        float* __restrict__ part, int d, int h, int wd, int c,
                        long long rows, long long rows_per_block) {
    __shared__ float red[27][WG_ROWS][WG_CH];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int ch = blockIdx.x * WG_CH + tx;
    const long long r0 = (long long)blockIdx.y * rows_per_block;
    const long long r1 =
        r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
    const long long sw = c, sh = (long long)wd * c, sd = (long long)h * sh;

    float acc[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) acc[k] = 0.0f;
    if (ch < c) {
        for (long long r = r0 + ty; r < r1; r += WG_ROWS) {
            const int yy = (int)(r % h);
            const long long bz = r / h;           // b * d + z
            const int zz = (int)(bz % d);
            const float* grow = g + bz * sd + (long long)yy * sh + ch;
            const float* xrow[9];
            bool rin[9];
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                const int z = zz + k / 3 - 1, y = yy + k % 3 - 1;
                rin[k] = z >= 0 && z < d && y >= 0 && y < h;
                xrow[k] = x + (rin[k] ? (bz + k / 3 - 1) * sd +
                                            (long long)y * sh + ch
                                      : 0);
            }
            // win[k][j]: input row k at columns xx - 1 + j
            float win[9][3];
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                win[k][0] = 0.0f;
                win[k][1] = rin[k] ? __ldg(xrow[k]) : 0.0f;
            }
            for (int xx = 0; xx < wd; ++xx) {
                const bool right = xx + 1 < wd;
#pragma unroll
                for (int k = 0; k < 9; ++k)
                    win[k][2] = rin[k] && right
                                    ? __ldg(xrow[k] + (xx + 1) * sw) : 0.0f;
                const float gv = __ldg(grow + xx * sw);
#pragma unroll
                for (int k = 0; k < 9; ++k)
#pragma unroll
                    for (int j = 0; j < 3; ++j)
                        acc[3 * k + j] = __fmaf_rn(win[k][j], gv, acc[3 * k + j]);
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    win[k][0] = win[k][1];
                    win[k][1] = win[k][2];
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 27; ++k) red[k][ty][tx] = acc[k];
    __syncthreads();
    for (int o = ty * WG_CH + tx; o < 27 * WG_CH; o += WG_CH * WG_ROWS) {
        const int k = o / WG_CH, lane = o % WG_CH;
        const int gc = blockIdx.x * WG_CH + lane;
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < WG_ROWS; ++t) s = __fadd_rn(s, red[k][t][lane]);
        if (gc < c) part[((long long)blockIdx.y * 27 + k) * c + gc] = s;
    }
}

__global__ void depthwise_wgrad_reduce(const float* __restrict__ part,
                                       float* __restrict__ dw, int n,
                                       int n_parts) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.0f;
    for (int p = 0; p < n_parts; ++p) s = __fadd_rn(s, part[(long long)p * n + i]);
    dw[i] = s;
}

// x, g: (b, d, h, wd, c) float32; dw: (27, c) float32; part: a workspace of
// n_parts x 27 x c floats, n_parts = ceil(b d h / rows_per_block), which the
// caller sizes (kernels/depthwise.py:wgrad_plan). Launches the two passes on
// `stream`, does not synchronise; returns the first launch's cudaError_t.
extern "C" int fseg_depthwise_wgrad(const void* x, const void* g, void* dw,
                                    void* part, int b, int d, int h, int wd,
                                    int c, long long rows_per_block,
                                    int n_parts, void* stream) {
    if (b < 1 || d < 1 || h < 1 || wd < 1 || c < 1 || rows_per_block < 1)
        return (int)cudaErrorInvalidValue;
    const long long rows = (long long)b * d * h;
    if ((rows + rows_per_block - 1) / rows_per_block != n_parts ||
        n_parts > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((unsigned)((c + WG_CH - 1) / WG_CH), (unsigned)n_parts);
    depthwise_wgrad_partial<<<grid, dim3(WG_CH, WG_ROWS), 0, s>>>(
        (const float*)x, (const float*)g, (float*)part, d, h, wd, c, rows,
        rows_per_block);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n = 27 * c;
    depthwise_wgrad_reduce<<<(n + 255) / 256, 256, 0, s>>>(
        (const float*)part, (float*)dw, n, n_parts);
    return (int)cudaGetLastError();
}

// x, y: (b, d, h, wd, c), w: (3, 3, 3, c), contiguous device memory of one
// dtype (0: float32, 1: bfloat16); launches on `stream`, does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int fseg_depthwise_conv3(const void* x, const void* w, void* y,
                                    int b, int d, int h, int wd, int c,
                                    int dtype, void* stream) {
    if (b < 1 || d < 1 || h < 1 || wd < 1 || c < 1 || dtype < 0 || dtype > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int elem = dtype == 0 ? 4 : 2;
    const bool aligned =
        ((uintptr_t)x | (uintptr_t)y) % 16 == 0 && (c * elem) % 16 == 0;
    // one launch shape for every tiled case, from the sweep (PERF.md):
    // 32-channel slices (C = 144 runs 4.5 of them; 16-channel slices were
    // slower there), 8 x 16 tiles, runs of 4 along W, 3 stages
    if (aligned && dtype == 0)
        return launch_tiled<float, 32, 8, 16, 4, 3>(
            (const float*)x, (const float*)w, (float*)y, b, d, h, wd, c, s);
    if (aligned)
        return launch_tiled<__nv_bfloat16, 32, 8, 16, 4, 3>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
            (__nv_bfloat16*)y, b, d, h, wd, c, s);
    const long long nrun = (wd + DW_TW - 1) / DW_TW;
    const long long total = (long long)b * d * h * nrun * c;
    const long long blocks = (total + DW_THREADS - 1) / DW_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        depthwise_simple<float><<<(unsigned)blocks, DW_THREADS, 0, s>>>(
            (const float*)x, (const float*)w, (float*)y, d, h, wd, c, total);
    else
        depthwise_simple<__nv_bfloat16><<<(unsigned)blocks, DW_THREADS, 0, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
            (__nv_bfloat16*)y, d, h, wd, c, total);
    return (int)cudaGetLastError();
}
