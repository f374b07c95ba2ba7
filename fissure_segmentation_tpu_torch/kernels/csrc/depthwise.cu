// K6: 3x3x3 depthwise convolution, stride 1 or 2, zero padding 1,
// channel-last, and its weight gradient, for Hopper (sm_90a).
//
// Replaces fissure_segmentation_tpu/ops/pallas/depthwise.py:depthwise_conv3
// (kernel body _dw_kernel) and depthwise_conv3_ring (_dw_ring_kernel), which
// compute the stride-1 function: for x (B, D, H, W, C) and w (3, 3, 3, C),
// both float32 or both bfloat16, and the stride s (1 or 2),
//   y[b, z, y, x, c] = sum over (dz, dy, dx), in that lexicographic order, of
//                      x[b, s z + dz - 1, s y + dy - 1, s x + dx - 1, c]
//                      * w[dz, dy, dx, c]
// with every tap outside the volume read as zero, accumulated in float32 from
// 0 and rounded once to x's dtype; y is ceil(n / s) long along each of D, H
// and W. Stride 1 is the depthwise layer of MobileNetASPP's stride-1 inverted
// residuals; stride 2 is block 5's depthwise layer and LR-ASPP's stride-2
// 3x3x3 ones, which the JAX package computes with XLA's grouped convolution
// (models/seg_cnn.py:53, models/lraspp_3d.py:66; no Pallas kernel): stride 2
// is the stride-1 function taken at every other output along each axis.
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
// At stride 2 an output reads 8 inputs on average: x's bytes alone bound it
// (0.54 ms at block 5's (1, 128^3, 192) f32), the products are an eighth.
//
// Design. A block owns a TH x TW tile of the output's (H, W) and a slice of
// CS channels, and marches along D over one run of output planes. Each
// input plane of the tile with its halo (S (TH - 1) + 3 rows of
// S (TW - 1) + 3 voxels) comes from device memory into shared memory with
// 16-byte cp.async copies (4 float32 or 8 bfloat16 channels a copy,
// channels the fastest index); a copy that falls outside the volume, in (D,
// H or W), is a zero fill, so padded taps are zeros in shared memory and are
// multiplied like any other. ST stages: the copy of plane p + ST - 1 is in
// flight while plane p is used. So every input voxel is read from device
// memory about once (the halo rows and columns of neighbouring tiles mostly
// from L2), not 27 times through L1/L2.
//
// A thread owns 4 channels of a run of RW outputs along W. Its channels'
// 27 weights stay in registers (27 x 4 floats; 8 bfloat16 channels a
// thread would need 216 registers for them, so bfloat16 threads also own
// 4 channels, as 8-byte shared-memory reads). For each of the plane's
// three rows it reads the S (RW - 1) + 3 inputs of its run once and uses
// each for every output and every plane of output that takes it.
//
// Summation order while marching. Stride 1: output plane o takes its taps
// from input planes o - 1 (dz = 0), o (dz = 1) and o + 1 (dz = 2). The
// thread keeps three rotating accumulators: input plane p adds its dz = 0
// products to a fresh accumulator (output p + 1, set to 0 first), its
// dz = 1 products to output p's, and its dz = 2 products to output
// p - 1's, which is then complete and stored. Stride 2: output o takes
// input planes 2o - 1, 2o and 2o + 1, so the march consumes two input
// planes an output plane and two accumulators rotate: an even plane of the
// run starts one output (dz = 0) and completes the one before (dz = 2), an
// odd plane adds the dz = 1 products of the one it started. Within a plane
// the products go in (dy, dx) order. So each output still receives its 27
// products in (dz, dy, dx) order, from 0, each rounded as the plain version
// rounds it: bit-equal. The rotation is unrolled, so the accumulators stay
// in registers.
//
// Shapes whose channel rows are not 16-byte multiples (C = 5, 33 in
// float32, C % 8 != 0 in bfloat16) cannot be copied in 16-byte pieces; they
// take a simple kernel (one thread per 4 W-outputs x channel, taps straight
// from device memory, the same order of additions). The stride-1 tile,
// slice, run and stage count are one launch shape for every layer, from a
// sweep on the card (PERF.md); stride 2 takes 4 x 8 output tiles (9 x 17
// input voxels a plane) and runs of 2. The TPU kernels' z-plane BlockSpec
// triple and DMA ring are the TPU's formulations of the same streaming and
// are not carried over.
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

// the output's length along an axis of n voxels at stride s: ceil(n / s)
__host__ __device__ __forceinline__ int out_len(int n, int s) {
    return (n - 1) / s + 1;
}

// ---- the simple kernel (channel rows that are not 16-byte multiples) ----

template <typename T, int S>
__global__ void __launch_bounds__(DW_THREADS)
depthwise_simple(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int d, int h, int wd, int c,
                 long long total) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= total) return;
    const int od = out_len(d, S), oh = out_len(h, S), ow = out_len(wd, S);
    const int nrun = (ow + DW_TW - 1) / DW_TW;
    const int ch = (int)(g % c);
    long long r = g / c;
    const int x0 = (int)(r % nrun) * DW_TW;
    r /= nrun;
    const int yy = (int)(r % oh);
    r /= oh;
    const int zz = (int)(r % od);
    const long long b = r / od;

    const size_t sh = (size_t)wd * c;  // strides of H and D, in elements
    const size_t sd = (size_t)h * sh;
    const T* xb = x + (size_t)b * d * sd + ch;
    constexpr int NV = S * (DW_TW - 1) + 3;  // inputs a row of the run reads

    float acc[DW_TW];
#pragma unroll
    for (int t = 0; t < DW_TW; ++t) acc[t] = 0.0f;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
        const int z = S * zz + dz - 1;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
            const int yv = S * yy + dy - 1;
            const bool row_in = z >= 0 && z < d && yv >= 0 && yv < h;
            const T* row = xb + (row_in ? (size_t)z * sd + (size_t)yv * sh : 0);
            float v[NV];
#pragma unroll
            for (int j = 0; j < NV; ++j) {
                const int xv = S * x0 + j - 1;
                v[j] = row_in && xv >= 0 && xv < wd
                           ? to_f32(row[(size_t)xv * c]) : 0.0f;
            }
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
                const float wt = to_f32(w[((dz * 3 + dy) * 3 + dx) * c + ch]);
#pragma unroll
                for (int t = 0; t < DW_TW; ++t)
                    acc[t] = __fadd_rn(acc[t], __fmul_rn(v[S * t + dx], wt));
            }
        }
    }
    const size_t osh = (size_t)ow * c, osd = (size_t)oh * osh;
    T* out = y + (size_t)b * od * osd + (size_t)zz * osd + (size_t)yy * osh + ch;
#pragma unroll
    for (int t = 0; t < DW_TW; ++t)
        if (x0 + t < ow) out[(size_t)(x0 + t) * c] = from_f32<T>(acc[t]);
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

// the accumulators a plane's dz = 0, 1 and 2 products go to (-1: none)
template <int A0, int A1, int A2>
struct Slots {
    static constexpr int dz0 = A0, dz1 = A1, dz2 = A2;
};

template <typename T, int CS, int TH, int TW, int RW, int ST, int S>
struct Tile {
    static constexpr int CG = CS / 4;               // threads along C
    static constexpr int NT = CG * (TW / RW) * TH;  // threads a block
    static constexpr int EPC = 16 / sizeof(T);      // elements a copy
    // the input tile with halo, and the inputs a thread's run reads a row
    static constexpr int PH = S * (TH - 1) + 3, PW = S * (TW - 1) + 3;
    static constexpr int NV = S * (RW - 1) + 3;
    static constexpr int NACC = S == 1 ? 3 : 2;     // rotating accumulators
    // a pixel's channels in shared memory, padded off multiples of 128
    // bytes so that neighbouring runs fall in other banks
    static constexpr int PS = (CS * sizeof(T)) % 128 ? CS + EPC : CS;
    static constexpr int PLANE = PH * PW * PS;      // elements a stage
    static constexpr int SMEM = ST * PLANE * sizeof(T);
    static_assert(CS % EPC == 0 && CS % 4 == 0 && TW % RW == 0, "tile");
    static_assert(S == 1 || S == 2, "stride");
};

template <typename T, int CS, int TH, int TW, int RW, int ST, int S, int MINB>
__global__ void __launch_bounds__((Tile<T, CS, TH, TW, RW, ST, S>::NT), MINB)
depthwise_tiled(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, int d, int h, int wd, int c, int zlen) {
    using G = Tile<T, CS, TH, TW, RW, ST, S>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);

    const int od = out_len(d, S), oh = out_len(h, S), ow = out_len(wd, S);
    const int tiles_w = (ow + TW - 1) / TW;
    const int y0 = (blockIdx.x / tiles_w) * TH;  // the output tile's origin
    const int x0 = (blockIdx.x % tiles_w) * TW;
    const int c0 = blockIdx.y * CS;
    const int nz = (od + zlen - 1) / zlen;
    const int bb = blockIdx.z / nz;
    const int z0 = (blockIdx.z % nz) * zlen;
    const int z1 = z0 + zlen < od ? z0 + zlen : od;
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
    const long long osh = (long long)ow * c, osd = (long long)oh * osh;
    const T* xb = x + (long long)bb * d * sd;
    T* yb = y + (long long)bb * od * osd;
    // the input tile's origin; input planes iz0 .. iz0 + np - 1
    const int iy0 = S * y0 - 1, ix0 = S * x0 - 1, iz0 = S * z0 - 1;
    const int np = S * (z1 - z0 - 1) + 3;

    // input plane p (z = iz0 + p) -> stage p % ST, zero-filled outside
    auto issue = [&](int p) {
        const int z = iz0 + p;
        const bool zin = z >= 0 && z < d;
        if (p >= np) {       // past the run: an empty group keeps the count
            asm volatile("cp.async.commit_group;\n" ::: "memory");
            return;
        }
        T* dst = sm + (p % ST) * G::PLANE;
        constexpr int CPP = CS / G::EPC;
        for (int k = tid; k < G::PH * G::PW * CPP; k += G::NT) {
            const int q = k % CPP, pix = k / CPP;
            const int gy = iy0 + pix / G::PW, gx = ix0 + pix % G::PW;
            const int gc = c0 + q * G::EPC;
            const bool ok = zin && gy >= 0 && gy < h && gx >= 0 && gx < wd &&
                            gc < c;
            const T* src =
                ok ? xb + z * sd + gy * sh + (long long)gx * c + gc : x;
            cp_async16(dst + pix * G::PS + q * G::EPC, src, ok ? 16 : 0);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    float acc[G::NACC][RW][4];
#pragma unroll
    for (int a = 0; a < G::NACC; ++a)
#pragma unroll
        for (int t = 0; t < RW; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[a][t][i] = 0.0f;
    // input plane p: its dz = 0 products start accumulator dz0 (set to 0
    // first), dz = 1 go to accumulator dz1, dz = 2 complete accumulator dz2,
    // which is then stored as the run's output plane o (o >= 0)
    auto plane = [&](int p, int o, auto slots) {
        using L = decltype(slots);
        asm volatile("cp.async.wait_group %0;\n" :: "n"(ST - 2) : "memory");
        __syncthreads();     // plane p landed; stage (p - 1) % ST is free
        issue(p + ST - 1);
        const T* pl = sm + (p % ST) * G::PLANE;
        if constexpr (L::dz0 >= 0) {
#pragma unroll
            for (int t = 0; t < RW; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[L::dz0][t][i] = 0.0f;
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
            float v[G::NV][4];
#pragma unroll
            for (int j = 0; j < G::NV; ++j)
                load4(pl + ((S * ty + dy) * G::PW + S * run * RW + j) * G::PS +
                          4 * cg, v[j]);
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
                const int k = dy * 3 + dx;
#pragma unroll
                for (int t = 0; t < RW; ++t)
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float a = v[S * t + dx][i];
                        if constexpr (L::dz0 >= 0)
                            acc[L::dz0][t][i] = __fadd_rn(
                                acc[L::dz0][t][i], __fmul_rn(a, wr[k][i]));
                        if constexpr (L::dz1 >= 0)
                            acc[L::dz1][t][i] = __fadd_rn(
                                acc[L::dz1][t][i], __fmul_rn(a, wr[9 + k][i]));
                        if constexpr (L::dz2 >= 0)
                            acc[L::dz2][t][i] = __fadd_rn(
                                acc[L::dz2][t][i], __fmul_rn(a, wr[18 + k][i]));
                    }
            }
        }
        if constexpr (L::dz2 >= 0) {
            const int gy = y0 + ty;
            if (o >= 0 && ch_ok && gy < oh) {  // output plane z0 + o is done
                T* out = yb + (z0 + o) * osd + gy * osh + ch;
#pragma unroll
                for (int t = 0; t < RW; ++t) {
                    const int gx = x0 + run * RW + t;
                    if (gx < ow) store4(out + (long long)gx * c, acc[L::dz2][t]);
                }
            }
        }
    };

#pragma unroll
    for (int p = 0; p < ST - 1; ++p) issue(p);
    if constexpr (S == 1) {
        // plane p starts output p and completes output p - 2
        for (int p = 0; p < np; p += 3) {
            plane(p, p - 2, Slots<0, 2, 1>());
            if (p + 1 < np) plane(p + 1, p - 1, Slots<1, 0, 2>());
            if (p + 2 < np) plane(p + 2, p, Slots<2, 1, 0>());
        }
    } else {
        // plane 2k starts output k and completes output k - 1; plane 2k + 1
        // adds output k's dz = 1 products
        for (int p = 0; p < np; p += 4) {
            plane(p, p / 2 - 1, Slots<0, -1, 1>());
            if (p + 1 < np) plane(p + 1, -1, Slots<-1, 0, -1>());
            if (p + 2 < np) plane(p + 2, p / 2, Slots<1, -1, 0>());
            if (p + 3 < np) plane(p + 3, -1, Slots<-1, 1, -1>());
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int CS, int TH, int TW, int RW, int ST, int S, int MINB>
static int launch_tiled(const T* x, const T* w, T* y, int b, int d, int h,
                        int wd, int c, cudaStream_t s) {
    using G = Tile<T, CS, TH, TW, RW, ST, S>;
    auto kern = depthwise_tiled<T, CS, TH, TW, RW, ST, S, MINB>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int od = out_len(d, S), oh = out_len(h, S), ow = out_len(wd, S);
    const long long tiles =
        (long long)((oh + TH - 1) / TH) * ((ow + TW - 1) / TW);
    const long long slices = (c + CS - 1) / CS;
    // split D into runs until there are DW_TARGET_BLOCKS blocks
    const long long per_run = tiles * slices * b;
    long long nz = (DW_TARGET_BLOCKS + per_run - 1) / per_run;
    if (nz > od) nz = od;
    if (nz < 1) nz = 1;
    const int zlen = (int)((od + nz - 1) / nz);
    nz = (od + zlen - 1) / zlen;
    if (tiles > 0x7fffffffLL || slices > 65535 || b * nz > 65535)
        return (int)cudaErrorInvalidValue;
    kern<<<dim3((unsigned)tiles, (unsigned)slices, (unsigned)(b * nz)), G::NT,
           G::SMEM, s>>>(x, w, y, d, h, wd, c, zlen);
    return (int)cudaGetLastError();
}

template <typename T, int S>
static int launch_simple(const T* x, const T* w, T* y, int b, int d, int h,
                         int wd, int c, cudaStream_t s) {
    const long long nrun = (out_len(wd, S) + DW_TW - 1) / DW_TW;
    const long long total = (long long)b * out_len(d, S) * out_len(h, S) *
                            nrun * c;
    const long long blocks = (total + DW_THREADS - 1) / DW_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    depthwise_simple<T, S><<<(unsigned)blocks, DW_THREADS, 0, s>>>(
        x, w, y, d, h, wd, c, total);
    return (int)cudaGetLastError();
}

// ---- the weight gradient (the backward's wgrad) ---------------------------
//
// dw[dz, dy, dx, c] = sum over (b, z, y, x) of
//     x[b, s z + dz - 1, s y + dy - 1, s x + dx - 1, c] * g[b, z, y, x, c]
// for x (B, D, H, W, C) and the output gradient g (B, ceil(D / s),
// ceil(H / s), ceil(W / s), C) float32, with taps outside the volume read
// as zero: the training step's gradient of K6's taps at stride s. It
// replaces no TPU kernel: the JAX package trains these layers with XLA's
// grouped convolution and has no Pallas backward (ops/pallas/depthwise.py:
// 1-26); the result is held against XLA's gradient in the CPU tests and
// against the float64 plain version on the card.
//
// What bounds it: every voxel of x and of g is read at least once, 8 bytes a
// voxel and channel at stride 1, and each takes 27 multiply-adds (54
// operations): 6.75 operations a byte, under the float32 ridge of 20, so
// device memory bounds it: 2 x 4 x B D H W C bytes over 3.35 TB/s, 1.6 ms at
// (32, 48^3, 192). The 27 FMAs of a voxel and channel at the card's 33.4e12
// FMA/s take 0.55 ms there, a third of it: the products must stay out of
// the way of the stream, and so must the shared-memory reads that feed them.
// At stride 2, g is an eighth of x and the products are an eighth: x's bytes
// alone bound it.
//
// Design (the tiled kernel, channel rows of 16-byte multiples). As K6's
// forward: a block owns a TH x TW tile of g's (H, W) and a slice of 32
// channels and marches along D over a run of g's planes, input plane by
// input plane; each input plane of the tile with its halo and each g plane
// of the tile come from device memory once, by 16-byte cp.async copies
// into rings of shared-memory stages (ST input stages; g plane k lives
// from input plane s k to s k + 2, so its ring has ceil((ST + 2) / s)
// stages). A thread owns 4 channels of a run of RW outputs along W and the
// 27 x 4 sums of its channels in registers. At input plane p it holds the
// RW g values of each output plane that takes p (three at stride 1: dz = 0,
// 1, 2; at stride 2 two on even planes, one on odd), reads each of the
// plane's three rows of its run once (S (RW - 1) + 3 inputs) and does
// every product that input takes part in: 27 RW FMAs a plane per channel
// from 3 (S (RW - 1) + 3) + 3 RW 16-byte shared-memory reads (30 at
// stride 1, RW = 4), where a thread that read its 9 input rows afresh for
// each output plane would need 58. Out-of-range outputs read g as zero.
//
// Reduction, deterministic: the 4 lanes of a warp that share channels add
// by two XOR shuffles (each lane adds the same two values), the warps' sums
// go through shared memory and are added in warp order, and the block
// writes its 27 x 32 partials to the workspace, row (D run, b, tile). Pass
// 2: a block of 32 x 8 threads a 32 (tap, channel) pairs; each of the 8
// thread rows adds every eighth partial in order, then the 8 sums in order.
// No float atomics: the result is the same from run to run. A term passes
// through at most zlen x RW + 2 + warps + ceil(n_parts / 8) + 8 roundings
// (`depth` of fseg_depthwise_wgrad_plan), which bounds the error:
// gamma_depth x sum |x g| of the exact sum.
//
// Channel rows that are not 16-byte multiples take the simple kernel: a
// block owns 32 channels (one a thread, so a warp reads 128 contiguous
// bytes of a voxel) and a run of `rows_per_block` rows (b, z, y) of g,
// which its 8 thread rows take in turn; a thread keeps its channel's 27
// sums in registers and marches along W with a three-column window of the
// 9 input rows its output row reads, straight from device memory. The
// block sums its 8 thread rows in a fixed order through shared memory.
#define WG_CS 32      // channels a block, both kernels
#define WG_ROWS 8     // the simple kernel: thread rows
#define WG_RED_Y 8    // pass 2: thread rows
#define WG_TARGET_BLOCKS 1056  // pass 1: split until this many (8 an SM)
// the tiled kernel's launch (TH, TW, RW, ST, S) by stride: 8 x 16 tiles,
// runs of 4 at stride 1; 8 x 8 tiles, runs of 2 at stride 2; 3 input stages
// (256 threads each)
#define WG_TILE_S1 8, 16, 4, 3, 1
#define WG_TILE_S2 8, 8, 2, 3, 2

template <int M>
struct Mask {  // the dz (bits) whose products an input plane holds
    static constexpr int value = M;
};

template <int TH, int TW, int RW, int ST, int S>
struct WTile {
    static constexpr int th = TH, tw = TW, rw = RW;
    static constexpr int CG = WG_CS / 4;            // threads along C
    static constexpr int NT = CG * (TW / RW) * TH;  // threads a block
    static constexpr int NW = NT / 32;              // warps a block
    static constexpr int XH = S * (TH - 1) + 3, XW = S * (TW - 1) + 3;
    static constexpr int NV = S * (RW - 1) + 3;     // inputs a run reads a row
    static constexpr int XPLANE = XH * XW * WG_CS;  // floats an input stage
    static constexpr int GPLANE = TH * TW * WG_CS;  // floats a g stage
    // g plane k is first read at input plane S k and last at S k + 2, and
    // is copied at step S k - ST + 1: its stage is free again when
    // S GST >= ST + 2
    static constexpr int GST = (ST + 2 + S - 1) / S;
    static constexpr int SMEM = (ST * XPLANE + GST * GPLANE) * 4;
    static constexpr int RED = NW * 27 * WG_CS * 4; // the block's reduction
    // the shuffles add the lanes cg, cg + 8, cg + 16, cg + 24
    static_assert(CG == 8 && NT % 32 == 0 && TW % RW == 0, "wgrad tile");
    static_assert(RED <= SMEM, "wgrad reduction");
    static_assert(S == 1 || S == 2, "stride");
};

template <int TH, int TW, int RW, int ST, int S>
__global__ void __launch_bounds__((WTile<TH, TW, RW, ST, S>::NT), 1)
depthwise_wgrad_tiled(const float* __restrict__ x,
                      const float* __restrict__ g, float* __restrict__ part,
                      int d, int h, int wd, int c, int zlen) {
    using G = WTile<TH, TW, RW, ST, S>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* xs = reinterpret_cast<float*>(smem_raw);
    float* gs = xs + ST * G::XPLANE;

    const int od = out_len(d, S), oh = out_len(h, S), ow = out_len(wd, S);
    const int tiles_w = (ow + TW - 1) / TW;
    const int y0 = (blockIdx.x / tiles_w) * TH;  // the g tile's origin
    const int x0 = (blockIdx.x % tiles_w) * TW;
    const int c0 = blockIdx.y * WG_CS;
    const int nz = (od + zlen - 1) / zlen;
    const int bb = blockIdx.z / nz;
    const int z0 = (blockIdx.z % nz) * zlen;
    const int n = (z0 + zlen < od ? z0 + zlen : od) - z0;  // g planes
    const int tid = threadIdx.x;
    const int cg = tid % G::CG;
    const int run = (tid / G::CG) % (TW / RW);
    const int ty = tid / (G::CG * (TW / RW));

    const long long sh = (long long)wd * c, sd = (long long)h * sh;
    const long long osh = (long long)ow * c, osd = (long long)oh * osh;
    const float* xb = x + (long long)bb * d * sd;
    const float* gb = g + (long long)bb * od * osd;
    // the input tile's origin; input planes iz0 .. iz0 + np - 1
    const int iy0 = S * y0 - 1, ix0 = S * x0 - 1, iz0 = S * z0 - 1;
    const int np = S * (n - 1) + 3;
    constexpr int CPP = WG_CS / 4;   // 16-byte copies a pixel

    // step p's copies, one group: input plane p (z = iz0 + p) into input
    // stage p % ST and, where it is g plane k's first (p = S k), g plane k
    // into g stage k % GST; zero fills outside the volume
    auto issue = [&](int p) {
        if (p < np) {
            const int z = iz0 + p;
            const bool zin = z >= 0 && z < d;
            float* dst = xs + (p % ST) * G::XPLANE;
            for (int k = tid; k < G::XH * G::XW * CPP; k += G::NT) {
                const int q = k % CPP, pix = k / CPP;
                const int yy = iy0 + pix / G::XW, xx = ix0 + pix % G::XW;
                const int gc = c0 + 4 * q;
                const bool ok = zin && yy >= 0 && yy < h && xx >= 0 &&
                                xx < wd && gc < c;
                const float* src =
                    ok ? xb + z * sd + yy * sh + (long long)xx * c + gc : x;
                cp_async16(dst + pix * WG_CS + 4 * q, src, ok ? 16 : 0);
            }
            if (p % S == 0 && p / S < n) {
                const int k0 = p / S;
                float* gd = gs + (k0 % G::GST) * G::GPLANE;
                for (int k = tid; k < TH * TW * CPP; k += G::NT) {
                    const int q = k % CPP, pix = k / CPP;
                    const int yy = y0 + pix / TW, xx = x0 + pix % TW;
                    const int gc = c0 + 4 * q;
                    const bool ok = yy < oh && xx < ow && gc < c;
                    const float* src = ok ? gb + (z0 + k0) * osd + yy * osh +
                                                (long long)xx * c + gc
                                          : g;
                    cp_async16(gd + pix * WG_CS + 4 * q, src, ok ? 16 : 0);
                }
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    float acc[27][4];
#pragma unroll
    for (int k = 0; k < 27; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[k][i] = 0.0f;

    // input plane p; M: the dz whose products it holds (bits)
    auto step = [&](int p, auto mask) {
        constexpr int M = decltype(mask)::value;
        asm volatile("cp.async.wait_group %0;\n" :: "n"(ST - 2) : "memory");
        __syncthreads();     // step p's copies landed; the freed stages idle
        issue(p + ST - 1);
        const float* xp = xs + (p % ST) * G::XPLANE;
        float gv[3][RW][4];  // g of the output plane taking p with each dz
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
            if (!((M >> dz) & 1)) continue;
            const int k = (p - dz) / S;   // (p - dz) % S == 0 by M
            const bool kin = p - dz >= 0 && k < n;
            const float* gp = gs + (kin ? k % G::GST : 0) * G::GPLANE +
                              (ty * TW + run * RW) * WG_CS + 4 * cg;
#pragma unroll
            for (int t = 0; t < RW; ++t) {
                if (kin) {
                    load4(gp + t * WG_CS, gv[dz][t]);
                } else {
#pragma unroll
                    for (int i = 0; i < 4; ++i) gv[dz][t][i] = 0.0f;
                }
            }
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
            float v[G::NV][4];
#pragma unroll
            for (int j = 0; j < G::NV; ++j)
                load4(xp + ((S * ty + dy) * G::XW + S * run * RW + j) * WG_CS +
                          4 * cg, v[j]);
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
                if (!((M >> dz) & 1)) continue;
#pragma unroll
                for (int dx = 0; dx < 3; ++dx)
#pragma unroll
                    for (int t = 0; t < RW; ++t)
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            float& a = acc[(dz * 3 + dy) * 3 + dx][i];
                            a = __fmaf_rn(v[S * t + dx][i], gv[dz][t][i], a);
                        }
            }
        }
    };

#pragma unroll
    for (int p = 0; p < ST - 1; ++p) issue(p);
    if constexpr (S == 1) {
        for (int p = 0; p < np; ++p) step(p, Mask<7>());
    } else {
        // even planes: dz = 0 of g plane p / 2 and dz = 2 of p / 2 - 1;
        // odd planes: dz = 1 of (p - 1) / 2
        for (int p = 0; p < np; p += 2) {
            step(p, Mask<5>());
            if (p + 1 < np) step(p + 1, Mask<2>());
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();         // every stage read; the space holds the sums

    const int lane = tid % 32, warp = tid / 32;
    float* red = xs;         // [NW][27][WG_CS]
#pragma unroll
    for (int k = 0; k < 27; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float v = acc[k][i];
            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
            if (lane < G::CG) red[(warp * 27 + k) * WG_CS + 4 * cg + i] = v;
        }
    __syncthreads();
    const long long row = (long long)blockIdx.z * gridDim.x + blockIdx.x;
    for (int o = tid; o < 27 * WG_CS; o += G::NT) {
        const int k = o / WG_CS, l = o % WG_CS;
        float s = red[k * WG_CS + l];
        for (int wi = 1; wi < G::NW; ++wi)
            s = __fadd_rn(s, red[(wi * 27 + k) * WG_CS + l]);
        if (c0 + l < c) part[(row * 27 + k) * c + c0 + l] = s;
    }
}

template <int TH, int TW, int RW, int ST, int S>
static int launch_wgrad_tiled(const float* x, const float* g, float* part,
                              int b, int d, int h, int wd, int c, int zlen,
                              int n_parts, cudaStream_t s) {
    using G = WTile<TH, TW, RW, ST, S>;
    auto kern = depthwise_wgrad_tiled<TH, TW, RW, ST, S>;
    const int od = out_len(d, S), oh = out_len(h, S), ow = out_len(wd, S);
    const long long tiles =
        (long long)((oh + TH - 1) / TH) * ((ow + TW - 1) / TW);
    const long long slices = (c + WG_CS - 1) / WG_CS;
    const long long nz = (od + zlen - 1) / zlen;
    if (tiles * b * nz != n_parts || tiles > 0x7fffffffLL ||
        slices > 65535 || b * nz > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3((unsigned)tiles, (unsigned)slices, (unsigned)(b * nz)), G::NT,
           G::SMEM, s>>>(x, g, part, d, h, wd, c, zlen);
    return (int)cudaGetLastError();
}

template <int S>
__global__ void __launch_bounds__(WG_CS * WG_ROWS)
depthwise_wgrad_simple(const float* __restrict__ x,
                       const float* __restrict__ g,
                       float* __restrict__ part, int d, int h, int wd, int c,
                       long long rows, long long rows_per_block) {
    __shared__ float red[27][WG_ROWS][WG_CS];
    const int od = out_len(d, S), oh = out_len(h, S), ow = out_len(wd, S);
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int ch = blockIdx.x * WG_CS + tx;
    const long long r0 = (long long)blockIdx.y * rows_per_block;
    const long long r1 =
        r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
    const long long sw = c, sh = (long long)wd * c, sd = (long long)h * sh;
    const long long osh = (long long)ow * c, osd = (long long)oh * osh;

    float acc[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) acc[k] = 0.0f;
    if (ch < c) {
        for (long long r = r0 + ty; r < r1; r += WG_ROWS) {
            const int yy = (int)(r % oh);
            const long long bz = r / oh;          // b * od + z
            const int zz = (int)(bz % od);
            const long long b = bz / od;
            const float* grow = g + bz * osd + (long long)yy * osh + ch;
            const float* xrow[9];
            bool rin[9];
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                const int z = S * zz + k / 3 - 1, y = S * yy + k % 3 - 1;
                rin[k] = z >= 0 && z < d && y >= 0 && y < h;
                xrow[k] = x + (rin[k] ? (b * d + z) * sd + (long long)y * sh +
                                            ch
                                      : 0);
            }
            // win[k][j]: input row k at column S xx - 1 + j
            float win[9][3];
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                win[k][0] = 0.0f;
                if (S == 1) win[k][1] = rin[k] ? __ldg(xrow[k]) : 0.0f;
            }
            for (int xx = 0; xx < ow; ++xx) {
                const int xr = S * xx + 1;        // the window's right column
                const bool right = xr < wd;
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    if (S == 2)  // column 2 xx < wd: xx < ceil(wd / 2)
                        win[k][1] = rin[k] ? __ldg(xrow[k] + (xr - 1) * sw)
                                           : 0.0f;
                    win[k][2] = rin[k] && right ? __ldg(xrow[k] + xr * sw)
                                                : 0.0f;
                }
                const float gv = __ldg(grow + xx * sw);
#pragma unroll
                for (int k = 0; k < 9; ++k)
#pragma unroll
                    for (int j = 0; j < 3; ++j)
                        acc[3 * k + j] = __fmaf_rn(win[k][j], gv, acc[3 * k + j]);
#pragma unroll
                for (int k = 0; k < 9; ++k) {
                    win[k][0] = win[k][S == 1 ? 1 : 2];
                    win[k][1] = win[k][2];
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 27; ++k) red[k][ty][tx] = acc[k];
    __syncthreads();
    for (int o = ty * WG_CS + tx; o < 27 * WG_CS; o += WG_CS * WG_ROWS) {
        const int k = o / WG_CS, lane = o % WG_CS;
        const int gc = blockIdx.x * WG_CS + lane;
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < WG_ROWS; ++t) s = __fadd_rn(s, red[k][t][lane]);
        if (gc < c) part[((long long)blockIdx.y * 27 + k) * c + gc] = s;
    }
}

// pass 2: dw[i] = the partials' sum, i = tap * c + channel; thread row ty
// adds partials ty, ty + 8, ... in order, then row 0 adds the 8 sums in order
__global__ void __launch_bounds__(32 * WG_RED_Y)
depthwise_wgrad_reduce(const float* __restrict__ part, float* __restrict__ dw,
                       int n, int n_parts) {
    __shared__ float sums[WG_RED_Y][32];
    const int i = blockIdx.x * 32 + threadIdx.x;
    float s = 0.0f;
    if (i < n)
        for (int p = threadIdx.y; p < n_parts; p += WG_RED_Y)
            s = __fadd_rn(s, part[(long long)p * n + i]);
    sums[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0 && i < n) {
        float t = 0.0f;
#pragma unroll
        for (int r = 0; r < WG_RED_Y; ++r) t = __fadd_rn(t, sums[r][threadIdx.x]);
        dw[i] = t;
    }
}

// the tiled kernel's plan for G: a D run of zlen g planes, split until
// WG_TARGET_BLOCKS blocks fill the card
template <class G>
static void tiled_plan(int b, int od, int oh, int ow, int c, long long* out) {
    const long long tiles =
        (long long)((oh + G::th - 1) / G::th) * ((ow + G::tw - 1) / G::tw);
    const long long per_run = tiles * ((c + WG_CS - 1) / WG_CS) * b;
    long long nz = (WG_TARGET_BLOCKS + per_run - 1) / per_run;
    nz = nz < 1 ? 1 : nz > od ? od : nz;
    const long long zlen = (od + nz - 1) / nz;
    const long long n_parts = tiles * b * ((od + zlen - 1) / zlen);
    out[0] = 1;
    out[1] = zlen;
    out[2] = n_parts;
    out[3] = zlen * G::rw + 2 + G::NW + (n_parts + WG_RED_Y - 1) / WG_RED_Y +
             WG_RED_Y;
}

// The wgrad's launch for x (b, d, h, wd, c) at `stride`, 16-byte aligned x
// and g or not (`aligned`): out[0] the tiled kernel (1) or the simple one
// (0), out[1] `run` (g planes a D run, or g rows (b, z, y) a block), out[2]
// n_parts (rows of the partial workspace), out[3] depth (the roundings a
// term passes through at most: a thread's chain of FMAs, the block's
// reduction and pass 2). The tiled kernel where the channel rows are
// 16-byte multiples and x and g aligned, else the simple kernel over runs
// of g's rows. Returns 0, or cudaErrorInvalidValue for a bad shape.
extern "C" int fseg_depthwise_wgrad_plan(int b, int d, int h, int wd, int c,
                                         int stride, int aligned,
                                         long long* out) {
    if (b < 1 || d < 1 || h < 1 || wd < 1 || c < 1 ||
        (stride != 1 && stride != 2))
        return (int)cudaErrorInvalidValue;
    const int od = out_len(d, stride), oh = out_len(h, stride),
              ow = out_len(wd, stride);
    if (aligned && c % 4 == 0) {
        if (stride == 1)
            tiled_plan<WTile<WG_TILE_S1>>(b, od, oh, ow, c, out);
        else
            tiled_plan<WTile<WG_TILE_S2>>(b, od, oh, ow, c, out);
        return 0;
    }
    const long long rows = (long long)b * od * oh;
    const long long slices = (c + WG_CS - 1) / WG_CS;
    long long want = (WG_TARGET_BLOCKS + slices - 1) / slices;
    want = want < 1 ? 1 : want;
    long long per_block = (rows + want - 1) / want;
    per_block = (per_block + WG_ROWS - 1) / WG_ROWS * WG_ROWS;
    const long long n_parts = (rows + per_block - 1) / per_block;
    out[0] = 0;
    out[1] = per_block;
    out[2] = n_parts;
    out[3] = per_block / WG_ROWS * ow + WG_ROWS +
             (n_parts + WG_RED_Y - 1) / WG_RED_Y + WG_RED_Y;
    return 0;
}

// x: (b, d, h, wd, c), g: (b, ceil(d / stride), ceil(h / stride),
// ceil(wd / stride), c), both float32; dw: (27, c) float32; part: a workspace
// of n_parts x 27 x c floats, n_parts that of fseg_depthwise_wgrad_plan
// (for x and g's alignment). Launches the two passes on `stream` as that
// plan says, does not synchronise; returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int fseg_depthwise_wgrad(const void* x, const void* g, void* dw,
                                    void* part, int b, int d, int h, int wd,
                                    int c, int stride, long long n_parts,
                                    void* stream) {
    long long plan[4];
    const int aligned = ((uintptr_t)x | (uintptr_t)g) % 16 == 0;
    int err = fseg_depthwise_wgrad_plan(b, d, h, wd, c, stride, aligned, plan);
    if (err != 0) return err;
    if (plan[2] != n_parts || n_parts > 0x7fffffffLL ||
        plan[1] > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const float *xf = (const float*)x, *gf = (const float*)g;
    const int run = (int)plan[1];
    if (plan[0]) {
        err = stride == 1
                  ? launch_wgrad_tiled<WG_TILE_S1>(xf, gf, (float*)part, b, d,
                                                   h, wd, c, run, (int)n_parts,
                                                   s)
                  : launch_wgrad_tiled<WG_TILE_S2>(xf, gf, (float*)part, b, d,
                                                   h, wd, c, run, (int)n_parts,
                                                   s);
    } else {
        const long long rows =
            (long long)b * out_len(d, stride) * out_len(h, stride);
        if (n_parts > 65535) return (int)cudaErrorInvalidValue;
        const dim3 grid((unsigned)((c + WG_CS - 1) / WG_CS),
                        (unsigned)n_parts);
        if (stride == 1)
            depthwise_wgrad_simple<1><<<grid, dim3(WG_CS, WG_ROWS), 0, s>>>(
                xf, gf, (float*)part, d, h, wd, c, rows, run);
        else
            depthwise_wgrad_simple<2><<<grid, dim3(WG_CS, WG_ROWS), 0, s>>>(
                xf, gf, (float*)part, d, h, wd, c, rows, run);
        err = (int)cudaGetLastError();
    }
    if (err != 0) return err;
    const int n = 27 * c;
    depthwise_wgrad_reduce<<<(n + 31) / 32, dim3(32, WG_RED_Y), 0, s>>>(
        (const float*)part, (float*)dw, n, (int)n_parts);
    return (int)cudaGetLastError();
}

// x: (b, d, h, wd, c), y: (b, ceil(d / stride), ceil(h / stride),
// ceil(wd / stride), c), w: (3, 3, 3, c), contiguous device memory of one
// dtype (0: float32, 1: bfloat16), stride 1 or 2; launches on `stream`, does
// not synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int fseg_depthwise_conv3(const void* x, const void* w, void* y,
                                    int b, int d, int h, int wd, int c,
                                    int stride, int dtype, void* stream) {
    if (b < 1 || d < 1 || h < 1 || wd < 1 || c < 1 || dtype < 0 ||
        dtype > 1 || (stride != 1 && stride != 2))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int elem = dtype == 0 ? 4 : 2;
    const bool aligned =
        ((uintptr_t)x | (uintptr_t)y) % 16 == 0 && (c * elem) % 16 == 0;
    const float *xf = (const float*)x, *wf = (const float*)w;
    const __nv_bfloat16 *xh = (const __nv_bfloat16*)x,
                        *wh = (const __nv_bfloat16*)w;
    // stride 1: one launch shape for every tiled case, from the sweep
    // (PERF.md): 32-channel slices (C = 144 runs 4.5 of them; 16-channel
    // slices were slower there), 8 x 16 tiles, runs of 4 along W, 3 stages.
    // stride 2: 4 x 8 output tiles, runs of 2, 3 stages, 2 blocks an SM
    if (aligned && stride == 1)
        return dtype == 0
                   ? launch_tiled<float, 32, 8, 16, 4, 3, 1, 1>(
                         xf, wf, (float*)y, b, d, h, wd, c, s)
                   : launch_tiled<__nv_bfloat16, 32, 8, 16, 4, 3, 1, 1>(
                         xh, wh, (__nv_bfloat16*)y, b, d, h, wd, c, s);
    if (aligned)
        return dtype == 0
                   ? launch_tiled<float, 32, 4, 8, 2, 3, 2, 2>(
                         xf, wf, (float*)y, b, d, h, wd, c, s)
                   : launch_tiled<__nv_bfloat16, 32, 4, 8, 2, 3, 2, 2>(
                         xh, wh, (__nv_bfloat16*)y, b, d, h, wd, c, s);
    if (stride == 1)
        return dtype == 0
                   ? launch_simple<float, 1>(xf, wf, (float*)y, b, d, h, wd,
                                             c, s)
                   : launch_simple<__nv_bfloat16, 1>(
                         xh, wh, (__nv_bfloat16*)y, b, d, h, wd, c, s);
    return dtype == 0
               ? launch_simple<float, 2>(xf, wf, (float*)y, b, d, h, wd, c, s)
               : launch_simple<__nv_bfloat16, 2>(xh, wh, (__nv_bfloat16*)y, b,
                                                 d, h, wd, c, s);
}
