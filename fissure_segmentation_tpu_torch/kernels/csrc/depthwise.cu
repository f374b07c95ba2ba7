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
// largest layer (1, 128, 128, 128, 192) in float32.
//
// Design (simple first; fast is later work): one thread per (run of DW_TW
// consecutive voxels along W, channel), the channel the fastest index, so a
// warp reads 32 consecutive channels of one neighbour (128 bytes in float32),
// coalesced. For each (dz, dy) the thread loads the DW_TW + 2 inputs of its
// row segment once and uses each for up to three outputs: 9 (DW_TW + 2) tap
// loads for DW_TW outputs instead of 27 DW_TW. Its channel's 27 weights are
// read once each, shared through L1 by every thread of the channel. The
// remaining re-reads of x by neighbouring threads (the dz and dy taps) are
// served by L1/L2, so device memory sees about one read of x. Not done here:
// z-streaming with an H x W tile and its halo in shared memory, cp.async or
// TMA, vectorised loads. The TPU kernels' z-plane BlockSpec triple and DMA
// ring are TPU memory-management formulations and are not carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DW_THREADS 256
#define DW_TW 4  // outputs along W per thread

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

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
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

// x, y: (b, d, h, wd, c), w: (3, 3, 3, c), contiguous device memory of one
// dtype (0: float32, 1: bfloat16); launches on `stream`, does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int fseg_depthwise_conv3(const void* x, const void* w, void* y,
                                    int b, int d, int h, int wd, int c,
                                    int dtype, void* stream) {
    if (b < 1 || d < 1 || h < 1 || wd < 1 || c < 1 || dtype < 0 || dtype > 1)
        return (int)cudaErrorInvalidValue;
    const long long nrun = (wd + DW_TW - 1) / DW_TW;
    const long long total = (long long)b * d * h * nrun * c;
    const long long blocks = (total + DW_THREADS - 1) / DW_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        depthwise_kernel<float><<<(unsigned)blocks, DW_THREADS, 0, s>>>(
            (const float*)x, (const float*)w, (float*)y, d, h, wd, c, total);
    else
        depthwise_kernel<__nv_bfloat16><<<(unsigned)blocks, DW_THREADS, 0, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
            (__nv_bfloat16*)y, d, h, wd, c, total);
    return (int)cudaGetLastError();
}
