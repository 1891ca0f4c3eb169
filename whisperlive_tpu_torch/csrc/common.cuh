// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel file exposes one extern "C" launcher that takes raw device
// pointers, sizes and the caller's CUDA stream, launches without
// synchronising, and returns cudaGetLastError() so the Python wrapper
// (whisperlive_tpu_torch/ops/_kernels.py) can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace wl {

// The TPU kernels mask with float32's most negative finite value, not -inf
// (whisperlive_tpu/ops/attention.py NEG_INF): a row whose every position
// is masked then gives a uniform softmax instead of NaN.
constexpr float kNegInf = -FLT_MAX;

// 16 signed int8 values packed in one 16-byte load -> 16 floats.
__device__ __forceinline__ void unpack_i8x16(const uint4& w, float f[16]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            f[i * 4 + j] = static_cast<float>(
                static_cast<int8_t>((words[i] >> (8 * j)) & 0xffu));
        }
    }
}

// 8 bf16 values packed in one 16-byte load -> 8 floats.
__device__ __forceinline__ void unpack_bf16x8(const uint4& a, float f[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(h[i]);
        f[2 * i] = v.x;
        f[2 * i + 1] = v.y;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// Block-wide reductions over blockDim.x threads (a multiple of 32). `buf`
// is shared scratch of at least 32 floats; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* buf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_max(v);
    __syncthreads();  // buf may still be read by a previous reduction
    if (lane == 0) buf[warp] = v;
    __syncthreads();
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? buf[lane] : -FLT_MAX;
    return warp_max(v);
}

__device__ __forceinline__ float block_sum(float v, float* buf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_sum(v);
    __syncthreads();
    if (lane == 0) buf[warp] = v;
    __syncthreads();
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? buf[lane] : 0.0f;
    return warp_sum(v);
}

}  // namespace wl
