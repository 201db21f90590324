// Helpers shared by the port's CUDA sources.
//
// Every source is built on its own by nvcc into a shared library with a plain
// C interface (see mlagg_unet_torch/ops/_ext.py). Each exported launcher
// returns the value of cudaGetLastError() right after its launch, so that the
// Python wrapper can raise on a launch the card refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed by the wrappers
#define MLAGG_F32 0
#define MLAGG_BF16 1

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

extern "C" const char* mlagg_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
