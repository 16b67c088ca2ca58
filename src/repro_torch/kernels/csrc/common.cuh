// Element conversions shared by the attention kernels: loads to f32,
// stores from f32, and the int8-pool load that dequantizes after the load
// (x * kv_scale, rounded to the query's dtype T, as the TPU kernels do in
// VMEM), so device-memory traffic stays at one byte per element.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, bool QUANT>
__device__ __forceinline__ float load_kv(const void* pool, long long i,
                                         float kv_scale) {
    if (QUANT) {
        const float x = (float)static_cast<const int8_t*>(pool)[i] * kv_scale;
        return round_to(x, static_cast<const T*>(nullptr));
    }
    return to_f(static_cast<const T*>(pool)[i]);
}
