// Vector loads shared by kernels A, B and C: VEC consecutive channels of one
// pixel or token, read through the read-only cache into f32 registers. f32
// takes 4, 2 or 1 channels (16, 8, 4 bytes); bf16 takes 8, 4, 2 or 1 (16, 8,
// 4, 2 bytes), converted exactly. The caller picks VEC from the channel count
// and the pointer's alignment.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float (&r)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      r[2 * k] = f.x, r[2 * k + 1] = f.y;
    }
  } else if constexpr (VEC == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      r[2 * k] = f.x, r[2 * k + 1] = f.y;
    }
  } else if constexpr (VEC == 2) {
    const float2 f = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    r[0] = f.x, r[1] = f.y;
  } else {
    r[0] = __bfloat162float(__ldg(p));
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = x.x, r[1] = x.y;
  } else {
    r[0] = __ldg(p);
  }
}

}  // namespace
