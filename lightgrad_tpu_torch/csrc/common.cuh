// Shared helpers of the port's kernels: f32/bf16 (and int8) loads and stores
// that widen to f32, warp reductions, and the masked-score constant.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Masked score: finite so that exp(NEG - NEG) stays 1 and never NaN.
#define LG_NEG (-1e30f)

__device__ __forceinline__ float lg_to_f(float x) { return x; }
__device__ __forceinline__ float lg_to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T lg_from_f(float x);
template <> __device__ __forceinline__ float lg_from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 lg_from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements (16-byte aligned for f32, 8-byte for bf16).
__device__ __forceinline__ float4 lg_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lg_load4(const __nv_bfloat16* p) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&u.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&u.y);
  float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

// Two consecutive elements (8-byte aligned for f32, 4-byte for bf16, 2-byte
// for int8).
__device__ __forceinline__ float2 lg_load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 lg_load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 lg_load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

// Read-only (non-coherent cache) load of data no launch in flight writes.
__device__ __forceinline__ float lg_ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float lg_ldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float lg_ldg(const int8_t* p) {
  return (float)__ldg(reinterpret_cast<const signed char*>(p));
}

__device__ __forceinline__ void lg_store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void lg_store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// 16 bytes global -> shared (a shared-window address), asynchronously;
// `bytes` 0 writes zeros and reads nothing.  Completion: lg_cp_async_commit
// closes a group, lg_cp_async_wait<N> waits until at most N are in flight.
__device__ __forceinline__ void lg_cp_async16(uint32_t dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared (through L1); `bytes` 0 writes a zero word.
__device__ __forceinline__ void lg_cp_async4(uint32_t dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void lg_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void lg_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint32_t lg_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float lg_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lg_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Widen rows [r0, r0 + R) of a (S, d) slab into shared f32 rows of D
// columns; rows past S and columns past d are zero.  With NT threads a
// multiple of D / 4, a thread keeps one column word, so its column test
// and row stride are set once, not per element.
template <typename T, int D, int R, int NT>
__device__ __forceinline__ void lg_stage(float4 (*dst)[D / 4], const T* src,
                                         int r0, int S, int d) {
  constexpr int D4 = D / 4, kStep = NT / D4;
  static_assert(NT % D4 == 0 && R % kStep == 0, "uneven tile staging");
  const int c4 = threadIdx.x % D4, r1 = threadIdx.x / D4;
  const bool col = c4 * 4 < d;
  const T* p = src + (size_t)(r0 + r1) * d + c4 * 4;
#pragma unroll
  for (int i = 0; i < R / kStep; ++i) {
    const int r = r1 + i * kStep;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col && r0 + r < S) val = lg_load4(p + (size_t)i * kStep * d);
    dst[r][c4] = val;
  }
}
