// Device helpers shared by the trilinear-warp kernels (warp_fwd.cu,
// warp_bwd.cu, warp_grid.cu).  kernels.py hashes this header with each
// source, so an edit here rebuilds every library that includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace facevae_warp {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16(v); }

// CPT channels of type T, loaded and stored as one vector (16 bytes at most)
template <typename T, int CPT>
struct alignas(sizeof(T) * CPT) Pack {
  T v[CPT];
};

// dst[0:CPT] += v[0:CPT] with the widest vector atomics the alignment allows
// (dst is CPT-float aligned: the callers' offsets are multiples of CPT).
template <int CPT>
__device__ __forceinline__ void atomic_add_vec(float* dst, const float* v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  if constexpr (CPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CPT; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + i), make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
    return;
  } else if constexpr (CPT % 2 == 0) {
#pragma unroll
    for (int i = 0; i < CPT; i += 2)
      atomicAdd(reinterpret_cast<float2*>(dst + i), make_float2(v[i], v[i + 1]));
    return;
  }
#endif
#pragma unroll
  for (int i = 0; i < CPT; ++i) atomicAdd(dst + i, v[i]);
}

struct Axis {
  float f, t;  // floor(g), g - floor(g)
};

__device__ __forceinline__ Axis axis(float g) {
  const float f = floorf(g);
  return {f, g - f};
}

// corner j = f + d lies in [0, size-1]; written as !(...) by the callers so
// that NaN and +-inf coordinates fail it
__device__ __forceinline__ bool inside(float j, int size) {
  return j >= 0.f && j <= (float)(size - 1);
}

// Calls f(static_cast<T*>(nullptr), std::integral_constant<int, CPT>{}) for
// dtype 0 = fp32 / 1 = bf16 and the channels per vector cpt; returns the
// cudaError_t of the launch f makes, or cudaErrorInvalidValue for a pair no
// kernel is built for.
template <typename F>
int dispatch(int dtype, int cpt, F&& f) {
  using std::integral_constant;
  if (dtype == 0) {
    float* t = nullptr;
    switch (cpt) {
      case 4: f(t, integral_constant<int, 4>{}); break;
      case 2: f(t, integral_constant<int, 2>{}); break;
      case 1: f(t, integral_constant<int, 1>{}); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == 1) {
    __nv_bfloat16* t = nullptr;
    switch (cpt) {
      case 8: f(t, integral_constant<int, 8>{}); break;
      case 4: f(t, integral_constant<int, 4>{}); break;
      case 2: f(t, integral_constant<int, 2>{}); break;
      case 1: f(t, integral_constant<int, 1>{}); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace facevae_warp
