// Device helpers shared by the trilinear-warp kernels (warp_fwd.cu,
// warp_bwd.cu, warp_grid.cu, probe_warp.cu).  kernels.py hashes this header
// with each source, so an edit here rebuilds every library that includes it.
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

// Where the dx kernels (warp_bwd.cu, warp_grid.cu) send their scatter-add,
// chosen by fast_warp.py: FloatSink by default, FixedSink when PyTorch's
// deterministic algorithms are on.  A kernel turns each contribution c (one
// channel of w * gout) into a summand with make(c, e), e its element of dx,
// may add summands bound for the same element together, and adds them with
// add<CPT>(e, v) for CPT channels from e.  prepare() runs once per thread.
//
// FloatSink: fp32 atomics (float4 / float2 where the vector allows), so the
// order of the adds, and the last bits of dx, vary from run to run.
struct FloatSink {
  using V = float;
  float* acc;
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ V make(float c, long long) const { return c; }
  template <int CPT>
  __device__ __forceinline__ void add(long long e, const V* v) const {
    atomic_add_vec<CPT>(acc + e, v);
  }
};

// FixedSink: a fixed-point sum in int64.  Each finite contribution is
// rounded once to round(c * 2^s) and added with a 64-bit integer atomic;
// integer addition is associative, so any order of the adds gives the same
// bits.  s (on the device, fast_warp.dx_scale_exponent) keeps count * M * 2^s
// <= 2^62 for M = max |finite gout| and count the samples that can reach one
// element (a sample's corner weights are at most 1), so no sum overflows.  A
// non-finite contribution sets a flag of its element instead (atomicOr, 4
// bits per element, 8 elements per word: 1 NaN, 2 +inf, 4 -inf), which
// fixed_to_float_kernel turns into IEEE's sum of them.
struct FixedSink {
  using V = long long;
  unsigned long long* acc;
  unsigned int* flags;
  const int* scale_exp;
  int s;
  __device__ __forceinline__ void prepare() { s = *scale_exp; }
  __device__ __forceinline__ V make(float c, long long e) const {
    const unsigned b = __float_as_uint(c);
    if ((b & 0x7f800000u) != 0x7f800000u) return __float2ll_rn(ldexpf(c, s));
    const unsigned bit = (b & 0x007fffffu) ? 1u : (b >> 31 ? 4u : 2u);
    atomicOr(flags + (e >> 3), bit << ((e & 7) * 4));
    return 0;
  }
  template <int CPT>
  __device__ __forceinline__ void add(long long e, const V* v) const {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (v[i] != 0) atomicAdd(acc + e + i, (unsigned long long)v[i]);
  }
};

// FixedSink's sums -> fp32, once per element: acc * 2^-s, or NaN / +-inf by
// IEEE's rules from the flags (NaN, or +inf with -inf, gives NaN).
__global__ void __launch_bounds__(kThreads)
fixed_to_float_kernel(const long long* __restrict__ acc, const unsigned int* __restrict__ flags,
                      const int* __restrict__ scale_exp, float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned f = (flags[i >> 3] >> ((i & 7) * 4)) & 7u;
  float r;
  if ((f & 1u) || f == 6u) r = __int_as_float(0x7fc00000);
  else if (f & 2u) r = __int_as_float(0x7f800000);
  else if (f & 4u) r = __int_as_float(0xff800000);
  else r = ldexpf(__ll2float_rn(acc[i]), -*scale_exp);
  out[i] = r;
}

inline int launch_fixed_to_float(const void* acc, const void* flags, const int* scale_exp,
                                 float* out, long long n, cudaStream_t s) {
  fixed_to_float_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const long long*>(acc), static_cast<const unsigned int*>(flags), scale_exp,
      out, n);
  return (int)cudaGetLastError();
}

// Writing a block's output tile out of shared memory in whole sectors (the
// multi-grid forward's tile kernel, warp_fwd.cu, and the banded probe,
// probe_warp.cu).
template <int U>
struct Unit;
template <>
struct Unit<16> {
  using type = uint4;
};
template <>
struct Unit<8> {
  using type = uint2;
};
template <>
struct Unit<4> {
  using type = unsigned;
};
template <>
struct Unit<2> {
  using type = unsigned short;
};

// dst[0 : rows*rowbytes] <- rows of rowbytes bytes, `stride` apart in the
// tile, copied in units of U bytes (U divides rowbytes and stride) by the
// block's NT threads
template <int U, int NT = kThreads>
__device__ __forceinline__ void copy_out(const unsigned char* __restrict__ tile, int stride,
                                         unsigned char* __restrict__ dst, int rowbytes, int rows) {
  using V = typename Unit<U>::type;
  const int per_row = rowbytes / U;
  const int total = rows * per_row;
  for (int j = threadIdx.x; j < total; j += NT) {
    const int r = j / per_row;
    reinterpret_cast<V*>(dst)[j] =
        *reinterpret_cast<const V*>(tile + r * stride + (j - r * per_row) * U);
  }
}

// copy_out with the unit chosen at run time
template <int NT = kThreads>
__device__ __forceinline__ void copy_out(int unit, const unsigned char* tile, int stride,
                                         unsigned char* dst, int rowbytes, int rows) {
  switch (unit) {
    case 16: copy_out<16, NT>(tile, stride, dst, rowbytes, rows); break;
    case 8: copy_out<8, NT>(tile, stride, dst, rowbytes, rows); break;
    case 4: copy_out<4, NT>(tile, stride, dst, rowbytes, rows); break;
    default: copy_out<2, NT>(tile, stride, dst, rowbytes, rows); break;
  }
}

// the widest unit (16, 8, 4, 2 bytes) that divides both
__host__ __device__ inline int copy_unit(long long a, long long b) {
  for (int u = 16; u > 2; u /= 2)
    if (a % u == 0 && b % u == 0) return u;
  return 2;
}

// The tile's row stride in bytes: the row rounded up to whole store vectors,
// plus one vector where that count is even (an odd count of vectors between
// rows puts a phase's stores on distinct banks).
inline int tile_stride(int rowbytes, int vec) {
  int units = (rowbytes + vec - 1) / vec;
  if (units % 2 == 0) ++units;
  return units * vec;
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

// Writes a launch's grid (x, y, z) and its threads a block to out[0..3],
// where out is not null: the wrapper reads back the grid it launched.
inline void record_launch(unsigned* out, dim3 grid, int threads) {
  if (out) {
    out[0] = grid.x;
    out[1] = grid.y;
    out[2] = grid.z;
    out[3] = (unsigned)threads;
  }
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
