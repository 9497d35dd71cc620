// Single-grid trilinear warp for Hopper (sm_90a), hand-written CUDA C++: the
// forward and its two cotangents, as three kernels.
//
// Replaces the single-grid Pallas kernels of facevae_tpu/ops/pallas/warp_mm.py:
//   warp_mm_fwd_pallas -> _fwd_kernel     -> grid_fwd_kernel below
//   warp_mm_bwd_pallas -> _dgrid_kernel   -> grid_dgrid_kernel below
//                      -> _drows_kernel   -> grid_dx_kernel below
// behind facevae_tpu/ops/fast_warp.py:grid_sample_3d_fast (grid_sample 3D,
// align_corners=True, zeros padding, one normalized grid per output sample).
//
//   x      [N, D, H, W, C]        fp32 or bf16, channel-last, contiguous
//   grid   [G, Do, Ho, Wo, 3]     fp32, normalized to [-1, 1], (x, y, z) last;
//                                 G = N * gps, grid g reads source n = g / gps
//   out    [G, Do, Ho, Wo, C]     x's dtype
//   gout   [G, Do, Ho, Wo, C]     x's dtype
//   dgrid  [G, Do, Ho, Wo, 3]     fp32, normalized units
//   dx     [N, D, H, W, C]        fp32 accumulator, zeroed by the caller
//
// Math, per (g, output voxel v): the pixel coordinate on each axis is
// p = (g + 1) * 0.5 * (size - 1), computed as the JAX package's _coords does;
// then, as in warp_fwd.cu / warp_bwd.cu, over the 8 corners j inside the
// volume with w = w_z * w_y * w_x, w_a = 1 - t_a or t_a, t_a = p_a - floor(p_a):
//   out[c]    = sum w * x[n, j, c]
//   dx[n,j,c] += w * gout[c]                                (summed over g)
//   dgrid_a   = (size_a - 1) / 2 * sum s_a * (other two w) * dot(gout, x[n, j])
// with s_a = -1 (lower corner) / +1 (upper).  Corners come from floor(p): at
// an exact integer the subgradient is torch's, and at the last index the
// upper corner lies outside and weighs 0.  A corner outside the volume, and a
// NaN or +-inf coordinate, adds nothing; an index is converted to int only
// inside the volume.  Sums are fp32, rounded once to the output dtype.
//
// What the TPU kernels do and these do not: they build one-hot matrices of
// the (z, y) corners in VMEM and contract them with the C-major source rows on
// the MXU, write the output channel-major [C, P] (voxels on the lanes), and
// accumulate dx as A^T @ (w_x * gout) in a VMEM block over a sequential grid.
// A GPU gathers the 8 corners directly and scatters dx with atomics.
//
// What bounds them on an H100: bytes, and atomics for dx.  At the Generator
// call (batch 8, 16x64x64 volume, C=32, gps=1, fp32) the forward reads 67 MB
// of source and 25 MB of grid and writes 67 MB; the dgrid kernel also reads
// gout (67 MB) and writes 25 MB; the dx kernel reads the grid and gout and
// writes 67 MB of dx through 34M float4 atomics.  At the reference-form MFE
// call (C=4, gps=16) the grid is 101 MB and the samples 134 MB.  PERF.md holds
// the measured times.
//
// Design: the forward and dx kernels run one thread per (g, v, vector of CPT
// channels) (16 bytes where C allows it), so the grid-major output and gout
// are read and written contiguously across a warp (unlike warp_fwd.cu's
// k-major stores); the dgrid kernel runs one thread per (g, v), since it sums
// a dot product over all C channels, and owns its three outputs.  blockIdx.y
// is g.  The dx kernel adds with float4 / float2 atomics where the vector
// allows it, so the order of its sums, and the last bits of dx, vary from run
// to run.
#include "warp_common.cuh"

namespace {

using namespace facevae_warp;

// normalized -> pixel coordinate, in the JAX package's order of operations
__device__ __forceinline__ float unnormalize(float g, int size) {
  return (g + 1.f) * 0.5f * (float)(size - 1);
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
grid_fwd_kernel(const T* __restrict__ x, const float* __restrict__ grid,
                T* __restrict__ out, int D, int H, int W, int C, int gps, int NV) {
  const int cvs = C / CPT;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)NV * cvs) return;  // ragged tail
  const int v = (int)(t / cvs);
  const int cv = (int)(t - (long long)v * cvs);
  const int g = blockIdx.y;
  const long long gv = (long long)g * NV + v;
  const float* p = grid + gv * 3;
  const Axis ax = axis(unnormalize(p[0], W)), ay = axis(unnormalize(p[1], H)),
             az = axis(unnormalize(p[2], D));
  const T* xn = x + (long long)(g / gps) * D * H * W * C + cv * CPT;

  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float zc = az.f + dz;
    if (!inside(zc, D)) continue;
    const float wz = dz ? az.t : 1.f - az.t;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yc = ay.f + dy;
      if (!inside(yc, H)) continue;
      const float wzy = wz * (dy ? ay.t : 1.f - ay.t);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xc = ax.f + dx;
        if (!inside(xc, W)) continue;
        const float w = wzy * (dx ? ax.t : 1.f - ax.t);
        const long long off = (((long long)(int)zc * H + (int)yc) * W + (int)xc) * C;
        const Pack<T, CPT> s = *reinterpret_cast<const Pack<T, CPT>*>(xn + off);
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[i] += w * to_float(s.v[i]);
      }
    }
  }
  Pack<T, CPT> o;
#pragma unroll
  for (int i = 0; i < CPT; ++i) store(&o.v[i], acc[i]);
  *reinterpret_cast<Pack<T, CPT>*>(out + gv * C + cv * CPT) = o;
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
grid_dgrid_kernel(const T* __restrict__ x, const float* __restrict__ grid,
                  const T* __restrict__ gout, float* __restrict__ dgrid, int D, int H,
                  int W, int C, int gps, int NV) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= NV) return;
  const int g = blockIdx.y;
  const long long gv = (long long)g * NV + v;
  const float* p = grid + gv * 3;
  const Axis ax = axis(unnormalize(p[0], W)), ay = axis(unnormalize(p[1], H)),
             az = axis(unnormalize(p[2], D));
  const T* xn = x + (long long)(g / gps) * D * H * W * C;
  const T* go = gout + gv * C;

  float ddx = 0.f, ddy = 0.f, ddz = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float zc = az.f + dz;
    if (!inside(zc, D)) continue;
    const float wz = dz ? az.t : 1.f - az.t, sz = dz ? 1.f : -1.f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yc = ay.f + dy;
      if (!inside(yc, H)) continue;
      const float wy = dy ? ay.t : 1.f - ay.t, sy = dy ? 1.f : -1.f;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xc = ax.f + dx;
        if (!inside(xc, W)) continue;
        const float wx = dx ? ax.t : 1.f - ax.t, sx = dx ? 1.f : -1.f;
        const T* xj = xn + (((long long)(int)zc * H + (int)yc) * W + (int)xc) * C;
        float dot = 0.f;
        for (int c = 0; c < C; c += CPT) {
          const Pack<T, CPT> s = *reinterpret_cast<const Pack<T, CPT>*>(xj + c);
          const Pack<T, CPT> o = *reinterpret_cast<const Pack<T, CPT>*>(go + c);
#pragma unroll
          for (int i = 0; i < CPT; ++i) dot += to_float(o.v[i]) * to_float(s.v[i]);
        }
        ddx += sx * wy * wz * dot;
        ddy += wx * sy * wz * dot;
        ddz += wx * wy * sz * dot;
      }
    }
  }
  float* d = dgrid + gv * 3;
  d[0] = ddx * ((float)(W - 1) * 0.5f);
  d[1] = ddy * ((float)(H - 1) * 0.5f);
  d[2] = ddz * ((float)(D - 1) * 0.5f);
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
grid_dx_kernel(const float* __restrict__ grid, const T* __restrict__ gout,
               float* __restrict__ dx_acc, int D, int H, int W, int C, int gps, int NV) {
  const int cvs = C / CPT;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)NV * cvs) return;
  const int v = (int)(t / cvs);
  const int cv = (int)(t - (long long)v * cvs);
  const int g = blockIdx.y;
  const long long gv = (long long)g * NV + v;
  const float* p = grid + gv * 3;
  const Axis ax = axis(unnormalize(p[0], W)), ay = axis(unnormalize(p[1], H)),
             az = axis(unnormalize(p[2], D));
  float* dn = dx_acc + (long long)(g / gps) * D * H * W * C + cv * CPT;
  const Pack<T, CPT> o = *reinterpret_cast<const Pack<T, CPT>*>(gout + gv * C + cv * CPT);
  float go[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) go[i] = to_float(o.v[i]);

#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float zc = az.f + dz;
    if (!inside(zc, D)) continue;
    const float wz = dz ? az.t : 1.f - az.t;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yc = ay.f + dy;
      if (!inside(yc, H)) continue;
      const float wzy = wz * (dy ? ay.t : 1.f - ay.t);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xc = ax.f + dx;
        if (!inside(xc, W)) continue;
        const float w = wzy * (dx ? ax.t : 1.f - ax.t);
        float upd[CPT];
#pragma unroll
        for (int i = 0; i < CPT; ++i) upd[i] = w * go[i];
        atomic_add_vec<CPT>(dn + (((long long)(int)zc * H + (int)yc) * W + (int)xc) * C, upd);
      }
    }
  }
}

dim3 blocks(long long threads, int G) {
  return dim3((unsigned)((threads + kThreads - 1) / kThreads), (unsigned)G);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, out and gout).  cpt: channels per vector
// (C % cpt == 0, cpt * sizeof(T) <= 16, x / out / gout / dx aligned to it).
// G = N * gps grids of NV voxels each.  Each returns the cudaError_t of its
// launch (0 = success).
extern "C" int facevae_grid_fwd(const void* x, const float* grid, void* out, int D, int H,
                                int W, int C, int gps, int G, int NV, int dtype, int cpt,
                                void* stream) {
  return dispatch(dtype, cpt, [&](auto t, auto c) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int CPT = decltype(c)::value;
    grid_fwd_kernel<T, CPT><<<blocks((long long)NV * (C / CPT), G), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), grid, static_cast<T*>(out), D, H, W, C, gps, NV);
  });
}

extern "C" int facevae_grid_bwd_dgrid(const void* x, const float* grid, const void* gout,
                                      float* dgrid, int D, int H, int W, int C, int gps,
                                      int G, int NV, int dtype, int cpt, void* stream) {
  return dispatch(dtype, cpt, [&](auto t, auto c) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int CPT = decltype(c)::value;
    grid_dgrid_kernel<T, CPT><<<blocks(NV, G), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), grid, static_cast<const T*>(gout), dgrid, D, H, W, C, gps, NV);
  });
}

extern "C" int facevae_grid_bwd_dx(const float* grid, const void* gout, float* dx, int D,
                                   int H, int W, int C, int gps, int G, int NV, int dtype,
                                   int cpt, void* stream) {
  return dispatch(dtype, cpt, [&](auto t, auto c) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int CPT = decltype(c)::value;
    grid_dx_kernel<T, CPT><<<blocks((long long)NV * (C / CPT), G), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        grid, static_cast<const T*>(gout), dx, D, H, W, C, gps, NV);
  });
}
