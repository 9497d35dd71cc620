// Trilinear-warp backward for Hopper (sm_90a), hand-written CUDA C++: the two
// cotangents of csrc/warp_fwd.cu, as two kernels.
//
// Replaces facevae_tpu/ops/pallas/warp_mm.py:warp_mm_bwd_multi_pallas, whose
// two pallas_calls run
//   _dgrid_multi_kernel  -> warp_bwd_dgrid_kernel below: the coordinate
//                           cotangents dgx, dgy, dgz [N, K1, NV], pixel units;
//   _drows_multi_kernel  -> warp_bwd_dx_kernel below: the source cotangent
//                           dx [N, D, H, W, C], a scatter-add of w * gout.
//
//   x     [N, D, H, W, C]   fp32 or bf16, channel-last, contiguous
//   g*    [N, K1, NV]       fp32 pixel coordinates (align_corners=True)
//   gout  [N, NV, K1 * C]   x's dtype, k-major (the forward's output layout)
//   dg*   [N, K1, NV]       fp32
//   dx    [N, D, H, W, C]   fp32 accumulator, zeroed by the caller
//
// Math, per (n, k, output voxel v) and per corner (j_z, j_y, j_x) inside the
// volume: w = w_z * w_y * w_x with w_a = 1 - t_a (lower corner) or t_a (upper
// corner), t_a = g_a - floor(g_a).  Then
//   dx[j, c]  += w * gout[c]
//   dg_a      += s_a * (prod of the other two w) * dot(gout, x[j]),
// s_a = -1 for the lower corner and +1 for the upper one.  The corners come
// from floor(g), so at an exact integer g the subgradient is torch's (and the
// JAX tent's sign(d) * [-1 < d <= 1], warp_mm.py:49-50): the corners are g
// (-1) and g + 1 (+1).  At the last index size-1 the upper corner lies
// outside the volume and weighs 0.  A corner outside the volume, and a NaN or
// +-inf coordinate, add nothing to either output; the index is converted to
// int only for corners inside the volume.
//
// What the TPU kernels do and these do not: one-hot matrices A, dA/dgy,
// dA/dgz built in VMEM turn the corner lookups into MXU matmuls, and dx is
// A^T @ (w_x * gout) accumulated in a VMEM-resident block over the voxel grid
// axis.  A GPU gathers the 8 corners directly and scatters with atomics.
//
// What bounds them on an H100: bytes for dgrid, atomics for dx.  At the MFE
// call site (batch 8, 16x64x64 volume, K1=15, C=4, fp32) the dgrid kernel
// reads 94.4 MB of coordinates, 125.8 MB of gout and an 8.4 MB volume (its
// corner reads hit L2) and writes 94.4 MB of dgrid: 323 MB, 96 us at 3.35
// TB/s.  The dx kernel reads the coordinates and gout and writes the 8.4 MB
// dx: 229 MB, 68 us, plus 8 corners x C / 4 float4 atomics per (n, k, v):
// 63M of them (each dx voxel receives ~8 x K1 = 120), 33.5M at the bf16
// Generator site (C=32, K1=1).  The L2's atomic units, not the bytes, set
// its pace: on MFE's sparse-motion coordinates the dx kernel runs at ~20% of
// its byte bound, on scattered ones at ~10%.
//
// Design: one thread per (n, k, v); blockIdx.y = n * K1 + k, so coordinate
// reads coalesce.  Each thread walks the 8 corners and, inside each, the C
// channels in vectors of CPT (16 bytes where C allows it).  The dgrid kernel
// owns its three outputs (no atomics).  The dx kernel adds into fp32 with
// atomicAdd on float4 / float2 where the vector allows it (sm_90), so the
// order of the sums, and the last bits of dx, vary from run to run.
//
// The dgrid kernel reads gout k-major: 16 B at 240 B intervals at MFE fp32,
// once per corner.  Copying each block's gout rows into a shared-memory tile
// first (the mirror of warp_fwd.cu's output tile) was built and measured: it
// lost on MFE's sparse-motion coordinates (PERF.md §6), so dgrid keeps this
// design.
//
// Summing a block's corners in a shared-memory box first and flushing each
// box voxel with one atomic was built and measured (PERF.md §6): sm_90a
// has no native shared-memory fp32 add (it compiles to a compare-and-swap
// loop), and with integer sums the shared-memory adds, zeroing, flush and
// lower occupancy cost what the fewer global atomics saved: within 1.2% of
// this kernel at the trained step's own MFE call, slower where the box
// rarely fits.  So dx keeps this design.
#include "warp_common.cuh"

namespace {

using namespace facevae_warp;

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
warp_bwd_dgrid_kernel(const T* __restrict__ x, const float* __restrict__ gx,
                      const float* __restrict__ gy, const float* __restrict__ gz,
                      const T* __restrict__ gout, float* __restrict__ dgx,
                      float* __restrict__ dgy, float* __restrict__ dgz,
                      int D, int H, int W, int C, int K1, int NV) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= NV) return;
  const int nk = blockIdx.y;  // n * K1 + k
  const int n = nk / K1;
  const int k = nk - n * K1;
  const long long ci = (long long)nk * NV + v;
  const Axis ax = axis(gx[ci]), ay = axis(gy[ci]), az = axis(gz[ci]);
  const T* xn = x + (long long)n * D * H * W * C;
  const T* go = gout + ((long long)n * NV + v) * K1 * C + (long long)k * C;

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
          const Pack<T, CPT> p = *reinterpret_cast<const Pack<T, CPT>*>(xj + c);
          const Pack<T, CPT> g = *reinterpret_cast<const Pack<T, CPT>*>(go + c);
#pragma unroll
          for (int i = 0; i < CPT; ++i) dot += to_float(g.v[i]) * to_float(p.v[i]);
        }
        ddx += sx * wy * wz * dot;
        ddy += wx * sy * wz * dot;
        ddz += wx * wy * sz * dot;
      }
    }
  }
  dgx[ci] = ddx;
  dgy[ci] = ddy;
  dgz[ci] = ddz;
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
warp_bwd_dx_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                   const float* __restrict__ gz, const T* __restrict__ gout,
                   float* __restrict__ dx_acc, int D, int H, int W, int C, int K1,
                   int NV) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= NV) return;
  const int nk = blockIdx.y;
  const int n = nk / K1;
  const int k = nk - n * K1;
  const long long ci = (long long)nk * NV + v;
  const Axis ax = axis(gx[ci]), ay = axis(gy[ci]), az = axis(gz[ci]);
  float* dn = dx_acc + (long long)n * D * H * W * C;
  const T* go = gout + ((long long)n * NV + v) * K1 * C + (long long)k * C;

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
        float* dj = dn + (((long long)(int)zc * H + (int)yc) * W + (int)xc) * C;
        for (int c = 0; c < C; c += CPT) {
          const Pack<T, CPT> g = *reinterpret_cast<const Pack<T, CPT>*>(go + c);
          float upd[CPT];
#pragma unroll
          for (int i = 0; i < CPT; ++i) upd[i] = w * to_float(g.v[i]);
          atomic_add_vec<CPT>(dj + c, upd);
        }
      }
    }
  }
}

dim3 grid_of(int N, int K1, int NV) {
  return dim3((unsigned)((NV + kThreads - 1) / kThreads), (unsigned)(N * K1));
}

template <typename T, int CPT>
void launch_dgrid(const void* x, const float* gx, const float* gy, const float* gz,
                  const void* gout, float* dgx, float* dgy, float* dgz, int N, int D,
                  int H, int W, int C, int K1, int NV, cudaStream_t s) {
  warp_bwd_dgrid_kernel<T, CPT><<<grid_of(N, K1, NV), kThreads, 0, s>>>(
      static_cast<const T*>(x), gx, gy, gz, static_cast<const T*>(gout), dgx, dgy, dgz,
      D, H, W, C, K1, NV);
}

template <typename T, int CPT>
void launch_dx(const float* gx, const float* gy, const float* gz, const void* gout,
               float* dx, int N, int D, int H, int W, int C, int K1, int NV,
               cudaStream_t s) {
  warp_bwd_dx_kernel<T, CPT><<<grid_of(N, K1, NV), kThreads, 0, s>>>(
      gx, gy, gz, static_cast<const T*>(gout), dx, D, H, W, C, K1, NV);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x and gout).  cpt: channels per vector (C % cpt
// == 0, cpt * sizeof(T) <= 16, x / gout / dx aligned to it).  Each returns the
// cudaError_t of its launch (0 = success).
extern "C" int facevae_warp_bwd_dgrid(const void* x, const float* gx, const float* gy,
                                      const float* gz, const void* gout, float* dgx,
                                      float* dgy, float* dgz, int N, int D, int H, int W,
                                      int C, int K1, int NV, int dtype, int cpt,
                                      void* stream) {
  return facevae_warp::dispatch(dtype, cpt, [&](auto t, auto c) {
    launch_dgrid<std::remove_pointer_t<decltype(t)>, decltype(c)::value>(
        x, gx, gy, gz, gout, dgx, dgy, dgz, N, D, H, W, C, K1, NV,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" int facevae_warp_bwd_dx(const float* gx, const float* gy, const float* gz,
                                   const void* gout, float* dx, int N, int D, int H, int W,
                                   int C, int K1, int NV, int dtype, int cpt, void* stream) {
  return facevae_warp::dispatch(dtype, cpt, [&](auto t, auto c) {
    launch_dx<std::remove_pointer_t<decltype(t)>, decltype(c)::value>(
        gx, gy, gz, gout, dx, N, D, H, W, C, K1, NV, static_cast<cudaStream_t>(stream));
  });
}
