// Trilinear-warp forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces facevae_tpu/ops/pallas/warp_mm.py:_fwd_multi_kernel (called by
// warp_mm_fwd_multi_pallas): sample ONE source volume x[n] at K1 sets of
// pixel coordinates (align_corners=True, zeros padding), output k-major.
//
//   x    [N, D, H, W, C]   fp32 or bf16, channel-last, contiguous
//   g*   [N, K1, NV]       fp32 pixel coordinates (x in [0, W-1], ...)
//   out  [N, NV, K1 * C]   x's dtype; channel k*C + c is grid k's sample of c
//
// Math: out = sum over the 8 corners (j_z, j_y, j_x) of
//   w_z * w_y * w_x * x[n, j_z, j_y, j_x, c],  w = 1 - |j - g| on the two
// neighbours of g, and a corner outside the volume weighs 0.  This is the tent
// form max(0, 1 - |j - g|) of the TPU kernel.  Sums are fp32; the result is
// rounded once to x's dtype.
//
// What the TPU kernel does and this one does not: it expresses the (z, y)
// lookup as a one-hot matmul A[VB, D*H] @ rows[D*H, C*W] and the x reduction
// as a segment matmul, with z-banding and channel grouping to fit VMEM and
// feed the MXU.  On the GPU the 8 corners are a direct gather, so none of
// that carries over.
//
// What bounds it on an H100: bytes.  Per output voxel and k the kernel reads
// 12 B of coordinates and writes C values; the 8 corner reads hit L2 (a
// 64x64x16 volume is 1 MB per sample at C=4 fp32, 8 MB at C=32, and
// neighbouring voxels share corners).  At batch 8, the MFE call (K1=15, C=4)
// moves ~94 MB of coordinates in and ~126 MB out; the Generator call (K1=1,
// C=32) reads a 67 MB volume and writes 67 MB.  At 3.35 TB/s both are a few
// tens of microseconds; PERF.md holds the measured times.
//
// Design: one thread per (n, k, output voxel v, vector of CPT channels), a
// 16-byte load per corner where C allows it (C=4 fp32: one float4; C=32 fp32:
// 8 threads of float4 per voxel).  Threads of a block run over consecutive
// (v, channel vector) of one (n, k) row, so coordinate reads coalesce and a
// corner's channel vectors are contiguous.  A pure gather: no atomics, so the
// result is deterministic.
#include "warp_common.cuh"

namespace {

using namespace facevae_warp;

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gx,
                const float* __restrict__ gy, const float* __restrict__ gz,
                T* __restrict__ out, int D, int H, int W, int C, int K1, int NV) {
  const int cvs = C / CPT;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)NV * cvs) return;  // ragged tail
  const int v = (int)(t / cvs);
  const int cv = (int)(t - (long long)v * cvs);
  const int nk = blockIdx.y;  // n * K1 + k
  const int n = nk / K1;
  const int k = nk - n * K1;

  const long long ci = (long long)nk * NV + v;
  const float px = gx[ci], py = gy[ci], pz = gz[ci];
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float tx = px - fx, ty = py - fy, tz = pz - fz;

  const T* xn = x + (long long)n * D * H * W * C + cv * CPT;
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float zc = fz + dz;
    // written as !(in range) so NaN and +-inf coordinates weigh 0
    if (!(zc >= 0.f && zc <= (float)(D - 1))) continue;
    const float wz = dz ? tz : 1.f - tz;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yc = fy + dy;
      if (!(yc >= 0.f && yc <= (float)(H - 1))) continue;
      const float wzy = wz * (dy ? ty : 1.f - ty);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xc = fx + dx;
        if (!(xc >= 0.f && xc <= (float)(W - 1))) continue;
        const float w = wzy * (dx ? tx : 1.f - tx);
        const long long off = (((long long)(int)zc * H + (int)yc) * W + (int)xc) * C;
        const Pack<T, CPT> p = *reinterpret_cast<const Pack<T, CPT>*>(xn + off);
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[i] += w * to_float(p.v[i]);
      }
    }
  }

  Pack<T, CPT> o;
#pragma unroll
  for (int i = 0; i < CPT; ++i) store(&o.v[i], acc[i]);
  *reinterpret_cast<Pack<T, CPT>*>(out + ((long long)n * NV + v) * K1 * C +
                                   (long long)k * C + cv * CPT) = o;
}

template <typename T, int CPT>
void launch(const void* x, const float* gx, const float* gy, const float* gz,
            void* out, int N, int D, int H, int W, int C, int K1, int NV,
            cudaStream_t stream) {
  const long long threads = (long long)NV * (C / CPT);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), (unsigned)(N * K1));
  warp_fwd_kernel<T, CPT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), gx, gy, gz, static_cast<T*>(out), D, H, W, C, K1, NV);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  cpt: channels per thread (C % cpt == 0, and
// cpt * sizeof(T) <= 16 with x and out aligned to it).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int facevae_warp_fwd(const void* x, const float* gx, const float* gy,
                                const float* gz, void* out, int N, int D, int H,
                                int W, int C, int K1, int NV, int dtype, int cpt,
                                void* stream) {
  return facevae_warp::dispatch(dtype, cpt, [&](auto t, auto c) {
    launch<std::remove_pointer_t<decltype(t)>, decltype(c)::value>(
        x, gx, gy, gz, out, N, D, H, W, C, K1, NV, static_cast<cudaStream_t>(stream));
  });
}
