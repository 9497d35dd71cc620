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
// What bounds it on an H100: bytes, and how the stores land.  Per output voxel
// and k the kernel reads 12 B of coordinates and writes C values; the 8 corner
// reads hit L2 (a 64x64x16 volume is 1 MB per sample at C=4 fp32, 8 MB at
// C=32, and neighbouring voxels share corners).  At batch 8 the MFE call
// (K1=15, C=4) moves ~94 MB of coordinates in and ~126 MB out (fp32): 68 us
// at 3.35 TB/s.  A thread per (n, k, voxel), as this kernel first was, stores
// its C values 240 B from its neighbour's in the k-major output, so each
// warp's 32 stores touch 32 sectors, each half written: on the TPU probe's
// samples that cost 0.135 ms of 0.349 (PERF.md, kernel 8 against kernel 1).
//
// Design, K1 > 1 (the tile kernel): one block per (n, tile of VT consecutive
// output voxels; VT = 64 unless a row passes 768 B, tile_voxels), doing all
// K1 grids.  Its threads walk the tile's (k, v,
// channel vector) items with the channel vector fastest, then v, so
// coordinate reads coalesce as before and each item gathers its 8 corners in
// the same order with the same weight products (the result stays bit for bit
// equal to warp_grid.cu's forward and to kernel 8).  Each result goes into a
// [VT][K1*C] tile in shared memory whose row stride, counted in store
// vectors, is odd, so the 8 (16 B) or 16 (8 B) stores of a phase hit
// distinct banks.  After one barrier the block writes the tile out as VT*K1*C
// contiguous values in the widest units (16, 8, 4 or 2 B) the row length
// allows: every warp store fills whole sectors.
//
// The corners are read from global memory (L2).  Staging the union box of a
// block's source voxels in shared memory, as kernel 8 (probe_warp.cu) does,
// was measured and lost at MFE: the K1 grids are shifted by different
// keypoints, so the union covers most of the volume and few boxes fit
// (PERF.md §6).
//
// K1 = 1 (the Generator and the TPS frame): the output row of a voxel is its
// C values.  Where C vectorises (the Generator's C = 32: 4 or 8 channels per
// thread) a thread per (n, voxel, channel vector) already stores
// contiguously, and that kernel (the first design) runs.  Where it does not
// (CPT = 1 with 1 < C <= 8, the TPS frame's C = 3), the first design gave
// each channel a thread, so C threads read the same three coordinates, took
// the same floors and weights and read one 2-byte channel per corner; the
// pixel kernel runs one thread per voxel instead, sums all C channels (the
// same products in the same order: the same bits) and writes the block's
// outputs through a shared-memory tile as one contiguous run.  Pure
// gathers: no atomics, so the result is deterministic.
#include "warp_common.cuh"

#include <cstdint>

namespace {

using namespace facevae_warp;

// acc[0:CPT] = the trilinear sample at (px, py, pz) of CPT channels of the
// volume src [D, H, W, C] (already offset to the channel vector), corners in
// the order z, y, x.
template <typename T, int CPT>
__device__ __forceinline__ void gather(const T* __restrict__ src, float px, float py, float pz,
                                       int D, int H, int W, int C, float* acc) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float tx = px - fx, ty = py - fy, tz = pz - fz;
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
        const Pack<T, CPT> p = *reinterpret_cast<const Pack<T, CPT>*>(src + off);
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[i] += w * to_float(p.v[i]);
      }
    }
  }
}

template <typename T, int CPT>
__device__ __forceinline__ Pack<T, CPT> pack(const float* acc) {
  Pack<T, CPT> o;
#pragma unroll
  for (int i = 0; i < CPT; ++i) store(&o.v[i], acc[i]);
  return o;
}

// K1 = 1: one thread per (n, output voxel v, vector of CPT channels)
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gx,
                const float* __restrict__ gy, const float* __restrict__ gz,
                T* __restrict__ out, int D, int H, int W, int C, int NV) {
  const int cvs = C / CPT;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)NV * cvs) return;  // ragged tail
  const int v = (int)(t / cvs);
  const int cv = (int)(t - (long long)v * cvs);
  const int n = blockIdx.y;
  const long long ci = (long long)n * NV + v;
  float acc[CPT];
  gather<T, CPT>(x + (long long)n * D * H * W * C + cv * CPT, gx[ci], gy[ci], gz[ci], D, H, W,
                 C, acc);
  *reinterpret_cast<Pack<T, CPT>*>(out + ci * C + cv * CPT) = pack<T, CPT>(acc);
}

// Calls f(voxel index j = (z * H + y) * W + x, weight w) for each of the 8
// corners of (px, py, pz) inside the volume [D, H, W]: gather's walk, with
// its weights (keep the two in step: the pixel kernel's bits match the
// other kernels' through them).  Both were measured as one walk (PERF.md
// §6): gather written through this one moved the tile kernel by -10% to
// +3% from set to set, and the pixel kernel written as gather<T, 1> per
// channel took 0.0162 ms on the TPS frame against 0.0110 with this one.
template <typename F>
__device__ __forceinline__ void for_corners(float px, float py, float pz, int D, int H, int W,
                                            F&& f) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float tx = px - fx, ty = py - fy, tz = pz - fz;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float zc = fz + dz;
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
        f(((long long)(int)zc * H + (int)yc) * W + (int)xc, wzy * (dx ? tx : 1.f - tx));
      }
    }
  }
}

// the most channels the pixel kernel sums in registers
constexpr int kPixelChannels = 8;

// K1 = 1 with 1 < C <= kPixelChannels channels that do not vectorise (CPT =
// 1, e.g. the TPS frame's C = 3): one thread per (n, output voxel) reads its
// coordinates once, takes each corner's weight once and sums all C channels
// (each channel's corners in gather's order, with its products: the same
// bits).  Its C values go to a shared-memory tile of the block's kThreads
// voxels, which the block writes out as one contiguous run in the widest
// units its length and address allow.  Grid (ceil(NV / kThreads), N);
// dynamic shared memory kThreads * C values.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_fwd_pixel_kernel(const T* __restrict__ x, const float* __restrict__ gx,
                      const float* __restrict__ gy, const float* __restrict__ gz,
                      T* __restrict__ out, int D, int H, int W, int C, int NV) {
  extern __shared__ int4 smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int n = blockIdx.y;
  const long long v0 = (long long)blockIdx.x * kThreads;
  const int vt = (int)min((long long)kThreads, NV - v0);
  if (threadIdx.x < vt) {
    const long long ci = (long long)n * NV + v0 + threadIdx.x;
    const T* src = x + (long long)n * D * H * W * C;
    float acc[kPixelChannels];
#pragma unroll
    for (int c = 0; c < kPixelChannels; ++c) acc[c] = 0.f;
    for_corners(gx[ci], gy[ci], gz[ci], D, H, W, [&](long long j, float w) {
      const T* p = src + j * C;
#pragma unroll
      for (int c = 0; c < kPixelChannels; ++c)
        if (c < C) acc[c] += w * to_float(p[c]);
    });
#pragma unroll
    for (int c = 0; c < kPixelChannels; ++c)
      if (c < C) store(&tile[threadIdx.x * C + c], acc[c]);
  }
  __syncthreads();
  unsigned char* dst = reinterpret_cast<unsigned char*>(out + (n * (long long)NV + v0) * C);
  const int bytes = vt * C * (int)sizeof(T);
  copy_out(copy_unit(bytes, (long long)reinterpret_cast<uintptr_t>(dst)),
           reinterpret_cast<const unsigned char*>(tile), bytes, dst, bytes, 1);
}

// K1 > 1: one block per (n, tile of vt output voxels), all K1 grids; grid
// (ceil(NV / vt), N).  Dynamic shared memory: the output tile, vt rows of
// `stride` bytes.
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
warp_fwd_tile_kernel(const T* __restrict__ x, const float* __restrict__ gx,
                     const float* __restrict__ gy, const float* __restrict__ gz,
                     T* __restrict__ out, int D, int H, int W, int C, int K1, int NV,
                     int vt_max, int stride, int unit) {
  extern __shared__ int4 smem[];
  unsigned char* tile = reinterpret_cast<unsigned char*>(smem);
  const int n = blockIdx.y;
  const long long v0 = (long long)blockIdx.x * vt_max;
  const int vt = (int)min((long long)vt_max, NV - v0);
  const int cvs = C / CPT;
  const int rowbytes = K1 * C * (int)sizeof(T);
  const long long cbase = (long long)n * K1 * NV + v0;  // + k * NV + v
  const T* src = x + (long long)n * D * H * W * C;
  const int per_k = vt * cvs;
  for (int i = threadIdx.x; i < K1 * per_k; i += kThreads) {
    const int k = i / per_k;
    const int r = i - k * per_k;
    const int v = r / cvs;
    const int cv = r - v * cvs;
    const long long ci = cbase + (long long)k * NV + v;
    float acc[CPT];
    gather<T, CPT>(src + cv * CPT, gx[ci], gy[ci], gz[ci], D, H, W, C, acc);
    *reinterpret_cast<Pack<T, CPT>*>(tile + v * stride + (k * C + cv * CPT) * (int)sizeof(T)) =
        pack<T, CPT>(acc);
  }
  __syncthreads();

  copy_out(unit, tile, stride,
           reinterpret_cast<unsigned char*>(out + (long long)(n * (long long)NV + v0) * K1 * C),
           rowbytes, vt);
}

// output voxels per block: 64 (15 KB of tile at MFE fp32, so several blocks
// share an SM), halved while the tile's rows exceed 48 KB
int tile_voxels(int rowbytes) {
  int vt = 64;
  while (vt > 1 && (long long)vt * rowbytes > 48 * 1024) vt /= 2;
  return vt;
}

template <typename T, int CPT>
int launch(const void* x, const float* gx, const float* gy, const float* gz, void* out, int N,
           int D, int H, int W, int C, int K1, int NV, cudaStream_t stream,
           unsigned* launched) {
  if (K1 == 1) {
    if constexpr (CPT == 1) {
      if (C > 1 && C <= kPixelChannels) {
        const dim3 grid((unsigned)((NV + kThreads - 1) / kThreads), (unsigned)N);
        record_launch(launched, grid, kThreads);
        warp_fwd_pixel_kernel<T><<<grid, kThreads, kThreads * C * sizeof(T), stream>>>(
            static_cast<const T*>(x), gx, gy, gz, static_cast<T*>(out), D, H, W, C, NV);
        return (int)cudaGetLastError();
      }
    }
    const long long threads = (long long)NV * (C / CPT);
    const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), (unsigned)N);
    record_launch(launched, grid, kThreads);
    warp_fwd_kernel<T, CPT><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), gx, gy, gz, static_cast<T*>(out), D, H, W, C, NV);
    return (int)cudaGetLastError();
  }
  const int rowbytes = K1 * C * (int)sizeof(T);
  const int vt = tile_voxels(rowbytes);
  const int stride = tile_stride(rowbytes, CPT * (int)sizeof(T));
  const long long smem = (long long)vt * stride;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = warp_fwd_tile_kernel<T, CPT>;
  if (smem > 48 * 1024) {  // above the default a kernel must ask for it
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((NV + vt - 1) / vt), (unsigned)N);
  record_launch(launched, grid, kThreads);
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(static_cast<const T*>(x), gx, gy, gz,
                                                   static_cast<T*>(out), D, H, W, C, K1, NV, vt,
                                                   stride, copy_unit(rowbytes, stride));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  cpt: channels per thread (C % cpt == 0, and
// cpt * sizeof(T) <= 16 with x and out aligned to it).  Returns the
// cudaError_t of the launch (0 = success).  launched (may be null): the
// launch's grid x, y, z and threads a block are written there.
extern "C" int facevae_warp_fwd(const void* x, const float* gx, const float* gy,
                                const float* gz, void* out, int N, int D, int H, int W, int C,
                                int K1, int NV, int dtype, int cpt, void* stream,
                                unsigned* launched) {
  int err = (int)cudaSuccess;
  const int dispatched = facevae_warp::dispatch(dtype, cpt, [&](auto t, auto c) {
    err = launch<std::remove_pointer_t<decltype(t)>, decltype(c)::value>(
        x, gx, gy, gz, out, N, D, H, W, C, K1, NV, static_cast<cudaStream_t>(stream),
        launched);
  });
  return err != (int)cudaSuccess ? err : dispatched;
}
