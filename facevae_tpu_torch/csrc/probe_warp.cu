// The two warp probes for Hopper (sm_90a), hand-written CUDA C++.  Both
// sample with align_corners=True and zeros padding at PIXEL coordinates, sum
// in fp32 and walk the 8 corners in the order of warp_fwd.cu (z, then y, then
// x; every corner test is !(0 <= j <= size-1), so NaN and +-inf weigh 0).
//
// probe_warp_kernel replaces tools/proto_pallas_warp.py:warp_kernel (called by
// pallas_warp): one volume in the probe's transposed layout,
//
//   volT [C*W, D*H] fp32 (row c*W + x, column z*H + y), gx/gy/gz [1, P] fp32
//   -> out [P, C] fp32.
//
// The TPU kernel searched 128-lane tiles with masked lane gathers, because
// Mosaic gathers only within a tile.  Here one thread per voxel reads its
// 4 (z, y) corners x 2 x corners x C channels directly.  Bound: bytes; the
// probe's call (D=16, H=W=64, C=4, P=65536) moves a 1 MB table, 0.8 MB of
// coordinates and 1 MB out: 2.88 MB, 0.86 us at 3.35 TB/s, so the launch
// bounds it.  The table sits in L2; the thread's channel reads are D*H*4
// bytes apart, which is the probe's layout, kept at the public function.
//
// probe_banded_warp_kernel replaces tools/proto_banded_warp.py's
// banded_fwd_kernel (MODE unset), blockwhen_fwd_kernel (MODE=blockwhen) and
// bandonly_fwd_kernel (MODE=bandonly), called by run_banded: kernel 1's
// multi-grid forward on the probe's row layout,
//
//   rows3 [N, D*H, C*W] bf16 (row z*H + y, column c*W + x),
//   cgx/cgy/cgz [N, K1, NV] fp32 -> out [N, NV, K1*C] fp32 (k-major),
//
// exact trilinear sums in fp32 over the bf16 source (the TPU kernel also
// rounded its one-hot weights and S*wx to bf16 for the MXU; this one does
// not, so it agrees with kernel 1 run on the same values).
//
// The question the probe asks: a block of VB z-coherent voxels samples a
// narrow (z, y) range of the source, so it could read a staged band instead
// of the whole volume.  The probe's band (ZB=8 z-slices x H=64 rows x 512 B
// = 256 KiB) does not fit the 227 KB of shared memory a block may use, so
// this kernel stages the (z, y) bounding box of the block's samples instead:
// rows zlo..zhi x ylo..yhi, each a contiguous C*W bf16 row of rows3.  The box
// covers every corner a sample may read (a sample with no z or no y corner
// inside the volume adds nothing).  Its budget is `budget` rows of dynamic
// shared memory; the probe's entry point passes 160 rows (80 KB at C*W=256),
// which holds every per-block union of the probe's theta=3 degree call
// (at most 150 rows) and every per-(block, k) box at theta=3 and 40 (at
// most 27 and 108 rows).  Two blocks of 512 threads fit an SM.
//
//   mode 0 (banded):    per (block, k) the box of that grid's samples; staged
//                       when it fits the budget, else the samples read rows3
//                       in global memory (L2).  One tile per k.
//   mode 1 (blockwhen): one box for the union of all K1 grids; staged once
//                       when it fits, else every k reads global memory.
//   mode 2 (bandonly):  mode 0 without the fallback: a box over the budget is
//                       cut to it, and corners outside the staged rows read 0
//                       (wrong there, as the TPU variant; for timing only).
//
// `staged` (optional, [N, NV/VB, K1] bytes) receives 1 where the box fits.
//
// Bound: bytes.  The probe's call moves 4.2 MB of rows, 94.4 MB of
// coordinates and 125.8 MB out: 224.4 MB, 67.0 us at 3.35 TB/s.  The stores
// are kernel 1's (16 B per sample, K1*C*4 = 240 B apart across a warp); what
// differs from kernel 1 is where the corners are read from, and that a block
// walks the K1 grids of its voxels in turn (PERF.md has the times).
#include <climits>
#include <type_traits>

#include "warp_common.cuh"

namespace {

using namespace facevae_warp;

template <int C>
__global__ void __launch_bounds__(kThreads)
probe_warp_kernel(const float* __restrict__ volT, const float* __restrict__ gx,
                  const float* __restrict__ gy, const float* __restrict__ gz,
                  float* __restrict__ out, int D, int H, int W, int P) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long DH = (long long)D * H;
  const float px = __ldg(gx + p), py = __ldg(gy + p), pz = __ldg(gz + p);
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float tx = px - fx, ty = py - fy, tz = pz - fz;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float zc = fz + dz;
    if (!inside(zc, D)) continue;
    const float wz = dz ? tz : 1.f - tz;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yc = fy + dy;
      if (!inside(yc, H)) continue;
      const float wzy = wz * (dy ? ty : 1.f - ty);
      const float* col = volT + (int)zc * H + (int)yc;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xc = fx + dx;
        if (!inside(xc, W)) continue;
        const float w = wzy * (dx ? tx : 1.f - tx);
        const int xi = (int)xc;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * __ldg(col + (c * W + xi) * DH);
      }
    }
  }
  Pack<float, C> o;
#pragma unroll
  for (int c = 0; c < C; ++c) o.v[c] = acc[c];
  *reinterpret_cast<Pack<float, C>*>(out + (long long)p * C) = o;
}

constexpr int kBandThreads = 512;
constexpr int kBanded = 0, kBlockWhen = 1, kBandOnly = 2;

struct Box {
  int zlo, zhi, ylo, yhi;  // empty while zhi < zlo
};

__device__ __forceinline__ Box empty_box() { return {INT_MAX, INT_MIN, INT_MAX, INT_MIN}; }

// add the (z, y) rows one sample may read: none if it has no z or no y corner
// in the volume (a NaN or +-inf coordinate has none)
__device__ __forceinline__ void extend(Box& b, float py, float pz, int D, int H) {
  const float fz = floorf(pz), fy = floorf(py);
  if (!(fz >= -1.f && fz <= (float)(D - 1) && fy >= -1.f && fy <= (float)(H - 1))) return;
  const int z = (int)fz, y = (int)fy;
  b.zlo = min(b.zlo, max(z, 0));
  b.zhi = max(b.zhi, min(z + 1, D - 1));
  b.ylo = min(b.ylo, max(y, 0));
  b.yhi = max(b.yhi, min(y + 1, H - 1));
}

// The union of every thread's box.  Ends with a barrier after the partials
// are written; the caller passes another barrier before the next call.
__device__ __forceinline__ Box block_union(Box b, int (*part)[4]) {
  const unsigned all = 0xffffffffu;
  b.zlo = __reduce_min_sync(all, b.zlo);
  b.zhi = __reduce_max_sync(all, b.zhi);
  b.ylo = __reduce_min_sync(all, b.ylo);
  b.yhi = __reduce_max_sync(all, b.yhi);
  if ((threadIdx.x & 31) == 0) {
    int* p = part[threadIdx.x >> 5];
    p[0] = b.zlo;
    p[1] = b.zhi;
    p[2] = b.ylo;
    p[3] = b.yhi;
  }
  __syncthreads();
  Box u = empty_box();
#pragma unroll
  for (int w = 0; w < kBandThreads / 32; ++w) {
    u.zlo = min(u.zlo, part[w][0]);
    u.zhi = max(u.zhi, part[w][1]);
    u.ylo = min(u.ylo, part[w][2]);
    u.yhi = max(u.yhi, part[w][3]);
  }
  return u;
}

struct Span {
  int nz, ny;  // the staged rows: nz z-slices of ny rows from (zlo, ylo)
  bool fits;   // the whole box fits the budget
};

__device__ __forceinline__ Span span(const Box& b, int budget, bool cut) {
  if (b.zhi < b.zlo || b.yhi < b.ylo) return {0, 0, true};
  Span s{b.zhi - b.zlo + 1, b.yhi - b.ylo + 1, true};
  s.fits = s.nz * s.ny <= budget;
  if (!s.fits && cut) {  // bandonly: keep what the budget holds
    if (s.ny <= budget) {
      s.nz = budget / s.ny;
    } else {
      s.nz = 1;
      s.ny = budget;
    }
  }
  return s;
}

// tile row (z - zlo) * ny + (y - ylo) <- src row z * H + y, C*W bf16 each
__device__ __forceinline__ void stage(unsigned short* tile, const unsigned short* src, int zlo,
                                      int ylo, Span s, int H, int CW, int vec) {
  if (vec) {  // CW % 8 == 0 and src 16-byte aligned: 16-byte copies
    const int per_row = CW / 8;
    const int total = s.nz * s.ny * per_row;
    int4* dst = reinterpret_cast<int4*>(tile);
    for (int i = threadIdx.x; i < total; i += kBandThreads) {
      const int row = i / per_row, col = i - row * per_row;
      const int zi = row / s.ny, yi = row - zi * s.ny;
      dst[i] = __ldg(reinterpret_cast<const int4*>(
                         src + ((long long)(zlo + zi) * H + ylo + yi) * CW) + col);
    }
  } else {
    const int total = s.nz * s.ny * CW;
    for (int i = threadIdx.x; i < total; i += kBandThreads) {
      const int row = i / CW, col = i - row * CW;
      const int zi = row / s.ny, yi = row - zi * s.ny;
      tile[i] = __ldg(src + ((long long)(zlo + zi) * H + ylo + yi) * CW + col);
    }
  }
}

__device__ __forceinline__ float bf16_bits(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}

// One sample of C channels from rows (zlo .. zlo+nz-1) x (ylo .. ylo+ny-1) of
// src (the staged tile, or the whole volume with zlo = ylo = 0, nz = D,
// ny = H); a corner outside those rows reads nothing.
template <int C>
__device__ __forceinline__ void sample(const unsigned short* __restrict__ src, int zlo, int nz,
                                       int ylo, int ny, int D, int H, int W, float px, float py,
                                       float pz, float* __restrict__ dst) {
  const int CW = C * W;
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float tx = px - fx, ty = py - fy, tz = pz - fz;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float zc = fz + dz;
    if (!inside(zc, D)) continue;
    const int zr = (int)zc - zlo;
    if ((unsigned)zr >= (unsigned)nz) continue;
    const float wz = dz ? tz : 1.f - tz;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yc = fy + dy;
      if (!inside(yc, H)) continue;
      const int yr = (int)yc - ylo;
      if ((unsigned)yr >= (unsigned)ny) continue;
      const float wzy = wz * (dy ? ty : 1.f - ty);
      const unsigned short* row = src + (long long)(zr * ny + yr) * CW;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xc = fx + dx;
        if (!inside(xc, W)) continue;
        const float w = wzy * (dx ? tx : 1.f - tx);
        const int xi = (int)xc;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * bf16_bits(row[c * W + xi]);
      }
    }
  }
  Pack<float, C> o;
#pragma unroll
  for (int c = 0; c < C; ++c) o.v[c] = acc[c];
  *reinterpret_cast<Pack<float, C>*>(dst) = o;
}

// grid (NV / VB, N): one block per (source n, block of VB voxels)
template <int C, int MODE>
__global__ void __launch_bounds__(kBandThreads)
probe_banded_warp_kernel(const unsigned short* __restrict__ rows3, const float* __restrict__ gx,
                         const float* __restrict__ gy, const float* __restrict__ gz,
                         float* __restrict__ out, unsigned char* __restrict__ staged, int D,
                         int H, int W, int K1, int NV, int VB, int budget, int vec) {
  extern __shared__ int4 smem[];
  unsigned short* tile = reinterpret_cast<unsigned short*>(smem);
  __shared__ int part[kBandThreads / 32][4];
  const int n = blockIdx.y, blk = blockIdx.x;
  const int CW = C * W;
  const unsigned short* src = rows3 + (long long)n * D * H * CW;
  const long long v0 = (long long)blk * VB;
  const long long flags = ((long long)n * gridDim.x + blk) * K1;

  // each k: the voxels' coordinates and output rows
  auto run_k = [&](int k, bool use_tile, int zlo, int ylo, Span s) {
    const long long base = ((long long)n * K1 + k) * NV + v0;
    for (int v = threadIdx.x; v < VB; v += kBandThreads) {
      const float px = __ldg(gx + base + v), py = __ldg(gy + base + v), pz = __ldg(gz + base + v);
      float* dst = out + (((long long)n * NV + v0 + v) * K1 + k) * C;
      if (use_tile)
        sample<C>(tile, zlo, s.nz, ylo, s.ny, D, H, W, px, py, pz, dst);
      else
        sample<C>(src, 0, D, 0, H, D, H, W, px, py, pz, dst);
    }
  };

  if (MODE == kBlockWhen) {
    Box b = empty_box();
    for (int k = 0; k < K1; ++k) {
      const long long base = ((long long)n * K1 + k) * NV + v0;
      for (int v = threadIdx.x; v < VB; v += kBandThreads)
        extend(b, __ldg(gy + base + v), __ldg(gz + base + v), D, H);
    }
    b = block_union(b, part);
    const Span s = span(b, budget, false);
    if (s.fits) stage(tile, src, b.zlo, b.ylo, s, H, CW, vec);
    if (staged != nullptr && threadIdx.x == 0)
      for (int k = 0; k < K1; ++k) staged[flags + k] = s.fits;
    __syncthreads();
    for (int k = 0; k < K1; ++k) run_k(k, s.fits, b.zlo, b.ylo, s);
  } else {
    for (int k = 0; k < K1; ++k) {
      const long long base = ((long long)n * K1 + k) * NV + v0;
      Box b = empty_box();
      for (int v = threadIdx.x; v < VB; v += kBandThreads)
        extend(b, __ldg(gy + base + v), __ldg(gz + base + v), D, H);
      // the barrier inside block_union also keeps this k's staging off the
      // tile until every thread has finished sampling k - 1
      b = block_union(b, part);
      const Span s = span(b, budget, MODE == kBandOnly);
      const bool use_tile = MODE == kBandOnly || s.fits;
      if (use_tile) stage(tile, src, b.zlo, b.ylo, s, H, CW, vec);
      if (staged != nullptr && threadIdx.x == 0) staged[flags + k] = s.fits;
      __syncthreads();  // the tile is staged; every thread has read part[]
      run_k(k, use_tile, b.zlo, b.ylo, s);
    }
  }
}

template <int C, int MODE>
int launch_banded(const void* rows3, const float* gx, const float* gy, const float* gz,
                  float* out, unsigned char* staged, int N, int D, int H, int W, int K1, int NV,
                  int VB, int budget, int vec, cudaStream_t stream) {
  const size_t smem = (size_t)budget * C * W * sizeof(unsigned short);
  auto kernel = probe_banded_warp_kernel<C, MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((unsigned)(NV / VB), (unsigned)N), kBandThreads, smem, stream>>>(
      static_cast<const unsigned short*>(rows3), gx, gy, gz, out, staged, D, H, W, K1, NV, VB,
      budget, vec);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, C>{}) for C in {1, 2, 4}; cudaErrorInvalidValue
// for any other C
template <typename F>
int for_channels(int C, F&& f) {
  switch (C) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 1: return f(std::integral_constant<int, 1>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C in {1, 2, 4}; out 16-byte aligned.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int facevae_probe_warp(const float* volT, const float* gx, const float* gy,
                                  const float* gz, float* out, int D, int H, int W, int C, int P,
                                  void* stream) {
  const dim3 grid((unsigned)((P + kThreads - 1) / kThreads));
  return for_channels(C, [&](auto c) {
    probe_warp_kernel<decltype(c)::value><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        volT, gx, gy, gz, out, D, H, W, P);
    return (int)cudaGetLastError();
  });
}

// mode 0 banded, 1 blockwhen, 2 bandonly; C in {1, 2, 4}; NV % VB == 0;
// budget >= 1 rows of C*W bf16; vec = 1 when C*W % 8 == 0 and rows3 is
// 16-byte aligned; staged may be null.  Returns the cudaError_t of the launch.
extern "C" int facevae_probe_banded_warp(const void* rows3, const float* gx, const float* gy,
                                         const float* gz, float* out, unsigned char* staged,
                                         int N, int D, int H, int W, int C, int K1, int NV,
                                         int VB, int budget, int mode, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return for_channels(C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    switch (mode) {
      case kBanded:
        return launch_banded<kC, kBanded>(rows3, gx, gy, gz, out, staged, N, D, H, W, K1, NV,
                                          VB, budget, vec, s);
      case kBlockWhen:
        return launch_banded<kC, kBlockWhen>(rows3, gx, gy, gz, out, staged, N, D, H, W, K1,
                                             NV, VB, budget, vec, s);
      case kBandOnly:
        return launch_banded<kC, kBandOnly>(rows3, gx, gy, gz, out, staged, N, D, H, W, K1, NV,
                                            VB, budget, vec, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
}
