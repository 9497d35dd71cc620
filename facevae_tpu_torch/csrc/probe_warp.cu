// The two warp probes for Hopper (sm_90a), hand-written CUDA C++.  Both
// sample with align_corners=True and zeros padding at PIXEL coordinates, sum
// in fp32 and walk the 8 corners in the order of warp_fwd.cu (z, then y, then
// x; every corner test is !(0 <= j <= size-1), so NaN and +-inf weigh 0), with
// warp_fwd.cu's products: the same bits as kernel 1 on the same fp32 values.
//
// probe_warp_kernel replaces tools/proto_pallas_warp.py:warp_kernel (called by
// pallas_warp): one volume in the probe's transposed layout,
//
//   volT [C*W, D*H] fp32 (row c*W + x, column z*H + y), gx/gy/gz [1, P] fp32
//   -> out [P, C] fp32.
//
// The TPU kernel searched 128-lane tiles with masked lane gathers, because
// Mosaic gathers only within a tile.  Here the probe's call (D=16, H=W=64,
// C=4, P=65536) reads its points uniformly over the whole 1 MB table, so no
// block can stage it, and the table sits in L2.  What costs is how many L2
// sectors a sample touches: in volT a sample's C channels x 2 x corners lie
// D*H*4 = 4 KB apart, 16 sectors a sample.  So two launches:
// probe_relayout_kernel re-lays volT into a channel-last scratch vol
// [D*H, W, C] (the wrapper allocates it) through a shared-memory tile, read
// along (z, y) and written along (x, c), both coalesced; probe_warp_kernel
// then reads each (z, y) corner's two x corners as two C-float vectors side
// by side, 4-8 sectors a sample.  Bound: bytes; the call moves a 1 MB table,
// 0.8 MB of coordinates and 1 MB out: 2.88 MB, 0.86 us at 3.35 TB/s, so the
// launches bound it.
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
// rows zlo..zhi x ylo..yhi of rows3.  The box covers every corner a sample
// may read (a sample with no z or no y corner inside the volume adds
// nothing).  Its budget is `budget` rows; the probe's entry point passes 160
// rows (80 KB at C*W=256), which holds every per-block union of the probe's
// theta=3 degree call (at most 150 rows) and every per-(block, k) box at
// theta=3 and 40 (at most 27 and 108 rows).
//
//   mode 0 (banded):    per (block, k) the box of that grid's samples; staged
//                       when it fits the budget, else the samples read rows3
//                       in global memory (L2).
//   mode 1 (blockwhen): one box for the union of all K1 grids; staged once
//                       when it fits, else every k reads global memory.
//   mode 2 (bandonly):  mode 0 without the fallback: a box over the budget is
//                       cut to it, and corners outside the staged rows read 0
//                       (wrong there, as the TPU variant; for timing only).
//
// `staged` (optional, [N, NV/VB, K1] bytes) receives 1 where the box fits.
//
// Bound: bytes.  The probe's call moves 4.2 MB of rows, 94.4 MB of
// coordinates and 125.8 MB out: 224.4 MB, 67.0 us at 3.35 TB/s.  Design,
// one block of 512 threads per (n, block of VB voxels):
//  - Stores: each result goes to a [VB][K1*C] fp32 tile in shared memory
//    (row stride an odd number of C-float vectors, so a phase's stores hit
//    distinct banks), which the block writes out at the end as VB*K1*C
//    contiguous values in 16-byte units (kernel 1's tile, warp_common.cuh
//    copy_out).  The first port wrote 16 B per sample, K1*C*4 = 240 B apart
//    across a warp, and those stores took ~0.135 of its 0.44 ms (PERF.md).
//  - Boxes: one pass over the block's y and z coordinates finds all K1
//    boxes, the loads of 8 grids in flight at once (a pass that waited for
//    each grid's loads in turn cost more than the sampling), warp
//    reductions, partials in shared memory, one barrier; x is prefetched
//    into L2 on the way.  One more barrier publishes the boxes and flags.
//  - Staging: a box's rows are nz contiguous runs of rows3 (one a z-slice),
//    so one thread hands them to the copy engine (cp.async.bulk) and the
//    block waits on an mbarrier that counts their bytes: no thread spends
//    instructions or registers on the copy.  The boxes of consecutive k go
//    into a ring of staged rows (all the rows shared memory holds beside
//    the rest: 205 at the probe's call; which boxes fit is the budget's
//    call); box k + 1 is copied while the block samples box k, beside it
//    where both fit the ring (one barrier a grid), else from row 0 after a
//    barrier.  Copying through registers instead, re-laying each row as x
//    pairs for 16-byte shared loads, measured slower: its copy instructions
//    and waits took 2-3K of the 4.5K cycles a grid at theta=40 (PERF.md).
//  - Samples: every load of a sample (8C 2-byte loads, from the staged rows
//    or from rows3 where a box does not fit) is issued before its first
//    product, a corner outside reading a valid address that is never added.
//    Each thread loads its next grid's coordinates before it samples this
//    one.
// Shared memory at the probe's call: tile 120 KB + ring 102.5 KB + boxes
// 4 KB: one block per SM (probe_banded_warp.launch_plan mirrors the sizes).
#include <climits>
#include <cstdint>
#include <type_traits>

#include "warp_common.cuh"

namespace {

using namespace facevae_warp;

// ---- kernel 7 ----

constexpr int kRelayoutZY = 32, kRelayoutX = 16;  // a relayout block's tile

// volT [C*W, D*H] -> vol [D*H, W, C]: one block per tile of kRelayoutZY
// columns (z, y) by kRelayoutX rows x of every channel; 1D grid, (z, y) tiles
// fastest.
template <int C>
__global__ void __launch_bounds__(kThreads)
probe_relayout_kernel(const float* __restrict__ volT, float* __restrict__ vol, int DH, int W) {
  constexpr int kRow = kRelayoutX * C;
  __shared__ float tile[kRelayoutZY][kRow + 1];  // [zy][x*C + c]; the pad spreads the banks
  const int tiles_zy = (DH + kRelayoutZY - 1) / kRelayoutZY;
  const int zy0 = (blockIdx.x % tiles_zy) * kRelayoutZY;
  const int x0 = (blockIdx.x / tiles_zy) * kRelayoutX;
  for (int i = threadIdx.x; i < kRelayoutZY * kRow; i += kThreads) {
    const int zy = i % kRelayoutZY, r = i / kRelayoutZY;  // r = c * kRelayoutX + x
    const int c = r / kRelayoutX, x = r - c * kRelayoutX;
    if (zy0 + zy < DH && x0 + x < W)
      tile[zy][x * C + c] = volT[(long long)(c * W + x0 + x) * DH + zy0 + zy];
  }
  __syncthreads();
  const int run = min(kRelayoutX, W - x0) * C;  // this tile's (x, c) values of one (z, y)
  for (int i = threadIdx.x; i < kRelayoutZY * kRow; i += kThreads) {
    const int zy = i / kRow, j = i - zy * kRow;
    if (zy0 + zy < DH && j < run) vol[((long long)(zy0 + zy) * W + x0) * C + j] = tile[zy][j];
  }
}

// one thread per point, reading the channel-last vol [D*H, W, C]
template <int C>
__global__ void __launch_bounds__(kThreads)
probe_warp_kernel(const float* __restrict__ vol, const float* __restrict__ gx,
                  const float* __restrict__ gy, const float* __restrict__ gz,
                  float* __restrict__ out, int D, int H, int W, int P) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
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
      const float* row = vol + ((long long)(int)zc * H + (int)yc) * W * C;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float xc = fx + dx;
        if (!inside(xc, W)) continue;
        const float w = wzy * (dx ? tx : 1.f - tx);
        const Pack<float, C> v = *reinterpret_cast<const Pack<float, C>*>(row + (int)xc * C);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * v.v[c];
      }
    }
  }
  Pack<float, C> o;
#pragma unroll
  for (int c = 0; c < C; ++c) o.v[c] = acc[c];
  *reinterpret_cast<Pack<float, C>*>(out + (long long)p * C) = o;
}

// ---- kernel 8 ----

constexpr int kBandThreads = 512;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kBanded = 0, kBlockWhen = 1, kBandOnly = 2;
constexpr int kBoxBatch = 8;   // grids whose coordinates a thread loads at once in the box pass

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

__device__ __forceinline__ void unite(Box& u, const Box& b) {
  u.zlo = min(u.zlo, b.zlo);
  u.zhi = max(u.zhi, b.zhi);
  u.ylo = min(u.ylo, b.ylo);
  u.yhi = max(u.yhi, b.yhi);
}

// the warp's union of b, written by lane 0 to p[0:4]
__device__ __forceinline__ void warp_partial(Box b, int* p) {
  const unsigned all = 0xffffffffu;
  b.zlo = __reduce_min_sync(all, b.zlo);
  b.zhi = __reduce_max_sync(all, b.zhi);
  b.ylo = __reduce_min_sync(all, b.ylo);
  b.yhi = __reduce_max_sync(all, b.yhi);
  if ((threadIdx.x & 31) == 0) {
    p[0] = b.zlo;
    p[1] = b.zhi;
    p[2] = b.ylo;
    p[3] = b.yhi;
  }
}

// The rows a block stages for one box: nz z-slices of ny rows from (zlo,
// ylo).  use: the block samples them from shared memory (banded and
// blockwhen where the box fits, bandonly always); fits: the whole box fits
// the budget.  An empty box stages nothing and fits.
struct Span {
  int zlo, ylo, nz, ny, use, fits;
};
static_assert(sizeof(Span) == 24, "launch_plan in proto_banded_warp.py counts 24 bytes a span");

__device__ __forceinline__ Span span(const Box& b, int budget, int mode) {
  if (b.zhi < b.zlo || b.yhi < b.ylo) return {0, 0, 0, 0, 1, 1};
  Span s{b.zlo, b.ylo, b.zhi - b.zlo + 1, b.yhi - b.ylo + 1, 1, 1};
  s.fits = s.nz * s.ny <= budget;
  s.use = s.fits || mode == kBandOnly;
  if (!s.fits && mode == kBandOnly) {  // keep what the budget holds
    if (s.ny <= budget) {
      s.nz = budget / s.ny;
    } else {
      s.nz = 1;
      s.ny = budget;
    }
  }
  return s;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Staging a span of rows3[n] into the ring: staged row r (z = zlo + r / ny,
// y = ylo + r % ny) is rows3 row z*H + y as it is, C*W bf16 ([c][x]).  A
// z-slice's ny rows are contiguous in rows3, so a span is nz contiguous runs.
//
// vec (C*W % 8 == 0, rows3 16-byte aligned): one thread hands the runs to the
// copy engine (cp.async.bulk, one per z-slice) and they land on the block's
// mbarrier, which counts their bytes; the block waits on it before it
// samples the span.  Else every thread copies elements in turn and the
// mbarrier is only arrived at.  Either way each staging completes one phase.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrive that also expects `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

template <int C>
__device__ __forceinline__ void stage(unsigned short* ring, const unsigned short* src,
                                      const Span& s, int H, int W, int vec, uint64_t* bar) {
  const int CW = C * W;
  if (vec) {
    if (threadIdx.x == 0) {
      // the block's earlier reads of these rows (ordered by the caller's
      // barrier) before the copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const unsigned run = (unsigned)(s.ny * CW * 2);
      mbar_expect(bar, run * s.nz);
      for (int zi = 0; zi < s.nz; ++zi)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(smem_u32(ring + (long long)zi * s.ny * CW)),
            "l"(src + ((long long)(s.zlo + zi) * H + s.ylo) * CW), "r"(run), "r"(smem_u32(bar))
            : "memory");
    }
  } else {
    const int total = s.nz * s.ny * CW;
    for (int i = threadIdx.x; i < total; i += kBandThreads) {
      const int row = i / CW, j = i - row * CW;
      const int zi = row / s.ny, yi = row - zi * s.ny;
      ring[i] = src[((long long)(s.zlo + zi) * H + s.ylo + yi) * CW + j];
    }
    if (threadIdx.x == 0) mbar_expect(bar, 0);
  }
}

__device__ __forceinline__ float bf16_bits(unsigned v) { return __uint_as_float(v << 16); }

// A sample's corners (warp_fwd.cu's gather, split so that every load can
// be issued before the first product): per axis the two corners' weights,
// whether each lies inside, and its index (0 where it does not, so that
// every load reads a valid address; a corner outside is never added).
struct Corners {
  float w[3][2];
  bool in[3][2];
  int j[3][2];
};

__device__ __forceinline__ Corners corners(float px, float py, float pz, int D, int H, int W) {
  Corners k;
  const float g[3] = {px, py, pz};
  const int size[3] = {W, H, D};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = floorf(g[a]), t = g[a] - f;
    k.w[a][0] = 1.f - t;
    k.w[a][1] = t;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float jc = f + d;
      k.in[a][d] = inside(jc, size[a]);
      k.j[a][d] = k.in[a][d] ? (int)jc : 0;
    }
  }
  return k;
}

// One sample of C channels from [c][x] rows: rows3[n] in global memory
// (kStaged false: every row) or a staged span in shared memory (a corner
// outside its rows reads nothing).  Every load is issued before the first
// product; the products and their order are warp_fwd.cu's gather.
template <int C, bool kStaged>
__device__ __forceinline__ void sample(const unsigned short* __restrict__ rows, const Span& s,
                                       int D, int H, int W, float px, float py, float pz,
                                       float* acc) {
  const Corners k = corners(px, py, pz, D, H, W);
  const int CW = C * W;
  bool zy[2][2];
  float v[2][2][2][C];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      long long r;
      if (kStaged) {
        const int zr = k.j[2][dz] - s.zlo, yr = k.j[1][dy] - s.ylo;
        zy[dz][dy] = k.in[2][dz] && k.in[1][dy] && (unsigned)zr < (unsigned)s.nz &&
                     (unsigned)yr < (unsigned)s.ny;
        r = zy[dz][dy] ? zr * s.ny + yr : 0;
      } else {
        zy[dz][dy] = k.in[2][dz] && k.in[1][dy];
        r = (long long)k.j[2][dz] * H + k.j[1][dy];
      }
      const unsigned short* row = rows + r * CW;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const unsigned short* e = row + c * W + k.j[0][dx];
          v[dz][dy][dx][c] = bf16_bits(kStaged ? *e : __ldg(e));
        }
    }
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      if (!zy[dz][dy]) continue;
      const float wzy = k.w[2][dz] * k.w[1][dy];
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        if (!k.in[0][dx]) continue;
        const float w = wzy * k.w[0][dx];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * v[dz][dy][dx][c];
      }
    }
}

__host__ __device__ inline long long align16(long long b) { return (b + 15) / 16 * 16; }

constexpr long long kMaxShared = 227 * 1024;  // the dynamic shared memory a block may ask for

// A block's dynamic shared memory: the mbarrier (16 bytes), the output tile
// (VB rows of `stride` bytes), the ring (`ring` staged rows of C*W bf16), the
// boxes' warp partials and spans (KB = 1 for blockwhen, else K1).
// launch_plan in proto_banded_warp.py mirrors it.
inline long long band_smem(int VB, int stride, int W, int C, long long ring, int KB) {
  return 16 + align16((long long)VB * stride) + align16(ring * C * W * 2) +
         (long long)KB * (kBandWarps * 16 + (long long)sizeof(Span));
}

// The ring's rows: all the rows the block's shared memory holds beside the
// rest, at least the budget.  Two consecutive boxes then go side by side
// more often; which boxes fit is still the budget's call.
inline int ring_rows(int VB, int stride, int W, int C, int budget, int KB) {
  const long long rest = kMaxShared - band_smem(VB, stride, W, C, 0, KB) - 15;
  return (int)max((long long)budget, rest / (C * W * 2));
}

// grid (NV / VB, N): one block per (source n, block of VB voxels)
template <int C, int MODE>
__global__ void __launch_bounds__(kBandThreads)
probe_banded_warp_kernel(const unsigned short* __restrict__ rows3, const float* __restrict__ gx,
                         const float* __restrict__ gy, const float* __restrict__ gz,
                         float* __restrict__ out, unsigned char* __restrict__ staged, int D,
                         int H, int W, int K1, int NV, int VB, int budget, int ring_rows,
                         int stride, int vec) {
  extern __shared__ int4 smem[];
  constexpr bool kUnion = MODE == kBlockWhen;
  const int KB = kUnion ? 1 : K1;
  const int CW = C * W;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* tile = reinterpret_cast<unsigned char*>(smem) + 16;
  unsigned short* ring =
      reinterpret_cast<unsigned short*>(tile + align16((long long)VB * stride));
  int* part = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(ring) + align16((long long)ring_rows * CW * 2));
  Span* spans = reinterpret_cast<Span*>(part + KB * kBandWarps * 4);
  const int n = blockIdx.y, blk = blockIdx.x;
  const unsigned short* src = rows3 + (long long)n * D * H * CW;
  const long long v0 = (long long)blk * VB;
  const long long cb = (long long)n * K1 * NV + v0;  // + k * NV + v: a coordinate
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) mbar_init(bar);

  // Every box of the block in one pass over its y and z coordinates, kBoxBatch
  // grids' loads in flight at once; x is prefetched into L2 for the sampling.
  Box u = empty_box();
  for (int k0 = 0; k0 < K1; k0 += kBoxBatch) {
    Box b[kBoxBatch];
#pragma unroll
    for (int j = 0; j < kBoxBatch; ++j) b[j] = empty_box();
    for (int v = threadIdx.x; v < VB; v += kBandThreads) {
      float ys[kBoxBatch], zs[kBoxBatch];
#pragma unroll
      for (int j = 0; j < kBoxBatch; ++j) {
        ys[j] = zs[j] = __int_as_float(0x7fc00000);  // NaN: adds no row
        if (k0 + j < K1) {
          const long long i = cb + (long long)(k0 + j) * NV + v;
          ys[j] = __ldg(gy + i);
          zs[j] = __ldg(gz + i);
          prefetch_l2(gx + i);
        }
      }
#pragma unroll
      for (int j = 0; j < kBoxBatch; ++j) extend(kUnion ? u : b[j], ys[j], zs[j], D, H);
    }
    if (!kUnion) {
#pragma unroll
      for (int j = 0; j < kBoxBatch; ++j)
        if (k0 + j < K1) warp_partial(b[j], part + ((k0 + j) * kBandWarps + warp) * 4);
    }
  }
  if (kUnion) warp_partial(u, part + warp * 4);
  __syncthreads();  // also publishes the mbarrier's initialisation
  for (int kb = threadIdx.x; kb < KB; kb += kBandThreads) {
    Box t = empty_box();
#pragma unroll
    for (int w = 0; w < kBandWarps; ++w) {
      const int* p = part + (kb * kBandWarps + w) * 4;
      unite(t, {p[0], p[1], p[2], p[3]});
    }
    const Span s = span(t, budget, MODE);
    spans[kb] = s;
    if (staged != nullptr) {
      const long long f = ((long long)n * gridDim.x + blk) * K1;
      if (kUnion)
        for (int k = 0; k < K1; ++k) staged[f + k] = s.fits;
      else
        staged[f + kb] = s.fits;
    }
  }
  __syncthreads();

  // grid k's samples into the tile, from the span at ring row `off` or from
  // global memory; (cx, cy, cz): this thread's first voxel's coordinates,
  // loaded one grid ahead
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (threadIdx.x < VB) {
    cx = __ldg(gx + cb + threadIdx.x);
    cy = __ldg(gy + cb + threadIdx.x);
    cz = __ldg(gz + cb + threadIdx.x);
  }
  auto run_k = [&](int k, const Span& s, int off) {
    float nx = 0.f, ny = 0.f, nz = 0.f;
    if (k + 1 < K1 && threadIdx.x < VB) {
      const long long i = cb + (long long)(k + 1) * NV + threadIdx.x;
      nx = __ldg(gx + i);
      ny = __ldg(gy + i);
      nz = __ldg(gz + i);
    }
    for (int v = threadIdx.x; v < VB; v += kBandThreads) {
      float px = cx, py = cy, pz = cz;
      if (v != threadIdx.x) {
        const long long i = cb + (long long)k * NV + v;
        px = __ldg(gx + i);
        py = __ldg(gy + i);
        pz = __ldg(gz + i);
      }
      float acc[C];
      if (s.use)
        sample<C, true>(ring + (long long)off * CW, s, D, H, W, px, py, pz, acc);
      else
        sample<C, false>(src, s, D, H, W, px, py, pz, acc);
      Pack<float, C> o;
#pragma unroll
      for (int c = 0; c < C; ++c) o.v[c] = acc[c];
      *reinterpret_cast<Pack<float, C>*>(tile + v * stride + k * C * 4) = o;
    }
    cx = nx;
    cy = ny;
    cz = nz;
  };

  unsigned parity = 0;  // of the mbarrier's next phase: one a staging
  if (kUnion) {
    const Span s = spans[0];
    if (s.use) {
      stage<C>(ring, src, s, H, W, vec, bar);
      mbar_wait(bar, parity);
    }
    __syncthreads();
    for (int k = 0; k < K1; ++k) run_k(k, s, 0);
  } else {
    Span cur = spans[0];
    int off = 0;  // cur's first ring row
    if (cur.use) stage<C>(ring, src, cur, H, W, vec, bar);
    for (int k = 0; k < K1; ++k) {
      if (cur.use) {  // cur has landed
        mbar_wait(bar, parity);
        parity ^= 1;
      }
      // ... and every thread sees it and is done with the span before it
      __syncthreads();
      const Span nxt = k + 1 < K1 ? spans[k + 1] : Span{0, 0, 0, 0, 0, 1};
      // nxt's ring rows: beside cur where they fit (copied while the block
      // samples cur), else from row 0 after a barrier
      const int rc = cur.nz * cur.ny, rn = nxt.nz * nxt.ny;
      bool beside = true;
      int noff = 0;
      if (cur.use && rn > off) {
        beside = off + rc + rn <= ring_rows;
        if (beside) noff = off + rc;
      }
      if (nxt.use && beside) stage<C>(ring + (long long)noff * CW, src, nxt, H, W, vec, bar);
      run_k(k, cur, off);
      if (nxt.use && !beside) {
        __syncthreads();
        stage<C>(ring, src, nxt, H, W, vec, bar);
      }
      cur = nxt;
      off = noff;
    }
  }
  __syncthreads();
  const int rowbytes = K1 * C * 4;
  copy_out<kBandThreads>(copy_unit(rowbytes, stride), tile, stride,
                         reinterpret_cast<unsigned char*>(out + (n * (long long)NV + v0) * K1 * C),
                         rowbytes, VB);
}

template <int C, int MODE>
int launch_banded(const void* rows3, const float* gx, const float* gy, const float* gz,
                  float* out, unsigned char* staged, int N, int D, int H, int W, int K1, int NV,
                  int VB, int budget, int vec, cudaStream_t stream) {
  const int stride = tile_stride(K1 * C * 4, C * 4);
  const int KB = MODE == kBlockWhen ? 1 : K1;
  const int rows = ring_rows(VB, stride, W, C, budget, KB);
  const long long smem = band_smem(VB, stride, W, C, rows, KB);
  if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
  auto kernel = probe_banded_warp_kernel<C, MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((unsigned)(NV / VB), (unsigned)N), kBandThreads, (size_t)smem, stream>>>(
      static_cast<const unsigned short*>(rows3), gx, gy, gz, out, staged, D, H, W, K1, NV, VB,
      budget, rows, stride, vec);
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

// C in {1, 2, 4}; vol a scratch of D*H*W*C fp32 (the channel-last table);
// vol and out 16-byte aligned.  Two launches.  Returns the cudaError_t of the
// launches (0 = success).
extern "C" int facevae_probe_warp(const float* volT, float* vol, const float* gx,
                                  const float* gy, const float* gz, float* out, int D, int H,
                                  int W, int C, int P, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DH = D * H;
  const unsigned tiles = (unsigned)(((DH + kRelayoutZY - 1) / kRelayoutZY) *
                                    (long long)((W + kRelayoutX - 1) / kRelayoutX));
  const dim3 grid((unsigned)((P + kThreads - 1) / kThreads));
  return for_channels(C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    if (tiles > 0) {  // an empty volume: no corner lies inside, the sampler writes zeros
      probe_relayout_kernel<kC><<<tiles, kThreads, 0, s>>>(volT, vol, DH, W);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    probe_warp_kernel<kC><<<grid, kThreads, 0, s>>>(vol, gx, gy, gz, out, D, H, W, P);
    return (int)cudaGetLastError();
  });
}

// mode 0 banded, 1 blockwhen, 2 bandonly; C in {1, 2, 4}; NV % VB == 0;
// budget >= 1 rows; vec = 1 when C*W % 8 == 0 and rows3 is 16-byte aligned;
// staged may be null; the block's shared memory (band_smem) at most 227 KB.
// Returns the cudaError_t of the launch.
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
