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
// of source and 6.3 MB of grid and writes 67 MB (0.042 ms at 3.35 TB/s); the
// dgrid kernel also reads gout (67 MB) and writes 6.3 MB; the dx kernel reads
// the grid and gout and writes 67 MB of dx through 34M float4 atomics.  At
// the reference-form MFE call (C=4, gps=16) the grid is 101 MB and the
// samples 134 MB.  PERF.md holds the measured times.
//
// The forward.  Its first design ran a thread per (g, v, channel vector), as
// the backward kernels below do: at C = 32 the 8 threads of a voxel each
// loaded the same coordinates and took the same floors, weights, inside tests
// and float-to-int conversions (3 a corner), and each summed its corners
// load by load.  It ran at 36-54% of its byte bound, and bf16 was no faster
// than fp32 at the reference form.  Variants timed against it in one call
// each (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6) showed what held it back:
// the instructions of the coordinate work (a conversion runs at a quarter of
// the FMA rate) and too few loads in flight a thread.  Now:
//   - corners() does a voxel's coordinate work once: 3 floors and 3
//     conversions, the 8 indices from one base in unsigned arithmetic, the 8
//     weights as the first design's products;
//   - C == CPT (the reference form's C = 4): grid_fwd_voxel_kernel, a thread
//     per 4 voxels of a grid (one from each quarter of the launch, so each
//     round of a warp stays coalesced): it loads all 4 voxels' coordinates
//     first, keeps each corner table in registers and issues the corners'
//     loads two at a time (at most 64 registers, 4 blocks an SM);
//   - C > CPT (the Generator's C = 32): grid_fwd_table_kernel, a block per
//     (g, 256 voxels).  A thread per voxel writes its corner table to shared
//     memory; then the block walks the (voxel, channel vector) items, the
//     vector fastest, so a warp's corner loads still read whole rows.  fp32
//     issues all 8 loads before its sums (64 registers, 4 blocks an SM);
//     bf16 leaves their order to the compiler in 32 registers (batched, it
//     spilled or lost blocks and ran slower).  At N = 1 (evaluation's gif
//     modes) its 256 blocks fill the 132 SMs in one wave, where the first
//     design's 2048 took two;
//   - the grid is read and the output written evict-first (__ldcs, __stcs):
//     each is touched once.  1-2% at every set.
// The same corners in the order z, y, x, the same weight products and the
// same fp32 sums in the same order, rounded once: the output is bit for bit
// the first design's (bench_warp.py's digests) and kernel 1's at K1 = 1.
// Measured and dropped (PERF.md §6): the block's source box staged in shared
// memory where it fits (40 or 80 KB, chosen per block): slower than the table
// kernel at every set and 1.3-4.3x the first design's time at bf16 and at
// the reference form, where the boxes of rotated grids are many times their
// footprint; the x corners carried in registers along runs of voxels (1.1-1.2x
// the same walk without it); output tiles of 2x4x32, 4x8x8 or 1x16x16 voxels
// in place of 256 consecutive ones (mixed at the Generator, 1.4-1.7x at the
// reference form); the coordinates copied through shared memory (1.4x); bf16
// loaded in 8-byte vectors so that it can batch as fp32 does (1.0-1.2x the
// 16-byte ones).
//
// The backward kernels run threads per (g, v, vector of CPT channels) (16
// bytes where C allows it), so gout is read contiguously across a warp
// (unlike warp_fwd.cu's k-major output); blockIdx.y is g.  The dx kernel
// runs one thread per channel vector.  The dgrid kernel sums a dot product
// over all C channels per corner: it runs LANES threads per (g, v) (the power
// of two >= C / CPT, at most 32), each loading its cotangent vector once and
// reading one coalesced vector of each corner, and reduces the three partial
// sums over the voxel's lanes with __shfl_xor_sync; lanes 0-2 store them.
// Its first design, a thread per (g, v) reading every vector of gout again at
// each of the 8 corners (64 loads where 8 do at the fp32 Generator, none
// coalesced across the warp), was slower than F.grid_sample's backward
// (PERF.md §6).
// The dx kernel is bound by its atomics, not its bytes: 8 corners x C / CPT
// vector atomics per (g, v), 33.5M float4 ones at the fp32 Generator call
// against a 67 MB byte bound of 42 us.  It pairs corners across lanes before
// the atomic, as warp_bwd.cu's dx kernel does: lane l holds voxel v's
// channel vector cv and lane l - cvs (cvs = C / CPT) the same vector of
// voxel v - 1, so for each (dz, dy) lane l takes lane l - cvs's upper x
// corner by a shuffle where it is its own lower one, adds it to its own, and
// the giver skips that atomic.  No lane returns early: a lane past the last
// voxel takes part with a NaN coordinate, whose corners all lie outside.  At
// the fp32 Generator's own grid in a training step 29% of the atomics pair
// (a warp holds 4 voxels there, so at most 3 of 4 upper corners can), and
// the kernel takes 18% less time than without the pairing; at the
// reference form (cvs = 1) 17% less (PERF.md §6).  Walking runs of 8
// voxels along W per thread, the upper corner carried in registers into the
// next voxel's lower one (7 of 8 can pair), was built and measured: 1-2%
// slower at the Generator's step, 28% slower at the reference form.
// The dx kernel adds through a sink (warp_common.cuh): by default float4 /
// float2 atomics where the vector allows it, so the order of its sums, and
// the last bits of dx, vary from run to run; in deterministic mode
// (fast_warp.py, when torch.are_deterministic_algorithms_enabled()) a
// fixed-point int64 sum whose bits do not depend on the order, at the cost of
// scalar 64-bit atomics, the int64 buffer and a conversion pass.  The
// contributions are made into int64 before the shuffle, so the pairing keeps
// that mode's bits.
#include "warp_common.cuh"

namespace {

using namespace facevae_warp;

// normalized -> pixel coordinate, in the JAX package's order of operations
__device__ __forceinline__ float unnormalize(float g, int size) {
  return (g + 1.f) * 0.5f * (float)(size - 1);
}

// Calls f(k, j, w) for the 8 corners k = 4 dz + 2 dy + dx of the pixel
// coordinates (px, py, pz), in that order: j the corner's voxel index in the
// volume [D, H, W], -1 outside it (NaN and +-inf coordinates too), w its
// weight (w_z * w_y, then * w_x).  Three float-to-int conversions a voxel:
// the lower corner's index is formed in wrapping unsigned arithmetic from the
// floors converted with saturation, and used only for a corner inside the
// volume, where every floor lies in [-1, size - 1].
template <class F>
__device__ __forceinline__ void corners(float px, float py, float pz, int D, int H, int W, F&& f) {
  const Axis ax = axis(px), ay = axis(py), az = axis(pz);
  const bool xin[2] = {inside(ax.f, W), inside(ax.f + 1.f, W)};
  const bool yin[2] = {inside(ay.f, H), inside(ay.f + 1.f, H)};
  const bool zin[2] = {inside(az.f, D), inside(az.f + 1.f, D)};
  const unsigned base = ((unsigned)__float2int_rz(az.f) * (unsigned)H +
                         (unsigned)__float2int_rz(ay.f)) * (unsigned)W +
                        (unsigned)__float2int_rz(ax.f);
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float wz = dz ? az.t : 1.f - az.t;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wzy = wz * (dy ? ay.t : 1.f - ay.t);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const unsigned d = ((unsigned)dz * H + dy) * W + dx;
        f(dz * 4 + dy * 2 + dx, zin[dz] && yin[dy] && xin[dx] ? (int)(base + d) : -1,
          wzy * (dx ? ax.t : 1.f - ax.t));
      }
    }
  }
}

// the pixel coordinates of grid entry p (the grid is streamed once: loads
// marked evict-first)
template <class F>
__device__ __forceinline__ void grid_corners(const float* p, int D, int H, int W, F&& f) {
  corners(unnormalize(__ldcs(p), W), unnormalize(__ldcs(p + 1), H),
          unnormalize(__ldcs(p + 2), D), D, H, W, f);
}

// CPT channels of one output voxel, stored evict-first (written once)
template <typename T, int CPT>
__device__ __forceinline__ void put(T* dst, const Pack<T, CPT>& o) {
  using U = typename Unit<sizeof(Pack<T, CPT>)>::type;
  __stcs(reinterpret_cast<U*>(dst), *reinterpret_cast<const U*>(&o));
}

// CPT channels of one output voxel from the corner table off[k * S], w[k * S]
// (S: its stride): the corners' loads BATCH at a time, each batch issued
// before its sums, the sums in corner order, rounded once
template <typename T, int CPT, int BATCH, int S>
__device__ __forceinline__ Pack<T, CPT> sample(const T* __restrict__ src, int C,
                                               const int* off, const float* w) {
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += BATCH) {
    Pack<T, CPT> val[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int j = off[(k0 + k) * S];
      if (j >= 0) val[k] = *reinterpret_cast<const Pack<T, CPT>*>(src + (long long)j * C);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (off[(k0 + k) * S] < 0) continue;
      const float wk = w[(k0 + k) * S];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += wk * to_float(val[k].v[c]);
    }
  }
  Pack<T, CPT> o;
#pragma unroll
  for (int c = 0; c < CPT; ++c) store(&o.v[c], acc[c]);
  return o;
}

// Voxels a thread of the voxel kernel, corner loads issued before their
// sums, and blocks an SM (the register cap of __launch_bounds__), as
// measured (PERF.md §6)
constexpr int kVoxelsPerThread = 4, kVoxelBatch = 2, kVoxelBlocks = 4;
template <typename T>
constexpr int kTableBatch = sizeof(T) == 4 ? 8 : 1;
template <typename T>
constexpr int kTableBlocks = sizeof(T) == 4 ? 4 : 8;

// C == CPT (one channel vector a voxel): a thread per kVoxelsPerThread
// voxels of grid g, v + j * 256 * gridDim.x (so each j reads and writes
// coalesced runs), all of whose coordinates it loads before its first
// corner
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads, kVoxelBlocks)
grid_fwd_voxel_kernel(const T* __restrict__ x, const float* __restrict__ grid,
                      T* __restrict__ out, int D, int H, int W, int C, int gps, int NV) {
  const int g = blockIdx.y;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long v0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float* gg = grid + (long long)g * NV * 3;
  float p[kVoxelsPerThread][3];
#pragma unroll
  for (int j = 0; j < kVoxelsPerThread; ++j) {
    const long long v = v0 + j * stride;
#pragma unroll
    for (int a = 0; a < 3; ++a) p[j][a] = v < NV ? __ldcs(gg + v * 3 + a) : 0.f;
  }
  const T* xn = x + (long long)(g / gps) * D * H * W * C;
  T* og = out + (long long)g * NV * C;
#pragma unroll
  for (int j = 0; j < kVoxelsPerThread; ++j) {
    const long long v = v0 + j * stride;
    if (v >= NV) break;
    int off[8];
    float w[8];
    corners(unnormalize(p[j][0], W), unnormalize(p[j][1], H), unnormalize(p[j][2], D), D, H, W,
            [&](int k, int jj, float wk) {
              off[k] = jj;
              w[k] = wk;
            });
    put<T, CPT>(og + v * C, sample<T, CPT, kVoxelBatch, 1>(xn, C, off, w));
  }
}

// C > CPT: a block per (g, kThreads voxels); a thread per voxel writes its
// corner table to shared memory, then the block's threads take the
// (voxel, channel vector) items, the vector fastest
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads, kTableBlocks<T>)
grid_fwd_table_kernel(const T* __restrict__ x, const float* __restrict__ grid,
                      T* __restrict__ out, int D, int H, int W, int C, int gps, int NV) {
  __shared__ int s_off[8][kThreads];
  __shared__ float s_w[8][kThreads];
  const int g = blockIdx.y;
  const int i = threadIdx.x;
  const long long v0 = (long long)blockIdx.x * kThreads;
  const int nv = (int)min((long long)kThreads, NV - v0);
  if (i < nv)
    grid_corners(grid + ((long long)g * NV + v0 + i) * 3, D, H, W, [&](int k, int j, float wk) {
      s_off[k][i] = j;
      s_w[k][i] = wk;
    });
  __syncthreads();
  const int cvs = C / CPT;
  const T* xn = x + (long long)(g / gps) * D * H * W * C;
  T* og = out + ((long long)g * NV + v0) * C;
  for (int it = i; it < nv * cvs; it += kThreads) {
    const int vl = it / cvs;
    put<T, CPT>(og + (long long)it * CPT, sample<T, CPT, kTableBatch<T>, kThreads>(
                                              xn + (it - vl * cvs) * CPT, C, &s_off[0][vl],
                                              &s_w[0][vl]));
  }
}

constexpr unsigned kFull = 0xffffffffu;

// LANES threads per (g, v) (a power of two >= C / CPT, at most 32), each
// summing the dot products of its channel vectors: cv = lane, lane + LANES...
template <typename T, int CPT, int LANES>
__global__ void __launch_bounds__(kThreads)
grid_dgrid_kernel(const T* __restrict__ x, const float* __restrict__ grid,
                  const T* __restrict__ gout, float* __restrict__ dgrid, int D, int H,
                  int W, int C, int gps, int NV) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int v = (int)(t / LANES);
  const int lane = threadIdx.x & (LANES - 1);
  // no early return: the LANES lanes of a voxel reduce with shuffles below
  const bool live = v < NV;
  const int g = blockIdx.y;
  const long long gv = (long long)g * NV + v;
  const T* xn = x + (long long)(g / gps) * D * H * W * C;
  const T* go = gout + gv * C;

  float ddx = 0.f, ddy = 0.f, ddz = 0.f;
  if (live) {
    const float* p = grid + gv * 3;
    const Axis ax = axis(unnormalize(p[0], W)), ay = axis(unnormalize(p[1], H)),
               az = axis(unnormalize(p[2], D));
    for (int c = lane * CPT; c < C; c += LANES * CPT) {
      // this lane's cotangent vector, loaded once for the 8 corners
      const Pack<T, CPT> o = *reinterpret_cast<const Pack<T, CPT>*>(go + c);
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
            const Pack<T, CPT> s = *reinterpret_cast<const Pack<T, CPT>*>(
                xn + (((long long)(int)zc * H + (int)yc) * W + (int)xc) * C + c);
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < CPT; ++i) dot += to_float(o.v[i]) * to_float(s.v[i]);
            ddx += sx * wy * wz * dot;
            ddy += wx * sy * wz * dot;
            ddz += wx * wy * sz * dot;
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = LANES / 2; o > 0; o /= 2) {
    ddx += __shfl_xor_sync(kFull, ddx, o);
    ddy += __shfl_xor_sync(kFull, ddy, o);
    ddz += __shfl_xor_sync(kFull, ddz, o);
  }
  // lanes 0, 1, 2 of the voxel store its x, y, z: three neighbouring floats
  if (live && lane < 3)
    dgrid[gv * 3 + lane] = lane == 0 ? ddx * ((float)(W - 1) * 0.5f)
                         : lane == 1 ? ddy * ((float)(H - 1) * 0.5f)
                                     : ddz * ((float)(D - 1) * 0.5f);
  if (LANES < 3 && live && lane == 0) {  // fewer lanes than outputs
    if (LANES == 1) dgrid[gv * 3 + 1] = ddy * ((float)(H - 1) * 0.5f);
    dgrid[gv * 3 + 2] = ddz * ((float)(D - 1) * 0.5f);
  }
}

// A thread per (g, v, channel vector cv); lane l holds voxel v's vector cv
// and lane l - cvs the same vector of voxel v - 1 (cvs = C / CPT).
template <typename T, int CPT, class Sink>
__global__ void __launch_bounds__(kThreads)
grid_dx_kernel(const float* __restrict__ grid, const T* __restrict__ gout, Sink sink, int D,
               int H, int W, int C, int gps, int NV) {
  sink.prepare();
  const int cvs = C / CPT;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // no early return: the lanes of a warp exchange corners below; a lane past
  // the last voxel takes part with a NaN coordinate, whose corners all lie
  // outside
  const bool live = t < (long long)NV * cvs;
  const int v = live ? (int)(t / cvs) : 0;
  const int cv = live ? (int)(t - (long long)v * cvs) : 0;
  const int g = blockIdx.y;
  const long long gv = (long long)g * NV + v;
  const float* p = grid + gv * 3;
  const float nan = __int_as_float(0x7fc00000);
  const Axis ax = axis(live ? unnormalize(p[0], W) : nan),
             ay = axis(live ? unnormalize(p[1], H) : nan),
             az = axis(live ? unnormalize(p[2], D) : nan);
  const long long dn = (long long)(g / gps) * D * H * W * C + cv * CPT;
  Pack<T, CPT> o{};
  if (live) o = *reinterpret_cast<const Pack<T, CPT>*>(gout + gv * C + cv * CPT);
  float go[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) go[i] = to_float(o.v[i]);
  const bool x0in = inside(ax.f, W), x1in = inside(ax.f + 1.f, W);
  const float wx0 = 1.f - ax.t, wx1 = ax.t;

#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float zc = az.f + dz;
    const float wz = dz ? az.t : 1.f - az.t;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yc = ay.f + dy;
      const bool row_in = inside(zc, D) && inside(yc, H);
      const float wzy = wz * (dy ? ay.t : 1.f - ay.t);
      const int row = row_in ? ((int)zc * H + (int)yc) * W : 0;
      // the voxels of the lower and upper x corners, -1 outside the volume
      const int lo = row_in && x0in ? row + (int)ax.f : -1;
      const int hi = row_in && x1in ? row + (int)ax.f + 1 : -1;
      // along W the upper corner of voxel v - 1 (lane l - cvs, the same
      // channel vector) is often the lower corner of voxel v, which then adds
      // both and lane l - cvs skips its atomic; which lanes pair depends on
      // the coordinates alone (at cvs >= 32 none do)
      const int prev_hi = __shfl_up_sync(kFull, hi, cvs);
      const bool take = lane >= cvs && lo >= 0 && prev_hi == lo;
      const bool given = __shfl_down_sync(kFull, (int)take, cvs) && lane + cvs < 32;
      const float w0 = wzy * wx0, w1 = wzy * wx1;
      const long long e0 = dn + (long long)lo * C, e1 = dn + (long long)hi * C;
      typename Sink::V s0[CPT], s1[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        s0[i] = lo >= 0 ? sink.make(w0 * go[i], e0 + i) : 0;
        s1[i] = hi >= 0 ? sink.make(w1 * go[i], e1 + i) : 0;
        const typename Sink::V q = __shfl_up_sync(kFull, s1[i], cvs);
        if (take) s0[i] += q;
      }
      if (lo >= 0) sink.template add<CPT>(e0, s0);
      if (hi >= 0 && !given) sink.template add<CPT>(e1, s1);
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
// launch (0 = success).  facevae_grid_fwd's launched (may be null): the
// launch's grid x, y, z and threads a block are written there.  The forward
// launches (ceil(NV / 1024), G) blocks of 256 threads of
// grid_fwd_voxel_kernel where C == cpt, else (ceil(NV / 256), G) of
// grid_fwd_table_kernel (fast_warp._grid_fwd_plan mirrors this); it indexes
// source voxels and a block's 256 * C / cpt items with 32-bit ints (the
// wrapper refuses more).
extern "C" int facevae_grid_fwd(const void* x, const float* grid, void* out, int D, int H,
                                int W, int C, int gps, int G, int NV, int dtype, int cpt,
                                void* stream, unsigned* launched) {
  return dispatch(dtype, cpt, [&](auto t, auto c) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int CPT = decltype(c)::value;
    const int per_block = kThreads * (C == CPT ? kVoxelsPerThread : 1);
    const dim3 b((unsigned)(((long long)NV + per_block - 1) / per_block), (unsigned)G);
    record_launch(launched, b, kThreads);
    const auto kernel = C == CPT ? grid_fwd_voxel_kernel<T, CPT> : grid_fwd_table_kernel<T, CPT>;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    kernel<<<b, kThreads, 0, s>>>(static_cast<const T*>(x), grid, static_cast<T*>(out), D, H, W,
                                  C, gps, NV);
  });
}

extern "C" int facevae_grid_bwd_dgrid(const void* x, const float* grid, const void* gout,
                                      float* dgrid, int D, int H, int W, int C, int gps,
                                      int G, int NV, int dtype, int cpt, void* stream) {
  const int cvs = C / cpt;
  const int lanes = cvs <= 1 ? 1 : cvs <= 2 ? 2 : cvs <= 4 ? 4 : cvs <= 8 ? 8
                  : cvs <= 16 ? 16 : 32;
  return dispatch(dtype, cpt, [&](auto t, auto c) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int CPT = decltype(c)::value;
    const dim3 b = blocks((long long)NV * lanes, G);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* xs = static_cast<const T*>(x);
    const T* go = static_cast<const T*>(gout);
    switch (lanes) {
      case 1: grid_dgrid_kernel<T, CPT, 1><<<b, kThreads, 0, s>>>(xs, grid, go, dgrid, D, H, W, C, gps, NV); break;
      case 2: grid_dgrid_kernel<T, CPT, 2><<<b, kThreads, 0, s>>>(xs, grid, go, dgrid, D, H, W, C, gps, NV); break;
      case 4: grid_dgrid_kernel<T, CPT, 4><<<b, kThreads, 0, s>>>(xs, grid, go, dgrid, D, H, W, C, gps, NV); break;
      case 8: grid_dgrid_kernel<T, CPT, 8><<<b, kThreads, 0, s>>>(xs, grid, go, dgrid, D, H, W, C, gps, NV); break;
      case 16: grid_dgrid_kernel<T, CPT, 16><<<b, kThreads, 0, s>>>(xs, grid, go, dgrid, D, H, W, C, gps, NV); break;
      default: grid_dgrid_kernel<T, CPT, 32><<<b, kThreads, 0, s>>>(xs, grid, go, dgrid, D, H, W, C, gps, NV);
    }
  });
}

template <class Sink>
int launch_grid_dx(const float* grid, const void* gout, Sink sink, int D, int H, int W, int C,
                   int gps, int G, int NV, int dtype, int cpt, cudaStream_t s) {
  return dispatch(dtype, cpt, [&](auto t, auto c) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int CPT = decltype(c)::value;
    grid_dx_kernel<T, CPT, Sink><<<blocks((long long)NV * (C / CPT), G), kThreads, 0, s>>>(
        grid, static_cast<const T*>(gout), sink, D, H, W, C, gps, NV);
  });
}

extern "C" int facevae_grid_bwd_dx(const float* grid, const void* gout, float* dx, int D,
                                   int H, int W, int C, int gps, int G, int NV, int dtype,
                                   int cpt, void* stream) {
  return launch_grid_dx(grid, gout, FloatSink{dx}, D, H, W, C, gps, G, NV, dtype, cpt,
                        static_cast<cudaStream_t>(stream));
}

// The deterministic dx: grid_dx_kernel with FixedSink into acc (int64,
// zeroed) and flags (one word per 8 elements, zeroed) at the scale exponent
// *scale_exp, then fixed_to_float_kernel into dx (fp32).
extern "C" int facevae_grid_bwd_dx_det(const float* grid, const void* gout, void* acc,
                                       void* flags, const int* scale_exp, float* dx, int D,
                                       int H, int W, int C, int gps, int G, int NV, int dtype,
                                       int cpt, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FixedSink sink{static_cast<unsigned long long*>(acc), static_cast<unsigned int*>(flags),
                       scale_exp, 0};
  const int err = launch_grid_dx(grid, gout, sink, D, H, W, C, gps, G, NV, dtype, cpt, s);
  if (err) return err;
  return launch_fixed_to_float(acc, flags, scale_exp, dx,
                               (long long)(G / gps) * D * H * W * C, s);
}
