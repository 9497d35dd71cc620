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
// The dgrid kernel's first design ran a thread per (n, k, v) that read its
// whole cotangent vector again at each of the 8 corners: at MFE (C = 4) 16 B
// at 240 B intervals, from gout rows whose 15 grids ran far apart in time
// (blockIdx.y = n * K1 + k) and that do not fit the 50 MB L2 (126 MB); at the
// Generator (C = 32) 64 loads a thread where 8 do, none coalesced.  Its
// design now (kernel 5's, warp_grid.cu, carried over to the k-major layout):
// LANES threads per (n, k, v), each holding VPL cotangent vectors in
// registers, loaded once, and reading one coalesced vector per corner for
// each; the voxel's lanes reduce with __shfl_xor_sync and lane 0 stores its
// three outputs (no atomics).  VPL is 2 of fp32 and 4 of bf16
// (dgrid_vecs): at the Generator's C = 32 that is 4 lanes of 32 B (fp32) and
// one lane holding the whole 64 B bf16 voxel.  At MFE's C = 4
// one lane holds the one vector: the first design's sums, the same bits.  The grid
// puts k fastest, blockIdx.x = voxel block * K1 + k and blockIdx.y = n, so
// the K1 grids that read one voxel block's gout rows run together and any
// volume the 32-bit voxel index holds fits (the first design's order, voxel blocks
// on x and n * K1 on y, measured with the same kernel: within 2.5% either
// way, set by set).  A shared-memory tile of each block's gout rows (the
// mirror of warp_fwd.cu's output tile) lost on MFE's sparse-motion
// coordinates.
//
// The dx kernel runs one thread per (n, k, v), blockIdx.y = n * K1 + k, so
// coordinate reads coalesce.  It (a) loads its cotangent vectors once
// (registers, up to 8 vectors) instead of at each corner, and (b) pairs
// corners across lanes before the global atomic: for each (dz, dy) the upper
// x corner of lane i is, on smooth maps, the lower x corner of lane i + 1
// (neighbouring v run along W), so lane i + 1 takes lane i's contribution
// with a shuffle, adds it to its own and lane i skips that atomic.  It adds
// through a sink (warp_common.cuh): by default fp32 atomicAdd on float4 /
// float2 where the vector allows it (sm_90), so the order of the sums, and
// the last bits of dx, vary from run to run; in deterministic mode
// (fast_warp.py, when torch.are_deterministic_algorithms_enabled()) a
// fixed-point int64 sum whose bits do not depend on the order, at the cost of
// scalar 64-bit atomics, the int64 buffer and a conversion pass.  Which lanes
// pair depends on the coordinates alone, and the int64 sums are exact, so the
// pairing keeps that mode's bits.
//
// Summing a block's corners in a shared-memory box first and flushing each
// box voxel with one atomic was built and measured (PERF.md §6): sm_90a
// has no native shared-memory fp32 add (it compiles to a compare-and-swap
// loop), and with integer sums the shared-memory adds, zeroing, flush and
// lower occupancy cost what the fewer global atomics saved: within 1.2% of
// the first design at the trained step's own MFE call, slower where the box
// rarely fits.  The pairing above works in registers instead.
#include "warp_common.cuh"

namespace {

using namespace facevae_warp;

constexpr unsigned kFull = 0xffffffffu;

// LANES threads per (n, k, v), each holding VPL of its cotangent vectors
// (c = lane * CPT, then every LANES * CPT channels) in registers for the 8
// corners, and summing their dot products with the corner's vectors; the
// voxel's lanes then reduce with shuffles.  blockIdx.x = voxel block * K1 +
// k (the K1 grids of one voxel block run side by side, so the k-major gout
// rows they read share sectors), blockIdx.y = n.
template <typename T, int CPT, int LANES, int VPL>
__global__ void __launch_bounds__(kThreads)
warp_bwd_dgrid_kernel(const T* __restrict__ x, const float* __restrict__ gx,
                      const float* __restrict__ gy, const float* __restrict__ gz,
                      const T* __restrict__ gout, float* __restrict__ dgx,
                      float* __restrict__ dgy, float* __restrict__ dgz,
                      int D, int H, int W, int C, int K1, int NV) {
  constexpr int kStride = LANES * CPT;  // channels between a lane's vectors
  const int k = blockIdx.x % K1;
  const long long t = (long long)(blockIdx.x / K1) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & (LANES - 1);
  // no early return: the LANES lanes of a voxel reduce with shuffles below
  const bool live = t < (long long)NV * LANES;
  const int v = live ? (int)(t / LANES) : 0;
  const int n = blockIdx.y;
  const long long ci = ((long long)n * K1 + k) * NV + v;
  const T* xn = x + (long long)n * D * H * W * C;
  const T* go = gout + ((long long)n * NV + v) * K1 * C + (long long)k * C;

  float ddx = 0.f, ddy = 0.f, ddz = 0.f;
  if (live) {
    const Axis ax = axis(gx[ci]), ay = axis(gy[ci]), az = axis(gz[ci]);
    for (int c0 = lane * CPT; c0 < C; c0 += VPL * kStride) {
      // this lane's cotangent vectors, loaded once for the 8 corners
      Pack<T, CPT> g[VPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        if (VPL == 1 || c0 + j * kStride < C)
          g[j] = *reinterpret_cast<const Pack<T, CPT>*>(go + c0 + j * kStride);
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
            const T* xj = xn + (((long long)(int)zc * H + (int)yc) * W + (int)xc) * C + c0;
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < VPL; ++j) {
              if (VPL > 1 && c0 + j * kStride >= C) break;
              const Pack<T, CPT> p = *reinterpret_cast<const Pack<T, CPT>*>(xj + j * kStride);
#pragma unroll
              for (int i = 0; i < CPT; ++i) dot += to_float(g[j].v[i]) * to_float(p.v[i]);
            }
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
  if (live && lane == 0) {
    dgx[ci] = ddx;
    dgy[ci] = ddy;
    dgz[ci] = ddz;
  }
}

// VECS: the cotangent vectors a thread holds in registers (a power of two
// >= C / CPT), or 0 where C is too wide: then each (dz, dy) re-reads them.
template <typename T, int CPT, int VECS, class Sink>
__global__ void __launch_bounds__(kThreads)
warp_bwd_dx_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                   const float* __restrict__ gz, const T* __restrict__ gout, Sink sink,
                   int D, int H, int W, int C, int K1, int NV) {
  sink.prepare();
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int nk = blockIdx.y;
  const int n = nk / K1;
  const int k = nk - n * K1;
  // no early return: the lanes of a warp exchange corners below; a lane past
  // NV takes part with a NaN coordinate, whose corners all lie outside
  const bool live = v < NV;
  const long long ci = (long long)nk * NV + v;
  const float nan = __int_as_float(0x7fc00000);
  const Axis ax = axis(live ? gx[ci] : nan), ay = axis(live ? gy[ci] : nan),
             az = axis(live ? gz[ci] : nan);
  const long long dn = (long long)n * D * H * W * C;  // dx[n]'s first element
  const T* go = gout + ((long long)n * NV + v) * K1 * C + (long long)k * C;

  // (a) the cotangent, loaded once
  float g[VECS > 0 ? VECS * CPT : 1];
  if constexpr (VECS > 0) {
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
      Pack<T, CPT> p{};
      if (live && j * CPT < C) p = *reinterpret_cast<const Pack<T, CPT>*>(go + j * CPT);
#pragma unroll
      for (int i = 0; i < CPT; ++i) g[j * CPT + i] = to_float(p.v[i]);
    }
  }
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
      // (b) along W the upper corner of lane i is often the lower corner of
      // lane i + 1, which then adds both and lane i skips its atomic.  Which
      // lanes pair depends on the coordinates alone.
      const int prev_hi = __shfl_up_sync(kFull, hi, 1);
      const bool take = lane > 0 && lo >= 0 && prev_hi == lo;
      const bool given = __shfl_down_sync(kFull, (int)take, 1) && lane < 31;
      const float w0 = wzy * wx0, w1 = wzy * wx1;
      const long long e0 = dn + (long long)lo * C, e1 = dn + (long long)hi * C;
      // one vector of CPT channels from channel c; every lane of a warp makes
      // the same calls (C is uniform), so the shuffles inside meet
      auto scatter = [&](int c, const float* gc) {
        typename Sink::V s0[CPT], s1[CPT];
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          s0[i] = lo >= 0 ? sink.make(w0 * gc[i], e0 + c + i) : 0;
          s1[i] = hi >= 0 ? sink.make(w1 * gc[i], e1 + c + i) : 0;
          const typename Sink::V p = __shfl_up_sync(kFull, s1[i], 1);
          if (take) s0[i] += p;
        }
        if (lo >= 0) sink.template add<CPT>(e0 + c, s0);
        if (hi >= 0 && !given) sink.template add<CPT>(e1 + c, s1);
      };
      if constexpr (VECS > 0) {
#pragma unroll
        for (int j = 0; j < VECS; ++j)
          if (j * CPT < C) scatter(j * CPT, g + j * CPT);
      } else {
        for (int c = 0; c < C; c += CPT) {
          Pack<T, CPT> p{};
          if (live) p = *reinterpret_cast<const Pack<T, CPT>*>(go + c);
          float gc[CPT];
#pragma unroll
          for (int i = 0; i < CPT; ++i) gc[i] = to_float(p.v[i]);
          scatter(c, gc);
        }
      }
    }
  }
}

dim3 grid_of(int N, int K1, int NV) {
  return dim3((unsigned)((NV + kThreads - 1) / kThreads), (unsigned)(N * K1));
}

// The cotangent vectors a dgrid lane holds where a voxel has more than one:
// 2 of fp32 (at C = 32, 4 lanes a voxel), 4 of bf16 (at C = 32, the whole
// voxel in one lane).  Of 1, 2, 4 and 8 at the Generator's C = 32 these were
// the fastest at its call in the training step (bf16) and on every set
// (fp32); 2 of bf16 was 2% faster on the noisy set and 11% slower on the
// smooth one (PERF.md §6).
template <typename T>
constexpr int dgrid_vecs() {
  return sizeof(T) == 4 ? 2 : 4;
}

// The dgrid kernel's lanes per (n, k, v): the power of two >= C / CPT /
// vecs (at least 1, at most 32); fast_warp.py:_dgrid_lanes mirrors it for
// its limit check.
int dgrid_lanes(int C, int cpt, int vecs) {
  const int per_lane = (C / cpt + vecs - 1) / vecs;
  int lanes = 1;
  while (lanes < per_lane && lanes < 32) lanes *= 2;
  return lanes;
}

template <typename T, int CPT>
void launch_dgrid(const void* x, const float* gx, const float* gy, const float* gz,
                  const void* gout, float* dgx, float* dgy, float* dgz, int N, int D,
                  int H, int W, int C, int K1, int NV, cudaStream_t s) {
  constexpr int kVecs = dgrid_vecs<T>();
  const int lanes = dgrid_lanes(C, CPT, kVecs);
  const long long vblocks = ((long long)NV * lanes + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(vblocks * K1), (unsigned)N);
  const T* xs = static_cast<const T*>(x);
  const T* go = static_cast<const T*>(gout);
#define FACEVAE_DGRID(L, V)                                                              \
  warp_bwd_dgrid_kernel<T, CPT, L, V><<<grid, kThreads, 0, s>>>(xs, gx, gy, gz, go, dgx, \
                                                                dgy, dgz, D, H, W, C, K1, NV)
  if (C <= CPT) {  // one vector a voxel
    FACEVAE_DGRID(1, 1);
    return;
  }
  switch (lanes) {
    case 1: FACEVAE_DGRID(1, kVecs); break;
    case 2: FACEVAE_DGRID(2, kVecs); break;
    case 4: FACEVAE_DGRID(4, kVecs); break;
    case 8: FACEVAE_DGRID(8, kVecs); break;
    case 16: FACEVAE_DGRID(16, kVecs); break;
    default: FACEVAE_DGRID(32, kVecs);
  }
#undef FACEVAE_DGRID
}

// The cotangent vectors a thread holds: the power of two >= C / CPT, or 0
// (re-read per row of corners) past 8 vectors.  Both forms were measured
// against one (PERF.md §6, PR 7): the re-read form alone at every C was
// 3-15% slower at MFE and the fp32 Generator; wider C held in chunks of 8
// vectors was 1.0-1.3% slower at MFE and built no faster.
int held_vectors(int C, int cpt) {
  const int nvec = C / cpt;
  return nvec <= 1 ? 1 : nvec <= 2 ? 2 : nvec <= 4 ? 4 : nvec <= 8 ? 8 : 0;
}

template <typename T, int CPT, class Sink>
void launch_dx(const float* gx, const float* gy, const float* gz, const void* gout, Sink sink,
               int N, int D, int H, int W, int C, int K1, int NV, cudaStream_t s) {
  const dim3 grid = grid_of(N, K1, NV);
  const T* go = static_cast<const T*>(gout);
  switch (held_vectors(C, CPT)) {
    case 1: warp_bwd_dx_kernel<T, CPT, 1, Sink><<<grid, kThreads, 0, s>>>(
                gx, gy, gz, go, sink, D, H, W, C, K1, NV); break;
    case 2: warp_bwd_dx_kernel<T, CPT, 2, Sink><<<grid, kThreads, 0, s>>>(
                gx, gy, gz, go, sink, D, H, W, C, K1, NV); break;
    case 4: warp_bwd_dx_kernel<T, CPT, 4, Sink><<<grid, kThreads, 0, s>>>(
                gx, gy, gz, go, sink, D, H, W, C, K1, NV); break;
    case 8: warp_bwd_dx_kernel<T, CPT, 8, Sink><<<grid, kThreads, 0, s>>>(
                gx, gy, gz, go, sink, D, H, W, C, K1, NV); break;
    default: warp_bwd_dx_kernel<T, CPT, 0, Sink><<<grid, kThreads, 0, s>>>(
                gx, gy, gz, go, sink, D, H, W, C, K1, NV);
  }
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
        gx, gy, gz, gout, FloatSink{dx}, N, D, H, W, C, K1, NV,
        static_cast<cudaStream_t>(stream));
  });
}

// The deterministic dx: the same kernel with FixedSink into acc (int64,
// zeroed) and flags (one word per 8 elements, zeroed) at the scale exponent
// *scale_exp, then fixed_to_float_kernel into dx (fp32).
extern "C" int facevae_warp_bwd_dx_det(const float* gx, const float* gy, const float* gz,
                                       const void* gout, void* acc, void* flags,
                                       const int* scale_exp, float* dx, int N, int D, int H,
                                       int W, int C, int K1, int NV, int dtype, int cpt,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FixedSink sink{static_cast<unsigned long long*>(acc), static_cast<unsigned int*>(flags),
                       scale_exp, 0};
  const int err = facevae_warp::dispatch(dtype, cpt, [&](auto t, auto c) {
    launch_dx<std::remove_pointer_t<decltype(t)>, decltype(c)::value>(
        gx, gy, gz, gout, sink, N, D, H, W, C, K1, NV, s);
  });
  if (err) return err;
  return launch_fixed_to_float(acc, flags, scale_exp, dx, (long long)N * D * H * W * C, s);
}
