// The two gather probes for Hopper (sm_90a), hand-written CUDA C++.
//
// probe_gather_kernel replaces tools/microbench_pallas_gather.py:gather_kernel
// (called by run_case): out[s, p] = table[s, idx[s, p]], a lane-axis
// take_along_axis inside one Pallas block.
//
//   table [S, T] fp32, idx [S, P] int32 -> out [S, P] fp32
//
// probe_lane_gather_kernel replaces tools/microbench_lane_gather.py's
// closure `kernel` (its pallas_call in main): every block b gathers the same
// VB columns from each row of a [CW, DH] table,
//
//   data [CW, DH] bf16, idx [NB, 1, VB] int32 -> out [NB, CW, VB] bf16,
//   out[b, r, v] = data[r, idx[b, 0, v]].
//
// In both, an index outside [0, T) (or [0, DH)) reads 0: the probes draw
// every index in range, and the kernels never read outside the table.  Both
// copy the table's bits, so they agree bit for bit with the plain versions.
//
// What bounds them on an H100: at the probes' sizes the launch, not bytes.
// probe_gather moves at most 5.24 MB (the (16, 65536, 8192) case: a 4 MB
// table, 0.5 MB of indices, 0.5 MB out), 1.6 us at 3.35 TB/s, and its
// small cases move a few KB: every case takes about the time of an empty
// kernel launched in the same grid (probe_gather_floor_kernel, which the
// probe times beside it).  The lane gather moves 34.3 MB (a 512 KB table,
// 256 KB of indices, 33.5 MB out), 10.2 us.  Every table fits the 50 MB L2,
// so the scattered reads cost L2 latency, not DRAM bytes.
//
// Design: probe_gather runs a 2-D grid, blockIdx.y a row s (a grid-stride
// loop past 65535 rows), so no thread divides; each thread takes 4
// consecutive p of its row: one 16-byte index load and one 16-byte store
// where P % 4 == 0 and the pointers are 16-byte aligned (every probe case),
// else 4 scalar loads and stores (the last thread of a row takes the tail).
// The table reads go through the read-only cache; nothing is staged in
// shared memory (a gather of at most 4 values a thread from an L2-resident
// row gains nothing from a copy of the row first).  The lane gather runs
// one thread per 16-byte chunk [b, r, v:v+8] of the output, so a
// warp stores 512 contiguous bytes; the thread reads its 8 indices as two
// 16-byte loads (shared by the CW rows of block b, so L1 serves all but the
// first) and 8 bf16 values scattered within the 2 KB row r.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pick(const float* __restrict__ row, int j, int T) {
  return (j >= 0 && j < T) ? __ldg(row + j) : 0.f;
}

// Each thread: out[s, p:p+4] for p = 4 * (blockIdx.x * kThreads + threadIdx.x).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                    float* __restrict__ out, int S, int T, int P) {
  const long long p = 4LL * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (p >= P) return;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const float* row = table + (long long)s * T;
    const long long o = (long long)s * P + p;
    if (kVec) {
      const int4 j = __ldg(reinterpret_cast<const int4*>(idx + o));
      *reinterpret_cast<float4*>(out + o) =
          make_float4(pick(row, j.x, T), pick(row, j.y, T), pick(row, j.z, T), pick(row, j.w, T));
    } else {
      const int n = P - p < 4 ? (int)(P - p) : 4;
      for (int q = 0; q < n; ++q) out[o + q] = pick(row, __ldg(idx + o + q), T);
    }
  }
}

// The launch floor: the same grid and block as probe_gather_kernel, no work.
__global__ void __launch_bounds__(kThreads)
probe_gather_floor_kernel(const float* __restrict__, const int* __restrict__,
                          float* __restrict__, int, int, int) {}

struct alignas(16) Chunk {
  unsigned short v[8];  // 8 bf16 values, as bits
};

__global__ void __launch_bounds__(kThreads)
probe_lane_gather_kernel(const unsigned short* __restrict__ data, const int* __restrict__ idx,
                         unsigned short* __restrict__ out, int CW, int DH, int NB, int VB) {
  const int cpr = VB / 8;  // chunks per output row
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)NB * CW * cpr) return;
  const long long row = t / cpr;  // b * CW + r
  const int c = (int)(t - row * cpr);
  const int r = (int)(row % CW);
  const long long b = row / CW;
  const int4* ip = reinterpret_cast<const int4*>(idx + b * VB + c * 8);
  const int4 i0 = __ldg(ip), i1 = __ldg(ip + 1);
  const int js[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
  const unsigned short* src = data + (long long)r * DH;
  Chunk o;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    o.v[q] = (js[q] >= 0 && js[q] < DH) ? __ldg(src + js[q]) : (unsigned short)0;
  *reinterpret_cast<Chunk*>(out + row * VB + c * 8) = o;
}

}  // namespace

// x: 4 outputs a thread along P; y: a row each, at most 65535 (grid-stride).
static dim3 gather_grid(int S, int P) {
  const long long threads = ((long long)P + 3) / 4;
  return dim3((unsigned)((threads + kThreads - 1) / kThreads), (unsigned)(S < 65535 ? S : 65535));
}

// Each returns the cudaError_t of its launch (0 = success).
// vec: P % 4 == 0 and idx, out 16-byte aligned (the wrapper checks).
extern "C" int facevae_probe_gather(const float* table, const int* idx, float* out, int S,
                                    int T, int P, int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    probe_gather_kernel<true><<<gather_grid(S, P), kThreads, 0, st>>>(table, idx, out, S, T, P);
  else
    probe_gather_kernel<false><<<gather_grid(S, P), kThreads, 0, st>>>(table, idx, out, S, T, P);
  return (int)cudaGetLastError();
}

extern "C" int facevae_probe_gather_floor(const float* table, const int* idx, float* out,
                                          int S, int T, int P, void* stream) {
  probe_gather_floor_kernel<<<gather_grid(S, P), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(table, idx, out, S, T, P);
  return (int)cudaGetLastError();
}

// VB % 8 == 0, idx and out 16-byte aligned (the wrapper checks).
extern "C" int facevae_probe_lane_gather(const void* data, const int* idx, void* out, int CW,
                                         int DH, int NB, int VB, void* stream) {
  const long long n = (long long)NB * CW * (VB / 8);
  probe_lane_gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(data), idx, static_cast<unsigned short*>(out), CW, DH,
      NB, VB);
  return (int)cudaGetLastError();
}
