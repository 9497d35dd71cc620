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
// What bounds them on an H100: bytes, and at the probes' sizes the launch.
// probe_gather moves at most 5.24 MB (the (16, 65536, 8192) case: a 4 MB
// table, 0.5 MB of indices, 0.5 MB out), 1.6 us at 3.35 TB/s; the lane
// gather moves 34.3 MB (a 512 KB table, 256 KB of indices, 33.5 MB out),
// 10.2 us.  Every table fits the 50 MB L2, so the scattered reads cost L2
// latency, not DRAM bytes.
//
// Design: probe_gather runs one thread per output element; neighbouring
// threads read neighbouring indices and write neighbouring outputs (both
// coalesced), and the table read goes through the read-only cache.  The lane
// gather runs one thread per 16-byte chunk [b, r, v:v+8] of the output, so a
// warp stores 512 contiguous bytes; the thread reads its 8 indices as two
// 16-byte loads (shared by the CW rows of block b, so L1 serves all but the
// first) and 8 bf16 values scattered within the 2 KB row r.  Neither stages
// anything in shared memory: the TPU kernels' VMEM blocks exist for the
// TPU's memory, and on this card the tables already sit in L1/L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                    float* __restrict__ out, int S, int T, int P) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)S * P) return;
  const long long s = i / P;
  const int j = __ldg(idx + i);
  out[i] = (j >= 0 && j < T) ? __ldg(table + s * T + j) : 0.f;
}

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

// Each returns the cudaError_t of its launch (0 = success).
extern "C" int facevae_probe_gather(const float* table, const int* idx, float* out, int S,
                                    int T, int P, void* stream) {
  const long long n = (long long)S * P;
  probe_gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
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
