// P3: slab-window dots reduced in the kernel to strided bin winners.
//
// Replaces the TPU kernel benchmarks/experiments/probe_r3_binned.py
// (binned_dots, pallas_call at :98; body make_binned_kernel :44-83).
//
// For each query the kernel forms K1's maskless dots over the flat
// [T * win] lanes of its T table windows (flat lane p = t * win + lane,
// CSR row row0[q, t] + lane) and keeps, for each of `nbins` strided bins
// (bin = p % nbins), the largest dot and the flat lane of the LOWEST row r
// (p = r * nbins + bin) that reaches it -- the TPU body's
// min(where(b == max, r, rows)) at :74-76.  Only vals [q, nbins] f32 and
// pos [q, nbins] int32 leave the kernel: the [q, T, win] dots are never
// written and the stage-1 top-k over them is gone.
//
// What bounds it on the H100: at the probe point (q = 8,192, T = 8, win =
// 640, d = 128) it reads the same window bytes as K1 (5.4 GB int8, 10.7 GB
// bf16, logical) and does the same ~11 GFLOP, but writes 8 MB instead of
// K1's 168 MB of dots: bandwidth-bound on the slab reads.
//
// Design: one block per query; the T window starts sit in shared memory.
// The block's threads form groups of G lanes (K1's row groups: a group
// reads one slab row as 16-byte chunks, the query chunk in registers, a
// shuffle tree sums).  Group g owns bins g, g + groups, ...; for each it
// walks r = 0 .. T*win/nbins - 1 upward, so adjacent groups read adjacent
// CSR rows, and keeps a running max with a strict '>': the lowest row wins
// ties, as on the TPU.

#include "slabrow.cuh"

namespace {

using namespace slabrow;

constexpr int kThreads = 256;

template <int DT, int CPL>
__global__ void __launch_bounds__(kThreads)
binned_kernel(const uint8_t* __restrict__ slab,
              const float* __restrict__ queries,
              const int32_t* __restrict__ row0,
              float* __restrict__ vals, int32_t* __restrict__ pos,
              int T, int win, int d, int nbins, int group) {
  constexpr int E = Elems<DT>::n;
  extern __shared__ int32_t srow0[];       // [T] absolute first rows
  const int qi = blockIdx.x;
  for (int t = threadIdx.x; t < T; t += kThreads) srow0[t] = row0[(size_t)qi * T + t];
  __syncthreads();

  const int chunks = d / E;
  const int lane = threadIdx.x % group;
  const int g = threadIdx.x / group;
  const int groups = kThreads / group;
  float qreg[CPL * E];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + j * group;
#pragma unroll
    for (int e = 0; e < E; ++e)
      qreg[j * E + e] = c < chunks ? queries[(size_t)qi * d + c * E + e] : 0.f;
  }
  const size_t row_bytes = (size_t)d * (16 / E);
  const int rows = T * win / nbins;

  // every lane runs every iteration, so the shuffles see full warps
  for (int b0 = 0; b0 < nbins; b0 += groups) {
    const int bin = b0 + g;
    const bool active = bin < nbins;
    float best = __int_as_float(0xff800000);   // -inf
    int best_r = 0;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      float acc = 0.f;
      if (active) {
        const int p = r * nbins + bin;
        const int t = p / win;
        const uint4* row = reinterpret_cast<const uint4*>(
            slab + ((size_t)srow0[t] + (p - t * win)) * row_bytes);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + j * group;
          if (c < chunks) acc = chunk_dot<DT>(__ldg(row + c), qreg + j * E, acc);
        }
      }
      for (int off = group / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (acc > best) {
        best = acc;
        best_r = r;
      }
    }
    if (active && lane == 0) {
      vals[(size_t)qi * nbins + bin] = best;
      pos[(size_t)qi * nbins + bin] = best_r * nbins + bin;
    }
  }
}

template <int DT>
int launch(const void* slab, const void* queries, const void* row0, void* vals,
           void* pos, int q, int T, int win, int d, int nbins,
           cudaStream_t stream) {
  constexpr int E = Elems<DT>::n;
  if (d % E != 0 || nbins <= 0 || (T * win) % nbins != 0)
    return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  const int chunks = d / E;
  const int group = row_group(chunks);
  const int cpl = (chunks + group - 1) / group;
  const size_t smem = (size_t)T * sizeof(int32_t);
#define BINNED_LAUNCH(C)                                                     \
  binned_kernel<DT, C><<<q, kThreads, smem, stream>>>(                       \
      (const uint8_t*)slab, (const float*)queries, (const int32_t*)row0,     \
      (float*)vals, (int32_t*)pos, T, win, d, nbins, group)
  switch (cpl) {
    case 1: BINNED_LAUNCH(1); break;
    case 2: BINNED_LAUNCH(2); break;
    case 3: BINNED_LAUNCH(3); break;
    case 4: BINNED_LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;   // row wider than 2048 B
  }
#undef BINNED_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crt_binned_dots(const void* slab, const void* queries,
                               const void* row0, void* vals, void* pos, int q,
                               int T, int win, int d, int nbins, int dtype,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch<kF32>(slab, queries, row0, vals, pos, q, T, win, d, nbins, s);
    case kBF16: return launch<kBF16>(slab, queries, row0, vals, pos, q, T, win, d, nbins, s);
    case kI8: return launch<kI8>(slab, queries, row0, vals, pos, q, T, win, d, nbins, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
