// P2 / P4: the slab-window loop with other scoring bodies, row-wise (the
// first design, kept for timing: the probes run the tile-major bodies of
// probetile.cu; ops/kernels/slabvariants.py `slab_window_variant_rowwise`).
//
// Replaces the TPU kernels benchmarks/experiments/probe_r3_split.py
// (run_variant, pallas_call at :156; body variant_kernel :90-139) and
// benchmarks/experiments/probe_r3_final.py (nomask_dots, pallas_call at
// :99; body make_kernel :50-84).  Their "vpu" bodies are K1 with mask off
// (csrc/slabscore.cu); this file has the other three:
//
//   load_floor    (P2 "zeros")   every window byte is loaded and folded
//                 into a register with XOR; the output is the first
//                 element of table 0's window, as f32, broadcast to every
//                 lane.  Each block XORs its fold into sink[q], so the
//                 loads cannot be optimised away and the sink checks that
//                 every byte was read.
//   rounded_query (P2 "mxu_rep" / "mxu_tile", bf16 slabs)  dots against
//                 the query rounded to bf16 (round to nearest even, what
//                 astype does), f32 products and sum.
//   i8_dot        (P4 "mxu_i8", int8 slabs)  int8 row x int8 query with
//                 __dp4a and an exact int32 sum, written as f32 (|dot| <=
//                 128 x 127 x 127 < 2^24, so the f32 is exact).
//
// What bounds it on the H100: the same window bytes as K1's row-wise body
// (at q = 8,192, T = 8, win = 640, d = 128: 5.4 GB int8 / 10.7 GB bf16
// read, 168 MB of output written), every window read from memory though
// the windows cover only 1.86 GB (3.7 GB) of slab rows.  load_floor does
// no arithmetic but the same loads and output writes (plus one atomic per
// warp), so its time bounds this access pattern, not the loads alone.
//
// Design: K1's first (one block per (query, window), groups of G lanes
// each reading one slab row as 16-byte chunks, a shuffle tree per row).

#include <cuda_bf16.h>

#include "slabrow.cuh"

namespace {

using namespace slabrow;

constexpr int kThreads = 128;

enum Mode { kLoadFloor = 0, kRoundedQuery = 1, kI8Dot = 2 };

__device__ __forceinline__ int dp4a_chunk(uint4 v, const int* q, int acc) {
  acc = __dp4a((int)v.x, q[0], acc);
  acc = __dp4a((int)v.y, q[1], acc);
  acc = __dp4a((int)v.z, q[2], acc);
  return __dp4a((int)v.w, q[3], acc);
}

template <int DT, int MODE, int CPL>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const uint8_t* __restrict__ slab,
               const void* __restrict__ queries,
               const int32_t* __restrict__ row0,
               float* __restrict__ out_all, uint32_t* __restrict__ sink,
               int T, int win, int d, int group) {
  constexpr int E = Elems<DT>::n;
  const int w = blockIdx.x;                // window index q * T + t
  const int qi = w / T;
  const int chunks = d / E;
  const int lane = threadIdx.x % group;
  const int rows_per_iter = kThreads / group;
  const size_t row_bytes = (size_t)d * (16 / E);

  // query chunk in registers: f32 rounded to bf16, or int8 as 4 words
  float qreg[MODE == kRoundedQuery ? CPL * E : 1];
  int qint[MODE == kI8Dot ? CPL * 4 : 1];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + j * group;
    if constexpr (MODE == kRoundedQuery) {
      const float* qf = (const float*)queries + (size_t)qi * d;
#pragma unroll
      for (int e = 0; e < E; ++e)
        qreg[j * E + e] = c < chunks
            ? __bfloat162float(__float2bfloat16_rn(qf[c * E + e])) : 0.f;
    } else if constexpr (MODE == kI8Dot) {
      const uint4 v = c < chunks
          ? reinterpret_cast<const uint4*>((const int8_t*)queries + (size_t)qi * d)[c]
          : make_uint4(0u, 0u, 0u, 0u);
      qint[j * 4 + 0] = (int)v.x;
      qint[j * 4 + 1] = (int)v.y;
      qint[j * 4 + 2] = (int)v.z;
      qint[j * 4 + 3] = (int)v.w;
    }
  }
  const uint8_t* base = slab + (size_t)row0[w] * row_bytes;
  float* out = out_all + (size_t)w * win;
  const float first = MODE == kLoadFloor
      ? element<DT>(slab + (size_t)row0[(size_t)qi * T] * row_bytes, 0) : 0.f;
  uint32_t fold = 0u;

#pragma unroll 4
  for (int r0 = 0; r0 < win; r0 += rows_per_iter) {
    const int r = r0 + threadIdx.x / group;
    const uint4* row = reinterpret_cast<const uint4*>(base + (size_t)r * row_bytes);
    float acc = 0.f;
    int iacc = 0;
    if (r < win) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + j * group;
        if (c < chunks) {
          const uint4 v = __ldg(row + c);
          if constexpr (MODE == kLoadFloor) fold ^= v.x ^ v.y ^ v.z ^ v.w;
          else if constexpr (MODE == kRoundedQuery) acc = chunk_dot<DT>(v, qreg + j * E, acc);
          else iacc = dp4a_chunk(v, qint + j * 4, iacc);
        }
      }
    }
    if constexpr (MODE == kRoundedQuery) {
      for (int off = group / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    } else if constexpr (MODE == kI8Dot) {
      for (int off = group / 2; off > 0; off /= 2)
        iacc += __shfl_xor_sync(0xffffffffu, iacc, off);
      acc = (float)iacc;
    } else {
      acc = first;
    }
    if (lane == 0 && r < win) out[r] = acc;
  }
  if constexpr (MODE == kLoadFloor) {
    for (int off = 16; off > 0; off /= 2) fold ^= __shfl_xor_sync(0xffffffffu, fold, off);
    if (threadIdx.x % 32 == 0) atomicXor(sink + qi, fold);
  }
}

template <int DT, int MODE>
int launch(const void* slab, const void* queries, const void* row0, void* out,
           void* sink, int q, int T, int win, int d, cudaStream_t stream) {
  constexpr int E = Elems<DT>::n;
  if (d % E != 0) return (int)cudaErrorInvalidValue;
  const int chunks = d / E;
  const int group = row_group(chunks);
  const int cpl = (chunks + group - 1) / group;
  const long long blocks = (long long)q * T;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
#define VARIANT_LAUNCH(C)                                                    \
  variant_kernel<DT, MODE, C><<<(unsigned)blocks, kThreads, 0, stream>>>(    \
      (const uint8_t*)slab, queries, (const int32_t*)row0, (float*)out,      \
      (uint32_t*)sink, T, win, d, group)
  switch (cpl) {
    case 1: VARIANT_LAUNCH(1); break;
    case 2: VARIANT_LAUNCH(2); break;
    case 3: VARIANT_LAUNCH(3); break;
    case 4: VARIANT_LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;   // row wider than 2048 B
  }
#undef VARIANT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// queries: f32 [q, d] (rounded_query; unread by load_floor) or int8 [q, d]
// (i8_dot); sink: [q] int32, zeroed by the caller (load_floor only)
extern "C" int crt_slab_window_variant(const void* slab, const void* queries,
                                       const void* row0, void* out, void* sink,
                                       int q, int T, int win, int d, int mode,
                                       int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kLoadFloor) {
    switch (dtype) {
      case kF32: return launch<kF32, kLoadFloor>(slab, queries, row0, out, sink, q, T, win, d, s);
      case kBF16: return launch<kBF16, kLoadFloor>(slab, queries, row0, out, sink, q, T, win, d, s);
      case kI8: return launch<kI8, kLoadFloor>(slab, queries, row0, out, sink, q, T, win, d, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (mode == kRoundedQuery && dtype == kBF16)
    return launch<kBF16, kRoundedQuery>(slab, queries, row0, out, sink, q, T, win, d, s);
  if (mode == kI8Dot && dtype == kI8)
    return launch<kI8, kI8Dot>(slab, queries, row0, out, sink, q, T, win, d, s);
  return (int)cudaErrorInvalidValue;
}
