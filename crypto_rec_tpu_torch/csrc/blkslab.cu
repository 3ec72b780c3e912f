// P5: slab-window dots over block-transposed slabs.
//
// Replaces the TPU kernel benchmarks/experiments/probe_r4_blk.py
// (blk_window_dots, pallas_call at :132; body make_blk_kernel :68-112).
//
// Each table's slab is stored as [n_pad / 128, d, 128] blocks: block b,
// row k, lane j holds element k of CSR row 128 b + j.  A window is nblk
// adjacent blocks starting at a 128-aligned CSR row, and lane j of the
// [nblk * 128] output is the f32 dot of the query with CSR row
// aligned + j.  The host wrapper (ops/kernels/blkslab.py) owns the
// geometry (128-row alignment, the clamp) and passes each window's
// absolute first block.
//
// What bounds it on the H100: the same window bytes as K1 (at q = 8,192,
// T = 8, win = 640, d = 128: 5.4 GB int8 / 10.7 GB bf16, logical), read as
// d rows of 128 contiguous bytes (int8) or 256 (bf16) per block.  On the
// TPU the layout cut the lane-reduce work of the dot; here there is no
// reduction at all: each thread sums over k in registers.
//
// Design: one block per (query, window), the query in shared memory.
// Each thread owns one 4-byte word of a block row -- 4 adjacent lanes
// (int8) or 2 (bf16) -- so a warp reads 128 contiguous bytes per row, and
// it walks the d rows with f32 FMAs into 4 (or 2) accumulators.

#include "slabrow.cuh"

namespace {

using namespace slabrow;

constexpr int kLanes = 128;    // CSR rows per block

template <int DT>  // kBF16 or kI8
__global__ void blk_dots_kernel(const uint8_t* __restrict__ slab,
                                const float* __restrict__ queries,
                                const int32_t* __restrict__ blk0,
                                float* __restrict__ dots, int T, int nblk,
                                int d) {
  constexpr int LPT = DT == kI8 ? 4 : 2;       // lanes per thread (one word)
  constexpr int TPR = kLanes / LPT;            // threads per block row
  constexpr int ESIZE = DT == kI8 ? 1 : 2;
  extern __shared__ float sq[];                // [d] the query
  const int w = blockIdx.x;                    // window index q * T + t
  const int qi = w / T;
  for (int k = threadIdx.x; k < d; k += blockDim.x) sq[k] = queries[(size_t)qi * d + k];
  __syncthreads();

  const int b = threadIdx.x / TPR;             // block of the window
  const int u = threadIdx.x % TPR;             // word within the block row
  const size_t row_words = kLanes * ESIZE / 4;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      slab + ((size_t)blk0[w] + b) * d * kLanes * ESIZE) + u;
  float acc[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) acc[i] = 0.f;
#pragma unroll 8
  for (int k = 0; k < d; ++k) {
    const uint32_t v = __ldg(src + k * row_words);
    const float qk = sq[k];
    if constexpr (DT == kI8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(i8(v, i), qk, acc[i]);
    } else {
      acc[0] = fmaf(__uint_as_float(v << 16), qk, acc[0]);
      acc[1] = fmaf(__uint_as_float(v & 0xffff0000u), qk, acc[1]);
    }
  }
  float* out = dots + (size_t)w * nblk * kLanes + b * kLanes + u * LPT;
  if constexpr (DT == kI8) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    *reinterpret_cast<float2*>(out) = make_float2(acc[0], acc[1]);
  }
}

template <int DT>
int launch(const void* slab, const void* queries, const void* blk0, void* dots,
           int q, int T, int nblk, int d, cudaStream_t stream) {
  constexpr int TPR = kLanes / (DT == kI8 ? 4 : 2);
  const int threads = nblk * TPR;
  if (nblk <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)q * T;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  blk_dots_kernel<DT><<<(unsigned)blocks, threads, d * sizeof(float), stream>>>(
      (const uint8_t*)slab, (const float*)queries, (const int32_t*)blk0,
      (float*)dots, T, nblk, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crt_blk_window_dots(const void* slab, const void* queries,
                                   const void* blk0, void* dots, int q, int T,
                                   int nblk, int d, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16: return launch<kBF16>(slab, queries, blk0, dots, q, T, nblk, d, s);
    case kI8: return launch<kI8>(slab, queries, blk0, dots, q, T, nblk, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
