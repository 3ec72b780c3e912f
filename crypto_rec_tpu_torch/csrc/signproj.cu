// K2: fused sign-projection + bit-pack hash for cosine (SimHash) LSH.
//
// Replaces the TPU kernel crypto_rec_tpu/ops/pallas/signproj.py
// (signproj_bucket_ids, pallas_call at :61, body _kernel :37-41):
//   acc = x @ proj (f32), bit = acc >= 0, the k bits of each table packed
//   MSB-first into an int32 bucket id (reference cosine_g_gen.hpp:62-72).
//
// What bounds it on the H100: at the index-build point (2M x 128 rows,
// proj [128, 104]) the kernel reads ~1 GB of x and writes 64 MB of ids for
// ~27 GFLOP of f32 FMA: it is memory-bound (1 GB at 3.35 TB/s ~0.3 ms),
// and the FMA work (27 GFLOP at 67 TFLOP/s ~0.4 ms) sits close behind.
//
// Design: each block stages the whole proj matrix [d, L*k] in shared
// memory once, then walks tiles of x rows (coalesced 16-byte loads into
// shared memory).  Each thread owns two rows of one table, accumulates
// their k projections in registers with plain f32 FFMA, then packs the
// signs with shifts and ORs.  No TF32
// and no tensor cores: a rounding change flips the sign of projections
// near zero and breaks bucket parity with the reference hash.  The [n, L*k]
// projection tensor never leaves the SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 30;         // bucket ids are int32: k <= 30 bits per table
constexpr int kRows = 2;          // rows per thread: one proj load feeds 2 FMAs
constexpr int kMaxBlocks = 1024;  // a few waves of blocks on 132 SMs
constexpr long long kMaxSmemBytes = 232448;  // opt-in shared memory per block

// x row tile stride in floats: d + 1 keeps the rows of one warp on
// different shared-memory banks.  Each block stages proj once and then
// walks row tiles tile = blockIdx.x, blockIdx.x + gridDim.x, ...  Thread
// (g, t) owns rows kRows*g .. kRows*g + kRows-1 of a tile and table t; K is
// a template parameter so the k accumulators of each row stay in registers
// and no issue slot is spent on projections the table does not have.
template <int K>
__global__ void __launch_bounds__(kThreads)
signproj_kernel(const float* __restrict__ x, const float* __restrict__ proj,
                int32_t* __restrict__ out, int n, int d, int L,
                int rows_per_tile) {
  extern __shared__ float smem[];
  const int lk = L * K;
  float* p_s = smem;                 // [d, L*K]
  float* x_s = smem + d * lk;        // [rows_per_tile, d + 1]
  const int xs = d + 1;
  for (int i = threadIdx.x; i < d * lk; i += blockDim.x) p_s[i] = proj[i];

  const int r0 = kRows * (threadIdx.x / L);   // this thread's first row
  const int t = threadIdx.x % L;              // and its table
  const int d4 = d / 4;                       // d % 4 == 0 (host-checked)
  const int n_tiles = (n + rows_per_tile - 1) / rows_per_tile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * rows_per_tile;
    __syncthreads();                 // proj staged / previous tile consumed
    for (int i = threadIdx.x; i < rows_per_tile * d4; i += blockDim.x) {
      const int rr = i / d4, c = i % d4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + rr < n)
        v = reinterpret_cast<const float4*>(x + (size_t)(row0 + rr) * d)[c];
      float* dst = x_s + rr * xs + 4 * c;
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    __syncthreads();
    if (r0 >= rows_per_tile || row0 + r0 >= n) continue;

    float acc[kRows][K];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int j = 0; j < K; ++j) acc[u][j] = 0.f;
    const float* xr = x_s + r0 * xs;
    const float* pc = p_s + t * K;   // proj[i, t*K + j] is pc[i*lk + j]
    for (int i = 0; i < d; ++i) {
      float xv[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) xv[u] = xr[u * xs + i];
      const float* pi = pc + i * lk;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float pv = pi[j];
#pragma unroll
        for (int u = 0; u < kRows; ++u) acc[u][j] = fmaf(xv[u], pv, acc[u][j]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (row0 + r0 + u >= n) break;
      int32_t id = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) id |= (acc[u][j] >= 0.f ? 1 : 0) << (K - 1 - j);
      out[(size_t)(row0 + r0 + u) * L + t] = id;
    }
  }
}

template <int K>
int launch(const float* x, const float* proj, int32_t* out, int n, int d,
           int L, cudaStream_t stream) {
  // rows per tile: kRows per thread, fewer when proj leaves too little of
  // the 227 KB a block may use (threads past the tile then idle)
  const long long free_floats = kMaxSmemBytes / 4 - (long long)d * L * K;
  int rows_per_tile = kRows * (kThreads / L);
  const long long fit = free_floats / (d + 1) / kRows * kRows;
  if (fit < rows_per_tile) rows_per_tile = (int)fit;
  if (rows_per_tile < kRows) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)d * L * K + (size_t)rows_per_tile * (d + 1));
  cudaError_t err = cudaFuncSetAttribute(
      signproj_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + rows_per_tile - 1) / rows_per_tile;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks > 0)
    signproj_kernel<K><<<blocks, kThreads, smem, stream>>>(
        x, proj, out, n, d, L, rows_per_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crt_signproj(const void* x, const void* proj, void* out,
                            int n, int d, int k, int L, void* stream) {
  if (L < 1 || L > kThreads || d % 4 != 0) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* pf = (const float*)proj;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define CRT_K(K) case K: return launch<K>(xf, pf, o, n, d, L, s);
    CRT_K(1) CRT_K(2) CRT_K(3) CRT_K(4) CRT_K(5) CRT_K(6) CRT_K(7) CRT_K(8)
    CRT_K(9) CRT_K(10) CRT_K(11) CRT_K(12) CRT_K(13) CRT_K(14) CRT_K(15)
    CRT_K(16) CRT_K(17) CRT_K(18) CRT_K(19) CRT_K(20) CRT_K(21) CRT_K(22)
    CRT_K(23) CRT_K(24) CRT_K(25) CRT_K(26) CRT_K(27) CRT_K(28) CRT_K(29)
    CRT_K(30)
#undef CRT_K
    default: return (int)cudaErrorInvalidValue;   // k > kMaxK
  }
}
