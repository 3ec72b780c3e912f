// K1, row-wise body: slab-window dot products, one block per window.
//
// The main path runs the tile-major body in slabtile.cu.  This one stays
// compiled as crt_slab_window_dots_rowwise so a run on the card can time
// the two designs against each other on the same inputs; nothing on the
// serving or probe paths calls it.
//
// Replaces the TPU kernel crypto_rec_tpu/ops/pallas/slabscore.py
// (slab_window_dots, pallas_call at :360; bodies _make_kernel_fused
// :176-244 and the per-window _make_kernel :110-173, which exists only for
// the TPU's VMEM budget and has no counterpart here).
//
// For every (query, window) pair the kernel dots the f32 query with each
// of the window's `win` CSR-ordered slab rows, upcasting the slab element
// (int8, bf16 or f32) to f32 before an f32 multiply, and writes
// dots[q, t, lane].  With mask != 0, lanes outside [head, head + size) are
// -inf.  The host wrapper (ops/kernels/slabscore.py) owns the window
// geometry: the 32-row alignment, the clamp, head/size and the per-table
// row offsets arrive here as absolute first rows `row0[q, t]`.
//
// What bounds it on the H100: at the CF point (q = 8,192, T = 8 tables,
// win = 640, d = 128, int8) it streams 8,192 x 8 x 640 x 128 B ~5.4 GB of
// slab rows and does ~11 GFLOP: bandwidth-bound (~1.6 ms if every row came
// from HBM at 3.35 TB/s).  The only slack is L2 reuse: queries that share a
// bucket read the same window rows, and the 50 MB L2 keeps recently
// streamed windows, so the HBM bytes may be well under 5.4 GB.
//
// Design: one block per (query, window).  The block's threads split into
// groups of G lanes (G = a power of two <= 32); a group owns one slab row
// at a time and its lanes read the row as 16-byte chunks (coalesced, one
// 128-byte row per 8 lanes for int8 d = 128).  Each lane keeps the query
// elements of its chunks in registers, so the inner loop is a 16-byte load,
// an upcast and f32 FMAs; a shuffle tree reduces the group's partial sums.
// No tensor cores: a simple kernel that is right first.

#include "slabrow.cuh"

namespace {

using namespace slabrow;

constexpr int kThreads = 128;
constexpr int kMaxChunks = 4;   // 16-byte chunks per lane: row <= 2048 B

// CPL = 16-byte chunks per lane (1..kMaxChunks), a template parameter so a
// lane holds only the query registers it uses: int8 d = 128 needs 16 floats,
// which keeps enough blocks resident per SM to cover memory latency.
template <int DT, int CPL>
__global__ void __launch_bounds__(kThreads)
slab_dots_kernel(const uint8_t* __restrict__ slab,
                 const float* __restrict__ queries,
                 const int32_t* __restrict__ row0,
                 const int32_t* __restrict__ head,
                 const int32_t* __restrict__ size,
                 float* __restrict__ dots, int T, int win, int d, int mask,
                 int group) {
  constexpr int E = Elems<DT>::n;
  const int w = blockIdx.x;                // window index q * T + t
  const int qi = w / T;
  const int chunks = d / E;                // 16-byte chunks per slab row
  const int lane = threadIdx.x % group;
  const int rows_per_iter = kThreads / group;

  float qreg[CPL * E];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + j * group;
#pragma unroll
    for (int e = 0; e < E; ++e)
      qreg[j * E + e] = c < chunks ? queries[(size_t)qi * d + c * E + e] : 0.f;
  }
  const size_t row_bytes = (size_t)d * (16 / E);
  const uint8_t* base = slab + (size_t)row0[w] * row_bytes;
  const int h = head[w];
  const int hs = h + size[w];
  float* out = dots + (size_t)w * win;

#pragma unroll 4
  for (int r0 = 0; r0 < win; r0 += rows_per_iter) {
    const int r = r0 + threadIdx.x / group;
    const uint4* row = reinterpret_cast<const uint4*>(base + (size_t)r * row_bytes);
    float acc = 0.f;
    if (r < win) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + j * group;
        if (c < chunks) acc = chunk_dot<DT>(__ldg(row + c), qreg + j * E, acc);
      }
    }
    for (int off = group / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0 && r < win)
      out[r] = (mask && (r < h || r >= hs)) ? __int_as_float(0xff800000) : acc;
  }
}

template <int DT, int CPL>
void launch_cpl(unsigned blocks, cudaStream_t stream, const void* slab,
                const void* queries, const void* row0, const void* head,
                const void* size, void* dots, int T, int win, int d, int mask,
                int group) {
  slab_dots_kernel<DT, CPL><<<blocks, kThreads, 0, stream>>>(
      (const uint8_t*)slab, (const float*)queries, (const int32_t*)row0,
      (const int32_t*)head, (const int32_t*)size, (float*)dots, T, win, d,
      mask, group);
}

template <int DT>
int launch(const void* slab, const void* queries, const void* row0,
           const void* head, const void* size, void* dots, int q, int T,
           int win, int d, int mask, cudaStream_t stream) {
  constexpr int E = Elems<DT>::n;
  if (d % E != 0) return (int)cudaErrorInvalidValue;
  const int chunks = d / E;
  const int group = row_group(chunks);
  const int cpl = (chunks + group - 1) / group;
  const long long blocks = (long long)q * T;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const unsigned nb = (unsigned)blocks;
  switch (cpl) {
    case 1: launch_cpl<DT, 1>(nb, stream, slab, queries, row0, head, size, dots, T, win, d, mask, group); break;
    case 2: launch_cpl<DT, 2>(nb, stream, slab, queries, row0, head, size, dots, T, win, d, mask, group); break;
    case 3: launch_cpl<DT, 3>(nb, stream, slab, queries, row0, head, size, dots, T, win, d, mask, group); break;
    case 4: launch_cpl<DT, 4>(nb, stream, slab, queries, row0, head, size, dots, T, win, d, mask, group); break;
    default: return (int)cudaErrorInvalidValue;   // row wider than kMaxChunks allow
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crt_slab_window_dots_rowwise(const void* slab, const void* queries,
                                    const void* row0, const void* head,
                                    const void* size, void* dots, int q, int T,
                                    int win, int d, int mask, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32: return launch<kF32>(slab, queries, row0, head, size, dots, q, T, win, d, mask, s);
    case kBF16: return launch<kBF16>(slab, queries, row0, head, size, dots, q, T, win, d, mask, s);
    case kI8: return launch<kI8>(slab, queries, row0, head, size, dots, q, T, win, d, mask, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
