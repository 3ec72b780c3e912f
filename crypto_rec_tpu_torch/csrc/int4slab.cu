// P6: slab-window dots over nibble-packed int4 slabs.
//
// Replaces the TPU kernel benchmarks/experiments/probe_r5_int4.py
// (slab_window_dots_int4, pallas_call at :139; body _make_kernel_int4
// :68-110).
//
// A packed byte holds two adjacent CSR rows' elements: hi nibble = even
// row, lo nibble = odd row, each a signed 4-bit value ((v ^ 8) - 8).  For
// every (query, window) pair the kernel reads the window's win/2 packed
// rows and writes the f32 dots in the TPU kernel's "halves" layout: lane
// j < win/2 is CSR row aligned + 2j (hi nibbles), lane win/2 + j is row
// aligned + 2j + 1 (lo nibbles).  The host wrapper (ops/kernels/int4slab.py)
// owns the geometry (64-row alignment, the clamp) and passes each window's
// absolute first packed row.
//
// What bounds it on the H100: at the probe point (q = 32,768, T = 8, win =
// 640, d = 128) it reads 32,768 x 8 x 320 x 128 B = 10.7 GB of packed
// window bytes, half of K1's int8 21.5 GB, and does twice K1's FMAs per
// byte (2 x 21 GFLOP here) plus the nibble unpacking: if K1 is bound by
// bytes this kernel should take about half its time.
//
// Design: K1's.  One block per (query, window); groups of G lanes each
// read one packed row as 16-byte chunks (coalesced), the query chunk in
// registers; each lane keeps two f32 accumulators (even and odd row) and a
// shuffle tree sums both.

#include "slabrow.cuh"

namespace {

constexpr int kThreads = 128;

// both nibble rows of one 16-byte chunk against their 16 query elements
__device__ __forceinline__ void nibble_dot(uint4 v, const float* q, float& hi,
                                           float& lo) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int byte = (int)((w[i] >> (8 * b)) & 0xffu);
      hi = fmaf((float)(((byte >> 4) ^ 8) - 8), q[4 * i + b], hi);
      lo = fmaf((float)(((byte & 15) ^ 8) - 8), q[4 * i + b], lo);
    }
  }
}

template <int CPL>
__global__ void __launch_bounds__(kThreads)
int4_dots_kernel(const uint8_t* __restrict__ slab,
                 const float* __restrict__ queries,
                 const int32_t* __restrict__ row0,
                 float* __restrict__ dots, int T, int win, int d, int group) {
  const int w = blockIdx.x;                // window index q * T + t
  const int qi = w / T;
  const int chunks = d / 16;               // 16-byte chunks per packed row
  const int lane = threadIdx.x % group;
  const int rows_per_iter = kThreads / group;
  const int win2 = win / 2;

  float qreg[CPL * 16];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + j * group;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      qreg[j * 16 + e] = c < chunks ? queries[(size_t)qi * d + c * 16 + e] : 0.f;
  }
  const uint8_t* base = slab + (size_t)row0[w] * d;
  float* out = dots + (size_t)w * win;

#pragma unroll 4
  for (int r0 = 0; r0 < win2; r0 += rows_per_iter) {
    const int r = r0 + threadIdx.x / group;
    const uint4* row = reinterpret_cast<const uint4*>(base + (size_t)r * d);
    float hi = 0.f, lo = 0.f;
    if (r < win2) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + j * group;
        if (c < chunks) nibble_dot(__ldg(row + c), qreg + j * 16, hi, lo);
      }
    }
    for (int off = group / 2; off > 0; off /= 2) {
      hi += __shfl_xor_sync(0xffffffffu, hi, off);
      lo += __shfl_xor_sync(0xffffffffu, lo, off);
    }
    if (lane == 0 && r < win2) {
      out[r] = hi;
      out[win2 + r] = lo;
    }
  }
}

}  // namespace

extern "C" int crt_int4_window_dots(const void* slab, const void* queries,
                                    const void* row0, void* dots, int q, int T,
                                    int win, int d, void* stream) {
  if (d % 16 != 0 || win % 2 != 0) return (int)cudaErrorInvalidValue;
  const int chunks = d / 16;
  const int group = slabrow::row_group(chunks);
  const int cpl = (chunks + group - 1) / group;
  const long long blocks = (long long)q * T;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define INT4_LAUNCH(C)                                                       \
  int4_dots_kernel<C><<<(unsigned)blocks, kThreads, 0, s>>>(                 \
      (const uint8_t*)slab, (const float*)queries, (const int32_t*)row0,     \
      (float*)dots, T, win, d, group)
  switch (cpl) {
    case 1: INT4_LAUNCH(1); break;
    case 2: INT4_LAUNCH(2); break;
    case 3: INT4_LAUNCH(3); break;
    case 4: INT4_LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;   // packed row wider than 2048 B
  }
#undef INT4_LAUNCH
  return (int)cudaGetLastError();
}
