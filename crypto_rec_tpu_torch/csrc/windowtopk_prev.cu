// S1's previous design, kept compiled for timing only: no path calls it.
// `ops/kernels/windowtopk.window_topk_prev` launches it on the card, so a
// run can time it beside the threshold design of windowtopk.cu on the same
// rows.  Same contract as crt_window_topk (the k largest of each row,
// descending, equal values lowest index first, NaN above +inf, -0.0 equal
// to +0.0 and written back as the row's own bits).
//
// The key.  Each lane maps to a 64-bit key, unique in its row: the high
// half is an order-preserving image of the value (sign-flipped IEEE bits,
// -0.0 folded onto +0.0, every NaN onto the top), the low half ~index, so
// among equal values the lower index has the larger key.  Round r takes
// the largest key below round r - 1's, so the output is deterministic and
// is the stable sort's prefix.
//
// Design: k serial rounds of arg-max, one output key a round.
// - Per-window rows (m <= 1,024): one warp a row, the row's keys in
//   registers (PER a lane, lane-strided so the loads coalesce).  Each
//   lane keeps the largest of its keys not yet taken; a round is a warp
//   arg-max of those (5 64-bit shuffles), and only the lane that won
//   rescans its PER keys.  Lane r % 32 keeps round r's key, so each 32
//   results are stored by 32 lanes at once.
// - Longer rows (m <= 32,768, k <= 1,024): one block a row, the row's
//   value images staged in shared memory (m * 4 bytes), the same rounds as
//   a block arg-max (warp shuffles, then the warps' maxima through a
//   double-buffered shared array: one barrier a round), the winning thread
//   rescanning its m / NT images; the taken keys wait in shared memory for
//   one coalesced store.

#include <cstdint>
#include <cuda_runtime.h>

namespace s1prev {

typedef unsigned long long u64;

constexpr int kWarpMaxM = 1024;
constexpr int kMaxM = 32768;
constexpr int kMaxK = 1024;
constexpr int kWarpRows = 8;            // rows (warps) a 256-thread block

// Order-preserving image of an f32 as uint32: larger value, larger image.
__device__ __forceinline__ uint32_t order_bits(float x) {
  if (x != x) return 0xFFFFFFFFu;       // NaN: above +inf, as the sort puts it first
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;         // -0.0 ties +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Unique in its row and > 0 (the low half has bit 31 set for i < 2^31),
// so 0 stands for "no key left".
__device__ __forceinline__ u64 make_key(uint32_t bits, int i) {
  return ((u64)bits << 32) | (u64)(uint32_t)(~(uint32_t)i);
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)(~(uint32_t)key);
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 x = __shfl_xor_sync(0xffffffffu, v, o);
    v = x > v ? x : v;
  }
  return v;
}

template <int PER>
__global__ void __launch_bounds__(32 * kWarpRows)
warp_rows(const float* __restrict__ values, float* __restrict__ out_v,
          long long* __restrict__ out_i, int R, int m, int k) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;                 // the whole warp leaves together
  const float* src = values + (size_t)row * m;
  u64 key[PER];
  u64 lmax = 0ull;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = j * 32 + lane;
    key[j] = i < m ? make_key(order_bits(src[i]), i) : 0ull;
    lmax = key[j] > lmax ? key[j] : lmax;
  }
  u64 mine = 0ull;
  for (int r = 0; r < k; ++r) {
    const u64 best = warp_max(lmax);
    if (lane == (r & 31)) mine = best;
    if (lmax == best) {                 // exactly one lane: keys are unique
      u64 next = 0ull;
#pragma unroll
      for (int j = 0; j < PER; ++j)
        next = (key[j] < best && key[j] > next) ? key[j] : next;
      lmax = next;
    }
    if ((r & 31) == 31 || r == k - 1) {   // store this group of <= 32 rounds
      const int slot = (r & ~31) + lane;
      if (lane <= (r & 31)) {
        const int i = key_index(mine);
        out_v[(size_t)row * k + slot] = src[i];
        out_i[(size_t)row * k + slot] = i;
      }
    }
  }
}

// Every thread gets the block's largest v; red: this round's half of a
// double-buffered [2][NT / 32] array (round r + 2 writes it again only
// after every thread passed round r + 1's barrier, so after the reads).
template <int NT>
__device__ __forceinline__ u64 block_max(u64 v, u64* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_max(lane < NT / 32 ? red[lane] : 0ull);
}

template <int NT>
size_t block_smem(int m, int k) {
  return (size_t)k * 8 + 2 * (NT / 32) * 8 + (size_t)m * 4;
}

template <int NT>
__global__ void __launch_bounds__(NT)
block_rows(const float* __restrict__ values, float* __restrict__ out_v,
           long long* __restrict__ out_i, int m, int k) {
  extern __shared__ u64 smem[];
  u64* res = smem;                      // [k] the keys taken, in order
  u64* red = res + k;                   // [2][NT / 32]
  uint32_t* img = (uint32_t*)(red + 2 * (NT / 32));   // [m]
  const float* src = values + (size_t)blockIdx.x * m;
  const int t = threadIdx.x;
  u64 lmax = 0ull;
  for (int i = t; i < m; i += NT) {     // each thread reads back only its own images
    const uint32_t b = order_bits(src[i]);
    img[i] = b;
    const u64 key = make_key(b, i);
    lmax = key > lmax ? key : lmax;
  }
  for (int r = 0; r < k; ++r) {
    const u64 best = block_max<NT>(lmax, red + (r & 1) * (NT / 32));
    if (t == 0) res[r] = best;
    if (lmax == best) {
      u64 next = 0ull;
      for (int i = t; i < m; i += NT) {
        const u64 key = make_key(img[i], i);
        next = (key < best && key > next) ? key : next;
      }
      lmax = next;
    }
  }
  __syncthreads();
  for (int r = t; r < k; r += NT) {
    const int i = key_index(res[r]);
    out_v[(size_t)blockIdx.x * k + r] = src[i];
    out_i[(size_t)blockIdx.x * k + r] = i;
  }
}

template <int PER>
int launch_warp(const float* v, float* ov, long long* oi, int R, int m, int k,
                cudaStream_t s) {
  const unsigned grid = (unsigned)((R + kWarpRows - 1) / kWarpRows);
  warp_rows<PER><<<grid, 32 * kWarpRows, 0, s>>>(v, ov, oi, R, m, k);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_block(const float* v, float* ov, long long* oi, int R, int m, int k,
                 cudaStream_t s) {
  const size_t bytes = block_smem<NT>(m, k);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_rows<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  block_rows<NT><<<(unsigned)R, NT, bytes, s>>>(v, ov, oi, m, k);
  return (int)cudaGetLastError();
}

}  // namespace s1prev

// (values [R, m] f32, out_v [R, k] f32, out_i [R, k] int64, R, m, k, stream)
extern "C" int crt_window_topk_prev(const void* values, void* out_v, void* out_i,
                               int R, int m, int k, void* stream) {
  using namespace s1prev;
  if (R < 0 || m < 1 || k < 1 || k > m || m > kMaxM || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const float* v = (const float*)values;
  float* ov = (float*)out_v;
  long long* oi = (long long*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= kWarpMaxM) {
    switch ((m + 127) / 128) {          // PER: keys a lane, a multiple of 4
      case 1: return launch_warp<4>(v, ov, oi, R, m, k, s);
      case 2: return launch_warp<8>(v, ov, oi, R, m, k, s);
      case 3: return launch_warp<12>(v, ov, oi, R, m, k, s);
      case 4: return launch_warp<16>(v, ov, oi, R, m, k, s);
      case 5: return launch_warp<20>(v, ov, oi, R, m, k, s);
      case 6: return launch_warp<24>(v, ov, oi, R, m, k, s);
      case 7: return launch_warp<28>(v, ov, oi, R, m, k, s);
      default: return launch_warp<32>(v, ov, oi, R, m, k, s);
    }
  }
  if (m <= 2048) return launch_block<64>(v, ov, oi, R, m, k, s);
  if (m <= 8192) return launch_block<256>(v, ov, oi, R, m, k, s);
  return launch_block<512>(v, ov, oi, R, m, k, s);
}
