// K2's kernel template and launcher, shared by signproj.cu (S = 1, many
// tables) and signproj_wide.cu (S = 4, L <= 2), which nvcc compiles in
// parallel.  The design note is at the top of signproj.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace k2 {

constexpr int kThreads = 256;
constexpr int kStages = 3;        // slices in flight
constexpr int kBlocksPerSM = 2;

// rows per thread: 4, or 2 where 4 * K accumulators would spill (5 or 6
// rows spill at K = 13 under the 128 registers two blocks an SM allow)
template <int K> struct Rows { static constexpr int n = K > 16 ? 2 : 4; };
// floats per table in shared proj: K rounded up to 4, plus 4 when that is a
// multiple of 8, so the 8 tables a quarter-warp reads sit on distinct
// 16-byte bank groups
template <int K> struct Stride {
  static constexpr int kp = (K + 3) / 4 * 4;
  static constexpr int n = (kp / 4) % 2 ? kp : kp + 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// S = d splits: a slice holds 16 (S = 1) or 32 (S = 4) columns of each
// row, a block 256 / S (row group, table) units
template <int S> struct Split {
  static constexpr int bk = S == 1 ? 16 : 8 * S;   // columns a slice
  static constexpr int u = bk / 4;                  // 16-byte units a slice row
  static constexpr int h = bk / S / 4;              // of them a lane reads
  static constexpr int units = kThreads / S;
};

// float offset of 16-byte unit u of row r within a slice: units XOR-
// swizzled on the row, so 8 rows' same unit hit 8 distinct bank groups
template <int S>
__device__ __forceinline__ int slice_off(int r, int u) {
  constexpr int U = Split<S>::u;
  return r * Split<S>::bk + ((u ^ ((r / (8 / U)) & (U - 1))) << 2);
}

template <int K, int S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
signproj_kernel(const float* __restrict__ x, const float* __restrict__ proj,
                int32_t* __restrict__ out, int n, int d, int L) {
  constexpr int kBK = Split<S>::bk;
  constexpr int kUnits = Split<S>::units;
  constexpr int R = Rows<K>::n;
  constexpr int KP = (K + 3) / 4 * 4;
  constexpr int TS = Stride<K>::n;
  extern __shared__ __align__(16) float smem[];
  const int G = kUnits / L;            // row groups
  const int BM = R * G;                // rows per tile
  const int nc = (d + kBK - 1) / kBK;  // slices per tile, the last zero-padded
  const int dp = nc * kBK;
  float* p_s = smem;                   // [dp][L][TS], zero-padded
  float* x_s = smem + dp * L * TS;     // kStages x [BM][kBK], swizzled
  for (int i = threadIdx.x; i < dp * L * TS; i += kThreads) {
    const int j = i % TS, t = (i / TS) % L, k = i / (TS * L);
    p_s[i] = j < K && k < d ? proj[k * L * K + t * K + j] : 0.f;
  }

  const int n_tiles = (n + BM - 1) / BM;
  const int my_tiles = blockIdx.x < n_tiles
      ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = my_tiles * nc;

  auto issue = [&](int s) {
    if (s < total) {
      const int tile = blockIdx.x + (s / nc) * gridDim.x;
      const int c = s % nc;
      float* dst = x_s + (s % kStages) * BM * kBK;
      const long long row_base = (long long)tile * BM;
      for (int i = threadIdx.x; i < Split<S>::u * BM; i += kThreads) {
        const int r = i / Split<S>::u, u = i % Split<S>::u;
        const long long row = row_base + r;
        const bool ok = row < n && c * kBK + u * 4 < d;   // d % 4 == 0
        const float* src = ok ? x + row * d + c * kBK + u * 4 : x;
        cp_async16(dst + slice_off<S>(r, u), src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // lane l of warp w: d split s = l / (32 / S), unit w (32 / S) + l % (32 / S)
  const int lane = threadIdx.x % 32;
  const int split = lane / (32 / S);
  const int unit = (threadIdx.x / 32) * (32 / S) + lane % (32 / S);
  const int g = unit / L, t = unit % L;
  const bool active = g < G;
  float acc[R][K];
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int j = 0; j < K; ++j) acc[u][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // slice s landed; slot s-1 consumed
    issue(s + kStages - 1);
    const int c = s % nc;
    if (active) {
      const float* xs = x_s + (s % kStages) * BM * kBK;
#pragma unroll
      for (int h = 0; h < Split<S>::h; ++h) {   // this split's columns, 4 at a time
        float4 xv[R];
#pragma unroll
        for (int u = 0; u < R; ++u)
          xv[u] = *reinterpret_cast<const float4*>(
              xs + slice_off<S>(g + u * G, Split<S>::h * split + h));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4* pr = reinterpret_cast<const float4*>(
              p_s + ((c * kBK + (Split<S>::h * split + h) * 4 + kk) * L + t) * TS);
          float pv[KP];
#pragma unroll
          for (int v = 0; v < KP / 4; ++v) {
            const float4 p4 = pr[v];
            pv[4 * v] = p4.x; pv[4 * v + 1] = p4.y;
            pv[4 * v + 2] = p4.z; pv[4 * v + 3] = p4.w;
          }
#pragma unroll
          for (int u = 0; u < R; ++u) {
            const float xk = kk == 0 ? xv[u].x : kk == 1 ? xv[u].y
                           : kk == 2 ? xv[u].z : xv[u].w;
#pragma unroll
            for (int j = 0; j < K; ++j) acc[u][j] = fmaf(xk, pv[j], acc[u][j]);
          }
        }
      }
    }
    if (c == nc - 1) {                 // tile done: sum the splits, pack the signs
      const long long row_base =
          (long long)(blockIdx.x + (s / nc) * gridDim.x) * BM;
#pragma unroll
      for (int u = 0; u < R; ++u) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
#pragma unroll
          for (int o = 32 / S; o < 32; o *= 2)
            acc[u][j] += __shfl_xor_sync(0xffffffffu, acc[u][j], o);
        }
        const long long row = row_base + g + u * G;
        if (active && split == 0 && row < n) {
          int32_t id = 0;
#pragma unroll
          for (int j = 0; j < K; ++j) id |= (acc[u][j] >= 0.f ? 1 : 0) << (K - 1 - j);
          out[row * L + t] = id;
        }
#pragma unroll
        for (int j = 0; j < K; ++j) acc[u][j] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <int K, int S>
int launch_split(const float* x, const float* proj, int32_t* out, int n, int d,
           int L, cudaStream_t stream) {
  constexpr int kBK = Split<S>::bk;
  const int BM = Rows<K>::n * (Split<S>::units / L);
  if (BM == 0) return (int)cudaErrorInvalidValue;
  const size_t dp = (size_t)(d + kBK - 1) / kBK * kBK;
  const size_t smem = sizeof(float) *
      (dp * L * Stride<K>::n + (size_t)kStages * BM * kBK);
  cudaError_t err = cudaFuncSetAttribute(
      signproj_kernel<K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = ((long long)n + BM - 1) / BM;
  const long long cap = (long long)kBlocksPerSM * num_sms();
  const int blocks = (int)(n_tiles < cap ? n_tiles : cap);
  if (blocks > 0)
    signproj_kernel<K, S><<<blocks, kThreads, smem, stream>>>(x, proj, out, n, d, L);
  return (int)cudaGetLastError();
}

// the S = 4 launcher, instantiated for k = 1..30 in signproj_wide.cu
template <int K>
int launch_wide(const float* x, const float* proj, int32_t* out, int n, int d,
                int L, cudaStream_t stream);

}  // namespace k2
