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
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// Tables [t0, t0 + LG) of every row, t0 = blockIdx.y LG.  kRes (resident):
// all of proj, [nc kBK][LG][TS] zero-padded, staged once for the block's
// life, as the design took it where it fits (one group, LG = L).  Else
// streamed: each slice of x comes with the same columns of the tables'
// projections, [kBK][LG][TS], in the same ring, so shared memory holds no
// more of proj than a slice's share whatever d is.  Either way slice c's
// projections sit at the same offsets, and each sum runs over d in the
// same order.
template <int K, int S, bool kRes>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
signproj_kernel(const float* __restrict__ x, const float* __restrict__ proj,
                int32_t* __restrict__ out, int n, int d, int L, int LG) {
  constexpr int kBK = Split<S>::bk;
  constexpr int kUnits = Split<S>::units;
  constexpr int R = Rows<K>::n;
  constexpr int KP = (K + 3) / 4 * 4;
  constexpr int TS = Stride<K>::n;
  extern __shared__ __align__(16) float smem[];
  const int t0 = blockIdx.y * LG;      // the block's first table
  const int G = kUnits / LG;           // row groups
  const int BM = R * G;                // rows per tile
  const int nc = (d + kBK - 1) / kBK;  // slices per tile, the last zero-padded
  const int ps_size = kBK * LG * TS;
  float* x_s = smem;                           // kStages x [BM][kBK], swizzled
  float* p_s = smem + kStages * BM * kBK;      // [nc or kStages][kBK][LG][TS]
  if (kRes) {
    for (int i = threadIdx.x; i < nc * ps_size; i += kThreads) {
      const int j = i % TS, t = (i / TS) % LG, k = i / (TS * LG);
      p_s[i] = j < K && k < d ? proj[(size_t)k * L * K + t * K + j] : 0.f;
    }
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
      // streamed: the slice's columns of proj, zero past d and past the
      // last table; the pad lanes j >= K of each table are never read into
      // a sum
      float* pdst = p_s + (s % kStages) * ps_size;
      for (int i = threadIdx.x; !kRes && i < kBK * LG * K; i += kThreads) {
        const int j = i % K, t = (i / K) % LG, col = c * kBK + i / (K * LG);
        const bool ok = col < d && t0 + t < L;
        const float* src = ok ? proj + ((size_t)col * L + t0 + t) * K + j : proj;
        cp_async4(pdst + ((i / (K * LG)) * LG + t) * TS + j, src, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // lane l of warp w: d split s = l / (32 / S), unit w (32 / S) + l % (32 / S)
  const int lane = threadIdx.x % 32;
  const int split = lane / (32 / S);
  const int unit = (threadIdx.x / 32) * (32 / S) + lane % (32 / S);
  const int g = unit / LG, t = unit % LG;
  const bool active = g < G && t0 + t < L;
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
      const float* ps = p_s + (kRes ? c : s % kStages) * ps_size;
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
              ps + (((Split<S>::h * split + h) * 4 + kk) * LG + t) * TS);
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
          out[row * L + t0 + t] = id;
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

inline int max_smem() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (bytes <= 0) bytes = 232448;
  }
  return bytes;
}

// Streamed, a block's shared memory is the ring's x slices and proj slices
// for LG tables.  Tables are split into ceil(L / LG) groups on grid.y, LG
// the largest ceil(L / groups) whose ring fits kSmemBudget (two blocks an
// SM).
constexpr size_t kSmemBudget = 110 * 1024;

template <int K, int S>
size_t ring_bytes(int lg) {
  return sizeof(float) * (size_t)kStages * Split<S>::bk *
         ((size_t)Rows<K>::n * (Split<S>::units / lg) + (size_t)lg * Stride<K>::n);
}

template <int K, int S, bool kRes>
int launch_kernel(const float* x, const float* proj, int32_t* out, int n, int d, int L,
                  int LG, int groups, size_t smem, cudaStream_t stream) {
  const int BM = Rows<K>::n * (Split<S>::units / LG);
  cudaError_t err = cudaFuncSetAttribute(
      signproj_kernel<K, S, kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = ((long long)n + BM - 1) / BM;
  long long cap = (long long)kBlocksPerSM * num_sms() / groups;
  if (cap < 1) cap = 1;
  const int blocks = (int)(n_tiles < cap ? n_tiles : cap);
  if (blocks > 0)
    signproj_kernel<K, S, kRes><<<dim3(blocks, groups), kThreads, smem, stream>>>(
        x, proj, out, n, d, L, LG);
  return (int)cudaGetLastError();
}

// proj resident where all of it fits beside the ring (the design's shapes
// before the streamed form; one block an SM where it exceeds half the SM),
// streamed in groups otherwise
template <int K, int S>
int launch_split(const float* x, const float* proj, int32_t* out, int n, int d,
           int L, cudaStream_t stream) {
  constexpr int kBK = Split<S>::bk;
  if (L <= Split<S>::units) {
    const size_t dp = (size_t)(d + kBK - 1) / kBK * kBK;
    const size_t BM = (size_t)Rows<K>::n * (Split<S>::units / L);
    const size_t smem = sizeof(float) * (dp * L * Stride<K>::n + (size_t)kStages * BM * kBK);
    if (smem <= (size_t)max_smem())
      return launch_kernel<K, S, true>(x, proj, out, n, d, L, L, 1, smem, stream);
  }
  int groups = 1, LG = L;
  while (LG > Split<S>::units || ring_bytes<K, S>(LG) > kSmemBudget) {
    if (LG == 1) return (int)cudaErrorInvalidValue;
    ++groups;
    LG = (L + groups - 1) / groups;
  }
  groups = (L + LG - 1) / LG;
  return launch_kernel<K, S, false>(x, proj, out, n, d, L, LG, groups, ring_bytes<K, S>(LG),
                                    stream);
}

// the S = 4 launcher, instantiated for k = 1..30 in signproj_wide.cu
template <int K>
int launch_wide(const float* x, const float* proj, int32_t* out, int n, int d,
                int L, cudaStream_t stream);

}  // namespace k2
