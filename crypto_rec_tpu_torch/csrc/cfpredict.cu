// The CF engine's prediction: get_predicted_user_sim (reference
// lib/crypto_rec.hpp:280-306) for a batch of q users, each with P selected
// neighbours of an [n, c] rating table:
//
//   w_p     = valid_p ? sim_p : 0
//   abs_sum = sum_p |w_p|
//   main_j  = sum_p w_p (R[id_p, j] - mean[id_p])       (valid slots only)
//   pred_j  = known_j ? rating_j
//                     : mean_q + (abs_sum > 0 ? main_j / max(abs_sum, 1e-30) : 0)
//
// Replaces no TPU kernel: the JAX package computes it with XLA ops
// (crypto_rec_tpu/models/rec/engine.py:61 predict_scores), and so does the
// port's plain version (ops/kernels/cfpredict.py cf_predict_plain), through
// a [q, P, c] f32 neighbour gather that device memory carries four times
// (the gather, the centred copy, the mask, the contraction).
//
// What bounds it on the H100: bytes.  Each operand read once and the
// prediction written once come to 115 MB at the CF cell's shape (q = 73,421,
// P = 20, c = 100, int64 ids), 0.034 ms at 3.35 TB/s; its 2 q P c = 294
// MFLOP are nothing.  The q P neighbour rows (587 MB) are re-reads of the
// [n, c] table, which at 29 MB stays in the 50 MB L2.  Nothing of [q, P, c]
// is written.
//
// Design: one warp a user, kWarps users a block.  Lane p of a group of 32
// slots loads slot p's validity, id, weight and neighbour mean once; a
// ballot of the valid slots is the warp-uniform list of rows to read, so an
// empty slot costs no load, and __shfl_sync hands each row's id, weight and
// mean to every lane.  Lanes own the columns of a kCols-wide chunk: four
// adjacent columns read as one float4 where c % 4 == 0 and the rating
// tables and the output are 16-byte aligned (a 400-byte row is one warp
// load at c = 100), else columns lane, lane + 32, lane + 64 and lane + 96
// as scalars.  Slots are taken in the order p = 0 ... P - 1, kUnroll rows'
// loads started before their FMAs, so each sum runs in a fixed order and a
// run repeats bit for bit.  f32 FMA and IEEE division (no fast math, no
// TF32).  Wider rows go chunk by chunk, each walking the slots again; more
// than 32 slots go in groups of 32.  A valid slot whose id lies outside
// [0, n) is not read: the user's unknown coins come out NaN (the plain
// version's gather raises there).

#include <cuda_runtime.h>
#include <stdint.h>

namespace cfp {

constexpr int kWarps = 8;          // users a block
constexpr int kCols = 128;         // columns a chunk: 4 a lane
constexpr int kUnroll = 4;         // rows whose loads are in flight together
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-30f;     // cfpredict._EPS

// column t (0..3) of this lane in the chunk at c0
template <bool V4>
__device__ __forceinline__ int col(int c0, int lane, int t) {
  return V4 ? c0 + 4 * lane + t : c0 + lane + 32 * t;
}

template <bool V4>
__device__ __forceinline__ void load_cols(const float* __restrict__ row, int c0, int lane,
                                          int c, float (&x)[4]) {
  if (V4) {
    const int j = col<true>(c0, lane, 0);
    if (j < c) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + j));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = col<false>(c0, lane, t);
      x[t] = j < c ? __ldg(row + j) : 0.f;
    }
  }
}

template <typename Id, bool V4>
__global__ void __launch_bounds__(32 * kWarps)
predict_rows(const float* __restrict__ q_r, const uint8_t* __restrict__ q_known,
             const float* __restrict__ q_mean, const float* __restrict__ n_r,
             const float* __restrict__ n_mean, const float* __restrict__ sims,
             const Id* __restrict__ ids, const uint8_t* __restrict__ valid,
             float* __restrict__ out, int q, int P, int c, int n) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= q) return;                        // the whole warp
  const long long slot0 = (long long)u * P;
  const float mu_q = q_mean[u];
  for (int c0 = 0; c0 < c; c0 += kCols) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float abs_sum = 0.f;
    bool poison = false;
    for (int g0 = 0; g0 < P; g0 += 32) {
      const int p = g0 + lane;
      long long id = 0;
      float w = 0.f, mu = 0.f;
      bool take = false, oob = false;
      if (p < P && valid[slot0 + p]) {
        id = (long long)ids[slot0 + p];
        oob = id < 0 || id >= n;
        take = !oob;
        if (take) {
          w = sims[slot0 + p];
          mu = n_mean[id];
        }
      }
      poison |= __any_sync(kFull, oob);
      unsigned live = __ballot_sync(kFull, take);
      while (live) {                         // warp-uniform
        int s[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          s[k] = live ? __ffs(live) - 1 : -1;
          live &= live - 1;
        }
        long long rid[kUnroll];
        float ws[kUnroll], ms[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int src = s[k] < 0 ? 0 : s[k];
          rid[k] = __shfl_sync(kFull, id, src);
          ws[k] = __shfl_sync(kFull, w, src);
          ms[k] = __shfl_sync(kFull, mu, src);
        }
        float x[kUnroll][4];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          if (s[k] >= 0) load_cols<V4>(n_r + rid[k] * c, c0, lane, c, x[k]);
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (s[k] < 0) continue;
          abs_sum += fabsf(ws[k]);
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[t] = fmaf(ws[k], x[k][t] - ms[k], acc[t]);
        }
      }
    }
    const long long row = (long long)u * c;
    float r[4];
    load_cols<V4>(q_r + row, c0, lane, c, r);
    float y[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = col<V4>(c0, lane, t);
      const float delta = abs_sum > 0.f ? __fdiv_rn(acc[t], fmaxf(abs_sum, kEps)) : 0.f;
      const float pred = poison ? __int_as_float(0x7fc00000) : __fadd_rn(mu_q, delta);
      y[t] = (j < c && q_known[row + j]) ? r[t] : pred;
    }
    if (V4) {
      if (col<true>(c0, lane, 0) < c)
        *reinterpret_cast<float4*>(out + row + col<true>(c0, lane, 0)) =
            make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = col<false>(c0, lane, t);
        if (j < c) out[row + j] = y[t];
      }
    }
  }
}

template <typename Id>
int launch(const void* q_r, const void* q_known, const void* q_mean, const void* n_r,
           const void* n_mean, const void* sims, const void* ids, const void* valid,
           void* out, int q, int P, int c, int n, cudaStream_t stream) {
  const bool v4 = c % 4 == 0 &&
      (((uintptr_t)q_r | (uintptr_t)n_r | (uintptr_t)out) & 15) == 0;
  const dim3 grid((unsigned)((q + kWarps - 1) / kWarps)), block(32 * kWarps);
#define CFP_ARGS (const float*)q_r, (const uint8_t*)q_known, (const float*)q_mean, \
    (const float*)n_r, (const float*)n_mean, (const float*)sims, (const Id*)ids,     \
    (const uint8_t*)valid, (float*)out, q, P, c, n
  if (v4)
    predict_rows<Id, true><<<grid, block, 0, stream>>>(CFP_ARGS);
  else
    predict_rows<Id, false><<<grid, block, 0, stream>>>(CFP_ARGS);
#undef CFP_ARGS
  return (int)cudaGetLastError();
}

}  // namespace cfp

// ids: int32 (id_bytes 4) or int64 (8); every other operand as the header
// states, row-major and contiguous; out: [q, c] f32.
extern "C" int crt_cf_predict(const void* q_r, const void* q_known, const void* q_mean,
                              const void* n_r, const void* n_mean, const void* sims,
                              const void* ids, const void* valid, void* out, int q,
                              int P, int c, int n, int id_bytes, void* stream) {
  if (q < 0 || P < 0 || c < 0 || n < 0 || (id_bytes != 4 && id_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (q == 0 || c == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return id_bytes == 8
      ? cfp::launch<long long>(q_r, q_known, q_mean, n_r, n_mean, sims, ids, valid, out,
                               q, P, c, n, s)
      : cfp::launch<int32_t>(q_r, q_known, q_mean, n_r, n_mean, sims, ids, valid, out,
                             q, P, c, n, s);
}
