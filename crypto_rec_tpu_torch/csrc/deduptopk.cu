// D1: the dedup top-k epilogue of the packed retrieval, one launch.
//
// Replaces no TPU kernel: the JAX package runs this stage as XLA ops
// (crypto_rec_tpu/ops/pallas/slabscore.py:399 _dedup_topk_pairs: a stable
// id sort, a gather, lax.top_k), and so does the port's plain version
// (ops/kernels/deduptopk.py dedup_topk_plain): two stable segmented sorts
// of [q, m] and about 30 torch launches.  Per row of m (score, candidate)
// pairs this kernel returns what the plain version returns, bit for bit:
//   - a candidate is dropped when its id is >= n_rows, its score is not
//     finite, or an earlier position of the row holds the same id (the
//     first occurrence decides, whatever a later duplicate scores);
//   - of the survivors the best min(k, m), score descending, equal scores
//     (+0.0 and -0.0 equal) lowest id first, each score with its own bits;
//     empty slots -inf and id -1.
// Two operand forms, one body:
//   resolved: ids [q, m] int32 / int64 (ids below -2^31 read as -2^31);
//   lanes:    S1's lanes [q, m] int32 / int64 with the windows they index,
//             aligned [q, T] and rows [T, n_pad] int32: lane j of the
//             per-table stage 1 (kk > 0) is lane[j] of window t = j / kk,
//             of the flat one (kk = 0) lane[j] % win of window
//             lane[j] / win; its row is rows[t, min(aligned[t] + lane,
//             n_pad - 1)], and a lane whose score is -inf or NaN is a pad
//             (ops/kernels/deduptopk.lane_rows and the sentinel).
//
// What bounds it on the H100: bytes.  The scores and lanes read once, each
// lane's row id gathered once, the top-k written once: 127 MB, 0.038 ms at
// the CF cell's shape (q = 73,421, m = 96 = 8 windows x 12, k = 20, int64
// lanes), 45 MB, 0.013 ms at the batch cell's ([8,192, 320] -> 40) at 3.35
// TB/s (bounds.dedup_call).  Its comparisons run on no unit with a
// published peak.  Nothing of [q, m] is written back.
//
// Design: one warp a row for m <= 1,024 (both cells: 96 and 320), PER =
// the power of two >= m / 32 candidates a lane in registers, lane-strided
// (position j * 32 + lane) so the loads coalesce.
// 1. Dedup: each candidate claims its id's slot in a warp-private hash
//    table in shared memory (2 x 32 PER 64-bit slots of (id, position),
//    open addressing): one atomicCAS where the id is new, an atomicMin of
//    the pair where it is not, so the slot ends holding the id's least
//    position.  After a __syncwarp a candidate survives where its slot
//    holds its own position.  No sort.
// 2. Select: a survivor's 64-bit key is its score's order-preserving image
//    (-0.0 folded onto +0.0) over its biased id inverted, so keys are
//    unique and order as (score desc, id asc); a dropped candidate's key is
//    0, below every survivor's.  The n = min(k, survivors)-th largest key
//    is found bit by bit below the keys' common prefix (a warp count a
//    bit, __reduce_add_sync, stopping where exactly n keys are at or above
//    it); the n winners go to shared memory by ballot, and each is written
//    at its rank, counted among them (n <= kRankMax).  Where more than
//    kRankMax are kept, a bitonic sort of the row's 32 PER keys in
//    registers (strides below PER swap registers, the rest
//    __shfl_xor_sync) puts slot t at output t.
// 3. Write: each output's score is read again at the first position its
//    id's slot holds (L1), so -0.0 stays -0.0; the table is cleared for
//    the warp's next row.
// Past 1,024 candidates (up to kMaxM) one block of kBlockThreads a row runs
// steps 1 and 3 with the keys in shared memory (24 B a candidate slot: the
// keys, a table of twice the slots) and sorts them by a bitonic sort
// between barriers.  Warps and blocks walk rows grid-strided; each adds its
// survivors to `kept` (a 64-bit device counter, when given) once.  The
// kernels' names share no part with S1's (warp_rows, block_rows), which
// the benchmark's readers pick out of a trace by name.

#include <cuda_runtime.h>
#include <stdint.h>

namespace d1 {

typedef unsigned int u32;
typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = 0x7FFFFFFF;        // no candidate: no kept id is INT_MAX
constexpr u64 kFree = ~0ull;              // a free slot: no (id, position) is all ones
constexpr int kRankMax = 64;              // winners a warp ranks by counting
constexpr int kWarpMaxM = 1024;
constexpr int kMaxM = 8192;
constexpr int kBlockThreads = 1024;
constexpr float kMaxFinite = 3.402823466e38f;
constexpr u32 kNegInfBits = 0xff800000u;

struct Rows {
  const float* scores;   // [q, m]
  const void* ids;       // [q, m] ids or lanes
  const int* aligned;    // [q, T] (lanes form) or null
  const int* rows;       // [T, n_pad] (lanes form)
  float* out_s;          // [q, k]
  int* out_i;            // [q, k]
  u64* kept;             // a device counter or null
  int q, m, k, n_rows, T, n_pad, win, kk;
};

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }
__host__ __device__ constexpr int warps_of(int per) { return per >= 32 ? 2 : 4; }   // <= 35 KB

__device__ __forceinline__ u32 order_bits(float x) {
  const u32 u = __float_as_uint(x);
  const u32 img = u ^ ((u32)((int)u >> 31) | 0x80000000u);   // negative: ~u, else u | sign
  return img == 0x7FFFFFFFu ? 0x80000000u : img;             // -0.0 ties +0.0
}

__device__ __forceinline__ u64 make_key(float s, int id) {
  return ((u64)order_bits(s) << 32) | (u64)(~((u32)id ^ 0x80000000u));
}

__device__ __forceinline__ int key_id(u64 key) {
  return (int)(~(u32)key ^ 0x80000000u);
}

__device__ __forceinline__ bool finite(float s) { return fabsf(s) <= kMaxFinite; }

// Candidate e of the row: its row id, or kEmpty where it is dropped before
// the dedup (an id >= n_rows; in the lanes form also a -inf / NaN score).
template <typename Id>
__device__ __forceinline__ int candidate_id(const Rows& o, int row, int e, float s) {
  long long v = (long long)__ldg((const Id*)o.ids + (size_t)row * o.m + e);
  if (o.aligned != nullptr) {
    if (!(s > __uint_as_float(kNegInfBits))) return kEmpty;
    int t, off;
    if (o.kk > 0) {
      t = e / o.kk;
      off = (int)v;
    } else {
      t = (int)(v / o.win);
      off = (int)(v % o.win);
    }
    const int pos = min(__ldg(o.aligned + (size_t)row * o.T + t) + off, o.n_pad - 1);
    v = __ldg(o.rows + (size_t)t * o.n_pad + pos);
  }
  if (v >= o.n_rows) return kEmpty;
  return (int)(v < -2147483648LL ? -2147483648LL : v);
}

__device__ __forceinline__ u32 hash_slot(int id, int shift) {
  return ((u32)id * 2654435761u) >> shift;
}

__device__ __forceinline__ u64 entry(int id, int e) {
  return ((u64)(u32)id << 32) | (u32)e;
}

// Insert (id, e) into the table: one atomicCAS claims a free slot; where the
// id holds one already, atomicMin leaves the least position in it.
__device__ __forceinline__ u32 insert(u64* tab, u32 mask, int shift, int id, int e) {
  const u64 mine = entry(id, e);
  u32 h = hash_slot(id, shift);
  for (;;) {
    const u64 prev = atomicCAS(tab + h, kFree, mine);
    if (prev == kFree) break;
    if ((u32)(prev >> 32) == (u32)id) {
      atomicMin(tab + h, mine);
      break;
    }
    h = (h + 1) & mask;
  }
  return h;
}

// The first position of an id the table holds (no free slot precedes its
// slot on its probe path).
__device__ __forceinline__ int first_pos(const u64* tab, u32 mask, int shift, int id) {
  u32 h = hash_slot(id, shift);
  while ((u32)(tab[h] >> 32) != (u32)id) h = (h + 1) & mask;
  return (int)(u32)tab[h];
}

// Output slot t of the row from its key: the id, the score at its first position.
__device__ __forceinline__ void write_slot(const Rows& o, int row, int kout, int t, u64 key,
                                           const u64* tab, u32 mask, int shift,
                                           const float* src) {
  float v = __uint_as_float(kNegInfBits);
  int id = -1;
  if (key != 0ull) {
    id = key_id(key);
    v = __ldg(src + first_pos(tab, mask, shift, id));
  }
  o.out_s[(size_t)row * kout + t] = v;
  o.out_i[(size_t)row * kout + t] = id;
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

__device__ __forceinline__ u32 lanes_below() {
  u32 r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

// Bitonic sort, descending, of the warp's 32 PER keys, slot lane * PER + j.
template <int PER>
__device__ __forceinline__ void warp_sort_desc(u64 (&key)[PER], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * PER; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= PER) {
        const int lx = stride / PER;
        const bool lower = (lane & lx) == 0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const bool desc = ((lane * PER + j) & size) == 0;
          const u64 o = __shfl_xor_sync(kFull, key[j], lx);
          key[j] = lower == desc ? umax(key[j], o) : umin(key[j], o);
        }
      } else {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if ((j & stride) == 0) {
            const bool desc = ((lane * PER + j) & size) == 0;
            const u64 a = key[j], b = key[j | stride];
            key[j] = desc ? umax(a, b) : umin(a, b);
            key[j | stride] = desc ? umin(a, b) : umax(a, b);
          }
        }
      }
    }
  }
}

// The n-th largest of the warp's nonzero keys (unique; 1 <= n < their
// count): the bits below the keys' common prefix set from the top while at
// least n keys stay at or above, stopping where exactly n do.
template <int PER>
__device__ __forceinline__ u64 warp_nth(const u64 (&key)[PER], u32 n) {
  u32 hmax = 0u, hmin = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (key[j] != 0ull) {
      hmax = max(hmax, (u32)(key[j] >> 32));
      hmin = min(hmin, (u32)(key[j] >> 32));
    }
  }
  hmax = __reduce_max_sync(kFull, hmax);
  hmin = __reduce_min_sync(kFull, hmin);
  const u32 d = hmax ^ hmin;
  int b = d ? 63 - __clz(d) : 31;
  u64 lo = d ? (u64)(hmax & ~((2u << (31 - __clz(d))) - 1u)) << 32 : (u64)hmax << 32;
  for (; b >= 0; --b) {
    const u64 cand = lo | (1ull << b);
    u32 c = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) c += key[j] >= cand;
    c = __reduce_add_sync(kFull, c);
    if (c >= n) {
      lo = cand;
      if (c == n) break;
    }
  }
  return lo;
}

template <int PER, typename Id>
__global__ void __launch_bounds__(32 * warps_of(PER))
warp_dedup(const Rows o) {
  constexpr int H = 64 * PER, W = warps_of(PER);
  constexpr int kShift = 32 - ilog2(H);
  constexpr u32 kMask = H - 1;
  extern __shared__ u64 wsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  u64* tab = wsm + warp * (H + kRankMax);
  u64* buf = tab + H;
  for (int i = lane; i < H; i += 32) tab[i] = kFree;
  __syncwarp();
  const int kout = min(o.k, o.m);
  u64 kept = 0;
  for (int row = blockIdx.x * W + warp; row < o.q; row += gridDim.x * W) {
    const float* src = o.scores + (size_t)row * o.m;
    float s[PER];
    int id[PER];
    u32 slot[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = j * 32 + lane;
      s[j] = e < o.m ? __ldg(src + e) : 0.0f;
      id[j] = e < o.m ? candidate_id<Id>(o, row, e, s[j]) : kEmpty;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j)
      slot[j] = id[j] != kEmpty ? insert(tab, kMask, kShift, id[j], j * 32 + lane) : 0u;
    __syncwarp();
    u64 key[PER];
    u32 n_keep = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const bool keep = id[j] != kEmpty && (u32)tab[slot[j]] == (u32)(j * 32 + lane) &&
                        finite(s[j]);
      key[j] = keep ? make_key(s[j], id[j]) : 0ull;
      n_keep += keep;
    }
    const u32 S = __reduce_add_sync(kFull, n_keep);
    kept += S;
    const u32 n = min((u32)kout, S);
    if (n <= (u32)kRankMax) {
      // the n winners to buf, then each written at its rank among them
      const u64 lo = n == S ? 1ull : warp_nth<PER>(key, n);
      u32 base = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const bool w = key[j] >= lo;
        const u32 b = __ballot_sync(kFull, w);
        if (w) buf[base + __popc(b & lanes_below())] = key[j];
        base += __popc(b);
      }
      __syncwarp();
      for (u32 p = lane; p < n; p += 32) {
        const u64 kp = buf[p];
        u32 r = 0;
        for (u32 i = 0; i < n; ++i) r += buf[i] > kp;
        write_slot(o, row, kout, (int)r, kp, tab, kMask, kShift, src);
      }
      for (int t = (int)n + lane; t < kout; t += 32)
        write_slot(o, row, kout, t, 0ull, tab, kMask, kShift, src);
    } else {
      warp_sort_desc<PER>(key, lane);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int t = lane * PER + j;
        if (t < kout) write_slot(o, row, kout, t, key[j], tab, kMask, kShift, src);
      }
    }
    __syncwarp();
    for (int i = lane; i < H; i += 32) tab[i] = kFree;
    __syncwarp();
  }
  if (o.kept != nullptr && lane == 0 && kept) atomicAdd(o.kept, kept);
}

template <typename Id>
__global__ void __launch_bounds__(kBlockThreads)
block_dedup(const Rows o, int log_p2) {
  extern __shared__ u64 bsm[];
  const int P2 = 1 << log_p2, H = 2 * P2;
  const int shift = 32 - (log_p2 + 1);
  const u32 mask = (u32)H - 1;
  u64* keys = bsm;
  u64* tab = keys + P2;
  const int tid = threadIdx.x;
  for (int i = tid; i < H; i += kBlockThreads) tab[i] = kFree;
  __syncthreads();
  const int kout = min(o.k, o.m);
  u64 kept = 0;
  for (int row = blockIdx.x; row < o.q; row += gridDim.x) {
    const float* src = o.scores + (size_t)row * o.m;
    for (int e = tid; e < o.m; e += kBlockThreads) {
      const int id = candidate_id<Id>(o, row, e, __ldg(src + e));
      if (id != kEmpty) insert(tab, mask, shift, id, e);
    }
    __syncthreads();
    for (int e = tid; e < P2; e += kBlockThreads) {
      u64 key = 0ull;
      if (e < o.m) {
        const float s = __ldg(src + e);
        const int id = candidate_id<Id>(o, row, e, s);
        if (id != kEmpty && finite(s) && first_pos(tab, mask, shift, id) == e)
          key = make_key(s, id);
      }
      keys[e] = key;
      kept += key != 0ull;
    }
    __syncthreads();
    for (int size = 2; size <= P2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < P2 / 2; i += kBlockThreads) {
          const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
          const bool desc = (lo & size) == 0;
          const u64 a = keys[lo], b = keys[hi];
          if (desc ? a < b : a > b) {
            keys[lo] = b;
            keys[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int t = tid; t < kout; t += kBlockThreads)
      write_slot(o, row, kout, t, keys[t], tab, mask, shift, src);
    __syncthreads();
    for (int i = tid; i < H; i += kBlockThreads) tab[i] = kFree;
    __syncthreads();
  }
  if (o.kept != nullptr) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) kept += __shfl_xor_sync(kFull, kept, d);
    if ((tid & 31) == 0 && kept) atomicAdd(o.kept, kept);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

template <int PER, typename Id>
int launch_warp(const Rows& o, cudaStream_t stream) {
  constexpr int W = warps_of(PER);
  const size_t smem = (size_t)W * (64 * PER + kRankMax) * sizeof(u64);
  static int per_sm = 0;                 // resident blocks an SM (one wave)
  if (per_sm == 0 && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &per_sm, warp_dedup<PER, Id>, 32 * W, smem) != cudaSuccess ||
                      per_sm < 1))
    per_sm = 1;
  const int need = (o.q + W - 1) / W, full = sm_count() * per_sm;
  const int grid = need < full ? need : full;
  warp_dedup<PER, Id><<<grid, 32 * W, smem, stream>>>(o);
  return (int)cudaGetLastError();
}

template <typename Id>
int launch(const Rows& o, cudaStream_t stream) {
  const int per = (o.m + 31) / 32;
  if (per <= 1) return launch_warp<1, Id>(o, stream);
  if (per <= 2) return launch_warp<2, Id>(o, stream);
  if (per <= 4) return launch_warp<4, Id>(o, stream);
  if (per <= 8) return launch_warp<8, Id>(o, stream);
  if (per <= 16) return launch_warp<16, Id>(o, stream);
  if (o.m <= kWarpMaxM) return launch_warp<32, Id>(o, stream);
  int log_p2 = 0;
  while ((1 << log_p2) < o.m) ++log_p2;
  const size_t smem = (size_t)(1 << log_p2) * 3 * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(block_dedup<Id>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = o.q < 2 * sm_count() ? o.q : 2 * sm_count();
  block_dedup<Id><<<grid, kBlockThreads, smem, stream>>>(o, log_p2);
  return (int)cudaGetLastError();
}

}  // namespace d1

// scores [q, m] f32; ids [q, m] int32 (id_bytes 4) or int64 (8): row ids, or
// with aligned [q, T] and rows [T, n_pad] (int32) given, S1's lanes of those
// windows (kk > 0: per-table stage 1 of kk lanes a window, m = T kk; kk 0:
// flat lanes in [0, T win)); out_s [q, min(k, m)] f32, out_i int32; kept: a
// 64-bit device counter the survivors are added to, or null.  All
// row-major and contiguous.
extern "C" int crt_dedup_topk(const void* scores, const void* ids, const void* aligned,
                              const void* rows, void* out_s, void* out_i, void* kept, int q,
                              int m, int k, int n_rows, int id_bytes, int T, int n_pad,
                              int win, int kk, void* stream) {
  if (q < 0 || m < 0 || m > d1::kMaxM || k < 0 || (id_bytes != 4 && id_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (aligned != nullptr && (rows == nullptr || T < 1 || n_pad < 1 || win < 1 || kk < 0))
    return (int)cudaErrorInvalidValue;
  if (q == 0 || m == 0 || k == 0) return 0;
  const d1::Rows o{(const float*)scores, ids, (const int*)aligned, (const int*)rows,
                   (float*)out_s, (int*)out_i, (unsigned long long*)kept,
                   q, m, k, n_rows, T, n_pad, win, kk};
  cudaStream_t s = (cudaStream_t)stream;
  return id_bytes == 8 ? d1::launch<long long>(o, s) : d1::launch<int32_t>(o, s);
}
