// K1, tile-major: slab-window dot products with each slab row staged once.
//
// Replaces the TPU kernel crypto_rec_tpu/ops/pallas/slabscore.py
// (slab_window_dots, pallas_call at :360; body _make_kernel_fused
// :176-244).  Same function as the row-wise body in slabscore.cu: for
// every (query, window) pair p, dots[p, lane] = query . slab[row0[p] + lane]
// for lane < win, times scale[row0[p] + lane] when a per-row scale is given
// (the JAX package multiplies its kernel's output by the gathered scale
// windows, slabscore.py:381-395), -inf outside [head, head + size) when
// mask != 0.
//
// What bounds it on the H100: the unique bytes, each slab row covered by a
// window read once plus the dots written once (at the CF point ~1.9 GB of
// slab and 0.17 GB of dots, ~0.62 ms at 3.35 TB/s).  The row-wise body
// reads every window from memory, so it pays for the LOGICAL bytes instead
// (5.4 GB there; 550 GB on the euclidean cube, where ~256 queries probe
// each vertex).  Reading a row once means dotting it against every query
// whose window covers it: a matrix product, 2 q T win d FLOP (1.2 TFLOP on
// the euclidean cubes), which only the tensor cores finish under the byte
// bound (16-18 ms at 67 TFLOP/s of f32 FFMA).
//
// Design:
// - The wrapper (ops/kernels/slabscore.py, plain torch on the device)
//   sorts the pairs by row0, cuts the flat slab into tiles of RT rows (256
//   at d <= 128, 128 at d = 256: the tile's bf16 rows take 64 KB) and
//   lists work items: a tile and at most M = 32 of the sorted pairs whose
//   windows meet it (a contiguous range), so a hot tile is spread over
//   many blocks.
// - A block takes one item: it stages the tile's rows in shared memory as
//   bf16 (int8 upcast in registers, bf16 copied by cp.async) and its
//   pairs' f32 queries, split in registers into three bf16 terms q = hi +
//   mid + lo; int8 and bf16 slab values are exact in bf16, so the three
//   products summed in f32 keep f32 accuracy (two terms leave ~2^-16
//   relative).  The pairs' fields (pair id, row0, head, head + size)
//   come pre-gathered in sorted order, so a block's loads take two
//   rounds: the tile's rows, and beside them each pair's fields and then
//   its query terms.
// - 8 warps compute the M x RT dots with mma.sync m16n8k16 bf16 (f32
//   accumulate), operands read by ldmatrix from rows whose 16-byte chunks
//   are XOR-swizzled on the row's low 3 bits (conflict-free).  Each
//   16-wide slice of d is summed from zero by the tensor core and added to
//   the running dot in f32: the tensor core's f32 accumulation truncates
//   relative to its accumulator, so feeding it the running total costs
//   accuracy where dots cancel (augmented int8 rows, dots ~10^3).  A warp
//   skips the m16 tiles past the item's pairs.
// - The epilogue stages the dots in shared memory and writes, for each
//   pair, the lanes tile_row - row0[p] that fall in [0, win): one
//   contiguous run of dots[p], a warp's 32 lanes a whole line.  Every
//   (pair, lane) belongs to exactly one tile and one item, so each is
//   written once.
// - f32 slabs are not exact in bf16: they take f32 FFMA in the same item
//   schedule (RT = 32, M = 32), a simple loop over shared memory.
// - Offsets into dots are 64-bit: q T win exceeds 2^31 on the euclidean
//   MultiCube.
// - The per-row scale (per-row int8 packs) is applied where each lane is
//   stored, the one place its absolute slab row is known: one 4-byte load
//   beside each store (a tile's 1 KB of scales, cached), and the dots are
//   still written once.

#include "slabrow.cuh"
#include "tilemma.cuh"

namespace {

using namespace slabrow;
using namespace tilemma;

constexpr int kThreads = 256;     // 8 warps: 2 along the pairs, 4 along the rows
constexpr int kM = 32;            // pairs per item (tensor-core path)
constexpr int kMaxD = 256;
constexpr int kF32RT = 32, kF32M = 32;

// the sorted pairs' fields in Args::meta, [kMeta][P] int32; the query of
// pair p is p / T
enum Meta { kPair = 0, kRow0, kHead, kHeadEnd, kMeta };

struct Args {
  const uint8_t* slab;
  const float* queries;      // [q, d] f32, 16-byte aligned
  const float* scale;        // [n_rows] f32 per slab row, or null: no scale
  const int32_t* meta;       // [kMeta, P] (mask on) or [kHead, P]: pair id, row0,
                             // head, head + size, in the pairs' row0 order
  const int32_t* item_tile;  // [I]
  const int32_t* item_lo;    // [I] first sorted position of the item
  const int32_t* item_cnt;   // [I] pairs in the item; 0 from the first empty on
  float* dots;               // [P, win]
  int n_items, P, T, win, d, n_rows, mask;
};

// the stored value of a dot against slab row `row` (absolute): times the
// row's scale when there is one, -inf on a masked lane
__device__ __forceinline__ float lane_value(const Args& a, int row, int lane, int h0,
                                            int h1, float v) {
  if (a.scale) v *= __ldg(a.scale + row);
  return a.mask && (lane < h0 || lane >= h1) ? __int_as_float(0xff800000) : v;
}

// one output lane of pair slot m at tile row `row` (absolute)
__device__ __forceinline__ void put(const Args& a, const int (*s_meta)[64], int m,
                                    int row, float v) {
  const int lane = row - s_meta[kRow0][m];
  if (lane < 0 || lane >= a.win) return;
  a.dots[(size_t)s_meta[kPair][m] * a.win + lane] =
      lane_value(a, row, lane, s_meta[kHead][m], s_meta[kHeadEnd][m], v);
}

struct Item {
  int cnt, lo, tile;
};

__device__ __forceinline__ Item load_item(const Args& a, int i) {
  Item it{0, 0, 0};
  if (i < a.n_items) {
    it.cnt = a.item_cnt[i];
    it.lo = a.item_lo[i];
    it.tile = a.item_tile[i];
  }
  return it;
}

// ---- tensor-core path: int8 / bf16 slabs ----
//
// One block an item; two blocks share an SM (88 KB of shared memory at
// d <= 128, 113 KB at d = 256), so one block's loads overlap the other's
// tensor-core work.  MT = 2 (d <= 128): tiles of 256 rows, the 8 warps
// side by side along the rows, each with both m16 tiles of the 32 pairs.
// MT = 1 (d = 256): tiles of 128 rows, warps 2 x 4 (pairs x rows).  Either
// way a warp owns (16 MT) x 32 of the output.
template <int DT, int MT>
__global__ void __launch_bounds__(kThreads, 2)
tile_dots_mma(Args a) {
  constexpr int M = kM;
  constexpr int kRT = 128 * MT;
  constexpr int kLd = DT == kI8 ? kRT * (MT == 2 ? 128 : 256) / 16 / kThreads : 1;
  const Item it = load_item(a, blockIdx.x);
  const int cnt = it.cnt;
  if (cnt == 0) return;
  const int tile0 = it.tile * kRT;
  const int d = a.d, cpr = d / 8, c16 = d / 16;   // 16-byte chunks: bf16, int8

  extern __shared__ __align__(128) uint8_t smem_raw[];
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kRT][d]
  __nv_bfloat16* a_s = b_s + kRT * d;                                 // [3][M][d]
  int (*s_meta)[64] = reinterpret_cast<int (*)[64]>(a_s + 3 * M * d); // [kMeta][64]
  const float* qf = static_cast<const float*>(a.queries);

  // the tile's rows, zero past the slab's end: int8 loads issued first,
  // upcast exactly once the pairs' loads are on their way
  uint4 v[kLd];
  if (DT == kI8) {
#pragma unroll
    for (int j = 0; j < kLd; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / c16;
      v[j] = make_uint4(0, 0, 0, 0);
      if (i < kRT * c16 && tile0 + r < a.n_rows)
        v[j] = __ldg(reinterpret_cast<const uint4*>(a.slab + (size_t)(tile0 + r) * d) +
                     i % c16);
    }
  } else {
    for (int i = threadIdx.x; i < kRT * cpr; i += kThreads) {
      const int r = i / cpr, c = i % cpr;
      const bool ok = tile0 + r < a.n_rows;
      const uint8_t* src = ok ? a.slab + ((size_t)(tile0 + r) * d + c * 8) * 2 : a.slab;
      cp_async16(b_s + swz(r, c, d), src, ok ? 16 : 0);
    }
  }
  // pair slot m = threadIdx.x / 8 and its 8 lanes: the slot's fields, and
  // as soon as its pair id lands the query, split into its three bf16
  // terms, while the tile's rows are still on their way; rows past cnt are
  // never read into a written dot
  static_assert(kThreads / 8 == M, "one 8-lane group a pair slot");
  const int slot = threadIdx.x / 8, sub = threadIdx.x % 8;
  if (slot < cnt) {
    const int p = __ldg(a.meta + (size_t)kPair * a.P + it.lo + slot);
    if (sub < (a.mask ? kMeta : kHead))
      s_meta[sub][slot] = sub == kPair ? p : __ldg(a.meta + (size_t)sub * a.P + it.lo + slot);
    const float4* q4 = reinterpret_cast<const float4*>(qf + (size_t)(p / a.T) * d);
    for (int c = sub; c < cpr; c += 8) {           // 8 elements a chunk
      const float4 u = __ldg(q4 + 2 * c), w = __ldg(q4 + 2 * c + 1);
      const float x[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
      uint32_t t[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float h[2][3];
#pragma unroll
        for (int k = 0; k < 2; ++k) split3(x[2 * e + k], h[k]);
#pragma unroll
        for (int term = 0; term < 3; ++term) t[term][e] = bf16x2(h[0][term], h[1][term]);
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
        *reinterpret_cast<uint4*>(a_s + term * M * d + swz(slot, c, d)) =
            make_uint4(t[term][0], t[term][1], t[term][2], t[term][3]);
    }
  }
  if (DT == kI8) {
#pragma unroll
    for (int j = 0; j < kLd; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i >= kRT * c16) break;
      const int r = i / c16, c = i % c16;
      const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      uint32_t o[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * e] = bf16x2(i8(w[e], 0), i8(w[e], 1));
        o[2 * e + 1] = bf16x2(i8(w[e], 2), i8(w[e], 3));
      }
      *reinterpret_cast<uint4*>(b_s + swz(r, 2 * c, d)) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(b_s + swz(r, 2 * c + 1, d)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int m_base = MT == 2 ? 0 : (warp / 4) * 16;
  const int n_base = MT == 2 ? warp * 32 : (warp % 4) * 32;
  const int mt_live = max(0, min(MT, (cnt - m_base + 15) / 16));
  const int mi = l >> 3, rr = l & 7;
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int kc = 0; mt_live > 0 && kc < d / 16; ++kc) {
    uint32_t b[4][2];
#pragma unroll
    for (int nb = 0; nb < 4; nb += 2) {
      uint32_t r4[4];
      const int row = n_base + nb * 8 + rr + (mi >> 1) * 8;
      ldmatrix_x4(r4, b_s + swz(row, 2 * kc + (mi & 1), d));
      b[nb][0] = r4[0]; b[nb][1] = r4[1]; b[nb + 1][0] = r4[2]; b[nb + 1][1] = r4[3];
    }
    // this slice's 16 products of each term start from zero (hi, then mid
    // and lo onto it) and join the running sums with an f32 add: the
    // tensor core's accumulation error is relative to the slice's sum, not
    // to the running total's
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= mt_live) break;
      const int arow = m_base + mt * 16 + rr + (mi & 1) * 8;
      float part[4][4];
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        uint32_t af[4];
        ldmatrix_x4(af, a_s + term * M * d + swz(arow, 2 * kc + (mi >> 1), d));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (term == 0) mma_bf16_zero(part[nt], af, b[nt][0], b[nt][1]);
          else mma_bf16(part[nt], af, b[nt][0], b[nt][1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[nt][e];
    }
  }

  // the epilogue goes through shared memory (the tile's space, free once
  // every warp is done with it), so each pair's run of lanes is written
  // with whole-line stores rather than 8-byte pieces of 8 rows
  constexpr int OS = kRT + 8;          // row stride: float2 writes conflict-free
  float* o_s = reinterpret_cast<float*>(b_s);                         // [M][OS]
  __syncthreads();
  const int g = l >> 2, tig = l & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mt_live) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m_base + mt * 16 + g + half * 8;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(o_s + m * OS + n_base + nt * 8 + 2 * tig) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
  }
  __syncthreads();
  for (int m = warp; m < cnt; m += kThreads / 32) {
    const int r0 = s_meta[kRow0][m];
    const int lo = max(0, tile0 - r0), hi = min(a.win, tile0 + kRT - r0);
    const int h0 = s_meta[kHead][m], h1 = s_meta[kHeadEnd][m];
    float* dst = a.dots + (size_t)s_meta[kPair][m] * a.win;
    const float* src = o_s + m * OS + r0 - tile0;
    for (int lane = lo + l; lane < hi; lane += 32)
      dst[lane] = lane_value(a, r0 + lane, lane, h0, h1, src[lane]);
  }
}

// ---- f32 slabs: FFMA over the same item schedule, one block an item ----
__global__ void __launch_bounds__(kThreads)
tile_dots_f32(Args a) {
  const Item it = load_item(a, blockIdx.x);
  const int cnt = it.cnt;
  if (cnt == 0) return;
  const int tile0 = it.tile * kF32RT;
  const int d = a.d, ds = d + 1;      // odd stride: rows on distinct banks
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* b_s = reinterpret_cast<float*>(smem_raw);   // [kF32RT][d + 1]
  float* q_s = b_s + kF32RT * ds;                    // [kF32M][d + 1]
  int (*s_meta)[64] = reinterpret_cast<int (*)[64]>(q_s + kF32M * ds);
  const float* slab = reinterpret_cast<const float*>(a.slab);
  const float* qf = a.queries;
  if ((int)threadIdx.x < cnt) {
    for (int f = 0; f < (a.mask ? kMeta : kHead); ++f)
      s_meta[f][threadIdx.x] = a.meta[(size_t)f * a.P + it.lo + threadIdx.x];
  }
  for (int i = threadIdx.x; i < kF32RT * d; i += kThreads) {
    const int r = i / d, k = i % d;
    b_s[r * ds + k] = tile0 + r < a.n_rows ? slab[(size_t)(tile0 + r) * d + k] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kF32M * d; i += kThreads) {
    const int m = i / d, k = i % d;
    q_s[m * ds + k] = m < cnt ? qf[(size_t)(s_meta[kPair][m] / a.T) * d + k] : 0.f;
  }
  __syncthreads();
  const int m = threadIdx.x / 8, n0 = threadIdx.x % 8;   // 4 rows n0 + 8 j each
  if (m >= cnt) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < d; ++k) {
    const float qv = q_s[m * ds + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(b_s[(n0 + 8 * j) * ds + k], qv, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) put(a, s_meta, m, tile0 + n0 + 8 * j, acc[j]);
}

template <int DT, int MT>
int launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)(128 * MT + 3 * kM) * a.d * 2 + kMeta * 64 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tile_dots_mma<DT, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_dots_mma<DT, MT><<<a.n_items, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// rt / m: the tile rows and pairs per item the wrapper's work list used;
// they must be this kernel's (int8 / bf16: 256 rows at d <= 128, 128 at
// d = 256, 32 pairs; f32: 32 and 32).  scale: f32 [n_rows] or null.
extern "C" int crt_slab_tile_dots(const void* slab, const void* queries,
                                  const void* scale,
                                  const void* meta, const void* item_tile,
                                  const void* item_lo, const void* item_cnt,
                                  void* dots, int n_items, int P, int T, int win,
                                  int d,
                                  int n_rows, int mask, int dtype, int rt, int m,
                                  void* stream) {
  Args a{(const uint8_t*)slab, (const float*)queries, (const float*)scale,
         (const int32_t*)meta, (const int32_t*)item_tile,
         (const int32_t*)item_lo, (const int32_t*)item_cnt, (float*)dots,
         n_items, P, T, win, d, n_rows, mask};
  cudaStream_t s = (cudaStream_t)stream;
  if (n_items <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    if (d % 4 || rt != kF32RT || m != kF32M) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(kF32RT + kF32M) * (d + 1) * 4 + kMeta * 64 * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        tile_dots_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tile_dots_f32<<<n_items, kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (d % 64 || rt != (d <= 128 ? 256 : 128) || m != kM) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) return d <= 128 ? launch_mma<kBF16, 2>(a, s) : launch_mma<kBF16, 1>(a, s);
  if (dtype == kI8) return d <= 128 ? launch_mma<kI8, 2>(a, s) : launch_mma<kI8, 1>(a, s);
  return (int)cudaErrorInvalidValue;
}
