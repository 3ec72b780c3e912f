// K1, tile-major: slab-window dot products with each slab row staged once.
//
// Replaces the TPU kernel crypto_rec_tpu/ops/pallas/slabscore.py
// (slab_window_dots, pallas_call at :360; body _make_kernel_fused
// :176-244).  For every (query, window) pair p, dots[p, lane] = query . slab[row0[p] + lane]
// for lane < win, times scale[row0[p] + lane] when a per-row scale is given
// (the JAX package multiplies its kernel's output by the gathered scale
// windows, slabscore.py:381-395), -inf outside [head, head + size) when
// mask != 0.
//
// What bounds it on the H100: the unique bytes, each slab row covered by a
// window read once plus the dots written once (at the CF point ~1.9 GB of
// slab and 0.17 GB of dots, ~0.62 ms at 3.35 TB/s).  A body with one block
// a window reads every window from memory, so it pays for the LOGICAL bytes
// instead (5.4 GB there; 550 GB on the euclidean cube, where ~256 queries
// probe each vertex).  Reading a row once means dotting it against every
// query whose window covers it: a matrix product, 2 q T win d FLOP (1.2
// TFLOP on the euclidean cubes), which only the tensor cores finish under
// the byte bound (16-18 ms at 67 TFLOP/s of f32 FFMA).
//
// Design:
// - The wrapper (ops/kernels/slabscore.py, plain torch on the device)
//   sorts the pairs by row0, cuts the flat slab into tiles of RT rows (256
//   on the tensor cores, 32 on the FFMA body below) and lists work items: a
//   tile and at most M = 32 of the sorted pairs whose windows meet it (a
//   contiguous range), so a hot tile is spread over many blocks.
// - A block takes one item and loops over d as a GEMM loops over K: it
//   stages the tile's rows as bf16 (int8 upcast in registers, bf16 copied
//   by cp.async) and its pairs' f32 queries, split in registers into three
//   bf16 terms q = hi + mid + lo, one 64-wide d-chunk at a time in two
//   buffers (88 KB a block whatever d, so two blocks share an SM), the next
//   chunk's loads in flight while the tensor cores work on this one.  int8
//   and bf16 slab values are exact in bf16, so the three products summed in
//   f32 keep f32 accuracy (two terms leave ~2^-16 relative).  The pairs'
//   fields (pair id, row0, head, head + size) come pre-gathered in sorted
//   order.  The staged chunk rows are 128 bytes whatever d, so `swz` needs
//   no whole row.  Rows of whole 16-byte units (int8 d % 16 == 0, bf16 d %
//   8 == 0) load a unit at a time.  Other rows (the recommender's 100
//   items, its 15 coins) take instantiations of their own (`Load`): int8
//   4-byte words where d % 4 == 0 and the slab allows it, else words
//   funnel shifted into place, the columns past d zero in the rows and in
//   the queries.  The arithmetic is the same.
// - 8 warps, side by side along the tile's rows, compute the M x RT dots
//   with mma.sync m16n8k16 bf16 (f32 accumulate), operands read by
//   ldmatrix from rows whose 16-byte chunks are XOR-swizzled on the row's
//   low 3 bits (conflict-free).  Each 16-wide slice of d is summed from
//   zero by the tensor core and added to the running dot in f32, which
//   stays in registers across chunks: the tensor core's f32 accumulation
//   truncates relative to its accumulator, so feeding it the running total
//   costs accuracy where dots cancel (augmented int8 rows, dots ~10^3).
//   The slices run in d order whatever the chunk width, so the dots equal
//   one pass over whole rows, bit for bit.  A warp skips the m16 tiles past
//   the item's pairs.
// - The epilogue stages the dots in shared memory and writes, for each
//   pair, the lanes tile_row - row0[p] that fall in [0, win): one
//   contiguous run of dots[p], a warp's 32 lanes a whole line.  Every
//   (pair, lane) belongs to exactly one tile and one item, so each is
//   written once.
// - f32 slabs are not exact in bf16: they take f32 FFMA in the same item
//   schedule (RT = 32, M = 32), a simple loop over shared memory, whole
//   rows up to d = 256 and d-chunks of 256 past it (the FMAs run in d
//   order either way).
// - Offsets into dots and the slab are 64-bit: q T win exceeds 2^31 on
//   the euclidean MultiCube, and 1M rows x 8 tables x 1,536 B is 12.6 GB.
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
constexpr int kDC = 64;           // d-chunk of the tensor-core body (bf16 values)
constexpr int kRT = 256;          // tile rows of the tensor-core body
constexpr int kMT = kM / 16;      // m16 tiles of pairs a warp
constexpr int kF32RT = 32, kF32M = 32, kF32DC = 256;

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

// pair slot m = threadIdx.x / 8 and its 8 lanes: the slot's fields to
// s_meta; -> its pair id (0 past the item's pairs)
__device__ __forceinline__ int stage_meta(const Args& a, const Item& it,
                                          int (*s_meta)[64]) {
  static_assert(kThreads / 8 == kM, "one 8-lane group a pair slot");
  const int slot = threadIdx.x / 8, sub = threadIdx.x % 8;
  if (slot >= it.cnt) return 0;
  const int p = __ldg(a.meta + (size_t)kPair * a.P + it.lo + slot);
  if (sub < (a.mask ? kMeta : kHead))
    s_meta[sub][slot] = sub == kPair ? p : __ldg(a.meta + (size_t)sub * a.P + it.lo + slot);
  return p;
}

// 8 query elements x[0, 8), split into their three bf16 terms, to 16-byte
// chunk c of pair slot `slot` in each term's [kM][ld] block
__device__ __forceinline__ void store_terms(__nv_bfloat16* a_s, int ld, int slot, int c,
                                            float4 u, float4 w) {
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
    *reinterpret_cast<uint4*>(a_s + term * kM * ld + swz(slot, c, ld)) =
        make_uint4(t[term][0], t[term][1], t[term][2], t[term][3]);
}

// 16 int8 values (one 16-byte unit) upcast exactly to bf16, to 16-byte
// chunks c and c + 1 of row r of a [rows][ld] bf16 block
__device__ __forceinline__ void store_i8_unit(__nv_bfloat16* b_s, int ld, int r, int c,
                                              uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o[2 * e] = bf16x2(i8(w[e], 0), i8(w[e], 1));
    o[2 * e + 1] = bf16x2(i8(w[e], 2), i8(w[e], 3));
  }
  *reinterpret_cast<uint4*>(b_s + swz(r, c, ld)) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(b_s + swz(r, c + 1, ld)) = make_uint4(o[4], o[5], o[6], o[7]);
}

// The 16-wide slices [0, ks) of staged rows b_s [rows][ld] against the
// query terms a_s [3][kM][ld], onto the warp's running sums.  Each slice's
// 16 products of each term start from zero (hi, then mid and lo onto it)
// and join the running sums with an f32 add: the tensor core's
// accumulation error is relative to the slice's sum, not to the running
// total's.
__device__ __forceinline__ void mma_slices(float (&acc)[kMT][4][4], const __nv_bfloat16* b_s,
                                           const __nv_bfloat16* a_s, int ld, int ks,
                                           int mt_live, int n_base, int l) {
  const int mi = l >> 3, rr = l & 7;
  for (int kc = 0; kc < ks; ++kc) {
    uint32_t b[4][2];
#pragma unroll
    for (int nb = 0; nb < 4; nb += 2) {
      uint32_t r4[4];
      const int row = n_base + nb * 8 + rr + (mi >> 1) * 8;
      ldmatrix_x4(r4, b_s + swz(row, 2 * kc + (mi & 1), ld));
      b[nb][0] = r4[0]; b[nb][1] = r4[1]; b[nb + 1][0] = r4[2]; b[nb + 1][1] = r4[3];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt >= mt_live) break;
      const int arow = mt * 16 + rr + (mi & 1) * 8;
      float part[4][4];
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        uint32_t af[4];
        ldmatrix_x4(af, a_s + term * kM * ld + swz(arow, 2 * kc + (mi >> 1), ld));
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
}

// The epilogue goes through shared memory o_s (free once every warp is
// done with the staged rows), so each pair's run of lanes is written with
// whole-line stores rather than 8-byte pieces of 8 rows.
__device__ __forceinline__ void store_dots(const Args& a, const int (*s_meta)[64],
                                           const float (&acc)[kMT][4][4], float* o_s,
                                           int tile0, int cnt, int mt_live, int n_base) {
  constexpr int OS = kRT + 8;           // row stride: float2 writes conflict-free
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncthreads();
  const int g = l >> 2, tig = l & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    if (mt >= mt_live) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + half * 8;
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

// ---- rows that are not whole 16-byte units ----
//
// How the tensor-core body reads a chunk's rows:
enum Load {
  kLdUnit,    // 16-byte units (int8 d % 16 == 0, bf16 d % 8 == 0)
  kLdWord,    // int8, d % 4 == 0 and the slab 4-byte aligned, as the
              // recommender's 100 items are: each unit as four 4-byte loads
  kLdShift,   // any other d or slab address: pieces from the aligned 4-byte
              // words that hold them, funnel shifted into place
};
// A piece `pc` of a staged chunk row holds columns 4 pc .. 4 pc + 3 of the
// chunk: 8 bytes of bf16 at element offset `piece_at` of a [rows][kDC]
// block (half of a swizzled 16-byte chunk).  Elements past d are zero, and
// no word that holds none of a piece's elements is read.  A load's result
// is not used until the chunk's loads have all been issued (a load used at
// once waits its whole latency, piece after piece: twice the time).

__device__ __forceinline__ int piece_at(int r, int pc) {
  return swz(r, pc >> 1, kDC) + (pc & 1) * 4;
}

// the aligned 4-byte word that holds byte `at`
__device__ __forceinline__ const uint32_t* word_of(uintptr_t at) {
  return reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
}

// bf16 elements e0 .. e0 + n - 1 of the flat slab (1 <= n <= 4) as two
// words of bf16 pairs, the elements from n on zero
__device__ __forceinline__ uint2 bf16_piece(const uint8_t* slab, size_t e0, int n) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(slab + 2 * e0);
  const int sh = at & 3, end = sh + 2 * n;      // sh is 0 or 2
  const uint32_t* w = word_of(at);
  const uint32_t w1 = end > 4 ? __ldg(w + 1) : 0u;
  const uint32_t x0 = __funnelshift_r(__ldg(w), w1, 8 * sh);
  const uint32_t x1 = __funnelshift_r(w1, end > 8 ? __ldg(w + 2) : 0u, 8 * sh);
  return make_uint2(n < 2 ? x0 & 0xffffu : x0, n < 3 ? 0u : n < 4 ? x1 & 0xffffu : x1);
}

// query elements col .. col + 7 of a row of d (col < d), zero past d:
// 16-byte loads where the rows are 16-byte aligned (rows16: d % 4 == 0),
// else one by one
__device__ __forceinline__ void query_tail(const float* qrow, int col, int d, bool rows16,
                                           float4& u, float4& w) {
  if (rows16) {
    u = __ldg(reinterpret_cast<const float4*>(qrow + col));
    w = col + 4 < d ? __ldg(reinterpret_cast<const float4*>(qrow + col) + 1)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = col + e < d ? __ldg(qrow + col + e) : 0.f;
  u = make_float4(x[0], x[1], x[2], x[3]);
  w = make_float4(x[4], x[5], x[6], x[7]);
}

// ---- tensor-core path: int8 / bf16 slabs of any width ----
//
// Tiles of 256 rows, each warp 32 of them against both m16 tiles of the 32
// pairs; d in chunks of kDC = 64, two stage buffers of [256][64] rows and
// [3][32][64] query terms (44 KB each).  Chunk c + 1's loads are issued before chunk c's
// products and stored after them, so one barrier a chunk separates the
// buffers' writers from their readers.  Columns past d are zero (rows by
// cp.async's zero fill or a zero register, queries as zero terms); whole
// slices past d are skipped.  LD (`Load`): how the rows are read; int8
// values wait in registers (units, or shifted pieces) for the chunk's
// products, bf16 pieces that are shifted are stored at once.
template <int DT, int LD>
__global__ void __launch_bounds__(kThreads, 2)
tile_dots_mma(Args a) {
  constexpr int kStage = (kRT + 3 * kM) * kDC;            // bf16 values a stage
  constexpr int kUnits = DT == kI8 ? kRT * kDC / 16 / kThreads   // int8 16-byte units
                                   : kRT * kDC / 8 / kThreads;   // bf16 16-byte chunks
  constexpr int kPieces = kRT * kDC / 4 / kThreads;             // 4-element pieces
  static_assert(kThreads / (kDC / 4) == 16, "a thread's pieces lie 16 rows apart");
  const Item it = load_item(a, blockIdx.x);
  const int cnt = it.cnt;
  if (cnt == 0) return;
  const int tile0 = it.tile * kRT;
  const int d = a.d, nch = (d + kDC - 1) / kDC;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kStage]
  int (*s_meta)[64] = reinterpret_cast<int (*)[64]>(stage + 2 * kStage);
  const int p = stage_meta(a, it, s_meta);
  const int slot = threadIdx.x / 8, sub = threadIdx.x % 8;
  const bool q_live = slot < cnt;
  const float* qrow = a.queries + (size_t)(p / a.T) * d;

  constexpr bool kAlign = LD == kLdUnit;
  uint4 v[DT == kI8 && LD != kLdShift ? kUnits : 1];
  uint32_t w8[DT == kI8 && LD == kLdShift ? kPieces : 1];
  // pieces: the thread's piece of each of its rows (pc), and the columns
  // the slices read (the rest of a chunk is never staged)
  const int pc = threadIdx.x & 15, d16 = (d + 15) / 16 * 16;
  float4 qu = make_float4(0.f, 0.f, 0.f, 0.f), qw = qu;
  // chunk c's loads: int8 rows and the query into registers, bf16 rows by
  // cp.async straight into buffer c & 1
  auto load = [&](int c) {
    __nv_bfloat16* b_s = stage + (c & 1) * kStage;
    if constexpr (kAlign) {
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if constexpr (DT == kI8) {
          const int r = i >> 2, col = c * kDC + (i & 3) * 16;
          v[j] = make_uint4(0, 0, 0, 0);
          if (tile0 + r < a.n_rows && col < d)
            v[j] = __ldg(reinterpret_cast<const uint4*>(a.slab + (size_t)(tile0 + r) * d + col));
        } else {
          const int r = i >> 3, ch = i & 7, col = c * kDC + ch * 8;
          const bool ok = tile0 + r < a.n_rows && col < d;
          const uint8_t* src = ok ? a.slab + ((size_t)(tile0 + r) * d + col) * 2 : a.slab;
          cp_async16(b_s + swz(r, ch, kDC), src, ok ? 16 : 0);
        }
      }
    } else if constexpr (DT == kI8 && LD == kLdWord) {
      // a 16-byte unit's four words, those past d zero
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int r = i >> 2, col = c * kDC + (i & 3) * 16;
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(a.slab + (size_t)(tile0 + r) * d + col);
        const bool ok = tile0 + r < a.n_rows;
        v[j].x = ok && col < d ? __ldg(src) : 0u;
        v[j].y = ok && col + 4 < d ? __ldg(src + 1) : 0u;
        v[j].z = ok && col + 8 < d ? __ldg(src + 2) : 0u;
        v[j].w = ok && col + 12 < d ? __ldg(src + 3) : 0u;
      }
    } else if (c * kDC + pc * 4 < d16) {
      // n: the piece's elements before d (none past it); row j of the
      // thread is r0 + 16 j
      const int col = c * kDC + pc * 4, n = min(4, d - col), r0 = threadIdx.x >> 4;
      auto e0 = [&](int j) { return (size_t)(tile0 + r0 + 16 * j) * d + col; };
      auto live = [&](int j) { return n > 0 && tile0 + r0 + 16 * j < a.n_rows; };
      if constexpr (DT == kI8) {
        uint32_t hi[kPieces];
#pragma unroll
        for (int j = 0; j < kPieces; ++j) {
          const uintptr_t at = reinterpret_cast<uintptr_t>(a.slab + e0(j));
          w8[j] = live(j) ? __ldg(word_of(at)) : 0u;
          hi[j] = live(j) && (at & 3) + n > 4 ? __ldg(word_of(at) + 1) : 0u;
        }
        const uint32_t keep = n >= 4 ? ~0u : (1u << 8 * max(n, 0)) - 1;
#pragma unroll
        for (int j = 0; j < kPieces; ++j) {
          const uintptr_t at = reinterpret_cast<uintptr_t>(a.slab + e0(j));
          w8[j] = __funnelshift_r(w8[j], hi[j], 8 * (at & 3)) & keep;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPieces; ++j)
          *reinterpret_cast<uint2*>(b_s + piece_at(r0 + 16 * j, pc)) =
              live(j) ? bf16_piece(a.slab, e0(j), n) : make_uint2(0u, 0u);
      }
    }
    const int col = c * kDC + sub * 8;
    if (q_live && col < d) {
      if constexpr (kAlign) {
        qu = __ldg(reinterpret_cast<const float4*>(qrow + col));
        qw = __ldg(reinterpret_cast<const float4*>(qrow + col) + 1);
      } else {
        query_tail(qrow, col, d, d % 4 == 0, qu, qw);
      }
    } else {
      qu = qw = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // ... and their stores to buffer c & 1
  auto store = [&](int c) {
    __nv_bfloat16* b_s = stage + (c & 1) * kStage;
    if constexpr (DT == kI8 && LD != kLdShift) {
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        const int i = threadIdx.x + j * kThreads;
        store_i8_unit(b_s, kDC, i >> 2, 2 * (i & 3), v[j]);
      }
    }
    if constexpr (DT == kI8 && LD == kLdShift) {
      if (c * kDC + pc * 4 < d16) {
#pragma unroll
        for (int j = 0; j < kPieces; ++j) {
          const int r = (threadIdx.x >> 4) + 16 * j;
          *reinterpret_cast<uint2*>(b_s + piece_at(r, pc)) = make_uint2(
              bf16x2(i8(w8[j], 0), i8(w8[j], 1)), bf16x2(i8(w8[j], 2), i8(w8[j], 3)));
        }
      }
    }
    if (q_live) store_terms(b_s + kRT * kDC, kDC, slot, sub, qu, qw);
  };

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int n_base = warp * 32;
  const int mt_live = min(kMT, (cnt + 15) / 16);
  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  load(0);
  store(0);
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) load(c + 1);
    const __nv_bfloat16* b_s = stage + (c & 1) * kStage;
    const int ks = min(kDC / 16, (d - c * kDC + 15) / 16);
    mma_slices(acc, b_s, b_s + kRT * kDC, kDC, ks, mt_live, n_base, l);
    if (c + 1 < nch) store(c + 1);
    cp_async_wait_all();
    __syncthreads();
  }
  store_dots(a, s_meta, acc, reinterpret_cast<float*>(stage), tile0, cnt, mt_live, n_base);
}

// ---- f32 slabs at d <= 256: FFMA over the same item schedule, one block an
// item, whole rows staged ----
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

// ---- f32 slabs past d = 256: the body above, d in chunks of kF32DC ----
__global__ void __launch_bounds__(kThreads)
tile_dots_ffma(Args a) {
  const Item it = load_item(a, blockIdx.x);
  const int cnt = it.cnt;
  if (cnt == 0) return;
  const int tile0 = it.tile * kF32RT;
  const int d = a.d, dc = min(d, kF32DC), ds = dc + 1;   // odd stride: rows on distinct banks
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* b_s = reinterpret_cast<float*>(smem_raw);   // [kF32RT][dc + 1]
  float* q_s = b_s + kF32RT * ds;                    // [kF32M][dc + 1]
  int (*s_meta)[64] = reinterpret_cast<int (*)[64]>(q_s + kF32M * ds);
  const float* slab = reinterpret_cast<const float*>(a.slab);
  if ((int)threadIdx.x < cnt) {
    for (int f = 0; f < (a.mask ? kMeta : kHead); ++f)
      s_meta[f][threadIdx.x] = a.meta[(size_t)f * a.P + it.lo + threadIdx.x];
  }
  __syncthreads();
  const int m = threadIdx.x / 8, n0 = threadIdx.x % 8;   // 4 rows n0 + 8 j each
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < d; c0 += dc) {
    const int w = min(dc, d - c0);
    if (c0 > 0) __syncthreads();                   // the last chunk's reads are done
    for (int i = threadIdx.x; i < kF32RT * w; i += kThreads) {
      const int r = i / w, k = i % w;
      b_s[r * ds + k] = tile0 + r < a.n_rows ? slab[(size_t)(tile0 + r) * d + c0 + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32M * w; i += kThreads) {
      const int mm = i / w, k = i % w;
      q_s[mm * ds + k] = mm < cnt
          ? a.queries[(size_t)(s_meta[kPair][mm] / a.T) * d + c0 + k] : 0.f;
    }
    __syncthreads();
    if (m < cnt) {
      for (int k = 0; k < w; ++k) {
        const float qv = q_s[m * ds + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(b_s[(n0 + 8 * j) * ds + k], qv, acc[j]);
      }
    }
  }
  if (m >= cnt) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) put(a, s_meta, m, tile0 + n0 + 8 * j, acc[j]);
}

template <typename Kernel>
int launch(Kernel kernel, const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.n_items, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)2 * (kRT + 3 * kM) * kDC * 2 + kMeta * 64 * sizeof(int);
  if (DT == kI8 ? a.d % 16 == 0 : a.d % 8 == 0)
    return launch(tile_dots_mma<DT, kLdUnit>, a, smem, stream);
  if (DT == kI8 && a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.slab) % 4 == 0)
    return launch(tile_dots_mma<DT, kLdWord>, a, smem, stream);
  return launch(tile_dots_mma<DT, kLdShift>, a, smem, stream);
}

int launch_f32(const Args& a, cudaStream_t stream) {
  const int dc = a.d < kF32DC ? a.d : kF32DC;
  const size_t smem = (size_t)(kF32RT + kF32M) * (dc + 1) * 4 + kMeta * 64 * sizeof(int);
  if (a.d <= kF32DC) return launch(tile_dots_f32, a, smem, stream);
  return launch(tile_dots_ffma, a, smem, stream);
}

}  // namespace

// rt / m: the tile rows and pairs per item the wrapper's work list used
// (`tile_shape` in ops/kernels/slabscore.py); they must be this kernel's:
// f32 slabs 32 and 32 (FFMA); int8 / bf16 slabs of any width 256 and 32
// (tensor cores).  scale: f32 [n_rows] or null.
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
  if (d <= 0 || (dtype != kF32 && dtype != kBF16 && dtype != kI8))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    if (rt != kF32RT || m != kF32M) return (int)cudaErrorInvalidValue;
    return launch_f32(a, s);
  }
  if (rt != kRT || m != kM) return (int)cudaErrorInvalidValue;
  return dtype == kBF16 ? launch_mma<kBF16>(a, s) : launch_mma<kI8>(a, s);
}
