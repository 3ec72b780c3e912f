// The probe kernels P2 (rounded_query and load_floor), P3 (binned top-1),
// P4 (i8_dot), P5 (blocked slabs) and P6 (int4 slabs), tile-major, all but
// load_floor on the tensor cores.
//
// Replaces the TPU kernels benchmarks/experiments/probe_r3_split.py
// (run_variant, pallas_call at :156; its "mxu_rep" / "mxu_tile" and
// "zeros" bodies in variant_kernel :90-139), probe_r3_final.py
// (nomask_dots, pallas_call at :99; its "mxu_i8" body in make_kernel
// :50-84), probe_r3_binned.py (binned_dots, pallas_call at :98; body
// make_binned_kernel :44-83), probe_r4_blk.py (blk_window_dots,
// pallas_call at :132; body make_blk_kernel :68-112) and probe_r5_int4.py
// (slab_window_dots_int4, pallas_call at :139; body _make_kernel_int4
// :68-110).
//
// What bounds them on the H100: the unique bytes.  Each slab row covered by
// some window is needed once, but a body with one block a window reads
// every window from memory: at the probe point (q = 8,192, L = 8, win 640) that is
// 5.4 GB of logical int8 windows (10.7 GB bf16) against 1.86 GB (3.7 GB) of
// covered rows; P6 reads 10.7 GB of packed windows against ~1.1 GB and
// unpacks every nibble once per window.  Reading a row once means dotting
// it against every window that covers it: a matrix product, which the
// tensor cores finish far under the byte bound.
//
// Design: K1's tile-major product (slabtile.cu) with the schedule found on
// the device.  The wrapper only sorts the (query, table) pairs by first
// slab row (`tile_schedule`, ops/kernels/probetile.py): K1's torch work
// list of ~25 small operations costs 0.3-0.9 ms of host dispatch at the
// probe point on an H100 host, more than a third of the kernel.  Here `tile_bounds` gives each tile of RT
// slab rows the range of sorted pairs whose windows meet it, and one block
// takes one tile:
// - it stages the tile in shared memory as bf16, once, by cp.async:
//   bf16 rows (P2, P3) as they are; int8 rows (P3), and P6's packed rows,
//   as bytes into the tail of the tile's space, then upcast in place, each
//   packed row unpacked into its two CSR rows, hi nibbles to the tile's
//   first half and lo nibbles to its second (values -8..7 are exact in
//   bf16).  P5's tile is one 128-row block of the blocked layout (half a
//   block at d = 256), stored [d][128]: it is staged as stored, [d][RT]
//   bf16 (int8 blocks through the tail and the upcast), and the product
//   reads it transposed (ldmatrix .trans); the same XOR swizzle keeps the
//   8 element rows one ldmatrix matrix reads on 8 distinct bank groups.
//   P4 stages its int8 rows as stored (no upcast: 128 rows, 8-32 KB), with
//   an int8 swizzle (`swz8`) that is also conflict-free at d = 64 and 192,
//   where a row ends half way through a 128-byte line;
// - it walks its pairs in chunks of M = 16: each pair's f32 query as NQ
//   bf16 terms: P2's query is rounded to bf16 by definition (the TPU's
//   astype), one term, so its products are exact and only the order of
//   the sum changes; P3, P5 and P6 split it into three (split3), so their
//   dots keep K1's tolerance.  4 warps run mma.sync m16n8k16 with the
//   tile's rows on the M side and the pairs on N in tiles of 8, so a chunk
//   of <= 8 pairs (~3 a tile at the probe point) costs half the products
//   of a full one; each 16-wide slice of d is summed from zero and added
//   in f32, as in K1.  P4's queries are int8 rows (`quantize_queries`),
//   staged as stored, one term: mma.sync m16n8k32 s8 x s8 -> s32 computes
//   the TPU body's preferred_element_type=int32 dot exactly, d / 32 MMAs
//   an (m16, n8) tile against 3 d / 16 for the split kinds, summed in
//   int32 over all of d;
// - the epilogue stages the chunk's dots in shared memory, over the query
//   terms.  P2, P4 and P5 write each pair's run of the lanes the tile
//   covers, out[pair * win + j], with float4 stores (the runs start on
//   32-row boundaries, P5's are whole 128- or 64-lane runs).  P6 writes each
//   pair's lanes in the halves layout: two contiguous runs, hi lanes j and
//   lo lanes win / 2 + j.  P3 never writes the dots: for each pair it
//   reduces the run of window lanes the tile covers to one candidate per
//   bin (the largest dot, the lowest lane on ties), and combines it into
//   the query's [nbins] keys with one 64-bit atomicMax (the key below).
//   The keys start at zero and every flat lane belongs to exactly one
//   tile, so each bin ends with its winner; a last pass decodes the keys.
// Blocks are small (128 threads, 41-56 KB of shared memory; P4 17-41 KB),
// so four or five share an SM and one block's loads overlap the others'
// work.
//
// P2's load_floor (`floor_tile`, below) runs the same schedule with no
// product: it is the floor of this family, each covered row loaded once
// and every window lane written once.

#include "slabrow.cuh"
#include "tilemma.cuh"

// P3's combine key.
//
// A bin's candidates meet in one 64-bit key per (query, bin), combined
// with atomicMax: the high word is the dot as an order-preserving unsigned
// (sign bit set: all bits flipped; else the sign bit set), the low word
// 0xFFFFFFFF - p for the candidate's flat lane p = t * win + lane.  The
// largest dot wins, and among equal dots the lowest p, which within a bin
// (p = r * nbins + bin) is the lowest row r: the TPU body's
// min(where(b == max, r, rows)).  -0 enters as +0, so the two zeros tie as
// they compare.  `bin_key` / `bin_unkey` in tests/test_torch_probe_tiles.py
// state the same order in plain torch.

namespace binkey {

__device__ __forceinline__ unsigned long long bin_key(float v, int p) {
  uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)p);
}

__device__ __forceinline__ void bin_put(unsigned long long* key, float v, int p) {
  atomicMax(key, bin_key(v, p));
}

// keys [n] -> vals [n] f32, pos [n] int32
static __global__ void bin_decode(const unsigned long long* __restrict__ keys,
                                  float* __restrict__ vals, int32_t* __restrict__ pos,
                                  long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = keys[i];
  uint32_t u = (uint32_t)(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  vals[i] = __uint_as_float(u);
  pos[i] = (int32_t)(0xFFFFFFFFu - (uint32_t)k);
}

static inline int launch_decode(const void* keys, void* vals, void* pos, long long n,
                                cudaStream_t s) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n + 255) / 256;
  bin_decode<<<(unsigned)blocks, 256, 0, s>>>((const unsigned long long*)keys,
                                              (float*)vals, (int32_t*)pos, n);
  return (int)cudaGetLastError();
}

}  // namespace binkey

namespace {

using namespace slabrow;
using namespace tilemma;

constexpr int kThreads = 128;     // 4 warps along the tile's rows
constexpr int kM = 16;            // pairs a chunk: one m16 tile

// what a block stages and what its epilogue writes (the C entry points'
// kind codes; ops/kernels/probetile.py KINDS)
enum Kind {
  kBinI8 = 0, kBinBF16 = 1,       // P3: CSR rows; bin keys
  kInt4 = 2,                      // P6: packed rows; dots, halves layout
  kRoundBF16 = 3,                 // P2 rounded_query: bf16 CSR rows; dots
  kBlkI8 = 4, kBlkBF16 = 5,       // P5: blocks [d][128], staged as stored; dots
  kI8Dot = 6,                     // P4 i8_dot: int8 CSR rows and queries,
                                  // staged as stored, s8 MMA; dots
};

struct Args {
  const uint8_t* slab;       // [n_rows, d]: int8 / bf16 rows or P6's packed
                             // bytes; P5: [n_rows / 128, d, 128] blocks
  const void* queries;       // [q, d] f32 (P4: int8), 16-byte aligned
  const int32_t* row0;       // [P] first slab rows, ascending
  const long long* pair;     // [P] pair ids (query * T + table) in that order
  const int32_t* bounds;     // [2, n_tiles]: each tile's first and end sorted pair
  void* out;                 // P3: keys [q, nbins] u64, zeroed; else dots [P, win] f32
  int P, n_tiles, T, win, span, d, n_rows, nbins;
};

// tile j's pairs are the sorted positions [lo_j, hi_j): lo_j the first row0
// > j rt - span, hi_j the first row0 >= (j + 1) rt (`tile_ranges`
// in tests/test_torch_probe_tiles.py states it in torch).  Sorted position i is lo_j
// for the tiles j with row0[i - 1] + span <= j rt < row0[i] + span, and
// hi_j for row0[i - 1] < (j + 1) rt <= row0[i]: a thread a position
// writes those runs of j, which partition the tiles.
__global__ void tile_bounds(const int32_t* __restrict__ row0, int P, int span, int rt,
                            int n_tiles, int32_t* __restrict__ bounds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > P) return;
  const long long prev = i == 0 ? -(1LL << 40) : row0[i - 1];
  const long long cur = i == P ? (1LL << 40) : row0[i];
  auto ceil_div = [rt](long long x) {
    return x >= 0 ? (x + rt - 1) / rt : -((-x) / rt);
  };
  auto floor_div = [rt](long long x) { return x >= 0 ? x / rt : -((-x + rt - 1) / rt); };
  const long long lo_a = max(0LL, ceil_div(prev + span));
  const long long lo_b = min((long long)n_tiles, ceil_div(cur + span));
  for (long long j = lo_a; j < lo_b; ++j) bounds[j] = i;
  const long long hi_a = max(0LL, floor_div(prev));
  const long long hi_b = min((long long)n_tiles, floor_div(cur));
  for (long long j = hi_a; j < hi_b; ++j) bounds[n_tiles + j] = i;
}

// bytes 0 and 1 (sel 0x4140) or 2 and 3 (sel 0x4342) of x, each a nibble
// n ^ 8, as the bf16 pair ((n ^ 8) - 8): 0x4300 | m is bf16 128 + m
__device__ __forceinline__ uint32_t nib_bf16x2(uint32_t x, uint32_t sel) {
  const uint32_t u = __byte_perm(x, 0u, sel) | 0x43004300u;
  const uint32_t c = 0x43084308u;                     // bf16 136, 136
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u),
                             *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int KIND> struct Traits {
  // a blocked tile, staged as stored ([d][RT]): the product reads it transposed
  static constexpr bool blk = KIND == kBlkI8 || KIND == kBlkBF16;
  // staged from bytes upcast in place (int8 rows or blocks, packed int4)
  static constexpr bool bytes = KIND == kBinI8 || KIND == kInt4 || KIND == kBlkI8;
  // int8 rows and queries as stored, int8 x int8 -> int32 on the tensor cores
  static constexpr bool i8 = KIND == kI8Dot;
  static constexpr bool dots = KIND == kRoundBF16 || blk || i8;   // plain [P, win] dots
};

// RT staged bf16 rows: 128 at d <= 128, 64 at d = 256 (32 KB either way);
// P4: 128 int8 rows at every d (8-32 KB); NQ bf16 query terms (P4: one
// int8 term)
template <int KIND, int RT, int NQ>
__global__ void __launch_bounds__(kThreads, 5)
probe_tile(Args a) {
  using K = Traits<KIND>;
  constexpr int M = kM;
  constexpr int kSR = KIND == kInt4 ? RT / 2 : RT;       // slab rows a tile holds
  constexpr int kMaxD = RT == 128 ? 128 : 256;
  constexpr int kLd = K::bytes ? kSR * kMaxD / 16 / kThreads : 1;
  constexpr int MR = RT / 64;                            // m16 tiles a warp
  constexpr int OS = RT + 4;                             // o_s stride: conflict-free
  constexpr int kEB = K::i8 ? 1 : 2;                     // bytes a staged element
  const int lo = a.bounds[blockIdx.x], hi = a.bounds[a.n_tiles + blockIdx.x];
  if (hi <= lo) return;
  const int tile0 = blockIdx.x * kSR;
  const int d = a.d, cpr = d / 8;                  // 16-byte bf16 chunks a query
  // a staged row: one slab row of d elements, or (blk) one element of RT lanes
  const int sw = K::blk ? RT : d;
  const int bw = sw / 16;                          // its 16-byte chunks of bytes
  // a blocked tile's first element: block tile0 / 128, lane tile0 % 128
  const size_t blk0 = K::blk ? (size_t)(tile0 / 128) * d * 128 + tile0 % 128 : 0;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [RT][d] / [d][RT]
  uint8_t* q_s = smem_raw + RT * d * kEB;                             // the query terms
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(q_s);        // [NQ][M][d]
  float* o_s = reinterpret_cast<float*>(q_s);                         // [M][OS]
  int (*s_meta)[M] = reinterpret_cast<int (*)[M]>(                    // [2][M]
      q_s + max(NQ * M * d * kEB, M * OS * 4));

  // the tile by cp.async, zero past the slab's end: bf16 straight to the
  // tile, bytes (int8, packed int4) to the tail of the tile's space, upcast
  // in place once the first chunk's queries are staged
  uint8_t* raw = smem_raw + RT * d * 2 - kSR * d;                     // [kSR][d] bytes
  if constexpr (K::i8) {               // int8 rows as stored: [RT][d] bytes
    for (int i = threadIdx.x; i < kSR * bw; i += kThreads) {
      const int r = i / bw, c = i % bw;
      const bool ok = tile0 + r < a.n_rows;
      cp_async16(smem_raw + swz8(r, c, d),
                 ok ? a.slab + (size_t)(tile0 + r) * d + c * 16 : a.slab, ok ? 16 : 0);
    }
  } else if constexpr (!K::bytes) {
    for (int i = threadIdx.x; i < kSR * d / 8; i += kThreads) {
      const int r = i / (sw / 8), c = i % (sw / 8);
      const bool ok = K::blk || tile0 + r < a.n_rows;
      const size_t e = K::blk ? blk0 + (size_t)r * 128 + c * 8
                              : (size_t)(tile0 + r) * d + c * 8;
      cp_async16(b_s + swz(r, c, sw), ok ? a.slab + e * 2 : a.slab, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kSR * d / 16; i += kThreads) {
      const int r = i / bw, c = i % bw;
      const bool ok = K::blk || tile0 + r < a.n_rows;
      const size_t e = K::blk ? blk0 + (size_t)r * 128 + c * 16
                              : (size_t)(tile0 + r) * d + c * 16;
      cp_async16(raw + i * 16, ok ? a.slab + e : a.slab, ok ? 16 : 0);
    }
  }

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int n_base = warp * (RT / 4);
  const int mi = l >> 3, rr = l & 7, g = l >> 2, tig = l & 3;
  constexpr int kSub = kThreads / M;                     // lanes a pair slot
  const int slot = threadIdx.x / kSub, sub = threadIdx.x % kSub;
  for (int c0 = lo; c0 < hi; c0 += M) {
    const int cnt = min(M, hi - c0);
    if (c0 != lo) __syncthreads();        // the last chunk's epilogue is done
    // pair slot m and its kSub lanes: the slot's fields and its query's NQ
    // bf16 terms (P4: its int8 row as stored); rows past cnt are never read
    // into a written dot
    if (slot < cnt) {
      const int p = (int)__ldg(a.pair + c0 + slot);
      if (sub == 0) s_meta[0][slot] = p;
      if (sub == 1) s_meta[1][slot] = __ldg(a.row0 + c0 + slot);
      const size_t qrow = (size_t)(p / a.T) * d;
      if constexpr (K::i8) {
        const uint4* q16 = reinterpret_cast<const uint4*>(
            static_cast<const int8_t*>(a.queries) + qrow);
        for (int c = sub; c < bw; c += kSub)             // 16 elements a chunk
          *reinterpret_cast<uint4*>(q_s + swz8(slot, c, d)) = __ldg(q16 + c);
      } else {
        const float4* q4 = reinterpret_cast<const float4*>(
            static_cast<const float*>(a.queries) + qrow);
        for (int c = sub; c < cpr; c += kSub) {          // 8 elements a chunk
          const float4 u = __ldg(q4 + 2 * c), w = __ldg(q4 + 2 * c + 1);
          const float x[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
          uint32_t t[NQ][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (NQ == 1) {
              t[0][e] = bf16x2(x[2 * e], x[2 * e + 1]);          // round to nearest even
            } else {
              float h[2][3];
#pragma unroll
              for (int k = 0; k < 2; ++k) split3(x[2 * e + k], h[k]);
#pragma unroll
              for (int term = 0; term < NQ; ++term) t[term][e] = bf16x2(h[0][term], h[1][term]);
            }
          }
#pragma unroll
          for (int term = 0; term < NQ; ++term)
            *reinterpret_cast<uint4*>(a_s + term * M * d + swz(slot, c, d)) =
                make_uint4(t[term][0], t[term][1], t[term][2], t[term][3]);
        }
      }
    }
    if (c0 == lo) {
      cp_async_wait_all();
      if constexpr (K::bytes) {
        // every thread's bytes are in; all are read before the bf16 rows
        // overwrite them
        __syncthreads();
        uint4 v[kLd];
#pragma unroll
        for (int j = 0; j < kLd; ++j) {
          const int i = threadIdx.x + j * kThreads;
          v[j] = i < kSR * d / 16 ? reinterpret_cast<const uint4*>(raw)[i]
                                  : make_uint4(0, 0, 0, 0);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kLd; ++j) {
          const int i = threadIdx.x + j * kThreads;
          if (i >= kSR * d / 16) break;
          const int r = i / bw, c = i % bw;
          const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
          uint32_t o[2][8];                  // [hi, lo] (P6) or [row] (int8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (KIND == kInt4) {
              const uint32_t x = w[e] ^ 0x88888888u;
              const uint32_t hn = (x >> 4) & 0x0F0F0F0Fu, ln = x & 0x0F0F0F0Fu;
              o[0][2 * e] = nib_bf16x2(hn, 0x4140);
              o[0][2 * e + 1] = nib_bf16x2(hn, 0x4342);
              o[1][2 * e] = nib_bf16x2(ln, 0x4140);
              o[1][2 * e + 1] = nib_bf16x2(ln, 0x4342);
            } else {
              o[0][2 * e] = bf16x2(i8(w[e], 0), i8(w[e], 1));
              o[0][2 * e + 1] = bf16x2(i8(w[e], 2), i8(w[e], 3));
            }
          }
#pragma unroll
          for (int h = 0; h < (KIND == kInt4 ? 2 : 1); ++h) {
            const int row = r + h * kSR;
            *reinterpret_cast<uint4*>(b_s + swz(row, 2 * c, sw)) =
                make_uint4(o[h][0], o[h][1], o[h][2], o[h][3]);
            *reinterpret_cast<uint4*>(b_s + swz(row, 2 * c + 1, sw)) =
                make_uint4(o[h][4], o[h][5], o[h][6], o[h][7]);
          }
        }
      }
    }
    __syncthreads();

    // the chunk's RT x 16 dots with the slab rows on the mma's M side: a
    // warp RT / 4 rows (MR m16 tiles) against the pairs in n8 tiles, one up
    // to 8 pairs and two past; a pair's query terms chain into one
    // accumulator, each 16-wide slice summed from zero (hi, then mid and lo
    // onto it) and added to the running dots in f32, as in K1.  P4: one
    // m16n8k32 s8 MMA a 32-wide slice, summed in int32 over all of d, exact
    // in any order; |dot| <= 256 x 127 x 127 < 2^24, so its f32 is exact
    const int halves = cnt > 8 ? 2 : 1;
    float acc[MR][2][4];
    int iacc[MR][2][4];
#pragma unroll
    for (int mr = 0; mr < MR; ++mr)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mr][h][e] = 0.f;
          iacc[mr][h][e] = 0;
        }
    for (int kc = 0; kc < d / (K::i8 ? 32 : 16); ++kc) {
      if constexpr (K::i8) {
        // 16-byte chunks 2 kc and 2 kc + 1 hold k 0-15 and 16-31 of the
        // slice, in the bf16 fragments' bytes
        uint32_t af[MR][4], r4[4];
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
          ldmatrix_x4(af[mr], smem_raw + swz8(n_base + mr * 16 + rr + (mi & 1) * 8,
                                              2 * kc + (mi >> 1), d));
        ldmatrix_x4(r4, q_s + swz8(rr + (mi >> 1) * 8, 2 * kc + (mi & 1), d));
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h >= halves) break;
            mma_s8(iacc[mr][h], af[mr], r4[2 * h], r4[2 * h + 1]);
          }
      } else {
        uint32_t af[MR][4], b[NQ][2][2];
#pragma unroll
        for (int mr = 0; mr < MR; ++mr) {
          if constexpr (K::blk)     // element rows 16 kc.., lanes of the m16 tile
            ldmatrix_x4_trans(af[mr], b_s + swz(16 * kc + (mi >> 1) * 8 + rr,
                                                (n_base + mr * 16) / 8 + (mi & 1), RT));
          else
            ldmatrix_x4(af[mr], b_s + swz(n_base + mr * 16 + rr + (mi & 1) * 8,
                                          2 * kc + (mi >> 1), d));
        }
#pragma unroll
        for (int term = 0; term < NQ; ++term) {
          uint32_t r4[4];
          ldmatrix_x4(r4, a_s + term * M * d + swz(rr + (mi >> 1) * 8, 2 * kc + (mi & 1), d));
          b[term][0][0] = r4[0]; b[term][0][1] = r4[1];
          b[term][1][0] = r4[2]; b[term][1][1] = r4[3];
        }
#pragma unroll
        for (int mr = 0; mr < MR; ++mr)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h >= halves) break;
            float part[4];
            mma_bf16_zero(part, af[mr], b[0][h][0], b[0][h][1]);
#pragma unroll
            for (int term = 1; term < NQ; ++term)
              mma_bf16(part, af[mr], b[term][h][0], b[term][h][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mr][h][e] += part[e];
          }
      }
    }
    if constexpr (K::i8) {
#pragma unroll
      for (int mr = 0; mr < MR; ++mr)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mr][h][e] = (float)iacc[mr][h][e];
    }
    __syncthreads();                      // o_s overlays the query terms
#pragma unroll
    for (int mr = 0; mr < MR; ++mr)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= halves) break;
        const int row = n_base + mr * 16 + g, m = h * 8 + 2 * tig;
        o_s[m * OS + row] = acc[mr][h][0];
        o_s[(m + 1) * OS + row] = acc[mr][h][1];
        o_s[m * OS + row + 8] = acc[mr][h][2];
        o_s[(m + 1) * OS + row + 8] = acc[mr][h][3];
      }
    __syncthreads();

    // a warp a pair: the window lanes j = tile row - row0 in [0, span)
    for (int m = warp; m < cnt; m += kThreads / 32) {
      const int pid = s_meta[0][m], r0 = s_meta[1][m];
      const int j_lo = max(0, tile0 - r0), j_hi = min(a.span, tile0 + kSR - r0);
      const float* src = o_s + m * OS + r0 - tile0;      // src[j]: lane j's dot
      if constexpr (K::dots) {
        float* dst = static_cast<float*>(a.out) + (size_t)pid * a.win;
        if ((r0 - tile0) % 4 == 0) {         // j_lo, j_hi and both rows on 16 bytes
          for (int j = j_lo + 4 * l; j < j_hi; j += 128)
            *reinterpret_cast<float4*>(dst + j) = *reinterpret_cast<const float4*>(src + j);
        } else {
          for (int j = j_lo + l; j < j_hi; j += 32) dst[j] = src[j];
        }
      } else if constexpr (KIND == kInt4) {
        float* dst = static_cast<float*>(a.out) + (size_t)pid * a.win;
        for (int j = j_lo + l; j < j_hi; j += 32) {
          dst[j] = src[j];                     // hi nibble: CSR row aligned + 2j
          dst[a.span + j] = src[kSR + j];      // lo nibble: CSR row aligned + 2j + 1
        }
      } else {
        // flat lane p = t win + j, bin p % nbins: the run's lanes j, j +
        // nbins, ... share a bin; a strict '>' keeps the lowest lane of a tie
        const int qi = pid / a.T, base = (pid - qi * a.T) * a.win;
        unsigned long long* keys = static_cast<unsigned long long*>(a.out) +
                                   (size_t)qi * a.nbins;
        const int first_end = min(j_hi, j_lo + a.nbins);
        for (int j = j_lo + l; j < first_end; j += 32) {
          float best = src[j];
          int bj = j;
          for (int j2 = j + a.nbins; j2 < j_hi; j2 += a.nbins) {
            if (src[j2] > best) {
              best = src[j2];
              bj = j2;
            }
          }
          binkey::bin_put(keys + (base + bj) % a.nbins, best, base + bj);
        }
      }
    }
  }
}

template <int KIND, int RT>
int launch(const Args& a, int32_t* bounds, cudaStream_t stream) {
  constexpr int NQ = KIND == kRoundBF16 || KIND == kI8Dot ? 1 : 3;
  constexpr int kSR = KIND == kInt4 ? RT / 2 : RT;
  constexpr int kEB = KIND == kI8Dot ? 1 : 2;          // bytes a staged element
  if (a.n_tiles <= 0 || a.P <= 0) return (int)cudaSuccess;
  tile_bounds<<<(a.P + 1 + 255) / 256, 256, 0, stream>>>(a.row0, a.P, a.span, kSR,
                                                         a.n_tiles, bounds);
  const int q_bytes = NQ * kM * a.d * kEB, o_bytes = kM * (RT + 4) * 4;   // o_s over a_s
  const size_t smem = (size_t)RT * a.d * kEB + (q_bytes > o_bytes ? q_bytes : o_bytes) +
                      2 * kM * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      probe_tile<KIND, RT, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_tile<KIND, RT, NQ><<<a.n_tiles, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// rt: the slab rows a tile holds, as the wrapper sized its bounds: 128 at
// d <= 128, 64 at d = 256 (P6: half, in packed rows); P4: 128 at every d
template <int KIND>
int launch_rt(const Args& a, int32_t* bounds, int rt, cudaStream_t s) {
  const int sr = KIND == kInt4 ? rt * 2 : rt;          // staged rows
  const int want = KIND == kI8Dot || a.d <= 128 ? 128 : 64;
  if (a.d <= 0 || a.d > 256 || a.d % 64 || sr != want) return (int)cudaErrorInvalidValue;
  if (Traits<KIND>::blk && (a.n_rows % 128 || a.win % 128))
    return (int)cudaErrorInvalidValue;                 // whole blocks
  if constexpr (KIND == kI8Dot) return launch<KIND, 128>(a, bounds, s);
  else return a.d <= 128 ? launch<KIND, 128>(a, bounds, s) : launch<KIND, 64>(a, bounds, s);
}

// P2 load_floor, tile-major: one block a tile of kFloorRows slab rows, the
// schedule of the kinds above (`tile_bounds`) and no product.  It reads the
// rows its pairs' windows cover (first pair's row0 to the last one's window
// end, inside the tile) once, with 16-byte loads straight to registers,
// and folds each row's 32-bit words into one word (lanes that share a row
// by shuffles, then one shared-memory atomicXor per row part); a prefix
// XOR over the tile's rows then gives each pair the XOR of the rows its
// window covers here, prefix[j_hi] ^ prefix[j_lo], which one atomicXor adds
// to fold[q].  Every window lane lies in exactly one tile, so each query's
// fold is the XOR of its windows' words, and its lanes are written once,
// with the query's first element (slab[row0[q, 0], 0], as f32) by float4
// stores.  What it costs is what the tile-major kernels cannot avoid:
// each covered row loaded once and the [q, L, win] output written.
constexpr int kFloorRows = 128;
constexpr int kFloorUnroll = 4;        // 16-byte loads in flight a thread

template <int DT>
__global__ void __launch_bounds__(kThreads)
floor_tile(const uint8_t* __restrict__ slab, const int32_t* __restrict__ row0,
           const long long* __restrict__ pair, const int32_t* __restrict__ bounds,
           const int32_t* __restrict__ pair_row0, float* __restrict__ out,
           uint32_t* __restrict__ fold, int n_tiles, int T, int win, int d, int n_rows) {
  __shared__ uint32_t s_row[kFloorRows];          // each row's XOR, 0 outside the windows
  __shared__ uint32_t s_pre[kFloorRows + 1];      // s_pre[j]: XOR of rows [0, j)
  const int lo = bounds[blockIdx.x], hi = bounds[n_tiles + blockIdx.x];
  if (hi <= lo) return;
  const int tile0 = blockIdx.x * kFloorRows;
  const int first = max(tile0, row0[lo]);
  const int last = min(min(tile0 + kFloorRows, n_rows), row0[hi - 1] + win);
  const int row_bytes = d * (16 / Elems<DT>::n), chunks = row_bytes / 16;
  // lanes that share one row: the largest power of two dividing its chunks,
  // at most a warp (chunk i of the run is row i / chunks)
  const int share = min(chunks & -chunks, 32);
  for (int i = threadIdx.x; i < kFloorRows; i += kThreads) s_row[i] = 0u;
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(slab + (size_t)first * row_bytes);
  const int total = (last - first) * chunks;
  for (int i0 = 0; i0 < total; i0 += kThreads * kFloorUnroll) {
    uint4 v[kFloorUnroll];
#pragma unroll
    for (int u = 0; u < kFloorUnroll; ++u) {
      const int i = i0 + u * kThreads + threadIdx.x;
      v[u] = i < total ? __ldg(src + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kFloorUnroll; ++u) {
      const int i = i0 + u * kThreads + threadIdx.x;
      uint32_t w = v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
      for (int off = share / 2; off > 0; off /= 2) w ^= __shfl_xor_sync(0xffffffffu, w, off);
      if (i < total && threadIdx.x % share == 0) atomicXor(s_row + first - tile0 + i / chunks, w);
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {              // the prefix: 4 rows a lane, then a warp scan
    const int l = threadIdx.x;
    uint32_t x[4], t = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) t ^= x[k] = s_row[4 * l + k];
    uint32_t incl = t;
    for (int off = 1; off < 32; off *= 2) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, incl, off);
      if (l >= off) incl ^= y;
    }
    uint32_t run = incl ^ t;
    if (l == 0) s_pre[0] = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) s_pre[4 * l + k + 1] = run ^= x[k];
  }
  __syncthreads();

  // a warp a pair: its window lanes j = tile row - row0 in [j_lo, j_hi)
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int m = lo + warp; m < hi; m += kThreads / 32) {
    const int pid = (int)pair[m], r0 = row0[m], qi = pid / T;
    const int j_lo = max(0, tile0 - r0), j_hi = min(win, tile0 + kFloorRows - r0);
    const float v = element<DT>(slab + (size_t)pair_row0[(size_t)qi * T] * row_bytes, 0);
    float* dst = out + (size_t)pid * win;
    if ((r0 - tile0) % 4 == 0) {         // j_lo, j_hi and the row on 16 bytes
      const float4 v4 = make_float4(v, v, v, v);
      for (int j = j_lo + 4 * l; j < j_hi; j += 128) *reinterpret_cast<float4*>(dst + j) = v4;
    } else {
      for (int j = j_lo + l; j < j_hi; j += 32) dst[j] = v;
    }
    if (l == 0) {
      const uint32_t f = s_pre[r0 - tile0 + j_hi] ^ s_pre[r0 - tile0 + j_lo];
      if (f) atomicXor(fold + qi, f);
    }
  }
}

template <int DT>
int launch_floor(const uint8_t* slab, const int32_t* row0, const long long* pair,
                 int32_t* bounds, const int32_t* pair_row0, float* out, uint32_t* fold,
                 int P, int T, int win, int d, int n_rows, cudaStream_t s) {
  const int n_tiles = (n_rows + kFloorRows - 1) / kFloorRows;
  if (d <= 0 || d % Elems<DT>::n) return (int)cudaErrorInvalidValue;
  tile_bounds<<<(P + 1 + 255) / 256, 256, 0, s>>>(row0, P, win, kFloorRows, n_tiles, bounds);
  floor_tile<DT><<<n_tiles, kThreads, 0, s>>>(slab, row0, pair, bounds, pair_row0, out,
                                              fold, n_tiles, T, win, d, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crt_binned_tile_dots(const void* slab, const void* queries,
                                    const void* row0, const void* pair, void* bounds,
                                    void* keys, void* vals, void* pos, int P, int q,
                                    int T, int win, int d, int n_rows, int nbins,
                                    int dtype, int rt, void* stream) {
  if (rt <= 0 || nbins <= 0 || (T * win) % nbins || (dtype != kBF16 && dtype != kI8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_keys = (long long)q * nbins;
  cudaError_t err = cudaMemsetAsync(keys, 0, (size_t)n_keys * 8, s);
  if (err != cudaSuccess) return (int)err;
  Args a{(const uint8_t*)slab, queries, (const int32_t*)row0,
         (const long long*)pair, (const int32_t*)bounds, keys, P, (n_rows + rt - 1) / rt,
         T, win, win, d, n_rows, nbins};
  int32_t* b = (int32_t*)bounds;
  const int rc = dtype == kI8 ? launch_rt<kBinI8>(a, b, rt, s)
                               : launch_rt<kBinBF16>(a, b, rt, s);
  if (rc != 0) return rc;
  return binkey::launch_decode(keys, vals, pos, n_keys, s);
}

// P2 rounded_query, P4, P5 and P6: dots [P, win] f32 of each sorted pair,
// in its window's lane order (P6: the halves layout); kind as `Kind`,
// n_rows and rt in the slab's rows (P6: packed rows); queries f32 [q, d]
// (P4: int8)
extern "C" int crt_tile_dots(const void* slab, const void* queries, const void* row0,
                             const void* pair, void* bounds, void* dots, int P, int T,
                             int win, int d, int n_rows, int kind, int rt, void* stream) {
  if (rt <= 0 || (kind == kInt4 && win % 2)) return (int)cudaErrorInvalidValue;
  Args a{(const uint8_t*)slab, queries, (const int32_t*)row0,
         (const long long*)pair, (const int32_t*)bounds, dots, P, (n_rows + rt - 1) / rt,
         T, win, kind == kInt4 ? win / 2 : win, d, n_rows, 0};
  int32_t* b = (int32_t*)bounds;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kInt4: return launch_rt<kInt4>(a, b, rt, s);
    case kRoundBF16: return launch_rt<kRoundBF16>(a, b, rt, s);
    case kBlkI8: return launch_rt<kBlkI8>(a, b, rt, s);
    case kBlkBF16: return launch_rt<kBlkBF16>(a, b, rt, s);
    case kI8Dot: return launch_rt<kI8Dot>(a, b, rt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// P2 load_floor: out [P, win] f32 (pair id order) and fold [q] (zeroed
// here); row0 / pair the sorted pairs, pair_row0 [q * T] their first rows
// in pair id order; dtype slabrow's Dtype of the [n_rows, d] rows; rt must
// be kFloorRows
extern "C" int crt_tile_load_floor(const void* slab, const void* row0, const void* pair,
                                   void* bounds, const void* pair_row0, void* out,
                                   void* fold, int P, int q, int T, int win, int d,
                                   int n_rows, int dtype, int rt, void* stream) {
  if (rt != kFloorRows || win <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(fold, 0, (size_t)q * sizeof(uint32_t), s);
  if (err != cudaSuccess || P <= 0 || n_rows <= 0) return (int)err;
  const uint8_t* sl = (const uint8_t*)slab;
  const int32_t* r = (const int32_t*)row0;
  const long long* p = (const long long*)pair;
  int32_t* b = (int32_t*)bounds;
  const int32_t* pr = (const int32_t*)pair_row0;
  switch (dtype) {
    case kF32: return launch_floor<kF32>(sl, r, p, b, pr, (float*)out, (uint32_t*)fold, P, T,
                                         win, d, n_rows, s);
    case kBF16: return launch_floor<kBF16>(sl, r, p, b, pr, (float*)out, (uint32_t*)fold, P,
                                           T, win, d, n_rows, s);
    case kI8: return launch_floor<kI8>(sl, r, p, b, pr, (float*)out, (uint32_t*)fold, P, T,
                                       win, d, n_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
