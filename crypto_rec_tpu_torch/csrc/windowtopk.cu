// S1: the stage-1 selection of K1's epilogue, tie-exact.
//
// No Pallas kernel replaced: the JAX package selects K1's dots with XLA's
// jax.lax.approx_max_k (crypto_rec_tpu/ops/pallas/slabscore.py:486, :503;
// models/lsh/hypercube.py:473, :674, :778) and jax.lax.top_k
// (slabscore.py:501, exact=True).  Off the TPU approx_max_k returns
// lax.top_k's answer, and torch.topk promises no order among equal values,
// so on the card this kernel computes the port's reference selection
// exactly: ops/topk.topk_desc, a stable descending sort cut to k.
//   values f32 [R, m], k <= m -> the k largest of each row, descending:
//   (values f32 [R, k], indices int64 [R, k]); equal values lowest index
//   first, NaN above +inf, +0.0 and -0.0 equal (ordered by index).
//
// The image.  Each value maps to an order-preserving uint32 (sign-flipped
// IEEE bits, -0.0 folded onto +0.0, every NaN onto 0xFFFFFFFF); a real
// value's image is at least -inf's, 0x007FFFFF, so 0 marks a lane past the
// row's end.  Sorting (image descending, index ascending) is topk_desc's
// order; the 64-bit key image << 32 | ~index is unique in its row and
// sorts that way.  The value written is the row's own (-0.0 stays -0.0).
//
// What bounds it on the H100: the bytes, R m 4 read once plus R k 12
// written (CF leg [65,536, 640]: 0.05 ms at 3.35 TB/s).  k serial arg-max
// rounds over the whole row (one per output key) cost k passes; this kernel
// finds each row's threshold in a constant number of passes over registers
// and sorts only the winners:
//
// 1. A lower bound lo on the k-th largest image, from maxima: each lane
//    (thread) keeps its largest image.  Warp rows (m <= 1,024, k <= 32):
//    k lanes hold an image at or above the k-th largest lane maximum, so
//    at least k images of the row do; for k > 20 each lane also keeps its
//    second largest, and ceil(k / 2) lanes hold two at or above the
//    ceil(k / 2)-th largest of those.  Block rows: each warp sorts its
//    lane maxima; for c warps, c of them hold ceil(k / c) lane maxima at or
//    above the c-th largest of the warps' ceil(k / c)-th; lo is the best of
//    these sound bounds (1 when k > the block's threads).
// 2. One pass marks, per lane, the images >= lo and > lo (two bit masks of
//    its PER slots); their counts, scanned over the lanes, give every lane
//    its place.  If at most CAP images are >= lo they are all candidates
//    (sort path).  Else, if fewer than k are > lo, lo is the k-th largest
//    itself (a tie at the threshold: tie path).  Else a bisection over
//    (lo, row max] (one counting pass a step) raises lo until one of the
//    two holds.  Rows full of ties take the tie path after the first
//    count, so the bisection is the bounded path of rows whose largest
//    images sit in few lanes.
// 3. Sort path: each lane reads the values at its mask's set bits again
//    (L1 holds the row) and writes their keys to shared memory; each
//    candidate's rank among all of them is counted there, and the k of
//    rank < k are written at their rank.  Tie path: every image > lo is
//    taken the same way, then images == lo lowest index first (ballots in
//    index order) until k are taken, and those k are ranked likewise.
//
// Warp rows: one warp a row, 8 rows a block, PER images a lane in
// registers, lane-strided (index j * 32 + lane) so each load coalesces and
// a ballot over the lanes is in index order; no barrier, 512 B of shared
// memory a warp for the candidates (CAP 64).  Block rows (1,024 < m <=
// 32,768 or k > 32): one block of NT threads a row, PER images a thread in
// registers (index j * NT + t), CAP max(128, 2 k), barriers only between
// the steps above and one per NT indices scanned on the tie path.
//
// Past those shapes (the JAX selections take any 1 <= k <= m):
// - m > 32,768, k <= 1,024: two levels, both here.  Block rows run on each
//   32,768-lane segment of a row (grid.y), and the wrapper selects again
//   over the segments' winners laid end to end, mapping the positions
//   back, until one segment is left.  The segments are in index order and
//   each one's winners come out by (value desc, index asc), so among equal
//   values the second level's lane order is the index order: topk_desc's
//   answer.
// - k > 1,024: radix_rows below, a radix select of each row's threshold,
//   the winners' keys sorted in global scratch.
//
// Its times beside torch.topk's, topk_desc's and the bound: chip_smoke.py
// phase 24 (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace s1 {

typedef unsigned int u32;
typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxM = 1024;
constexpr int kWarpMaxK = 32;
constexpr int kMaxM = 32768;
constexpr int kMaxK = 1024;
constexpr int kWarpRows = 8;            // rows (warps) a 256-thread block
constexpr int kWarpCap = 64;            // candidates a warp row ranks
constexpr int kTwoMaxK = 20;            // warp rows keep second maxima above this k

// Order-preserving image of an f32 as uint32: larger value, larger image.
__device__ __forceinline__ u32 order_bits(float x) {
  const u32 u = __float_as_uint(x);
  u32 img = u ^ ((u32)((int)u >> 31) | 0x80000000u);   // negative: ~u, else u | sign
  img = img == 0x7FFFFFFFu ? 0x80000000u : img;       // -0.0 ties +0.0
  return x != x ? 0xFFFFFFFFu : img;    // NaN: above +inf, as the sort puts it first
}

__device__ __forceinline__ u64 make_key(u32 img, int i) {
  return ((u64)img << 32) | (u64)(~(u32)i);
}

__device__ __forceinline__ int key_index(u64 key) {
  return (int)(~(u32)key);
}

__device__ __forceinline__ u32 lanes_below() {
  u32 r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

// Bitonic sort, descending, of one value a lane across the warp:
// afterwards lane 0 holds the largest, lane r the (r + 1)-th largest.
__device__ __forceinline__ u32 warp_sort_desc(u32 v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    const bool desc = (lane & size) == 0;
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u32 o = __shfl_xor_sync(kFull, v, stride);
      v = ((lane & stride) == 0) == desc ? max(v, o) : min(v, o);
    }
  }
  return v;
}

__device__ __forceinline__ u32 warp_incl_scan(u32 x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u32 y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Bit j of ge set where img[j] >= lo, of gt where img[j] > lo.
template <int PER>
__device__ __forceinline__ void threshold_masks(const u32 (&img)[PER], u32 lo, u32& ge,
                                                u32& gt) {
  ge = 0u;
  gt = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    ge |= (u32)(img[j] >= lo) << j;
    gt |= (u32)(img[j] > lo) << j;
  }
}

// Their counts: images >= lo in the low 16 bits, > lo in the high 16 (a row
// has at most 32,768, so neither half overflows when summed over it).
__device__ __forceinline__ u32 count_pair(u32 ge, u32 gt) {
  return (u32)__popc(ge) | ((u32)__popc(gt) << 16);
}

// The keys of the images at the set bits of `bits` (index j * STRIDE + t),
// read again from the row (L1 holds it), to buf[pos], buf[pos + 1], ...
template <int STRIDE>
__device__ __forceinline__ void gather(u32 bits, const float* src, int t, u64* buf, u32 pos) {
  while (bits) {
    const int i = (__ffs(bits) - 1) * STRIDE + t;
    bits &= bits - 1;
    buf[pos++] = make_key(order_bits(__ldg(src + i)), i);
  }
}

template <int PER>
__device__ __forceinline__ u32 count_ge(const u32 (&img)[PER], u32 x) {
  u32 c = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) c += img[j] >= x;
  return c;
}

// Each candidate's rank among the n keys in buf (unique, so the ranks are
// 0 .. n - 1), counted by the threads first, first + step, ...; the k of
// rank < k are written at their rank, each value as the row holds it.
// base: added to each index written (a segment's first lane in its row).
__device__ __forceinline__ void write_ranked(const u64* buf, int n, int k, int first, int step,
                                             const float* src, float* out_v,
                                             long long* out_i, long long base = 0) {
  for (int e = first; e < n; e += step) {
    const u64 key = buf[e];
    int rank = 0;
    for (int q = 0; q < n; ++q) rank += buf[q] > key;
    if (rank < k) {
      const int i = key_index(key);
      out_v[rank] = __ldg(src + i);
      out_i[rank] = base + i;
    }
  }
}

// Bisection step for the threshold: cnt(>= lo) = c_lo >= k > cnt(>= hi).
__device__ __forceinline__ void bisect(u32& lo, u64& hi, u32& c_lo, u32 mid, u32 c, int k) {
  if (c >= (u32)k) {
    lo = mid;
    c_lo = c;
  } else {
    hi = mid;
  }
}

template <int PER, int TOP>
__global__ void __launch_bounds__(32 * kWarpRows)
warp_rows(const float* __restrict__ values, float* __restrict__ out_v,
          long long* __restrict__ out_i, int R, int m, int k) {
  __shared__ u64 cand[kWarpRows][kWarpCap];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRows + warp;
  if (row >= R) return;                 // the whole warp leaves together
  const float* src = values + (size_t)row * m;
  u64* buf = cand[warp];

  u32 img[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = j * 32 + lane;
    img[j] = i < m ? order_bits(__ldg(src + i)) : 0u;
  }
  u32 m1 = 0u, m2 = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (TOP == 2) m2 = max(m2, min(m1, img[j]));
    m1 = max(m1, img[j]);
  }
  m1 = warp_sort_desc(m1);
  const u32 top = __shfl_sync(kFull, m1, 0);
  u32 lo = __shfl_sync(kFull, m1, k - 1);
  if (TOP == 2) lo = max(lo, __shfl_sync(kFull, warp_sort_desc(m2), (k + 1) / 2 - 1));
  lo = max(lo, 1u);

  u32 ge, gt;
  threshold_masks(img, lo, ge, gt);
  u32 p = count_pair(ge, gt);
  u32 incl = warp_incl_scan(p);
  u32 tot = __shfl_sync(kFull, incl, 31);
  if ((tot & 0xFFFFu) > (u32)kWarpCap && (tot >> 16) >= (u32)k) {
    u32 c_lo = tot >> 16;               // cnt(>= lo + 1) >= k > cnt(>= top + 1)
    u64 hi = (u64)top + 1;
    lo += 1;
    while (c_lo > (u32)kWarpCap && hi - lo > 1) {
      const u32 mid = lo + (u32)((hi - lo) >> 1);
      bisect(lo, hi, c_lo, mid, __reduce_add_sync(kFull, count_ge(img, mid)), k);
    }
    threshold_masks(img, lo, ge, gt);
    p = count_pair(ge, gt);
    incl = warp_incl_scan(p);
    tot = __shfl_sync(kFull, incl, 31);
  }
  const u32 excl = incl - p;
  int n = k;
  if ((tot & 0xFFFFu) <= (u32)kWarpCap) {   // sort path: every image >= lo
    gather<32>(ge, src, lane, buf, excl & 0xFFFFu);
    n = (int)(tot & 0xFFFFu);
  } else {                              // tie path: lo is the k-th largest
    gather<32>(gt, src, lane, buf, excl >> 16);
    const u32 ngt = tot >> 16, need = (u32)k - ngt;
    const u32 below = lanes_below();
    u32 taken = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {     // equal images in index order
      const bool eq = img[j] == lo;
      const u32 b = __ballot_sync(kFull, eq);
      const u32 r = taken + __popc(b & below);
      if (eq && r < need) buf[ngt + r] = make_key(lo, j * 32 + lane);
      taken += __popc(b);
      if (taken >= need) break;
    }
  }
  __syncwarp();
  write_ranked(buf, n, k, lane, 32, src, out_v + (size_t)row * k, out_i + (size_t)row * k);
}

// Exclusive prefix of x over the block's threads in order, and its total.
template <int NW>
__device__ __forceinline__ u32 block_scan(u32 x, u32* red, u32& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const u32 incl = warp_incl_scan(x);
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  u32 before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const u32 r = red[w];
    before += w < warp ? r : 0u;
    all += r;
  }
  total = all;
  return before + incl - x;
}

template <int NW>
__device__ __forceinline__ u32 block_sum(u32 x, u32* red) {
  x = __reduce_add_sync(kFull, x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  u32 all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) all += red[w];
  return all;
}

__host__ __device__ constexpr int block_cap(int k) {
  return 2 * k > 128 ? 2 * k : 128;
}

template <int NT>
size_t block_smem(int k) {
  return (size_t)block_cap(k) * 8 + (size_t)(NT / 32) * (32 + 1 + 3) * 4;
}

// One block a row segment: row blockIdx.x, lanes [s seg, s seg + seg) of
// its m_row for s = blockIdx.y; its min(k_all, length) winners go to
// out[row, s k_all ...] (rows of ldo), indices in the whole row.  A row of
// m <= kMaxM is one segment (seg = m, ldo = k).
template <int NT, int PER>
__global__ void __launch_bounds__(NT)
block_rows(const float* __restrict__ values, float* __restrict__ out_v,
           long long* __restrict__ out_i, int m_row, int k_all, int seg, int ldo) {
  constexpr int NW = NT / 32;
  extern __shared__ u64 smem[];
  const int cap = block_cap(k_all);
  const long long base = (long long)blockIdx.y * seg;
  const int m = min(seg, m_row - (int)base), k = min(k_all, m);
  u64* buf = smem;                      // [cap] candidate keys
  u32* lists = (u32*)(buf + cap);       // [NW][32] each warp's lane maxima, descending
  u32* bnd = lists + NW * 32;           // [NW] the bound of c = warp + 1 warps
  u32* red = bnd + NW;                  // [3][NW] warp sums: 0-1 by step parity, 2 scans
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float* src = values + (size_t)blockIdx.x * m_row + base;

  u32 img[PER];
  u32 mx = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = j * NT + t;
    img[j] = i < m ? order_bits(__ldg(src + i)) : 0u;
    mx = max(mx, img[j]);
  }
  lists[warp * 32 + lane] = warp_sort_desc(mx);
  __syncthreads();
  {
    const int c = warp + 1, jj = (k + c - 1) / c;
    u32 b = 0u;
    if (jj <= 32)                       // warp-uniform
      b = __shfl_sync(kFull, warp_sort_desc(lane < NW ? lists[lane * 32 + jj - 1] : 0u),
                      c - 1);
    if (lane == 0) bnd[warp] = b;
  }
  __syncthreads();
  u32 lo = 1u, top = 0u;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    lo = max(lo, bnd[w]);
    top = max(top, lists[w * 32]);
  }

  u32 ge, gt, tot;
  threshold_masks(img, lo, ge, gt);
  u32 p = count_pair(ge, gt);
  u32 excl = block_scan<NW>(p, red + 2 * NW, tot);
  if ((tot & 0xFFFFu) > (u32)cap && (tot >> 16) >= (u32)k) {
    __syncthreads();                    // every thread has read the scan's sums
    u32 c_lo = tot >> 16;
    u64 hi = (u64)top + 1;
    lo += 1;
    for (int step = 0; c_lo > (u32)cap && hi - lo > 1; ++step) {
      const u32 mid = lo + (u32)((hi - lo) >> 1);
      bisect(lo, hi, c_lo, mid, block_sum<NW>(count_ge(img, mid), red + (step & 1) * NW), k);
    }
    threshold_masks(img, lo, ge, gt);
    p = count_pair(ge, gt);
    excl = block_scan<NW>(p, red + 2 * NW, tot);
  }
  int n = k;
  if ((tot & 0xFFFFu) <= (u32)cap) {    // sort path: every image >= lo
    gather<NT>(ge, src, t, buf, excl & 0xFFFFu);
    n = (int)(tot & 0xFFFFu);
  } else {                              // tie path: lo is the k-th largest
    gather<NT>(gt, src, t, buf, excl >> 16);
    const u32 ngt = tot >> 16, need = (u32)k - ngt;
    const u32 below = lanes_below();
    u32 taken = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {     // equal images in index order: j, then thread
      const bool eq = img[j] == lo;
      const u32 b = __ballot_sync(kFull, eq);
      u32* sums = red + (j & 1) * NW;
      if (lane == 0) sums[warp] = __popc(b);
      __syncthreads();
      u32 before = 0, all = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const u32 r = sums[w];
        before += w < warp ? r : 0u;
        all += r;
      }
      const u32 r = taken + before + __popc(b & below);
      if (eq && r < need) buf[ngt + r] = make_key(lo, j * NT + t);
      taken += all;
      if (taken >= need) break;         // block-uniform
    }
  }
  __syncthreads();
  const size_t out0 = (size_t)blockIdx.x * ldo + (size_t)blockIdx.y * k_all;
  write_ranked(buf, n, k, t, NT, src, out_v + out0, out_i + out0, base);
}

template <int PER>
int launch_warp(const float* v, float* ov, long long* oi, int R, int m, int k,
                cudaStream_t s) {
  const unsigned grid = (unsigned)((R + kWarpRows - 1) / kWarpRows);
  if (k > kTwoMaxK)
    warp_rows<PER, 2><<<grid, 32 * kWarpRows, 0, s>>>(v, ov, oi, R, m, k);
  else
    warp_rows<PER, 1><<<grid, 32 * kWarpRows, 0, s>>>(v, ov, oi, R, m, k);
  return (int)cudaGetLastError();
}

// segs segments of seg lanes a row (1 and m for a whole row), out rows of ldo
template <int NT, int PER>
int launch_block(const float* v, float* ov, long long* oi, int R, int m, int k,
                 cudaStream_t s, int segs = 1, int seg = 0, int ldo = 0) {
  const size_t bytes = block_smem<NT>(k);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_rows<NT, PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  block_rows<NT, PER><<<dim3((unsigned)R, (unsigned)segs), NT, bytes, s>>>(
      v, ov, oi, m, k, segs == 1 ? m : seg, segs == 1 ? k : ldo);
  return (int)cudaGetLastError();
}

// ---- k > kMaxK: radix select in a row, the winners sorted in scratch ----
//
// One block of kRadixThreads a row.  Four passes over the row (8 bits of
// the image a pass, a 256-bin histogram in shared memory of the images
// that match the bits chosen so far) give the k-th largest image T and how
// many images equal to it are taken (need; the rest of the k are above
// it).  One pass in index order then writes the keys of every image > T
// (at an atomic position) and of the first `need` images == T (ranked by a
// block scan, lowest index first) to the row's scratch [P2] (P2 the power
// of two >= k, zero keys past k), a bitonic sort puts them in descending
// key order in place, and the first k are written as the row holds them.
// Simple and right; each step is a pass over the row or the scratch.
constexpr int kRadixThreads = 1024;

__global__ void __launch_bounds__(kRadixThreads)
radix_rows(const float* __restrict__ values, float* __restrict__ out_v,
           long long* __restrict__ out_i, u64* __restrict__ scratch, int m, int k, int P2) {
  constexpr int NT = kRadixThreads, NW = NT / 32;
  __shared__ u32 hist[256];
  __shared__ u32 red[2][NW];
  __shared__ u32 s_bin, s_rest, s_gt;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float* src = values + (size_t)blockIdx.x * m;
  u64* keys = scratch + (size_t)blockIdx.x * P2;

  u32 prefix = 0u, mask = 0u, rest = (u32)k;   // rest: the rank sought among the matches
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = t; b < 256; b += NT) hist[b] = 0u;
    __syncthreads();
    for (int i = t; i < m; i += NT) {
      const u32 img = order_bits(__ldg(src + i));
      if ((img & mask) == prefix) atomicAdd(&hist[(img >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (t == 0) {
      u32 above = 0u;
      int b = 255;
      for (; b > 0 && above + hist[b] < rest; --b) above += hist[b];
      s_bin = (u32)b;
      s_rest = rest - above;
    }
    __syncthreads();
    prefix |= s_bin << shift;
    mask |= 255u << shift;
    rest = s_rest;
    __syncthreads();                    // s_bin / s_rest read before the next pass
  }
  const u32 T = prefix, need = rest, ngt = (u32)k - need;
  if (t == 0) s_gt = 0u;
  __syncthreads();
  const u32 below = lanes_below();
  u32 taken = 0u;
  for (int i0 = 0; i0 < m; i0 += NT) {  // block-uniform trip count
    const int i = i0 + t;
    const u32 img = i < m ? order_bits(__ldg(src + i)) : 0u;
    if (i < m && img > T) keys[atomicAdd(&s_gt, 1u)] = make_key(img, i);
    const bool eq = i < m && img == T;
    if (taken < need) {                 // block-uniform
      const u32 b = __ballot_sync(kFull, eq);
      u32* sums = red[(i0 / NT) & 1];
      if (lane == 0) sums[warp] = __popc(b);
      __syncthreads();
      u32 before = 0u, all = 0u;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const u32 r = sums[w];
        before += w < warp ? r : 0u;
        all += r;
      }
      const u32 r = taken + before + __popc(b & below);
      if (eq && r < need) keys[ngt + r] = make_key(T, i);
      taken += all;
    }
  }
  for (int i = k + t; i < P2; i += NT) keys[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= P2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < P2 / 2; i += NT) {
        const int lo = (i / stride) * 2 * stride + i % stride, hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const u64 a = keys[lo], b = keys[hi];
        if ((a < b) == desc) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  float* ov = out_v + (size_t)blockIdx.x * k;
  long long* oi = out_i + (size_t)blockIdx.x * k;
  for (int r = t; r < k; r += NT) {
    const int i = key_index(keys[r]);
    ov[r] = __ldg(src + i);
    oi[r] = i;
  }
}

}  // namespace s1

// (values [R, m] f32, out_v [R, k] f32, out_i [R, k] int64, R, m, k, stream)
// m <= 32,768 and k <= 1,024
extern "C" int crt_window_topk(const void* values, void* out_v, void* out_i,
                               int R, int m, int k, void* stream) {
  using namespace s1;
  if (R < 0 || m < 1 || k < 1 || k > m || m > kMaxM || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const float* v = (const float*)values;
  float* ov = (float*)out_v;
  long long* oi = (long long*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= kWarpMaxM && k <= kWarpMaxK) {
    switch ((m + 127) / 128) {          // PER: images a lane, a multiple of 4
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
  if (m <= 1024) return launch_block<128, 8>(v, ov, oi, R, m, k, s);
  if (m <= 2048) return launch_block<128, 16>(v, ov, oi, R, m, k, s);
  if (m <= 4096) return launch_block<256, 16>(v, ov, oi, R, m, k, s);
  if (m <= 6144) return launch_block<256, 24>(v, ov, oi, R, m, k, s);
  if (m <= 8192) return launch_block<256, 32>(v, ov, oi, R, m, k, s);
  if (m <= 16384) return launch_block<512, 32>(v, ov, oi, R, m, k, s);
  return launch_block<1024, 32>(v, ov, oi, R, m, k, s);
}

// The first level of a row longer than 32,768 (k <= 1,024): segment s of
// lanes [32,768 s, 32,768 (s + 1)) of each row gives its min(k, length)
// winners, in S1's order, to out[row, s k ...]; out rows hold
// ldo = (segments - 1) k + min(k, last length) entries, indices in the row.
extern "C" int crt_window_topk_segments(const void* values, void* out_v, void* out_i,
                                        int R, int m, int k, int ldo, void* stream) {
  using namespace s1;
  const int segs = (m + kMaxM - 1) / kMaxM;
  const int last = m - (segs - 1) * kMaxM;
  if (R < 0 || m <= kMaxM || k < 1 || k > kMaxK || segs > 65535 ||
      ldo != (segs - 1) * k + (k < last ? k : last))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  return launch_block<1024, 32>((const float*)values, (float*)out_v, (long long*)out_i, R, m,
                                k, (cudaStream_t)stream, segs, kMaxM, ldo);
}

// k > 1,024, any m >= k: radix select a row (radix_rows); scratch: R x P2
// uint64 keys, P2 the power of two >= k.
extern "C" int crt_window_topk_large(const void* values, void* out_v, void* out_i,
                                     void* scratch, int R, int m, int k, int P2,
                                     void* stream) {
  using namespace s1;
  if (R < 0 || k < 1 || k > m || P2 < k || (P2 & (P2 - 1)) || P2 / 2 >= k)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  radix_rows<<<(unsigned)R, kRadixThreads, 0, (cudaStream_t)stream>>>(
      (const float*)values, (float*)out_v, (long long*)out_i, (u64*)scratch, m, k, P2);
  return (int)cudaGetLastError();
}
