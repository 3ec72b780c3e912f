// K2: fused sign-projection + bit-pack hash for cosine (SimHash) LSH.
//
// Replaces the TPU kernel crypto_rec_tpu/ops/pallas/signproj.py
// (signproj_bucket_ids, pallas_call at :61, body _kernel :37-41):
//   acc = x @ proj (f32), bit = acc >= 0, the k bits of each table packed
//   MSB-first into an int32 bucket id (reference cosine_g_gen.hpp:62-72).
//
// What bounds it on the H100: at L = 1 (cube vertices, 2M x 128 rows,
// proj [128, 13]) it reads x once, 1.02 GB: ~0.31 ms at 3.35 TB/s, with
// only 6.8 GFLOP of FMA.  At L = 8 (the index build, proj [128, 104]) the
// 53 GFLOP of f32 FFMA take ~0.79 ms at 67 TFLOP/s: operation-bound.
// No TF32 and no tensor cores: a rounding change flips the sign of
// projections near zero and breaks bucket parity with the reference hash.
//
// Design, as a streamed f32 GEMM with a bit-pack epilogue:
// - A block owns tiles of BM x rows (persistent over tiles) and every
//   table: 256 / S (row group g, table t) units, each run by S lanes that
//   split each slice's columns and sum their partial dots with shuffles
//   at the tile's end.  A lane accumulates R = 4 rows g, g + G, ... of
//   table t against the table's K projections: R * K registers, so each
//   shared load of proj feeds R FMAs and each x load K of them.
// - x streams through a ring of kStages slices of BM rows, filled by
//   cp.async: the loads of slice s + 2 overlap the FMAs of slice s.  At
//   L <= 2 (the cube vertices: few FMAs a byte) S = 4 and a slice holds a
//   whole 128-byte line of every row, so no DRAM burst is split between
//   slices.  At more tables S = 1 (4x the rows a block, no split sums to
//   shuffle) and a slice holds 16 columns: half the block-wide barriers of
//   8, which measured faster at L = 8.  A slice is 8-32 KB, so two blocks
//   of 8 warps stay resident on an SM; proj ([d, L, K padded to a stride
//   whose 16-byte groups are odd in number]) sits in shared memory for the
//   block's life, read as float4 without bank conflicts.
// - Where all of proj does not fit beside the ring (d = 384 at k = 13,
//   L = 8: 246 KB), proj streams instead: each ring slot holds the
//   slice's columns of proj too (4-byte cp.async from the [d, L k]
//   tensor), so shared memory holds no more of proj at d = 1,536 than at
//   d = 128, and the tables split into groups on grid.y where a slot's
//   proj for all of them would not fit two blocks an SM (L = 64 at
//   k = 13: three groups of 22, each re-reading x from L2).  Any d and L.
//   Each sum still runs over d in column order, the same as resident.
//   Streamed, the kernel took 1.13-1.35x the resident time at resident
//   shapes on an H100 (tools/chip_probes/prev_build_ab.py: proj re-read a
//   tile, 4-byte copies), so it runs only where resident cannot.
// - The 16-byte units of a slice row are XOR-swizzled on the row, so 8
//   rows' same unit hit 8 distinct bank groups.
// The [n, L*k] projection tensor never leaves the SM.

#include "signproj.cuh"

namespace k2 {

// L <= 2 streams (few FMAs a byte): 4 d splits, whole 128-byte lines a
// slice.  More tables are FMA-bound: no split, 64-byte slices, 4x the rows
// a block.
template <int K>
int launch(const float* x, const float* proj, int32_t* out, int n, int d,
           int L, cudaStream_t stream) {
  return L <= 2 ? launch_wide<K>(x, proj, out, n, d, L, stream)
                : launch_split<K, 1>(x, proj, out, n, d, L, stream);
}

}  // namespace k2

extern "C" int crt_signproj(const void* x, const void* proj, void* out,
                            int n, int d, int k, int L, void* stream) {
  if (L < 1 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* pf = (const float*)proj;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define CRT_K(K) case K: return k2::launch<K>(xf, pf, o, n, d, L, s);
    CRT_K(1) CRT_K(2) CRT_K(3) CRT_K(4) CRT_K(5) CRT_K(6) CRT_K(7) CRT_K(8)
    CRT_K(9) CRT_K(10) CRT_K(11) CRT_K(12) CRT_K(13) CRT_K(14) CRT_K(15)
    CRT_K(16) CRT_K(17) CRT_K(18) CRT_K(19) CRT_K(20) CRT_K(21) CRT_K(22)
    CRT_K(23) CRT_K(24) CRT_K(25) CRT_K(26) CRT_K(27) CRT_K(28) CRT_K(29)
    CRT_K(30)
#undef CRT_K
    default: return (int)cudaErrorInvalidValue;   // k > 30: ids are int32
  }
}
