// Shared pieces of the slab-row kernels (slabscore.cu, binned.cu,
// slabvariants.cu, probetile.cu): the slab element types, one element as
// f32, and the f32 dot of one 16-byte chunk of a slab row with its query
// elements.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slabrow {

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

// elements per 16-byte chunk
template <int DT> struct Elems;
template <> struct Elems<kF32> { static constexpr int n = 4; };
template <> struct Elems<kBF16> { static constexpr int n = 8; };
template <> struct Elems<kI8> { static constexpr int n = 16; };

// slab element e of a 16-byte-aligned row, as f32
template <int DT>
__device__ __forceinline__ float element(const uint8_t* row, int e) {
  if constexpr (DT == kF32) return reinterpret_cast<const float*>(row)[e];
  if constexpr (DT == kBF16)
    return __uint_as_float((uint32_t)reinterpret_cast<const uint16_t*>(row)[e] << 16);
  return (float)reinterpret_cast<const int8_t*>(row)[e];
}

// signed byte b of a little-endian word, as f32
__device__ __forceinline__ float i8(uint32_t w, int b) {
  return (float)((int32_t)(w << (24 - 8 * b)) >> 24);
}

// f32 dot of one 16-byte chunk with its query elements q[0, Elems<DT>::n)
template <int DT>
__device__ __forceinline__ float chunk_dot(uint4 v, const float* q, float acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (DT == kF32) {
      acc = fmaf(__uint_as_float(w[i]), q[i], acc);
    } else if (DT == kBF16) {   // little-endian: low half is the first element
      acc = fmaf(__uint_as_float(w[i] << 16), q[2 * i], acc);
      acc = fmaf(__uint_as_float(w[i] & 0xffff0000u), q[2 * i + 1], acc);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc = fmaf(i8(w[i], b), q[4 * i + b], acc);
    }
  }
  return acc;
}

// lanes per row group: the largest power of two <= min(chunks, 32)
inline int row_group(int chunks) {
  int group = 1;
  while (group * 2 <= chunks && group < 32) group *= 2;
  return group;
}

}  // namespace slabrow
