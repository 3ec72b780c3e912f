// Shared pieces of the slab kernels (slabtile.cu, probetile.cu): the slab
// element types, one element as f32, and one signed byte of a word as f32.

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

}  // namespace slabrow
