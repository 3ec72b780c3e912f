// K2 at L <= 2 (S = 4 d splits), in a translation unit of its own so nvcc
// builds it beside signproj.cu.

#include "signproj.cuh"

namespace k2 {

template <int K>
int launch_wide(const float* x, const float* proj, int32_t* out, int n, int d,
                int L, cudaStream_t stream) {
  return launch_split<K, 4>(x, proj, out, n, d, L, stream);
}

#define CRT_K(K)                                                              \
  template int launch_wide<K>(const float*, const float*, int32_t*, int, int, \
                              int, cudaStream_t);
CRT_K(1) CRT_K(2) CRT_K(3) CRT_K(4) CRT_K(5) CRT_K(6) CRT_K(7) CRT_K(8)
CRT_K(9) CRT_K(10) CRT_K(11) CRT_K(12) CRT_K(13) CRT_K(14) CRT_K(15)
CRT_K(16) CRT_K(17) CRT_K(18) CRT_K(19) CRT_K(20) CRT_K(21) CRT_K(22)
CRT_K(23) CRT_K(24) CRT_K(25) CRT_K(26) CRT_K(27) CRT_K(28) CRT_K(29)
CRT_K(30)
#undef CRT_K

}  // namespace k2
