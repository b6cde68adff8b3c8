// The rank24 table's one-load rank and the SBWT's C array in registers,
// shared by the kernels of the stream and replica engines
// (chain_opt.cu, segment_repair.cu): the device form of ops/rank24.py's
// rank24 and update_interval24.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fin {

// C[0..3], read once a lane and kept in registers
struct Cs {
  long long c0, c1, c2, c3;
  __device__ __forceinline__ long long operator[](int c) const {
    return c < 2 ? (c == 0 ? c0 : c1) : (c == 2 ? c2 : c3);
  }
  static __device__ __forceinline__ Cs load(const int32_t* C) {
    return Cs{__ldg(C), __ldg(C + 1), __ldg(C + 2), __ldg(C + 3)};
  }
};

// rank_c(i) of rank24 (ops/rank24.py rank24): one load, of entry c * n8 + i / 8;
// tab is flat (4 * n8,) [rank << 8 | byte] or, WIDE, (4 * n8, 2) [rank, byte]
template <bool WIDE>
__device__ __forceinline__ uint32_t rank24(const int32_t* tab, long long base, long long i) {
  const uint32_t mask = (1u << (i & 7)) - 1u;
  if (WIDE) {
    const int2 e = __ldg(reinterpret_cast<const int2*>(tab) + base + (i >> 3));
    return static_cast<uint32_t>(e.x) + __popc(static_cast<uint32_t>(e.y) & mask);
  }
  const uint32_t e = static_cast<uint32_t>(__ldg(tab + base + (i >> 3)));
  return (e >> 8) + __popc(e & mask);
}

}  // namespace fin
