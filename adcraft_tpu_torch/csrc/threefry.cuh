// threefry2x32 (20 rounds) for Hopper kernels, as jax.random computes it
// and as adcraft_tpu_torch/prng_kernel.py:threefry2x32 computes it in plain
// tensor ops. Shared by day_kernel.cu and prng_kernels.cu; the build hashes
// this header into each library's cache name (adcraft_tpu_torch/cuda_build.py).
//
// Every operation is a 32-bit integer add, xor or rotate; a rotate is one
// funnel shift (__funnelshift_l).

#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

// Both output words (y0, y1) for key (k0, k1) and counter (x0, x1).
__device__ __forceinline__ uint2 block(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

#undef TF_ROUND

// The word y0 ^ y1: jax.random.bits' 32-bit word under partitionable
// threefry, and the day kernel's draw.
__device__ __forceinline__ uint32_t word(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint2 y = block(k0, k1, x0, x1);
  return y.x ^ y.y;
}

}  // namespace threefry
