// jax.random's key tree and draws on Hopper, for the kernels of
// agg_day.cu and lanes_day.cu: keys and their children, the uniform
// transforms and the fused multiply-add of the plain versions' fma32 (the
// Laplace draws and the inverse-CDF binomial walk are in xla_math.cuh). Every float operation is the one the plain
// PyTorch version performs on the card, spelled so that nvcc cannot
// contract or reorder it (__fmul_rn, __fadd_rn, __fdiv_rn, IEEE sqrtf,
// rintf, and the expf, logf and log1pf that PyTorch's CUDA kernels
// call). The build hashes this header into each library's cache name
// (adcraft_tpu_torch/cuda_build.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

// rows of the (kNumParams, E, K) parameter tensor (agg_day.py)
enum {
  BID, BCTR, SCTR, LOC, SCALE, REV_MEAN, REV_STD, IMP_THRESH, IMP_INTERCEPT, IMP_SLOPE,
  MAX_BIDDERS, PARTICIPATION, kNumParams
};

struct Key {
  uint32_t k0, k1;
};

// split(key, n)[i] and fold_in(key, i) are both the pair at counter (0, i)
__device__ __forceinline__ Key child(Key k, uint32_t i) {
  const uint2 y = threefry::block(k.k0, k.k1, 0u, i);
  return Key{y.x, y.y};
}

__device__ __forceinline__ Key load_key(const long long* keys, long long stride, int e) {
  return Key{static_cast<uint32_t>(keys[e * stride]), static_cast<uint32_t>(keys[e * stride + 1])};
}

__device__ __forceinline__ uint32_t bits32(Key k, uint32_t counter) {
  return threefry::word(k.k0, k.k1, 0u, counter);
}

// jax.random.uniform's mantissa transform of a 32-bit word
__device__ __forceinline__ float uniform32(uint32_t w) {
  return __fsub_rn(__uint_as_float((w >> 9) | 0x3F800000u), 1.0f);
}

// uniform16: (b + 0.5) / 65536 of the low 16 bits; else uniform32
__device__ __forceinline__ float lane_uniform(Key k, uint32_t counter, int bits) {
  const uint32_t w = bits32(k, counter);
  if (bits == 16) return __fmul_rn(__fadd_rn(static_cast<float>(w & 0xFFFFu), 0.5f), 1.0f / 65536.0f);
  return uniform32(w);
}

// a * b + c rounded once, as XLA's contractions round it and as the plain
// version's fma32 computes it (a float64 sum rounded to odd, then cast)
__device__ __forceinline__ float fma32(float a, float b, float c) { return __fmaf_rn(a, b, c); }

}  // namespace
