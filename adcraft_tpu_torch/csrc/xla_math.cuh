// XLA's float32 log, log1p and erf_inv on the CPU, and jax.random.normal on
// them, as adcraft_tpu_torch/xla_math.py computes them: the same algorithms
// and constants (bit patterns), every product and sum spelled with
// __fmul_rn / __fadd_rn, and each fused multiply-add that LLVM forms on the
// CPU as fma32 (a float64 product and sum rounded to float32, which is what
// the plain version computes). So the kernels equal the plain version on
// the card bit for bit, and both equal jax.random's draws.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "jax_random.cuh"

namespace {

__device__ __forceinline__ float f32(uint32_t bits) { return __uint_as_float(bits); }

// Cephes logf (Eigen's plog_float) with LLVM's contractions
__device__ float xla_log(float y) {
  const float flt_min = f32(0x00800000u);
  const int bits = __float_as_int(y > flt_min ? y : flt_min);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 127), 1.0f);
  const float mant = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool low = mant < f32(0x3F3504F3u);
  const float x = __fadd_rn(__fsub_rn(mant, 1.0f), low ? mant : 0.0f);
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float z = __fmul_rn(x, x);
  const float x3 = __fmul_rn(z, x);
  const float p0 = fma32(fma32(x, f32(0x3D9021BBu), f32(0xBDEBD1B8u)), x, f32(0x3DEF251Au));
  const float p1 = fma32(fma32(x, f32(0xBDFE5D4Fu), f32(0x3E11E9BFu)), x, f32(0xBE2AAE50u));
  const float p2 = fma32(fma32(x, f32(0x3E4CCEACu), f32(0xBE7FFFFCu)), x, f32(0x3EAAAAAAu));
  const float poly = fma32(fma32(p0, x3, p1), x3, p2);
  float out = __fadd_rn(fma32(poly, x3, __fmul_rn(e, f32(0xB95E8083u))), fma32(z, -0.5f, x));
  out = fma32(e, f32(0x3F318000u), out);
  if (isnan(y) || y < 0.0f) out = __int_as_float(0x7FC00000);
  if (y == __int_as_float(0x7F800000)) out = y;
  if (fabsf(y) < flt_min) out = __int_as_float(0xFF800000);  // subnormals count as 0
  return out;
}

// whether xla_log1p takes its rational function at x: |x| < sqrt(2) - 1
__device__ __forceinline__ bool xla_log1p_rational_at(float x) {
  return fabsf(x) < f32(0x3ED413CDu);
}

// xla_log1p's rational function, for |x| < sqrt(2) - 1
__device__ float xla_log1p_rational(float x) {
  const uint32_t num_c[7] = {0x383DE04Bu, 0x3EFF40C5u, 0x40D284FAu, 0x41EF4B9Cu,
                             0x4273CC76u, 0x426473ADu, 0x41A05101u};
  const uint32_t den_c[6] = {0x417101ADu, 0x42A6185Bu, 0x435DC32Du,
                             0x439A8CA3u, 0x43586D8Au, 0x42707982u};
  float num = f32(num_c[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) num = fma32(num, x, f32(num_c[i]));
  float den = 1.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) den = fma32(den, x, f32(den_c[i]));
  const float x2 = __fmul_rn(x, x);
  return __fadd_rn(x, fma32(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den))));
}

// log(1 + x) outside |x| < sqrt(2) - 1, a rational function inside
__device__ float xla_log1p(float x) {
  if (!xla_log1p_rational_at(x)) return xla_log(__fadd_rn(x, 1.0f));
  return xla_log1p_rational(x);
}

// Giles' erf_inv of x in w = -l1p, l1p = log1p(-x^2), by fused Horner steps
__device__ float xla_erfinv_of(float x, float l1p) {
  const uint32_t lt5[9] = {0x32F16588u, 0x34B84B36u, 0xB66C7357u, 0xB6935AC1u, 0x396532DBu,
                           0xBAA45408u, 0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};
  const uint32_t ge5[9] = {0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u, 0xBB70BDE7u, 0x3BBC127Bu,
                           0xBBF9C5D7u, 0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};
  const bool lt = l1p > -5.0f;
  const float w = lt ? __fsub_rn(-2.5f, l1p) : __fsub_rn(sqrtf(-l1p), 3.0f);
  float p = f32(lt ? lt5[0] : ge5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fma32(p, w, f32(lt ? lt5[i] : ge5[i]));
  return __fmul_rn(x, fabsf(x) == 1.0f ? __int_as_float(0x7F800000) : p);
}

// jax.random.normal's uniform on [nextafter(-1, 0), 1) at a counter
__device__ __forceinline__ float uniform_open(Key k, uint32_t counter) {
  const float lo = __int_as_float(0xBF7FFFFF);
  const float span = __fsub_rn(1.0f, lo);
  return fmaxf(__fadd_rn(__fmul_rn(uniform32(bits32(k, counter)), span), lo), lo);
}

}  // namespace
