// XLA's float32 log, log1p, erf_inv, exp, expm1, tanh, pow, erf and erfc
// and its float scans on the CPU, jax.random.normal and the Laplace draws
// on them, and the explicit keywords' impression rate,
// cost moments and lane costs (adcraft_tpu_torch/distributions.py), as the
// plain version computes them: the same algorithms
// and constants (bit patterns), every product and sum spelled with
// __fmul_rn / __fadd_rn, and each fused multiply-add that LLVM forms on the
// CPU as fma32 (__fmaf_rn, rounded once, as the plain version's fma32
// rounds it). So the kernels equal the plain version on
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

// prng.normal_erfinv: erf_inv of jax.random.normal's uniform at a
// counter (the normal is this times sqrt(2))
__device__ __forceinline__ float xla_normal_erfinv(Key k, uint32_t counter) {
  const float u = uniform_open(k, counter);
  return xla_erfinv_of(u, xla_log1p(__fmul_rn(u, -u)));
}

// prng.normal: jax.random.normal's draw at a counter, sqrt(2) erf_inv(u)
__device__ __forceinline__ float xla_normal(Key k, uint32_t counter) {
  return __fmul_rn(xla_normal_erfinv(k, counter), 1.41421354f);
}

// xla_math.ftz: XLA's CPU code flushes subnormal results to zero
__device__ __forceinline__ float xla_ftz(float x) {
  return fabsf(x) < f32(0x00800000u) ? 0.0f : x;
}

// xla_math.exp: Cephes expf as XLA emits it; x clamped as torch.clamp
// clamps (a NaN passes)
__device__ float xla_exp(float x) {
  const float lo = f32(0xC2AF999Au), hi = f32(0x42B1999Au);
  x = x < lo ? lo : (x > hi ? hi : x);
  float n = floorf(fma32(x, f32(0x3FB8AA3Bu), 0.5f));
  n = n < -127.0f ? -127.0f : (n > 127.0f ? 127.0f : n);
  float r = fma32(n, -f32(0x3F318000u), x);
  r = fma32(n, -f32(0xB95E8083u), r);
  float p = fma32(r, f32(0x39506967u), f32(0x3AB743CEu));
  p = fma32(p, r, f32(0x3C088908u));
  p = fma32(p, r, f32(0x3D2AA9C1u));
  p = fma32(p, r, f32(0x3E2AAAAAu));
  p = fma32(p, r, 0.5f);
  const float y = __fadd_rn(fma32(p, __fmul_rn(r, r), r), 1.0f);
  const float scale = __int_as_float((static_cast<int>(n) + 127) << 23);
  return xla_ftz(__fmul_rn(y, scale));
}

// xla_math.erf: XLA's rational function, x clamped to +-3.7439
__device__ float xla_erf(float x) {
  const float c = f32(0x406F9C68u);
  x = x < -c ? -c : (x > c ? c : x);
  const float x2 = __fmul_rn(x, x);
  float p = fma32(x2, f32(0x39702D51u), f32(0x3B5F5DA2u));
  p = fma32(p, x2, f32(0x3D50B6EBu));
  p = fma32(p, x2, f32(0x3E3DA740u));
  p = fma32(p, x2, f32(0x3F906EBAu));
  float q = fma32(x2, f32(0xB3FD3906u), f32(0x37C588DFu));
  q = fma32(q, x2, f32(0x3A856D28u));
  q = fma32(q, x2, f32(0x3C6687D4u));
  q = fma32(q, x2, f32(0x3DE34C21u));
  q = fma32(q, x2, f32(0x3EFEB44Au));
  return __fdiv_rn(__fmul_rn(x, p), fma32(q, x2, 1.0f));
}

// the fused Horner steps of xla_math._horner: ((c0 x + c1) x + c2) ...
template <int N>
__device__ __forceinline__ float xla_horner(float x, const uint32_t (&c)[N]) {
  float p = fma32(x, f32(c[0]), f32(c[1]));
#pragma unroll
  for (int i = 2; i < N; ++i) p = fma32(p, x, f32(c[i]));
  return p;
}

// distributions.laplace_cdf on XLA's exp, at z = (x - loc) / scale
__device__ __forceinline__ float laplace_cdf_z(float z) {
  return z < 0.0f ? __fmul_rn(0.5f, xla_exp(z)) : __fsub_rn(1.0f, __fmul_rn(0.5f, xla_exp(-z)));
}

__device__ __forceinline__ float laplace_cdf(float x, float loc, float scale) {
  return laplace_cdf_z(__fdiv_rn(__fsub_rn(x, loc), scale));
}

// distributions.laplace_icdf on XLA's log: the plain version computes both
// branches' logs and selects one; the kernel computes only the selected one
__device__ __forceinline__ float laplace_icdf(float u, float loc, float scale) {
  const bool low = u < 0.5f;
  const float l = xla_log(fmaxf(__fmul_rn(2.0f, low ? u : __fsub_rn(1.0f, u)), 1e-38f));
  return fma32(scale, low ? l : -l, loc);
}

// distributions.int32_of: float to int32 as XLA converts it, toward zero,
// saturating at both ends, NaN to 0
__device__ __forceinline__ int xla_int32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 0x7FFFFFFF;
  if (x <= -2147483648.0f) return static_cast<int>(0x80000000u);
  return static_cast<int>(x);
}

// one lane cost in cents: round(|Laplace truncated to [-y0, y0]| * 100); a
// draw at XLA's log of 0 (a subnormal CDF argument) is infinite, and its
// cents INT32_MAX
__device__ __forceinline__ int lane_cost(float u, float loc, float scale, float f_lo, float f_hi) {
  const float x = laplace_icdf(fma32(u, __fsub_rn(f_hi, f_lo), f_lo), loc, scale);
  return xla_int32(rintf(__fmul_rn(fabsf(x), 100.0f)));
}

// xla_math.tanh: XLA's rational tanh, x clamped to +-7.998; x itself
// below 4e-4, +-1 from 20 on
__device__ float xla_tanh(float x) {
  const uint32_t p_c[7] = {0xA59F25C0u, 0x2A61337Eu, 0xAEBD37FFu, 0x335C0041u,
                           0x3779434Au, 0x3A270DEDu, 0x3BA059DCu};
  const uint32_t q_c[4] = {0x35A0D3D8u, 0x38F895D6u, 0x3B14AA05u, 0x3BA059DDu};
  const float c = f32(0x40FFF644u);
  const float xc = x < -c ? -c : (x > c ? c : x);
  const float x2 = __fmul_rn(xc, xc);
  float out = __fdiv_rn(__fmul_rn(xc, xla_horner(x2, p_c)), xla_horner(x2, q_c));
  if (fabsf(x) < f32(0x39D1B717u)) out = x;
  if (fabsf(x) >= 20.0f) out = copysignf(1.0f, x);
  return out;
}

// xla_math.expm1: exp(x) - 1 where |x| > 1/2, else tanh(x / 2) (exp(x) + 1),
// and x where x / 2 is 0
__device__ float xla_expm1(float x) {
  const float e = xla_exp(x);
  const float half = __fmul_rn(x, 0.5f);
  const float out =
      fabsf(x) > 0.5f ? __fsub_rn(e, 1.0f) : __fmul_rn(xla_tanh(half), __fadd_rn(e, 1.0f));
  return half == 0.0f ? x : out;
}

// xla_math.pow: the C library's powf, as XLA's CPU code calls it, for
// normal x > 0 or 0 (or y 0, or x 1): log2 and exp2 in double precision on its
// tables, each double operation as the plain version's tensor op. The
// tables sit in device memory and are read through the L1 (__ldg), a line
// each (kExp2T two): a warp's lanes index them by their own x and y, and
// the constant cache serves a warp's differing addresses one at a time.
__device__ __align__(128) double kPowInvc[16] = {
    0x1.661ec79f8f3bep+0, 0x1.571ed4aaf883dp+0, 0x1.49539f0f010b0p+0, 0x1.3c995b0b80385p+0,
    0x1.30d190c8864a5p+0, 0x1.25e227b0b8ea0p+0, 0x1.1bb4a4a1a343fp+0, 0x1.12358f08ae5bap+0,
    0x1.0953f419900a7p+0, 0x1p+0, 0x1.e608cfd9a47acp-1, 0x1.ca4b31f026aa0p-1,
    0x1.b2036576afce6p-1, 0x1.9c2d163a1aa2dp-1, 0x1.886e6037841edp-1, 0x1.767dcf5534862p-1};
__device__ __align__(128) double kPowLogc[16] = {
    -0x1.efec65b963019p-2, -0x1.b0b6832d4fca4p-2, -0x1.7418b0a1fb77bp-2, -0x1.39de91a6dcf7bp-2,
    -0x1.01d9bf3f2b631p-2, -0x1.97c1d1b3b7af0p-3, -0x1.2f9e393af3c9fp-3, -0x1.960cbbf788d5cp-4,
    -0x1.a6f9db6475fcep-5, 0x0p+0, 0x1.338ca9f24f53dp-4, 0x1.476a9543891bap-3,
    0x1.e840b4ac4e4d2p-3, 0x1.40645f0c6651cp-2, 0x1.88e9c2c1b9ff8p-2, 0x1.ce0a44eb17bccp-2};
__device__ __align__(128) unsigned long long kExp2T[32] = {
    0x3FF0000000000000ull, 0x3FEFD9B0D3158574ull, 0x3FEFB5586CF9890Full, 0x3FEF9301D0125B51ull,
    0x3FEF72B83C7D517Bull, 0x3FEF54873168B9AAull, 0x3FEF387A6E756238ull, 0x3FEF1E9DF51FDEE1ull,
    0x3FEF06FE0A31B715ull, 0x3FEEF1A7373AA9CBull, 0x3FEEDEA64C123422ull, 0x3FEECE086061892Dull,
    0x3FEEBFDAD5362A27ull, 0x3FEEB42B569D4F82ull, 0x3FEEAB07DD485429ull, 0x3FEEA47EB03A5585ull,
    0x3FEEA09E667F3BCDull, 0x3FEE9F75E8EC5F74ull, 0x3FEEA11473EB0187ull, 0x3FEEA589994CCE13ull,
    0x3FEEACE5422AA0DBull, 0x3FEEB737B0CDC5E5ull, 0x3FEEC49182A3F090ull, 0x3FEED503B23E255Dull,
    0x3FEEE89F995AD3ADull, 0x3FEEFF76F2FB5E47ull, 0x3FEF199BDD85529Cull, 0x3FEF3720DCEF9069ull,
    0x3FEF5818DCFBA487ull, 0x3FEF7C97337B9B5Full, 0x3FEFA4AFA2A490DAull, 0x3FEFD0765B6E4540ull};

__device__ float xla_pow(float x, float y) {
  if (y == 0.0f || x == 1.0f) return 1.0f;
  if (x == 0.0f) return 0.0f;  // y > 0
  const int ix = __float_as_int(x);
  const int tmp = ix - 0x3F330000;
  const int i = (tmp >> 19) & 15;
  const int top = tmp & -0x800000;
  const double z = static_cast<double>(__int_as_float(ix - top));
  const double r = __dadd_rn(__dmul_rn(z, __ldg(kPowInvc + i)), -1.0);
  const double y0 = __dadd_rn(__ldg(kPowLogc + i), static_cast<double>(top >> 23));
  const double r2 = __dmul_rn(r, r);
  const double lo = __dadd_rn(__dmul_rn(0x1.27616c9496e0bp-2, r), -0x1.71969a075c67ap-2);
  const double mid = __dadd_rn(__dmul_rn(0x1.ec70a6ca7baddp-2, r), -0x1.7154748bef6c8p-1);
  const double hi = __dadd_rn(__dmul_rn(0x1.71547652ab82bp+0, r), y0);
  const double log2x = __dadd_rn(__dmul_rn(lo, __dmul_rn(r2, r2)), __dadd_rn(__dmul_rn(mid, r2), hi));
  const double ylogx = __dmul_rn(static_cast<double>(y), log2x);
  const double shift = 0x1.8p+47;
  double kd = __dadd_rn(ylogx, shift);
  const long long ki = __double_as_longlong(kd);
  kd = __dsub_rn(kd, shift);
  const double rr = __dsub_rn(ylogx, kd);
  const double s = __longlong_as_double(static_cast<long long>(__ldg(kExp2T + (ki & 31))) +
                                        ((ki - 0x42E8000000000000ll) << 47));
  const double p = __dadd_rn(__dmul_rn(0x1.c6af84b912394p-5, rr), 0x1.ebfce50fac4f3p-3);
  const double q = __dadd_rn(__dmul_rn(0x1.62e42ff0c52d6p-1, rr), 1.0);
  double out = __dmul_rn(__dadd_rn(__dmul_rn(p, __dmul_rn(rr, rr)), q), s);
  if (ylogx <= -150.0) out = 0.0;
  return xla_ftz(__double2float_rn(out));
}

// The walk's constants for a success probability p: 1 - q and r = q / (1 -
// q) for q = min(p, 1 - p) (p clamped to [0, 1]), and whether the count
// flips (p > 1/2). They depend only on p, so agg_outcomes keeps them per
// keyword in shared memory.
struct WalkConsts {
  float omq, r;
  bool flip;
};

__device__ __forceinline__ WalkConsts walk_consts(float p) {
  p = fminf(fmaxf(p, 0.0f), 1.0f);
  const bool flip = p > 0.5f;
  const float q = flip ? __fsub_rn(1.0f, p) : p;
  const float omq = __fsub_rn(1.0f, q);
  return WalkConsts{omq, __fdiv_rn(q, omq), flip};
}

// distributions.binomial_inv_u: the inverse-CDF walk over nmax levels from
// the constants w and pmf0 = (1 - q)^n, XLA's powf (walk_count); recip(j)
// is the float32 1/j
template <class Recip>
__device__ __forceinline__ int walk_count_from(float pmf, float u, int n, const WalkConsts& w,
                                               int nmax, Recip recip) {
  const float nf = static_cast<float>(n);
  float cdf = pmf;
  int cnt = 0;
  // the CDF never falls, so the count stops at its first level >= u
  for (int j = 1; j <= nmax && cdf < u; ++j) {
    ++cnt;
    if (j == nmax) break;
    const float f = __fmul_rn(__fsub_rn(nf, static_cast<float>(j - 1)), __fmul_rn(w.r, recip(j)));
    pmf = fmaxf(__fmul_rn(pmf, f), 0.0f);
    cdf = __fadd_rn(cdf, pmf);
  }
  cnt = min(max(cnt, 0), n);
  return w.flip ? n - cnt : cnt;
}

template <class Recip>
__device__ int walk_count(float u, int n, const WalkConsts& w, int nmax, Recip recip) {
  // 1 - q >= 1/2: in xla_pow's domain
  return walk_count_from(xla_pow(w.omq, static_cast<float>(n)), u, n, w, nmax, recip);
}

template <class Recip>
__device__ __forceinline__ int binomial_walk(float u, int n, float p, int nmax, Recip recip) {
  return walk_count(u, n, walk_consts(p), nmax, recip);
}

// the CDF ladder of distributions.binomial_cdf for fixed (n, p): level 0
// is pmf0 = (1 - q)^n (XLA's powf), level j the XLA scan (blocks of 16) of
// the pmfs up to j, pmf j being pmf0 times the XLA scan of the factors
// (n - j + 1) / j r up to j
struct Ladder {
  float nf, r, pmf0;
  __device__ float factor(int j) const {
    return fmaxf(__fmul_rn(__fdiv_rn(__fsub_rn(nf, static_cast<float>(j - 1)),
                                     static_cast<float>(j)), r), 0.0f);
  }
};

__device__ __forceinline__ Ladder make_ladder(float nf, float p) {
  p = fminf(fmaxf(p, 0.0f), 1.0f);
  const float q = p > 0.5f ? __fsub_rn(1.0f, p) : p;
  return Ladder{nf, __fdiv_rn(q, __fsub_rn(1.0f, q)), xla_pow(__fsub_rn(1.0f, q), nf)};
}

// distributions.bid_cdf: F(bid) of Laplace(loc, scale); with cent_bids
// the bid is the env's round(100 b) * 0.01, whose product the env's
// program contracts into bid - loc (one fused multiply-add of the cents)
__device__ __forceinline__ float bid_cdf(float bid, float loc, float scale, bool cent_bids) {
  if (!cent_bids) return laplace_cdf(bid, loc, scale);
  return laplace_cdf_z(__fdiv_rn(fma32(rintf(__fmul_rn(bid, 100.0f)), 0.01f, -loc), scale));
}

// the binomial pool's click cost in dollars at the uniform u
// (distributions.pool_cost_u): F^-1(F(bid) u^(1/k)) for f_bid = F(bid),
// the argument clipped to [1e-38, 1] as XLA's CPU code clips it (the
// subnormal bound reads as 0), floored at 0 where k < 3, 0 where k = 0;
// from the bidder count's float32 reciprocal inv_k = 1 / k (0 where k <=
// 0; k < 3 where it is 1 or 1/2), which a caller may compute once a cell
__device__ __forceinline__ float pool_cost_inv(float u, float f_bid, float loc, float scale,
                                               float inv_k) {
  if (inv_k == 0.0f) return 0.0f;
  const float x = xla_pow(u, inv_k);
  const float a = xla_ftz(fminf(fmaxf(__fmul_rn(f_bid, x), 1e-38f), 1.0f));
  const float m = laplace_icdf(a, loc, scale);
  return inv_k > 0.4f ? fmaxf(m, 0.0f) : m;
}

__device__ __forceinline__ float pool_recip(int k) {
  return k > 0 ? __fdiv_rn(1.0f, static_cast<float>(k)) : 0.0f;
}

__device__ __forceinline__ float pool_cost(float u, float f_bid, float loc, float scale, int k) {
  return pool_cost_inv(u, f_bid, loc, scale, pool_recip(k));
}

// xla_math.cumsum / cumprod, one element at a time: XLA's CPU float scan
// adds (or multiplies) in blocks of 16, each block's elements in order;
// the blocks' totals are scanned the same way, level by level, and each
// element of a block after the first is combined with the scan of the
// totals before its block (the carry). kLevels levels hold 16^kLevels
// elements. Products flush subnormal results to zero, as XLA's CPU code.
template <bool kMul, int kLevels = 4>
struct XlaScan {
  float w[kLevels] = {};      // each level's running value within its current block
  float carry[kLevels] = {};  // the scan of the totals before that block
  int count[kLevels] = {};
  __device__ static float op(float a, float b) {
    return kMul ? xla_ftz(__fmul_rn(a, b)) : __fadd_rn(a, b);
  }
  // the scan's value at the next element x
  __device__ float push(float x) {
    w[0] = count[0] % 16 == 0 ? x : op(w[0], x);
    const float out = count[0] >= 16 ? op(w[0], carry[0]) : w[0];
    if (++count[0] % 16 == 0) up(w[0]);
    return out;
  }
  // a finished level-0 block's total v into the levels above; returns
  // the carry of the next level-0 block
  __device__ float up(float v) {
#pragma unroll
    for (int l = 1; l < kLevels; ++l) {
      w[l] = count[l] % 16 == 0 ? v : op(w[l], v);
      carry[l - 1] = count[l] >= 16 ? op(w[l], carry[l]) : w[l];
      if (++count[l] % 16 != 0) break;
      v = w[l];
    }
    return carry[0];
  }
  // the carries of the next two level-0 blocks once blocks of totals v0
  // and v1 finish, as two calls of up(v0), up(v1) return them, the scan
  // left as it is: they take level 1 and, where v0 finishes a level-1
  // block, level 2's carry after it
  __device__ void peek_carries(float v0, float v1, float& c1, float& c2) const {
    static_assert(kLevels >= 3, "the second carry may take level 2");
    const int n1 = count[1];
    const float w1 = n1 % 16 == 0 ? v0 : op(w[1], v0);
    c1 = n1 >= 16 ? op(w1, carry[1]) : w1;
    float carry1 = carry[1];
    if ((n1 + 1) % 16 == 0) {
      const float w2 = count[2] % 16 == 0 ? w1 : op(w[2], w1);
      carry1 = count[2] >= 16 ? op(w2, carry[2]) : w2;
    }
    const float w1b = (n1 + 1) % 16 == 0 ? v1 : op(w1, v1);
    c2 = n1 + 1 >= 16 ? op(w1b, carry1) : w1b;
  }
  // the scan's value after L >= 1 zeros, as L calls of push(0.0f) give
  // it: a zero leaves its block's running value as it is (or starts the
  // block at 0), so only each block it finishes sends its total up a
  // level, once per block and not once per zero
  __device__ float skip_zeros(int L) {
    static_assert(!kMul, "a product scan skips no zeros");
    float out = 0.0f;
    while (L > 0) {
      const int pos = count[0] % 16;
      const int step = min(L, 16 - pos);
      w[0] = pos == 0 ? 0.0f : op(w[0], 0.0f);
      out = count[0] + step - 1 >= 16 ? op(w[0], carry[0]) : w[0];
      count[0] += step;
      L -= step;
      if (count[0] % 16 == 0) up(w[0]);
    }
    return out;
  }
};

// binomial_inv_from_cdf's draw at the uniform u against the ladder of (n,
// p) over `levels` levels, the levels computed in order up to the first
// not below u (the ladder never falls): the count clipped to round(n) and
// flipped where p > 1/2
__device__ int ladder_draw(float nf, float p, int levels, float u) {
  const Ladder lad = make_ladder(nf, p);
  XlaScan<true> cp;
  XlaScan<false> cdf;
  int cnt = 0;
  for (int j = 0; j < levels; ++j) {
    const float pmf = j == 0 ? lad.pmf0 : xla_ftz(__fmul_rn(lad.pmf0, cp.push(lad.factor(j))));
    if (!(cdf.push(pmf) < u)) break;
    ++cnt;
  }
  const int ni = static_cast<int>(rintf(nf));
  cnt = min(cnt, ni);
  return p > 0.5f ? ni - cnt : cnt;
}

// xla_math.erfc: 1 - x P(x^2) below 1, else exp(-x^2) / |x| times a
// polynomial in 1 / x^2 (one below 2, one above), 0 past x^2 = 88.72
__device__ float xla_erfc(float x) {
  const uint32_t small_c[7] = {0x38A4B519u, 0xBA51FB80u, 0x3BAA02D9u, 0xBCDBFC87u,
                               0x3DE7167Cu, 0xBEC0939Fu, 0x3F906EBAu};
  const uint32_t lt2_c[9] = {0x3CBE9CF4u, 0xBE0E0868u, 0x3EBCCBD0u, 0xBF151CF8u, 0x3F1EF9E3u,
                             0xBEFD28C0u, 0x3EAE5471u, 0xBE8C5880u, 0x3F1056E6u};
  const uint32_t ge2_c[8] = {0xC127A483u, 0x414FA29Cu, 0xC0EFDB4Au, 0x403AF1FAu,
                             0xBF81F436u, 0x3ED7FC3Eu, 0xBE906C5Du, 0x3F106EB9u};
  const float z = fabsf(x);
  const float x2 = __fmul_rn(x, x);
  if (z < 1.0f) return fma32(-x, xla_horner(x2, small_c), 1.0f);
  const float q = __fdiv_rn(1.0f, x2);
  const float tail = z < 2.0f ? xla_horner(q, lt2_c) : xla_horner(q, ge2_c);
  float large = xla_ftz(__fmul_rn(__fmul_rn(xla_exp(-x2), __fdiv_rn(1.0f, z)), tail));
  if (x2 > f32(0x42B17218u)) large = 0.0f;
  return x < 0.0f ? __fsub_rn(2.0f, large) : large;
}

// distributions.ndtr: jax.scipy.special.ndtr on XLA's erf and erfc
__device__ float xla_ndtr(float x) {
  const float inv_sqrt2 = f32(0x3F3504F3u);
  const float w = __fmul_rn(x, inv_sqrt2);
  const float z = fabsf(w);
  const float y = z < inv_sqrt2 ? __fadd_rn(1.0f, xla_erf(w))
                                : (w > 0.0f ? __fsub_rn(2.0f, xla_erfc(z)) : xla_erfc(z));
  return __fmul_rn(y, 0.5f);
}

// distributions.normal_pdf: exp(-(x^2 + log(2 pi)) / 2)
__device__ __forceinline__ float xla_normal_pdf(float x) {
  return xla_exp(__fmul_rn(fma32(x, x, f32(0x3FEB3F8Eu)), -0.5f));
}

// An explicit cost model's per-click moments in the gate's unit
struct ExplicitMoments {
  float mu, sigma, cmax;
};

// distributions.cost_create_deci_moments: the clipped-normal moments of
// clip(N(sqrt(bid)/4 + 2.2, 1e-10 + sqrt(bid)/6), 0, 4.4) (its
// clipped_normal_moments at low 0, high 4.4) in decicents, with the 1/12
// quantization variance
__device__ ExplicitMoments cost_create_deci_moments(float bid) {
  const float s = sqrtf(bid);
  const float mean = fma32(s, 0.25f, 2.2f);
  const float std = fma32(s, f32(0x3E2AAAABu), 1e-10f);
  const float high = 4.4f;
  const float safe = std < 1e-20f ? 1e-20f : std;
  const float a = __fdiv_rn(__fsub_rn(0.0f, mean), safe);
  const float b = __fdiv_rn(__fsub_rn(high, mean), safe);
  const float fa = xla_ndtr(a), fb = xla_ndtr(b);
  const float pa = xla_normal_pdf(a), pb = xla_normal_pdf(b);
  const float mid = __fsub_rn(fb, fa), dp = __fsub_rn(pa, pb), ss = __fmul_rn(safe, safe);
  const float one_fb = __fsub_rn(1.0f, fb);
  float m1 = xla_ftz(fma32(safe, dp, fma32(mean, mid, fma32(high, one_fb, __fmul_rn(0.0f, fa)))));
  float m2 = fma32(f32(0x419AE148u), one_fb, __fmul_rn(0.0f, fa));  // 4.4 * 4.4 folded
  m2 = fma32(fma32(mean, mean, ss), mid, m2);
  m2 = fma32(__fmul_rn(__fmul_rn(mean, 2.0f), safe), dp, m2);
  m2 = fma32(ss, fma32(a, pa, -__fmul_rn(b, pb)), m2);
  float var = fma32(-m1, m1, m2);
  var = xla_ftz(var < 0.0f ? 0.0f : var);
  if (std <= 0.0f) {
    m1 = mean < 0.0f ? 0.0f : (mean > high ? high : mean);
    var = 0.0f;
  }
  const float h = __fmul_rn(sqrtf(var), 1000.0f);
  return ExplicitMoments{__fmul_rn(m1, 1000.0f), sqrtf(fma32(h, h, f32(0x3DAAAAABu))),
                         4400.0f};
}

// distributions.generic_cost_cent_moments: Abel sums of the normal's tail
// over `grid` cent cells (33 <= grid <= 1024), each sum in XLA's order:
// windows of 32 consecutive terms offset by half the padding to a multiple
// of 32 (the terms are non-negative, so the zero pads add nothing), the
// window sums then summed in order. From the first cell whose edge reaches
// the bid on, every term is 0 (its CDF is 1), and adding 0 changes no sum,
// so the walk stops there.
__device__ ExplicitMoments generic_cost_cent_moments(float bid, int grid) {
  const float s = sqrtf(bid);
  const float mu_r = __fadd_rn(__fmul_rn(s, 0.25f), __fmul_rn(bid, 0.5f));
  const float sig_r = fma32(s, f32(0x3E2AAAABu), 1e-10f);
  const int lo = ((32 - grid % 32) % 32) / 2;
  float mu = 0.0f, m2 = 0.0f, w_mu = 0.0f, w_m2 = 0.0f;
  for (int i = 0; i < grid; ++i) {
    const float fi = static_cast<float>(i);
    const float edge = __fmul_rn(__fadd_rn(fi, 0.5f), 0.01f);
    if (edge >= bid) break;
    float tail = __fsub_rn(1.0f, xla_ndtr(__fdiv_rn(__fsub_rn(edge, mu_r), sig_r)));
    tail = tail < 0.0f ? 0.0f : tail;
    w_mu = __fadd_rn(w_mu, tail);
    w_m2 = __fadd_rn(w_m2, __fmul_rn(fma32(fi, 2.0f, 1.0f), tail));
    if ((i + lo + 1) % 32 == 0) {  // a window ends
      mu = __fadd_rn(mu, w_mu);
      m2 = __fadd_rn(m2, w_m2);
      w_mu = w_m2 = 0.0f;
    }
  }
  mu = __fadd_rn(mu, w_mu);  // the window the walk stopped in
  m2 = __fadd_rn(m2, w_m2);
  float var = fma32(-mu, mu, m2);
  var = var < 0.0f ? 0.0f : var;
  return ExplicitMoments{mu, sqrtf(var), rintf(__fmul_rn(bid, 100.0f))};
}

// distributions.threshold_sigmoid: with c = clip(2 thresh, 0, 1),
// clip((1 + c) sigmoid(slope (bid - intercept)) - c / 2, 0, 1), the
// sigmoid XLA's 1 / (exp(-x) + 1)
__device__ float threshold_sigmoid(float bid, float thresh, float intercept, float slope) {
  float c = __fmul_rn(thresh, 2.0f);
  c = c < 0.0f ? 0.0f : (c > 1.0f ? 1.0f : c);
  const float x = __fmul_rn(slope, __fsub_rn(bid, intercept));
  const float r = xla_ftz(__fdiv_rn(1.0f, __fadd_rn(xla_exp(-x), 1.0f)));
  const float rate = fma32(r, __fadd_rn(c, 1.0f), -__fmul_rn(c, 0.5f));
  return rate < 0.0f ? 0.0f : (rate > 1.0f ? 1.0f : rate);
}

// distributions.cost_create_e: the rust cost_create at e = erf_inv(u) of
// its normal, in dollars
__device__ __forceinline__ float cost_create_e(float e, float bid) {
  const float s = sqrtf(bid);
  const float std = __fmul_rn(fma32(s, f32(0x3E2AAAABu), 1e-10f), f32(0x3FB504F3u));
  const float c = fma32(std, e, fma32(s, 0.25f, 2.2f));
  return c < 0.0f ? 0.0f : (c > 4.4f ? 4.4f : c);
}

// agg_day.explicit_costs: one explicit lane cost in the gate's unit at e =
// erf_inv(u) of its normal: the rust cost_create in decicents (rust) or
// the python generic_cost in cents
__device__ int explicit_cost(bool rust, float e, float bid) {
  if (rust) return static_cast<int>(rintf(__fmul_rn(cost_create_e(e, bid), 1000.0f)));
  const float s = sqrtf(bid);
  const float std = __fmul_rn(fma32(s, f32(0x3E2AAAABu), 1e-10f), f32(0x3FB504F3u));
  float c = fma32(std, e, __fadd_rn(__fmul_rn(s, 0.25f), __fmul_rn(bid, 0.5f)));
  c = c < 0.0f ? 0.0f : c;
  c = c < bid ? c : bid;
  c = __fmul_rn(rintf(__fmul_rn(c, 100.0f)), 0.01f);
  return static_cast<int>(rintf(__fmul_rn(c, 100.0f)));
}

}  // namespace
