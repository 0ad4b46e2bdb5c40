// The XLA day step on Hopper (sm_90a): three kernels for the three phases
// of adcraft_tpu/step.py:simulate_day (:991) in the configuration that
// bench.py:47-76 times (aggregate costs, conversion counts, revenue sums,
// inversion binomials, implicit single-competitor keywords). The JAX
// package left these phases to XLA, so no Pallas kernel constrains them:
//
// * agg_cells replaces the sampling phase, _cell_tables' agg
//   implicit-single branch (step.py:858-926) vmapped over sub-timesteps,
//   with the day-hoisted impression ladder (:1263-1282);
// * agg_gate replaces the budget gate (:1295-1391): the sequential rule of
//   _gate_keywords_scan_agg (:740) with _resolve_cell (:1087), to which the
//   lazy, chunked and compacted TPU gates are bit-identical;
// * agg_outcomes replaces the post-gate phase (:1392-1500): conversion
//   counts, revenue sums, cell_out's masks and the day sums.
//
// The plain PyTorch versions are adcraft_tpu_torch/agg_day.py:
// agg_cells_reference, agg_gate_reference, agg_outcomes_reference. Every
// float operation here is the one that version's tensor ops perform on the
// card, spelled so that nvcc cannot contract or reorder it: __fmul_rn,
// __fadd_rn, __fdiv_rn, IEEE sqrtf, rintf, the same expf, logf, log1pf and
// powf that PyTorch's CUDA kernels call, and fused multiply-adds (XLA's
// contractions, which the plain version writes in float64) as a float64
// product and sum rounded to float32. So the kernels equal it exactly.
//
// Keys follow jax.random's tree (threefry.cuh): per env and sub-timestep
// kt = fold_in(k_cells, t); k_auc, k_click, k_conv, k_rev = split(kt, 4);
// k_imp, k_cost = split(k_auc); k_sfull, k_lanes = split(k_cost); k_lite,
// k_rest = split(k_lanes); a deep lane column's key is fold_in(k_rest, k).
// A (K,) draw takes the word at counter k, the (L, K) lite table lane l's
// at l * K + k, a deep column lane i's at i.
//
// What bounds them: threefry words (integer ALU) and, far behind, the
// per-cell tables written and read once (about 16 bytes a cell between
// agg_cells and agg_gate, 12 between agg_gate and agg_outcomes). The
// design is the simplest that keeps the sequential part on one warp:
// agg_cells and agg_outcomes run one block per env and a thread per
// keyword over the sub-timesteps, with each sub-timestep's keys derived
// once per block into shared memory; agg_gate runs one warp per env and
// decides cells 32 at a time: a warp scan of the aggregate spends finds the
// run of full cells that break nothing (those before the first whose
// prefix reaches the budget), a ballot the run of cells that accept nothing
// (not full, and a first lite lane above the budget: the budget-decay tail
// of a day), and only a cell that accepts part of its clicks is
// lane-resolved, by the warp's lanes in parallel with a ballot for the
// first over-budget prefix.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kGateWarps = kThreads / 32;

// rows of the (kNumParams, E, K) parameter tensor (agg_day.py)
enum { BID, BCTR, SCTR, LOC, SCALE, REV_MEAN, REV_STD, kNumParams };

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

// a * b + c rounded once, as the plain version's float64 (a * b + c)
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                                     static_cast<double>(c)));
}

// prng.erfinv: XLA's float32 polynomial without contraction
__device__ float erfinv(float x) {
  const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
                        0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f,
                        1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
                        0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f,
                        2.83297682f};
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fadd_rn(lt ? lt5[i] : ge5[i], __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
}

// prng.normal: sqrt(2) erfinv(u), u uniform on [nextafter(-1, 0), 1)
__device__ __forceinline__ float normal(Key k, uint32_t counter) {
  const float lo = __int_as_float(0xBF7FFFFF);
  const float span = __fsub_rn(1.0f, lo);
  const float u = fmaxf(__fadd_rn(__fmul_rn(uniform32(bits32(k, counter)), span), lo), lo);
  return __fmul_rn(1.41421354f, erfinv(u));
}

__device__ __forceinline__ float laplace_cdf(float x, float loc, float scale) {
  const float z = __fdiv_rn(__fsub_rn(x, loc), scale);
  return z < 0.0f ? __fmul_rn(0.5f, expf(z)) : __fsub_rn(1.0f, __fmul_rn(0.5f, expf(-z)));
}

__device__ __forceinline__ float laplace_icdf(float u, float loc, float scale) {
  const float lo = logf(fmaxf(__fmul_rn(2.0f, u), 1e-38f));
  const float hi = -logf(fmaxf(__fmul_rn(2.0f, __fsub_rn(1.0f, u)), 1e-38f));
  return fma32(scale, u < 0.5f ? lo : hi, loc);
}

// one lane cost in cents: round(|Laplace truncated to [-y0, y0]| * 100)
__device__ __forceinline__ int lane_cost(float u, float loc, float scale, float f_lo, float f_hi) {
  const float x = laplace_icdf(fma32(u, __fsub_rn(f_hi, f_lo), f_lo), loc, scale);
  return static_cast<int>(rintf(__fmul_rn(fabsf(x), 100.0f)));
}

// distributions.binomial_inv_u: the inverse-CDF walk over nmax levels
__device__ int binomial_walk(float u, int n, float p, int nmax) {
  const float nf = static_cast<float>(n);
  p = fminf(fmaxf(p, 0.0f), 1.0f);
  const bool flip = p > 0.5f;
  const float q = flip ? __fsub_rn(1.0f, p) : p;
  const float r = __fdiv_rn(q, __fsub_rn(1.0f, q));
  float pmf = powf(__fsub_rn(1.0f, q), nf);
  float cdf = pmf;
  int cnt = 0;
  // the CDF never falls, so the count stops at its first level >= u
  for (int j = 1; j <= nmax && cdf < u; ++j) {
    ++cnt;
    if (j == nmax) break;
    const float f = __fmul_rn(__fsub_rn(nf, static_cast<float>(j - 1)),
                              __fmul_rn(r, __fdiv_rn(1.0f, static_cast<float>(j))));
    pmf = fmaxf(__fmul_rn(pmf, f), 0.0f);
    cdf = __fadd_rn(cdf, pmf);
  }
  cnt = min(max(cnt, 0), n);
  return flip ? n - cnt : cnt;
}

// distributions.agg_cost_cents_z and rev_sum_cents_z
__device__ __forceinline__ int agg_cost(int n, float mu, float sigma, float cmax, float z) {
  const float nf = static_cast<float>(n);
  const float s = rintf(fma32(nf, mu, __fmul_rn(__fmul_rn(sqrtf(nf), sigma), z)));
  return static_cast<int>(fminf(fmaxf(s, 0.0f), __fmul_rn(nf, cmax)));
}

__device__ __forceinline__ int rev_sum(int n, float mean_c, float std_c, float rev_std, float z) {
  const float nf = static_cast<float>(n);
  const float clt = rintf(fma32(nf, mean_c, __fmul_rn(__fmul_rn(sqrtf(nf), std_c), z)));
  const float exact = __fmul_rn(nf, rintf(mean_c));
  const float cents = fmaxf(rev_std <= 0.0f ? exact : clt, nf);
  return n > 0 ? static_cast<int>(cents) : 0;
}

// ---- the day's constants, as agg_day.cell_constants and
// distributions.rev_sum_moments compute them ----

// distributions.single_cost_cent_moments_closed, operation for operation
struct CostMoments {
  float mu, sigma, cmax;
};

struct Geo {
  float c, em1, e_c;
  __device__ float geo0(float n) const { return __fdiv_rn(-expm1f(__fmul_rn(-n, c)), em1); }
  __device__ float geo1(float n) const {
    const float x = __fadd_rn(
        __fsub_rn(1.0f, __fmul_rn(n, expf(__fmul_rn(-__fsub_rn(n, 1.0f), c)))),
        __fmul_rn(__fsub_rn(n, 1.0f), expf(__fmul_rn(-n, c))));
    return __fdiv_rn(__fmul_rn(e_c, x), __fmul_rn(em1, em1));
  }
};

__device__ __forceinline__ float safe_exp(float x) { return expf(fminf(x, 0.0f)); }

__device__ CostMoments cost_moments(float bid, float loc, float scale) {
  const float a = fabsf(loc);
  const float s = fmaxf(scale, 1e-12f);
  const float y0 = fmaxf(__fsub_rn(bid, 0.005f), 0.0f);
  Geo g;
  g.c = __fdiv_rn(1.0f, __fmul_rn(100.0f, s));
  const float bc = rintf(__fmul_rn(bid, 100.0f));
  const float big_i = fmaxf(__fsub_rn(bc, 1.0f), 0.0f);
  const float m = fminf(fmaxf(ceilf(__fsub_rn(__fmul_rn(100.0f, a), 0.5f)), 0.0f), big_i);
  g.em1 = -expm1f(-g.c);
  g.e_c = expf(-g.c);
  const float geo0_i = g.geo0(big_i), geo1_i = g.geo1(big_i);

  const float e_ay = safe_exp(__fdiv_rn(-__fsub_rn(a, y0), s));
  const float b_fac = safe_exp(__fdiv_rn(-__fadd_rn(a, 0.005f), s));
  const float b_cut = safe_exp(__fdiv_rn(-__fadd_rn(a, y0), s));
  const float half_ii = __fmul_rn(__fmul_rn(0.5f, big_i), __fsub_rn(big_i, 1.0f));
  const float sum_b = __fmul_rn(0.5f, __fsub_rn(__fmul_rn(b_fac, geo0_i), __fmul_rn(big_i, b_cut)));
  const float sum_ib =
      __fmul_rn(0.5f, __fsub_rn(__fmul_rn(b_fac, geo1_i), __fmul_rn(half_ii, b_cut)));

  // r2(n): t2 = safe_exp(-(100 a - n + 0.5) c); (t2 geo0(n), t2 ((n - 1) geo0(n) - geo1(n)))
  const float a100 = __fmul_rn(100.0f, a);
  const float t2_i = safe_exp(__fmul_rn(-__fadd_rn(__fsub_rn(a100, big_i), 0.5f), g.c));
  const float r2_i = __fmul_rn(t2_i, geo0_i);
  const float r2w_i = __fmul_rn(
      t2_i, __fsub_rn(__fmul_rn(__fsub_rn(big_i, 1.0f), geo0_i), geo1_i));
  const float sum_a_low = __fmul_rn(0.5f, __fsub_rn(__fmul_rn(big_i, e_ay), r2_i));
  const float sum_ia_low = __fmul_rn(0.5f, __fsub_rn(__fmul_rn(half_ii, e_ay), r2w_i));

  const float e_ya = safe_exp(__fdiv_rn(-__fsub_rn(y0, a), s));
  const float geo0_m = g.geo0(m), geo1_m = g.geo1(m);
  const float t2_m = safe_exp(__fmul_rn(-__fadd_rn(__fsub_rn(a100, m), 0.5f), g.c));
  const float r2_m = __fmul_rn(t2_m, geo0_m);
  const float r2w_m = __fmul_rn(t2_m, __fsub_rn(__fmul_rn(__fsub_rn(m, 1.0f), geo0_m), geo1_m));
  const float keep = __fsub_rn(1.0f, __fmul_rn(0.5f, e_ya));
  const float sum_a_pre = __fsub_rn(__fmul_rn(m, keep), __fmul_rn(0.5f, r2_m));
  const float sum_ia_pre = __fsub_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(0.5f, m), __fsub_rn(m, 1.0f)), keep), __fmul_rn(0.5f, r2w_m));
  const float n_top = __fsub_rn(big_i, m);
  const float t3 = expf(fminf(__fmul_rn(-__fsub_rn(__fadd_rn(m, 0.5f), a100), g.c), 30.0f));
  const float s3 = __fmul_rn(t3, g.geo0(n_top));
  const float s3w = __fadd_rn(__fmul_rn(t3, g.geo1(n_top)), __fmul_rn(m, s3));
  const float sum_a_top = __fmul_rn(0.5f, __fsub_rn(s3, __fmul_rn(n_top, e_ya)));
  const float sum_i_top =
      __fmul_rn(__fmul_rn(0.5f, __fadd_rn(__fsub_rn(big_i, 1.0f), m)), n_top);
  const float sum_ia_top =
      __fsub_rn(__fmul_rn(0.5f, s3w), __fmul_rn(__fmul_rn(0.5f, sum_i_top), e_ya));

  const bool low = y0 <= a;
  const float sum_a = low ? sum_a_low : __fadd_rn(sum_a_pre, sum_a_top);
  const float sum_ia = low ? sum_ia_low : __fadd_rn(sum_ia_pre, sum_ia_top);
  const float z = __fsub_rn(laplace_cdf(y0, a, s), laplace_cdf(-y0, a, s));
  const float zsafe = fmaxf(z, 1e-12f);
  const float tail0 = fmaxf(__fadd_rn(sum_a, sum_b), 0.0f);
  const float tail1 = fmaxf(__fadd_rn(sum_ia, sum_ib), 0.0f);
  const float mu = __fdiv_rn(tail0, zsafe);
  const float m2 = __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, tail1), tail0), zsafe);
  const float var = fmaxf(__fsub_rn(m2, __fmul_rn(mu, mu)), 0.0f);
  return CostMoments{mu, sqrtf(var), fmaxf(__fsub_rn(bc, 1.0f), 0.0f)};
}

// the t >= 1 impression ladder of distributions.binomial_cdf: level j's
// factor, and the count of levels below u (the ladder never falls)
struct Ladder {
  float nf, r, pmf0;
  int nmax;
  __device__ float factor(int j) const {
    const float recip = __double2float_rn(__ddiv_rn(1.0, static_cast<double>(j)));
    return fmaxf(__fmul_rn(__fmul_rn(__fsub_rn(nf, static_cast<float>(j - 1)), recip), r), 0.0f);
  }
  __device__ int count(float u) const {
    float cp = 1.0f, cdf = pmf0;
    int cnt = 0;
    for (int j = 1; j <= nmax && cdf < u; ++j) {
      ++cnt;
      if (j == nmax) break;
      cp = __fmul_rn(cp, factor(j));
      cdf = __fadd_rn(cdf, __fmul_rn(pmf0, cp));
    }
    return cnt;
  }
};

__device__ Ladder make_ladder(int n, float p, int nmax) {
  p = fminf(fmaxf(p, 0.0f), 1.0f);
  const float q = p > 0.5f ? __fsub_rn(1.0f, p) : p;
  const float nf = static_cast<float>(n);
  return Ladder{nf, __fdiv_rn(q, __fsub_rn(1.0f, q)), powf(__fsub_rn(1.0f, q), nf), nmax};
}

// jax.scipy.special.ndtr's branches (distributions._ndtr)
__device__ __forceinline__ float ndtr(float x) {
  const float inv_sqrt2 = 0.70710677f;
  const float w = __fmul_rn(x, inv_sqrt2);
  const float z = fabsf(w);
  const float y = z < inv_sqrt2 ? __fadd_rn(1.0f, erff(w))
                                : (w > 0.0f ? __fsub_rn(2.0f, erfcf(z)) : erfcf(z));
  return __fmul_rn(0.5f, y);
}

// distributions.rev_sum_moments: (100 m1, sqrt((100 s1)^2 + 1/12)) of the
// censored normal max(N(mean, std), 0.01)
__device__ float2 rev_moments(float mean, float std) {
  const float low = 0.01f;
  const float safe = fmaxf(std, 1e-20f);
  const float a = __fdiv_rn(__fsub_rn(low, mean), safe);
  const float big_f = ndtr(a);
  const float small_f =
      expf(__fsub_rn(__fmul_rn(-0.5f, __fmul_rn(a, a)), 0.918938518f));
  const float one_f = __fsub_rn(1.0f, big_f);
  float m1 = __fadd_rn(__fadd_rn(__fmul_rn(low, big_f), __fmul_rn(mean, one_f)),
                       __fmul_rn(safe, small_f));
  const float m2 = __fadd_rn(
      __fadd_rn(__fmul_rn(1e-4f, big_f),
                __fmul_rn(__fadd_rn(__fmul_rn(mean, mean), __fmul_rn(safe, safe)), one_f)),
      __fmul_rn(__fmul_rn(safe, __fadd_rn(mean, low)), small_f));
  float var = fmaxf(__fsub_rn(m2, __fmul_rn(m1, m1)), 0.0f);
  if (std <= 0.0f) {
    m1 = fmaxf(mean, low);
    var = 0.0f;
  }
  const float h = __fmul_rn(100.0f, sqrtf(var));
  return make_float2(__fmul_rn(100.0f, m1),
                     sqrtf(fma32(h, h, static_cast<float>(1.0 / 12.0))));
}

// ---- agg_cells: one block per env, a thread per keyword, t in a loop ----
// shared: per sub-timestep the keys k_imp, k_click, k_sfull, k_lite
__global__ void __launch_bounds__(kThreads)
    agg_cells_kernel(const float* __restrict__ params, const int* __restrict__ n_auc01,
                     const long long* __restrict__ keys, long long key_stride,
                     int* __restrict__ imp_out, int* __restrict__ ncl_out,
                     int* __restrict__ sfull_out, int* __restrict__ lite_out,
                     float* __restrict__ consts_out, int E, int K, int T, int m0, int m1, int L,
                     int bits) {
  extern __shared__ Key tkeys[];  // [T][4]
  const int e = blockIdx.x;
  const Key kc = load_key(keys, key_stride, e);
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const Key kt = child(kc, t);
    const Key k_auc = child(kt, 0);
    const Key k_cost = child(k_auc, 1);
    tkeys[4 * t + 0] = child(k_auc, 0);             // k_imp
    tkeys[4 * t + 1] = child(kt, 1);                // k_click
    tkeys[4 * t + 2] = child(k_cost, 0);            // k_sfull
    tkeys[4 * t + 3] = child(child(k_cost, 1), 0);  // k_lite
  }
  __syncthreads();
  const long long EK = static_cast<long long>(E) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const long long ek = static_cast<long long>(e) * K + k;
    const float bid = params[BID * EK + ek], bctr = params[BCTR * EK + ek];
    const float loc = params[LOC * EK + ek], scale = params[SCALE * EK + ek];
    const int n0 = n_auc01[ek], n1 = n_auc01[EK + ek];
    // the day's constants of this (env, keyword)
    const float y0 = __fsub_rn(bid, 0.005f);
    const float f_lo = laplace_cdf(-y0, loc, scale), f_hi = laplace_cdf(y0, loc, scale);
    const float p_win = fminf(fmaxf(__fsub_rn(f_hi, f_lo), 0.0f), 1.0f);
    const CostMoments cm = cost_moments(bid, loc, scale);
    const Ladder ladder = make_ladder(n1, p_win, m1);
    const bool flip1 = p_win > 0.5f;
    if (consts_out != nullptr) {
      consts_out[ek] = p_win;
      consts_out[EK + ek] = cm.mu;
      consts_out[2 * EK + ek] = cm.sigma;
      consts_out[3 * EK + ek] = cm.cmax;
      float cp = 1.0f, cdf = ladder.pmf0;
      for (int j = 0; j < m1; ++j) {
        if (j > 0) {
          cp = __fmul_rn(cp, ladder.factor(j));
          cdf = __fadd_rn(cdf, __fmul_rn(ladder.pmf0, cp));
        }
        consts_out[(4 + j) * EK + ek] = cdf;
      }
    }
    for (int t = 0; t < T; ++t) {
      const int m = t == 0 ? m0 : m1;
      const float u_imp = lane_uniform(tkeys[4 * t], k, bits);
      int imp;
      if (t == 0) {
        imp = binomial_walk(u_imp, n0, p_win, m0);
      } else {
        const int cnt = min(ladder.count(u_imp), n1);
        imp = flip1 ? n1 - cnt : cnt;
      }
      const int ncl = binomial_walk(lane_uniform(tkeys[4 * t + 1], k, bits), imp, bctr, m);
      const int s = agg_cost(ncl, cm.mu, cm.sigma, cm.cmax, normal(tkeys[4 * t + 2], k));
      const long long cell = (static_cast<long long>(e) * T + t) * K + k;
      imp_out[cell] = imp;
      ncl_out[cell] = ncl;
      sfull_out[cell] = s;
      for (int l = 0; l < L; ++l) {
        const float u = lane_uniform(tkeys[4 * t + 3], static_cast<uint32_t>(l * K + k), bits);
        lite_out[((static_cast<long long>(e) * T + t) * L + l) * K + k] =
            lane_cost(u, loc, scale, f_lo, f_hi);
      }
    }
  }
}

__device__ __forceinline__ long long warp_inclusive_sum(long long v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// _resolve_cell on one warp: lanes < L from the lite table, the rest drawn
// from fold_in(k_rest, k), whose key and truncation bounds are derived only
// if a deep lane is reached; the first prefix over B (or lane n) stops it.
// Returns the accepted clicks, and their spend in *spend (warp-uniform).
__device__ int resolve_cell(const float* __restrict__ params, const int* __restrict__ lite,
                            Key k_rest, int e, int t, int k, int n, long long B, int m, int E,
                            int K, int T, int L, int bits, int lane, long long* spend) {
  const long long EK = static_cast<long long>(E) * K;
  const long long ek = static_cast<long long>(e) * K + k;
  bool have_deep = false;
  Key k_col{0u, 0u};
  float loc = 0.0f, scale = 1.0f, f_lo = 0.0f, f_hi = 0.0f;
  long long carry = 0;
  int accepted = 0;
  for (int base = 0; base < m; base += 32) {
    if (!have_deep && n > L && base + 31 >= L) {
      loc = params[LOC * EK + ek];
      scale = params[SCALE * EK + ek];
      const float y0 = __fsub_rn(params[BID * EK + ek], 0.005f);
      f_lo = laplace_cdf(-y0, loc, scale);
      f_hi = laplace_cdf(y0, loc, scale);
      k_col = child(k_rest, static_cast<uint32_t>(k));
      have_deep = true;
    }
    const int idx = base + lane;
    const bool in = idx < n;
    long long c = 0;
    if (in) {
      c = idx < L ? lite[((static_cast<long long>(e) * T + t) * L + idx) * K + k]
                  : lane_cost(lane_uniform(k_col, static_cast<uint32_t>(idx - L), bits), loc,
                              scale, f_lo, f_hi);
    }
    const long long incl = warp_inclusive_sum(c, lane) + carry;
    const unsigned bad = __ballot_sync(kFull, !(in && incl <= B));
    if (bad == 0) {
      carry = __shfl_sync(kFull, incl, 31);
      accepted += 32;
      continue;
    }
    const int f = __ffs(bad) - 1;
    const long long before = __shfl_sync(kFull, incl, f > 0 ? f - 1 : 0);
    if (f > 0) carry = before;
    accepted += f;
    break;
  }
  *spend = carry;
  return accepted;
}

// ---- agg_gate: one warp per env walks its T*K cells in (t, k) order ----
__global__ void __launch_bounds__(kThreads)
    agg_gate_kernel(const float* __restrict__ params, const long long* __restrict__ keys,
                    long long key_stride, const int* __restrict__ s_full,
                    const int* __restrict__ n_clicks, const int* __restrict__ lite,
                    const int* __restrict__ budget_c, int* __restrict__ acc_out,
                    int* __restrict__ spend_out, int* __restrict__ n_sim, int E, int K, int T,
                    int m0, int m1, int L, int bits) {
  const int e = blockIdx.x * kGateWarps + threadIdx.x / 32;
  if (e >= E) return;
  const int lane = threadIdx.x & 31;
  long long B = budget_c[e];
  bool broken = false;
  int nsim = T * K;
  for (int t = 0; t < T; ++t) {
    const int m = t == 0 ? m0 : m1;
    const long long row = (static_cast<long long>(e) * T + t) * K;
    bool have_rest = false;
    Key k_rest{0u, 0u};
    for (int kb = 0; kb < K; kb += 32) {
      const int k = kb + lane;
      const bool valid = k < K;
      int my_acc = 0, my_spend = 0;
      if (!broken) {
        const long long s = valid ? s_full[row + k] : 0;
        const int n = valid ? n_clicks[row + k] : 0;
        const int c0 = valid ? lite[(static_cast<long long>(e) * T + t) * L * K + k] : 0;
        int start = 0;
        while (start < 32) {
          // a run of full cells: those before the first whose aggregate
          // spend, summed from `start`, reaches the budget
          const long long incl = warp_inclusive_sum(lane >= start ? s : 0, lane);
          const unsigned stop = __ballot_sync(kFull, valid && lane >= start && incl >= B);
          const int j = stop ? __ffs(stop) - 1 : 32;
          if (valid && lane >= start && lane < j) {
            my_acc = n;
            my_spend = static_cast<int>(s);
          }
          if (j == 32) {
            B -= __shfl_sync(kFull, incl, 31);
            break;
          }
          const long long s_j = __shfl_sync(kFull, s, j);
          B -= __shfl_sync(kFull, incl, j) - s_j;
          if (s_j <= B) {  // full, and it leaves the budget at exactly 0
            if (lane == j) {
              my_acc = n;
              my_spend = static_cast<int>(s);
            }
            B -= s_j;
          } else {
            // a run of cells that accept nothing at B > 0: not full, and no
            // click or a first lite lane above B; the budget stays, and so
            // does the day (at B <= 0, only the first cell of a day, that
            // cell breaks it)
            const unsigned from_j = ~((1u << j) - 1u);
            const unsigned zero = __ballot_sync(
                kFull, !valid || (B > 0 && s > B && (n == 0 || c0 > B)));
            const unsigned rest = ~zero & from_j;
            if (rest == 0) break;
            const int z = __ffs(rest) - 1;
            if (z > j) {
              start = z;
              continue;
            }
            if (!have_rest) {
              const Key kt = child(load_key(keys, key_stride, e), t);
              k_rest = child(child(child(child(kt, 0), 1), 1), 1);
              have_rest = true;
            }
            long long sp_j;
            const int p_j = resolve_cell(params, lite, k_rest, e, t, kb + j,
                                         __shfl_sync(kFull, n, j), B, m, E, K, T, L, bits, lane,
                                         &sp_j);
            if (lane == j) {
              my_acc = p_j;
              my_spend = static_cast<int>(sp_j);
            }
            B -= sp_j;
          }
          start = j + 1;
          if (B <= 0) {
            broken = true;
            nsim = t * K + kb + j + 1;
            break;
          }
        }
      }
      if (valid) {
        acc_out[row + k] = my_acc;
        spend_out[row + k] = my_spend;
      }
    }
  }
  if (lane == 0) n_sim[e] = nsim;
}

// ---- agg_outcomes: one block per env, a thread per keyword, t in a loop ----
// shared: per sub-timestep the keys k_conv, k_rev
__global__ void __launch_bounds__(kThreads)
    agg_outcomes_kernel(const float* __restrict__ params, const long long* __restrict__ keys,
                        long long key_stride, const int* __restrict__ imp,
                        const int* __restrict__ acc, const int* __restrict__ spend,
                        const int* __restrict__ n_sim, const int* __restrict__ n_auc01,
                        int* __restrict__ out, int E, int K, int T, int m0, int m1, int bits) {
  extern __shared__ Key tkeys[];  // [T][2]
  const int e = blockIdx.x;
  const Key kc = load_key(keys, key_stride, e);
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const Key kt = child(kc, t);
    tkeys[2 * t] = child(kt, 2);      // k_conv
    tkeys[2 * t + 1] = child(kt, 3);  // k_rev
  }
  __syncthreads();
  const long long EK = static_cast<long long>(E) * K;
  const int nsim = n_sim[e];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const long long ek = static_cast<long long>(e) * K + k;
    const float sctr = params[SCTR * EK + ek], rev_std = params[REV_STD * EK + ek];
    const float2 moments = rev_moments(params[REV_MEAN * EK + ek], rev_std);
    const float mean_c = moments.x, std_c = moments.y;
    const int n0 = n_auc01[ek], n1 = n_auc01[EK + ek];
    int s_imp = 0, s_clicks = 0, s_cost = 0, s_conv = 0, s_rev = 0, s_elig = 0;
    for (int t = 0; t < T && t * K + k < nsim; ++t) {
      const long long cell = (static_cast<long long>(e) * T + t) * K + k;
      const int a = acc[cell];
      // a walk over zero trials counts zero, and no conversion earns nothing
      const int nconv =
          a > 0 ? binomial_walk(lane_uniform(tkeys[2 * t], k, bits), a, sctr, t == 0 ? m0 : m1)
                : 0;
      const int rev = nconv > 0 ? rev_sum(nconv, mean_c, std_c, rev_std, normal(tkeys[2 * t + 1], k))
                                : 0;
      const int im = imp[cell];
      s_imp += im;
      s_clicks += a;
      s_cost += spend[cell];
      s_conv += nconv;
      s_rev += rev;
      s_elig += im >= 1 ? (t == 0 ? n0 : n1) : 0;
    }
    out[ek] = s_imp;
    out[EK + ek] = s_clicks;
    out[2 * EK + ek] = s_cost;
    out[3 * EK + ek] = s_conv;
    out[4 * EK + ek] = s_rev;
    out[5 * EK + ek] = s_elig;
  }
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` of `device` and returns cudaGetLastError()
// right after the launch (the library's runtime has its own current device).

// consts_out, if not null, receives the (4 + m1, E, K) constants the day
// used: p_win, cost mu, sigma, cmax, then the ladder's m1 levels
int agg_cells_launch(const float* params, const int* n_auc01, const long long* keys,
                     long long key_stride, int* imp, int* ncl, int* s_full, int* lite,
                     float* consts_out, int E, int K, int T, int m0, int m1, int L, int bits,
                     int device, void* stream) {
  if (E <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(T) * 4 * sizeof(Key);
  agg_cells_kernel<<<E, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, n_auc01, keys, key_stride, imp, ncl, s_full, lite, consts_out, E, K, T, m0, m1,
      L, bits);
  return static_cast<int>(cudaGetLastError());
}

int agg_gate_launch(const float* params, const long long* keys, long long key_stride,
                    const int* s_full, const int* n_clicks, const int* lite, const int* budget_c,
                    int* acc, int* spend, int* n_sim, int E, int K, int T, int m0, int m1, int L,
                    int bits, int device, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (E + kGateWarps - 1) / kGateWarps;
  agg_gate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, keys, key_stride, s_full, n_clicks, lite, budget_c, acc, spend, n_sim, E, K, T, m0,
      m1, L, bits);
  return static_cast<int>(cudaGetLastError());
}

int agg_outcomes_launch(const float* params, const long long* keys, long long key_stride,
                        const int* imp, const int* acc, const int* spend, const int* n_sim,
                        const int* n_auc01, int* out, int E, int K, int T, int m0, int m1,
                        int bits, int device, void* stream) {
  if (E <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(T) * 2 * sizeof(Key);
  agg_outcomes_kernel<<<E, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, keys, key_stride, imp, acc, spend, n_sim, n_auc01, out, E, K, T, m0, m1, bits);
  return static_cast<int>(cudaGetLastError());
}

const char* agg_day_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
