// jax.random.binomial for one call of a thread block's elements, as
// adcraft_tpu_torch/distributions.py:binomial computes it (its plain
// version): jax/_src/random.py's _binomial with _binomial_inversion and
// _btrs, and the adcraft wrapper's clip of p, NaN to 0 and clip to [0, n].
//
// The call's elements run both loops in lockstep: a loop continues while
// any element of the call needs it (__syncthreads_or), every pass derives
// its subkeys from the call's key chain (each thread derives the same
// keys), and BTRS keeps an element's draw from the LAST pass in which it
// accepted. Elements with n q <= 10 (q = min(p, 1 - p)) take the inversion
// loop's draw, the others BTRS's; inversion elements stay in BTRS as
// dummies (count 1e4, q 1/2) and BTRS elements in inversion with count 0,
// so each element's draw depends on the others, as in JAX. A loop whose
// draw no element takes is skipped: it changes nothing. Every thread of
// the block must call binomial_call; `in_call` marks the call's elements.
//
// Float operations are the plain version's: __fmul_rn and friends,
// XLA's log and log1p (xla_math.cuh), IEEE sqrtf, and fma32 where XLA
// contracts a product into a sum.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "jax_random.cuh"
#include "xla_math.cuh"

namespace {

// float32 of a double constant, as numpy rounds jnp's weak-typed constants
#define F32(x) static_cast<float>(x)

// jax.random's Stirling remainder: the table for k <= 9, else the series
__device__ float stirling_tail(float k) {
  const float tail[10] = {F32(0.0810614667953272), F32(0.0413406959554092),
                          F32(0.0276779256849983), F32(0.02079067210376509),
                          F32(0.0166446911898211), F32(0.0138761288230707),
                          F32(0.0118967099458917), F32(0.0104112652619720),
                          F32(0.00925546218271273), F32(0.00833056343336287)};
  const bool use_table = k <= 9.0f;
  const float kc = isnan(k) ? k : fminf(fmaxf(k, 0.0f), 9.0f);
  const float kp1 = __fadd_rn(kc, 1.0f);
  const float kp1sq = __fmul_rn(kp1, kp1);
  const float inner = __fdiv_rn(__fsub_rn(F32(1.0 / 360), __fdiv_rn(F32(1.0 / 1260), kp1sq)), kp1sq);
  const float approx = __fdiv_rn(__fsub_rn(F32(1.0 / 12), inner), kp1);
  return use_table ? tail[static_cast<int>(floorf(kc))] : approx;
}

// _binomial_inversion: the geometric-sum walk; one (subkey, key) split a pass
__device__ float binomial_inversion(Key key, bool in_call, float count, float q, uint32_t ctr) {
  const float log1mq = xla_log1p(-q);
  float num_geom = 0.0f, geom_sum = 0.0f;
  while (__syncthreads_or(in_call && geom_sum <= count)) {
    const Key sub = child(key, 0);
    key = child(key, 1);
    if (geom_sum <= count) num_geom = __fadd_rn(num_geom, 1.0f);
    const float u = uniform32(bits32(sub, ctr));
    geom_sum = __fadd_rn(geom_sum, ceilf(__fdiv_rn(xla_log(u), log1mq)));
  }
  return __fsub_rn(num_geom, 1.0f);
}

// _btrs: transformed rejection; one (key, s0, s1) split a pass, last accept wins
__device__ float binomial_btrs(Key key, bool in_call, float count, float q, uint32_t ctr) {
  const float omq = __fsub_rn(1.0f, q);
  const float stddev = sqrtf(__fmul_rn(__fmul_rn(count, q), omq));
  const float b = fma32(stddev, F32(2.53), F32(1.15));
  const float a = fma32(q, F32(0.01), fma32(b, F32(0.0248), F32(-0.0873)));
  const float c = fma32(count, q, 0.5f);
  const float v_r = __fsub_rn(F32(0.92), __fdiv_rn(F32(4.2), b));
  const float r = __fdiv_rn(q, omq);
  const float alpha = __fmul_rn(__fadd_rn(F32(2.83), __fdiv_rn(F32(5.1), b)), stddev);
  const float m = floorf(__fmul_rn(__fadd_rn(count, 1.0f), q));
  const float cm1 = __fadd_rn(__fsub_rn(count, m), 1.0f);  // count - m + 1
  // the bound's first term: loop-invariant, hoisted by XLA and rounded
  const float t1 =
      __fmul_rn(__fadd_rn(m, 0.5f), xla_log(__fdiv_rn(__fadd_rn(m, 1.0f), __fmul_rn(r, cm1))));
  const float s_m = stirling_tail(m);
  const float s_cm = stirling_tail(__fsub_rn(count, m));
  float k_out = -1.0f;
  bool accepted = false;
  while (__syncthreads_or(in_call && !accepted)) {
    const Key s0 = child(key, 1), s1 = child(key, 2);
    key = child(key, 0);
    const float u = __fsub_rn(uniform32(bits32(s0, ctr)), 0.5f);
    const float v = uniform32(bits32(s1, ctr));
    const float us = __fsub_rn(0.5f, fabsf(u));
    const bool accept1 = us >= F32(0.07) && v <= v_r;
    const float k = floorf(fma32(__fadd_rn(__fdiv_rn(__fmul_rn(2.0f, a), us), b), u, c));
    const bool reject = k < 0.0f || k > count;
    const float vl = xla_log(
        __fdiv_rn(__fmul_rn(v, alpha), __fadd_rn(__fdiv_rn(a, __fmul_rn(us, us)), b)));
    const float ck1 = __fadd_rn(__fsub_rn(count, k), 1.0f);  // count - k + 1
    float ub = fma32(__fadd_rn(k, 0.5f), xla_log(__fdiv_rn(__fmul_rn(r, ck1), __fadd_rn(k, 1.0f))),
                     fma32(__fadd_rn(count, 1.0f), xla_log(__fdiv_rn(cm1, ck1)), t1));
    ub = __fadd_rn(ub, s_m);
    ub = __fadd_rn(ub, s_cm);
    ub = __fsub_rn(ub, stirling_tail(k));
    ub = __fsub_rn(ub, stirling_tail(__fsub_rn(count, k)));
    const bool accept = accept1 || (!reject && vl <= ub);
    if (accept) k_out = k;
    accepted = accepted || accept;
  }
  return k_out;
}

// One element's Binomial(n, p) draw of a block-wide call keyed by `key`, at
// counter ctr (the element's index in the call), as int32. Threads outside
// the call pass in_call false (their result is 0) and must still call.
__device__ int binomial_call(Key key, bool in_call, float n, float p) {
  p = isnan(p) ? p : fminf(fmaxf(p, 0.0f), 1.0f);
  const uint32_t ctr = threadIdx.x;
  const bool p_lt_half = p < 0.5f;
  float q = p_lt_half ? p : __fsub_rn(1.0f, p);
  const bool bad_count = isnan(n) || n < 0.0f;
  const bool q_nan = isnan(q), q_neg = q < 0.0f;
  if (q_nan || q_neg) q = F32(0.01);
  const bool use_inversion = bad_count || __fmul_rn(n, q) <= 10.0f;
  const float count = floorf(n);
  const bool any_inversion = __syncthreads_or(in_call && use_inversion);
  const bool any_btrs = __syncthreads_or(in_call && !use_inversion);
  float inv = 0.0f, btrs = 0.0f;
  if (any_inversion) inv = binomial_inversion(key, in_call, use_inversion ? count : 0.0f, q, ctr);
  if (any_btrs) {
    btrs = binomial_btrs(key, in_call, use_inversion ? 1e4f : count, use_inversion ? 0.5f : q,
                         ctr);
  }
  float s = use_inversion ? inv : btrs;
  if (q_neg || q_nan || bad_count) s = __int_as_float(0x7FC00000);
  if (!(p_lt_half || bad_count || q_nan)) s = __fsub_rn(count, s);
  if (isnan(s) || !in_call) s = 0.0f;
  return static_cast<int>(fminf(fmaxf(s, 0.0f), n));
}

#undef F32

}  // namespace
