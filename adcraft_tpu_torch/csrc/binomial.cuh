// jax.random.binomial for one call of K elements on one warp, as
// adcraft_tpu_torch/distributions.py:binomial computes it (its plain
// version): jax/_src/random.py's _binomial with _binomial_inversion and
// _btrs, and the adcraft wrapper's clip of p, NaN to 0 and clip to [0, n].
//
// Layout: element k of a call is slot r = (k mod 32 R) / 32 of lane k mod
// 32 in group k / (32 R); R is a template parameter (1 to 4). A call of K
// <= 32 R elements is one group.
//
// The call's elements run both loops in lockstep: a loop continues while
// any element of the call needs it (__any_sync), each pass derives its
// subkeys once for the warp from the call's key chain (the keys are the
// same for every element), and BTRS keeps an element's draw from the LAST
// pass in which it accepted. Elements with n q <= 10 (q = min(p, 1 - p))
// take the inversion loop's draw, the others BTRS's; inversion elements
// stay in BTRS as dummies (count 1e4, q 1/2) and BTRS elements in
// inversion with count 0, so each element's BTRS draw depends on the
// others, as in JAX. A loop whose draw no element takes is skipped: it
// changes nothing.
//
// An inversion element's draw depends on its own words alone: once its
// geometric sum passes its count it stops counting, and the sum never
// falls. So an element that is done draws no more: the loop keeps the live
// elements packed in the warp's shared memory and draws ceil(live / 32)
// slots a pass; and the groups of a call of more than 32 R elements run
// their inversion loops apart. BTRS skips nothing: an accepted element may
// accept again. Its pass count is the call's, so a call of several groups
// first runs each group's BTRS loop to find the largest pass count P, then
// runs every group for exactly P passes.
//
// What bounds it: the warp's issue of a long per-slot chain (a threefry
// word, XLA's log with its fused multiply-adds, a division), and,
// we infer, the kernel's instruction cache: a version whose slots were
// unrolled into registers, with the loops inlined once per call and per
// phase, ran 2.3 times slower than a block per call. So both loops keep
// their per-slot state in shared memory and run one slot at a time, and
// each loop appears once in the code.
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

constexpr unsigned kWarpAll = 0xFFFFFFFFu;

// float32 of a double constant, as numpy rounds jnp's weak-typed constants
#define F32(x) static_cast<float>(x)

// jax.random's Stirling remainder: the table for k <= 9 (selected by
// value, so no table sits in local memory), else the series at the clamped k
__device__ __forceinline__ float stirling_tail(float k) {
  const bool use_table = k <= 9.0f;
  const float kc = isnan(k) ? k : fminf(fmaxf(k, 0.0f), 9.0f);
  if (use_table) {
    const int i = static_cast<int>(floorf(kc));
    float v = F32(0.0810614667953272);
    v = i == 1 ? F32(0.0413406959554092) : v;
    v = i == 2 ? F32(0.0276779256849983) : v;
    v = i == 3 ? F32(0.02079067210376509) : v;
    v = i == 4 ? F32(0.0166446911898211) : v;
    v = i == 5 ? F32(0.0138761288230707) : v;
    v = i == 6 ? F32(0.0118967099458917) : v;
    v = i == 7 ? F32(0.0104112652619720) : v;
    v = i == 8 ? F32(0.00925546218271273) : v;
    v = i == 9 ? F32(0.00833056343336287) : v;
    return v;
  }
  const float kp1 = __fadd_rn(kc, 1.0f);
  const float kp1sq = __fmul_rn(kp1, kp1);
  const float inner = __fdiv_rn(__fsub_rn(F32(1.0 / 360), __fdiv_rn(F32(1.0 / 1260), kp1sq)), kp1sq);
  return __fdiv_rn(__fsub_rn(F32(1.0 / 12), inner), kp1);
}

// One element of a call: its count, q, which loop's draw it takes and how
// the draw is finished (NaN out, flipped to count - draw)
struct BinomialElem {
  float n, count, q;
  bool in_call, use_inversion, nan_out, flip;
};

__device__ __forceinline__ BinomialElem binomial_elem(float n, float p, bool in_call) {
  p = isnan(p) ? p : fminf(fmaxf(p, 0.0f), 1.0f);
  const bool p_lt_half = p < 0.5f;
  float q = p_lt_half ? p : __fsub_rn(1.0f, p);
  const bool bad_count = isnan(n) || n < 0.0f;
  const bool q_nan = isnan(q), q_neg = q < 0.0f;
  if (q_nan || q_neg) q = F32(0.01);
  BinomialElem el;
  el.n = n;
  el.count = floorf(n);
  el.q = q;
  el.in_call = in_call;
  el.use_inversion = bad_count || __fmul_rn(n, q) <= 10.0f;
  el.nan_out = q_neg || q_nan || bad_count;
  el.flip = !(p_lt_half || bad_count || q_nan);
  return el;
}

__device__ __forceinline__ int binomial_finish(const BinomialElem& el, float inv, float btrs) {
  float s = el.use_inversion ? inv : btrs;
  if (el.nan_out) s = __int_as_float(0x7FC00000);
  if (el.flip) s = __fsub_rn(el.count, s);
  if (isnan(s) || !el.in_call) s = 0.0f;
  return static_cast<int>(fminf(fmaxf(s, 0.0f), el.n));
}

// Passes a call ran in each loop (0 where it skipped the loop), and, in a
// build with -DLANES_STAGE_CLOCKS, lane 0's SM clocks in each
struct BinomialPasses {
  int inversion = 0, btrs = 0;
  unsigned long long inversion_clocks = 0, btrs_clocks = 0;
};

__device__ __forceinline__ unsigned long long stage_clock() {
#ifdef LANES_STAGE_CLOCKS
  return clock64();
#else
  return 0;
#endif
}

// The inversion loop's state in a warp's shared memory: field f of the
// element at position j (slot j / 32, lane j % 32) at f R 32 + j; kInOut is
// indexed by an element's home position, r 32 + its lane.
enum { kInCount, kInLog1mq, kInNum, kInSum, kInCtr, kInHome, kInLive, kInOut, kInFields };

// _binomial_inversion over one group's slots: the geometric-sum walk, one
// (subkey, key) split a pass. The live elements are kept packed at the
// first positions of `state`, so that a pass draws ceil(live / 32) slots
// one at a time; an element that is done leaves its draw at its home
// position and the others move down (in place: no element moves up).
// Returns the passes run (warp-uniform).
template <int R>
__device__ int binomial_inversion(Key key, const BinomialElem (&el)[R], const uint32_t (&ctr)[R],
                                  float (&out)[R], float* state) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const auto at = [&](int f, int j) -> float& { return state[f * R * 32 + j]; };
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * 32 + lane;
    at(kInCount, j) = el[r].use_inversion ? el[r].count : 0.0f;
    at(kInLog1mq, j) = -el[r].q;  // -q, until the element is packed
    at(kInNum, j) = 0.0f;
    at(kInSum, j) = 0.0f;
    at(kInCtr, j) = __uint_as_float(ctr[r]);
    at(kInHome, j) = __int_as_float(j);
    at(kInLive, j) = el[r].in_call && 0.0f <= at(kInCount, j) ? 1.0f : 0.0f;
    at(kInOut, j) = -1.0f;  // num_geom - 1 of an element that never draws
  }
  // packs the live elements of the first n positions; returns their number
  const auto pack = [&](int n) {
    int kept = 0;
#pragma unroll 1
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool keep = j < n && at(kInLive, j) != 0.0f;
      const unsigned m = __ballot_sync(kWarpAll, keep);
      float f[kInLive];
#pragma unroll
      for (int i = 0; i < kInLive; ++i) f[i] = keep ? at(i, j) : 0.0f;
      __syncwarp();
      if (keep) {
        const int to = kept + __popc(m & below);
#pragma unroll
        for (int i = 0; i < kInLive; ++i) at(i, to) = f[i];
        at(kInLive, to) = 1.0f;
      }
      kept += __popc(m);
      __syncwarp();
    }
    return kept;
  };
  int live = pack(R * 32);
#pragma unroll 1
  for (int j0 = 0; j0 < live; j0 += 32) {
    const int j = j0 + lane;
    if (j < live) at(kInLog1mq, j) = xla_log1p(at(kInLog1mq, j));
  }
  int passes = 0;
  while (live > 0) {
    const Key sub = child(key, 0);
    key = child(key, 1);
    int still = 0;
#pragma unroll 1
    for (int j0 = 0; j0 < live; j0 += 32) {
      const int j = j0 + lane;
      bool stays = false;
      if (j < live && at(kInLive, j) != 0.0f) {  // a done element keeps its state
        const float u = uniform32(bits32(sub, __float_as_uint(at(kInCtr, j))));
        const float sum =
            __fadd_rn(at(kInSum, j), ceilf(__fdiv_rn(xla_log(u), at(kInLog1mq, j))));
        const float num = __fadd_rn(at(kInNum, j), 1.0f);
        at(kInNum, j) = num;
        at(kInSum, j) = sum;
        stays = sum <= at(kInCount, j);
        at(kInLive, j) = stays ? 1.0f : 0.0f;
        if (!stays) at(kInOut, __float_as_int(at(kInHome, j))) = __fsub_rn(num, 1.0f);
      }
      still += __popc(__ballot_sync(kWarpAll, stays));
    }
    // pack only when a slot's worth of positions frees up
    if ((still + 31) / 32 < (live + 31) / 32) {
      live = pack(live);
    } else {
      live = still == 0 ? 0 : live;
    }
    ++passes;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = at(kInOut, r * 32 + lane);
  return passes;
}

// BTRS's constants of an element with count `count` and q (both loops'
// own: the bound's first term is loop-invariant, hoisted by XLA and
// rounded)
struct BtrsConsts {
  float count, b, a, c, vr, r, alpha, cm1, t1, sm, scm;
};

__device__ __forceinline__ BtrsConsts btrs_consts(float count, float q) {
  BtrsConsts k;
  const float omq = __fsub_rn(1.0f, q);
  const float stddev = sqrtf(__fmul_rn(__fmul_rn(count, q), omq));
  const float b = fma32(stddev, F32(2.53), F32(1.15));
  const float r = __fdiv_rn(q, omq);
  const float m = floorf(__fmul_rn(__fadd_rn(count, 1.0f), q));
  const float cm1 = __fadd_rn(__fsub_rn(count, m), 1.0f);  // count - m + 1
  k.count = count;
  k.b = b;
  k.a = fma32(q, F32(0.01), fma32(b, F32(0.0248), F32(-0.0873)));
  k.c = fma32(count, q, 0.5f);
  k.vr = __fsub_rn(F32(0.92), __fdiv_rn(F32(4.2), b));
  k.r = r;
  k.alpha = __fmul_rn(__fadd_rn(F32(2.83), __fdiv_rn(F32(5.1), b)), stddev);
  k.cm1 = cm1;
  k.t1 = __fmul_rn(__fadd_rn(m, 0.5f), xla_log(__fdiv_rn(__fadd_rn(m, 1.0f), __fmul_rn(r, cm1))));
  k.sm = stirling_tail(m);
  k.scm = stirling_tail(__fsub_rn(count, m));
  return k;
}

// The same constants where binomial_btrs keeps them, a slot's fields in
// the warp's shared memory, each read where the test uses it
struct BtrsSlot {
  const float &count, &b, &a, &c, &vr, &r, &alpha, &cm1, &t1, &sm, &scm;
};

// One BTRS pass of an element with constants e (BtrsConsts or BtrsSlot):
// its draw k from the pass's subkeys (s0, s1) at counter ctr, and whether
// it accepts
template <class Consts>
__device__ __forceinline__ bool btrs_accept(const Consts& e, Key s0, Key s1, uint32_t ctr,
                                            float& k) {
  const float u = __fsub_rn(uniform32(bits32(s0, ctr)), 0.5f);
  const float v = uniform32(bits32(s1, ctr));
  const float us = __fsub_rn(0.5f, fabsf(u));
  const bool accept1 = us >= F32(0.07) && v <= e.vr;
  k = floorf(fma32(__fadd_rn(__fdiv_rn(__fmul_rn(2.0f, e.a), us), e.b), u, e.c));
  const bool reject = k < 0.0f || k > e.count;
  const float vl = xla_log(__fdiv_rn(__fmul_rn(v, e.alpha),
                                     __fadd_rn(__fdiv_rn(e.a, __fmul_rn(us, us)), e.b)));
  const float ck1 = __fadd_rn(__fsub_rn(e.count, k), 1.0f);  // count - k + 1
  float ub = fma32(__fadd_rn(k, 0.5f), xla_log(__fdiv_rn(__fmul_rn(e.r, ck1), __fadd_rn(k, 1.0f))),
                   fma32(__fadd_rn(e.count, 1.0f), xla_log(__fdiv_rn(e.cm1, ck1)), e.t1));
  ub = __fadd_rn(ub, e.sm);
  ub = __fadd_rn(ub, e.scm);
  ub = __fsub_rn(ub, stirling_tail(k));
  ub = __fsub_rn(ub, stirling_tail(__fsub_rn(e.count, k)));
  return accept1 || (!reject && vl <= ub);
}

// BTRS's per-slot state in a warp's shared memory: field f of slot r of
// lane l at (f R + r) 32 + l
enum {
  kBtCount, kBtB, kBtA, kBtC, kBtVr, kBtR, kBtAlpha, kBtCm1, kBtT1, kBtSm, kBtScm, kBtOut,
  kBtAccepted, kBtCtr, kBtInCall, kBtFields
};
static_assert(kInFields <= kBtFields, "the loops share one state buffer");

// _btrs over one group's slots: transformed rejection, one (key, s0, s1)
// split a pass, last accept wins. It runs until every element of the group
// has accepted (passes < 0) or exactly `passes` passes; returns the passes
// run (warp-uniform). The slots' state lives in `state` (kBtFields R 32
// floats of the warp's shared memory) and one slot is done at a time, so
// that the loop's code and registers are one slot's: BTRS runs in few calls.
template <int R>
__device__ int binomial_btrs(Key key, const BinomialElem (&el)[R], const uint32_t (&ctr)[R],
                             int passes, float (&out)[R], float* state) {
  const int lane = threadIdx.x % 32;
  const auto at = [&](int f, int r) -> float& { return state[(f * R + r) * 32 + lane]; };
#pragma unroll
  for (int r = 0; r < R; ++r) {
    at(kBtCount, r) = el[r].use_inversion ? 1e4f : el[r].count;
    at(kBtR, r) = el[r].use_inversion ? 0.5f : el[r].q;  // q, until below
    at(kBtCtr, r) = __uint_as_float(ctr[r]);
    at(kBtInCall, r) = el[r].in_call ? 1.0f : 0.0f;
  }
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const BtrsConsts e = btrs_consts(at(kBtCount, r), at(kBtR, r));
    at(kBtB, r) = e.b;
    at(kBtA, r) = e.a;
    at(kBtC, r) = e.c;
    at(kBtVr, r) = e.vr;
    at(kBtR, r) = e.r;
    at(kBtAlpha, r) = e.alpha;
    at(kBtCm1, r) = e.cm1;
    at(kBtT1, r) = e.t1;
    at(kBtSm, r) = e.sm;
    at(kBtScm, r) = e.scm;
    at(kBtOut, r) = -1.0f;
    at(kBtAccepted, r) = at(kBtInCall, r) != 0.0f ? 0.0f : 1.0f;
  }
  int pass = 0;
  for (;; ++pass) {
    if (passes < 0) {
      bool open = false;
#pragma unroll 1
      for (int r = 0; r < R; ++r) open = open || at(kBtAccepted, r) == 0.0f;
      if (!__any_sync(kWarpAll, open)) break;
    } else if (pass >= passes) {
      break;
    }
    const Key s0 = child(key, 1), s1 = child(key, 2);
    key = child(key, 0);
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      const BtrsSlot e{at(kBtCount, r), at(kBtB, r),     at(kBtA, r),   at(kBtC, r),
                       at(kBtVr, r),    at(kBtR, r),     at(kBtAlpha, r), at(kBtCm1, r),
                       at(kBtT1, r),    at(kBtSm, r),    at(kBtScm, r)};
      float k;
      const bool accept = btrs_accept(e, s0, s1, __float_as_uint(at(kBtCtr, r)), k);
      if (at(kBtInCall, r) != 0.0f && accept) {
        at(kBtOut, r) = k;
        at(kBtAccepted, r) = 1.0f;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = at(kBtOut, r);
  return pass;
}

// One jax.random.binomial call of K elements keyed by `key` on the calling
// warp (every lane must call). load(k, r) gives element k's (n, p) as a
// float2, r its slot; store(k, r, x) takes its int32 draw. The counter of
// element k's words is k. state is the warp's kBtFields R 32 floats of
// shared memory for the loops' state.
template <int R, class Load, class Store>
__device__ BinomialPasses binomial_warp(Key key, int K, Load load, Store store,
                                        float* state) {
  constexpr int G = 32 * R;
  const int lane = threadIdx.x % 32;
  const int groups = (K + G - 1) / G;
  BinomialPasses out;
  const auto elems = [&](int g, BinomialElem (&el)[R], uint32_t (&ctr)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = g * G + r * 32 + lane;
      const bool in_call = k < K;
      const float2 np = in_call ? load(k, r) : make_float2(0.0f, 0.0f);
      el[r] = binomial_elem(np.x, np.y, in_call);
      ctr[r] = static_cast<uint32_t>(k);
    }
  };
  // which loops the call runs (a call of one group finds out below)
  const auto loops = [&](const BinomialElem (&el)[R], bool& inv_l, bool& btrs_l) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      inv_l = inv_l || (el[r].in_call && el[r].use_inversion);
      btrs_l = btrs_l || (el[r].in_call && !el[r].use_inversion);
    }
  };
  bool inv_l = false, btrs_l = false;
#pragma unroll 1
  for (int g = 0; g < groups && groups > 1; ++g) {
    BinomialElem el[R];
    uint32_t ctr[R];
    elems(g, el, ctr);
    loops(el, inv_l, btrs_l);
  }
  bool any_inversion = __any_sync(kWarpAll, inv_l);
  bool any_btrs = __any_sync(kWarpAll, btrs_l);
  // BTRS's pass count is the call's: with several groups, phase 0 runs
  // each group's BTRS loop to find it; phase 1 draws. Each loop appears
  // once in the code.
  int btrs_passes = groups > 1 ? 0 : -1;
#pragma unroll 1
  for (int phase = any_btrs && groups > 1 ? 0 : 1; phase < 2; ++phase) {
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      BinomialElem el[R];
      uint32_t ctr[R];
      elems(g, el, ctr);
      if (groups == 1) {
        loops(el, inv_l, btrs_l);
        any_inversion = __any_sync(kWarpAll, inv_l);
        any_btrs = __any_sync(kWarpAll, btrs_l);
      }
      float inv[R], btrs[R];
#pragma unroll
      for (int r = 0; r < R; ++r) inv[r] = btrs[r] = 0.0f;
      if (phase == 1 && any_inversion) {
        const unsigned long long t0 = stage_clock();
        out.inversion = max(out.inversion, binomial_inversion<R>(key, el, ctr, inv, state));
        out.inversion_clocks += stage_clock() - t0;
      }
      if (any_btrs) {
        const unsigned long long t0 = stage_clock();
        const int passes =
            binomial_btrs<R>(key, el, ctr, phase == 0 ? -1 : btrs_passes, btrs, state);
        if (phase == 0) {
          btrs_passes = max(btrs_passes, passes);
        } else {
          out.btrs = passes;
        }
        out.btrs_clocks += stage_clock() - t0;
      }
      if (phase == 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (el[r].in_call) {
            store(g * G + r * 32 + lane, r, binomial_finish(el[r], inv[r], btrs[r]));
          }
        }
      }
    }
  }
  return out;
}

// The subkeys of one lane's BTRS passes, pass p's (s0, s1) being split(key_p,
// 3)[1:] and key_{p + 1} split(key_p, 3)[0]: the first kLanePassCap passes'
// in the lane's table in shared memory (entry i at table[i * 32], so that
// the lanes of a warp read neighbouring words), a later pass's walked from
// the chain (a test builds a cap of 1, -DLANE_PASS_CAP=1, to reach the walk)
#ifndef LANE_PASS_CAP
#define LANE_PASS_CAP 8
#endif
constexpr int kLanePassCap = LANE_PASS_CAP;

struct LanePassKeys {
  Key* table;  // this lane's 2 kLanePassCap entries
  Key tail;    // key_{kLanePassCap}

  __device__ void fill(Key key) {
    for (int p = 0; p < kLanePassCap; ++p) {
      table[2 * p * 32] = child(key, 1);
      table[(2 * p + 1) * 32] = child(key, 2);
      key = child(key, 0);
    }
    tail = key;
  }

  __device__ void get(int p, Key& s0, Key& s1) const {
    if (p < kLanePassCap) {
      s0 = table[2 * p * 32];
      s1 = table[(2 * p + 1) * 32];
      return;
    }
    Key key = tail;
    for (int i = kLanePassCap; i < p; ++i) key = child(key, 0);
    s0 = child(key, 1);
    s1 = child(key, 2);
  }
};

// One jax.random.binomial call of K elements keyed by `key` on the calling
// lane alone: binomial_warp's draws in another order, for calls too many
// and too alike to give a warp each (lanes_counts' pool instance runs its
// bidders' calls so, one lane per (env, t)). load(j) gives element j's (n,
// p), store(j, x) takes its draw; `keys` holds the lane's pass subkeys.
//
// An inversion element's draw depends on its own words alone, so each
// walks its own passes (key_{i + 1}, sub = split(key_i)). A BTRS element's
// draw is its k at the last pass below the call's pass count P in which it
// accepts, and P is one past the latest pass at which an element of the
// call (an inversion one as a dummy) first accepts. So BTRS is two sweeps
// of the elements, each element tried only until an accept: forward from
// pass 0 to its first accept, whose latest gives P; then backward from
// pass P - 1 to its first accept from the top (one exists: its forward
// accept). An element is tried about 2 / (acceptance rate) times, not P
// times, and a lane idles on no other element. The sweeps are flat loops
// (one try an iteration, element and pass in registers), so the lanes of
// a warp stay busy until each has tried its own call's elements; the BTRS
// constants are recomputed only where an element's (count, q) differs from
// the one before it (the pool's keywords share theirs).
template <class Load, class Store>
__device__ BinomialPasses binomial_lane(Key key, int K, Load load, Store store,
                                        LanePassKeys& keys) {
  BinomialPasses out;
  const auto elem = [&](int j) {
    const float2 np = load(j);
    return binomial_elem(np.x, np.y, true);
  };
  unsigned long long t0 = stage_clock();
  bool any_btrs = false;
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    const BinomialElem el = elem(j);
    if (!el.use_inversion) {
      any_btrs = true;
      continue;
    }
    float draw = -1.0f;  // num_geom - 1 of an element that never draws
    if (0.0f <= el.count) {
      const float log1mq = xla_log1p(-el.q);
      Key chain = key;
      float sum = 0.0f, num = 0.0f;
      do {
        const Key sub = child(chain, 0);
        chain = child(chain, 1);
        sum = __fadd_rn(sum, ceilf(__fdiv_rn(xla_log(uniform32(bits32(sub, j))), log1mq)));
        num = __fadd_rn(num, 1.0f);
      } while (sum <= el.count);
      draw = __fsub_rn(num, 1.0f);
      out.inversion = max(out.inversion, static_cast<int>(num));
    }
    store(j, binomial_finish(el, draw, 0.0f));
  }
  out.inversion_clocks = stage_clock() - t0;
  if (!any_btrs) return out;
  t0 = stage_clock();
  keys.fill(key);
  BtrsConsts c;
  float c_count = -1.0f, c_q = -1.0f;
  const auto consts_of = [&](const BinomialElem& el) {
    const float count = el.use_inversion ? 1e4f : el.count;
    const float q = el.use_inversion ? 0.5f : el.q;
    if (count != c_count || q != c_q) {
      c = btrs_consts(count, q);
      c_count = count;
      c_q = q;
    }
  };
  int P = 0;
#pragma unroll 1
  for (int j = 0, p = 0; j < K;) {
    consts_of(elem(j));
    Key s0, s1;
    keys.get(p, s0, s1);
    float k;
    if (btrs_accept(c, s0, s1, static_cast<uint32_t>(j), k)) {
      P = max(P, p + 1);
      ++j;
      p = 0;
    } else {
      ++p;
    }
  }
#pragma unroll 1
  for (int j = 0, p = P - 1; j < K;) {
    const BinomialElem el = elem(j);
    if (el.use_inversion) {  // its draw is the inversion walk's
      ++j;
      continue;
    }
    consts_of(el);
    Key s0, s1;
    keys.get(p, s0, s1);
    float k;
    if (btrs_accept(c, s0, s1, static_cast<uint32_t>(j), k)) {
      store(j, binomial_finish(el, 0.0f, k));
      ++j;
      p = P - 1;
    } else {
      --p;
    }
  }
  out.btrs = P;
  out.btrs_clocks = stage_clock() - t0;
  return out;
}

#undef F32

}  // namespace
