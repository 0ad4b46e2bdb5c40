// The lanes day on Hopper (sm_90a): kernels for the three phases of
// adcraft_tpu/step.py:simulate_day (:991) in the JAX package's default
// configuration (cost, conversion and revenue lanes, jax.random.binomial),
// for implicit single-competitor keywords, for explicit ones (kind
// EXPLICIT, EnvConfig's default) with either cost model, and for the
// binomial pool (lanes_counts' pool instance, lanes_gate_float's pool
// mode). The JAX package left these phases to XLA, so no Pallas kernel
// constrains them. CUDA C++ rather than Triton: the gates are sequential
// walks of one warp per env
// and the binomials warp-wide lockstep loops, both built on shuffles,
// ballots and per-warp shared buffers, not elementwise passes:
//
// * lanes_counts replaces _cell_tables' impressions and clicks
//   (run_cell_auctions -> implicit_single_auction, auction.py:126, and the
//   clicks binomial, step.py:934): one warp per (env, sub-timestep), four
//   such warps a block with no block barrier, each binomial one warp-wide
//   lockstep call of K elements, R = ceil(K / 32) slots a lane up to 4
//   (binomial.cuh), or the inverse-CDF walk (sampler "inversion"); its
//   explicit instance replaces explicit_auction's impressions (auction.py:
//   209, the threshold sigmoid's rate) and draws the clicks over max(imp,
//   1) candidates (the phantom click); its pool instance's bidders' calls
//   (implicit_pool_auction, auction.py:164) run before it in a kernel of
//   their own, one lane per call (lanes_bidders_kernel);
// * lanes_gate replaces the cost lanes (implicit_single_auction's truncated
//   Laplace, in cents) and the budget gate over the T K cells in (t, k)
//   order (_gate_keywords, step.py:115; the lazy and Jacobi TPU schedules
//   are bit-identical to it): one warp per env walks the cells through
//   windows of up to 32 (below); its python instance draws the python
//   model's cents (generic_cost, distributions.py:340), 0 in phantom cells;
// * lanes_gate_float replaces, for the rust model's continuous costs
//   (cost_create, distributions.py:325), the float32 gate that JAX runs
//   for costs that are not cents (_gate_keywords_jacobi, step.py:152):
//   one warp per env, windows of cells decided in runs by a scan of
//   guessed spends and a ballot (at lanes_gate_float_kernel);
// * lanes_outcomes replaces _append_conv_rev_tables (:953) and phase 3's
//   gathers and sums (:1400-1502): one block per env, its warps reading
//   tiles of 32 consecutive simulated cells, each warp drawing the
//   conversion flags below the accepted clicks and then the revenue below
//   the conversions densely, 32 lanes a step from two per-warp queues of
//   lanes (below), with integer atomics into the keywords' sums; in its
//   float mode (the rust model) one thread per keyword also adds the
//   float32 spends in XLA's order.
//
// The plain PyTorch versions are adcraft_tpu_torch/lanes_day.py:
// lanes_counts_reference, lanes_gate_reference, lanes_gate_float_reference,
// lanes_outcomes_reference.
// Every float operation here is the one that version's tensor ops perform
// on the card (jax_random.cuh, xla_math.cuh), so the kernels equal it
// exactly.
//
// Keys follow jax.random's tree: per env and sub-timestep kt =
// fold_in(k_cells, t); k_auc, k_click, k_conv, k_rev = split(kt, 4); k_imp,
// k_cost = split(k_auc). A (K,) draw takes keyword k's word at counter k, an
// (m, K) table lane j's at j K + k, and only the lanes a result reads are
// drawn.
//
// What bounds them: threefry words and the float work of the draws (the
// binomial's loops of XLA's log, the Laplace inverse CDF, the erf_inv
// polynomial and its log1p); all issue more instructions than the work
// needs, the gates most of all, since their decisions are one chain per
// env (lanes_gate_float's a float one, in XLA's order of sums). The
// gate's window splits the chain: stage A (all 32 lanes) takes up
// to 32 cells, with their clicks and keyword parameters loaded one window
// ahead, draws each cell's first cost lane, then the other lanes of the
// cells whose first lane is within the budget (the others are "skipped":
// over the budget, they accept nothing while it does not grow) densely, 32
// lanes a step across cells, into per-cell running prefixes in the warp's
// shared buffer, with each cell's total and whether its sums wrap int32;
// stage B decides the window from those with integer work only: a run of
// "whole" cells (unwrapped prefixes whose total is within the budget left,
// which stays positive) or of "passive" ones (no click, or a first lane
// over the budget), then one cell alone (passive, whole, a break,
// lane-resolved by a ballot over its prefixes, or walked alone if it was
// skipped and a wrapped negative spend has grown the budget), and on from
// the next cell with the new budget. lanes_counts derives each pass's
// subkeys once per warp and draws only the call's live elements, packed
// (binomial.cuh). lanes_outcomes' cells need from 0 to m lanes each (a
// flag word per accepted click, then a revenue normal per conversion), so
// a thread per cell would idle while the deepest cell of its warp walks;
// its warps queue lanes, not cells: a cell's flag lanes join the warp's
// flag ring, and once its conversions are known its revenue lanes join the
// revenue ring. Each draw step takes the 32 lanes at a ring's head, a lane
// finding its cell from an OR of the 32 entries' starts, so a cell may
// straddle two steps; a segmented ballot counts a cell's set flags. A
// revenue lane's erf_inv runs one of the two branches of XLA's log1p, each
// a chain of fused multiply-adds, so a warp that mixed them would run both:
// a revenue draw step stages each lane's uniform by its branch, and an
// erf_inv step runs 32 staged lanes of one branch. Every sum is int32
// arithmetic modulo 2**32, so any order of lanes and atomics gives the
// plain version's sums. The keywords' constants and sums sit in shared
// memory, or, for a K whose tables a block cannot hold, in device memory
// (the same kernel, its other instance).
//
// Built with -DLANES_STAGE_CLOCKS (chip_smoke.py builds it so beside the
// plain build), lane 0 of each warp also counts its SM clocks per stage,
// the walk's cells, the loops' passes and the outcome lanes and draw steps
// into g_lanes_stats, read with lanes_day_stats.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "binomial.cuh"
#include "jax_random.cuh"
#include "threefry.cuh"
#include "xla_math.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCountsWarps = 4;       // (env, t) calls per lanes_counts block, one warp each
constexpr int kMaxSlots = 4;          // R, the slots a lane holds of a group of 32 R elements
constexpr int kCountsBlocks = 5;      // lanes_counts blocks per SM its registers are capped for
constexpr int kBiddersWarps = 4;      // warps of a lanes_bidders block, each 32 (env, t) calls
constexpr int kBiddersBlocks = 6;     // lanes_bidders blocks per SM its registers are capped for
constexpr int kGateWarps = 4;         // envs per lanes_gate block, one warp each
constexpr int kGateCap = 256;         // cost lanes of a window, a warp's shared buffer
constexpr int kOutWarps = 4;          // warps of a lanes_outcomes block, one env
constexpr int kOutBlocks = 10;        // lanes_outcomes blocks per SM its registers are capped for
constexpr int kRing = 64;             // entries of a lanes_outcomes warp's lane ring
static_assert((kRing & (kRing - 1)) == 0 && kRing >= 63, "a ring holds 31 + 32 entries");
constexpr int kMaxDevices = 64;       // devices whose lanes_outcomes configuration is remembered

// g_lanes_stats: SM clocks of lane 0 of each warp per stage, the walk's
// cells and windows, the binomial loops' passes; lanes_day_stats reads them
enum {
  kGateKeyClocks,       // lanes_gate: the per-t cost keys
  kGateAClocks,         // stage A: loads, draws, prefixes
  kGateBClocks,         // stage B: the decisions and writes
  kGateWarpsRun,        // envs walked
  kGateWindows,         // windows drawn
  kGateCut,             // windows ended by the buffer's capacity
  kGateDeep,            // cells with more lanes than the buffer, walked alone
  kGateSkipped,         // cells whose lanes after the first were not drawn
  kGateRedrawn,         // ... walked alone later, the budget having grown
  kGateLanes,           // cost lanes drawn in windows
  kGateSimulated,       // cells simulated (n_sim summed)
  kGateWhole,           // cells that accept all their clicks and leave budget, in runs
  kGatePassive,         // cells that accept nothing and leave the budget, in runs
  kGateAloneWhole,      // cells decided alone that accept all their clicks
  kGateAlonePassive,    // ... that accept nothing
  kGateResolved,        // ... resolved by a ballot over their prefixes
  kCountsInvClocks,     // lanes_counts: SM clocks in the inversion loops
  kCountsBtrsClocks,    // ... in the BTRS loops
  kCountsClocks,        // ... in the whole warp
  kCountsCalls,         // binomial calls
  kCountsInvCalls,      // calls that ran the inversion loop
  kCountsInvPasses,     // their passes
  kCountsInvMax,        // the most passes of one call
  kCountsBtrsCalls,     // calls that ran the BTRS loop
  kCountsBtrsPasses,
  kCountsBtrsMax,
  kOutPrologueClocks,   // lanes_outcomes: keys, keyword tables, zeroed sums
  kOutTileClocks,       // ... the tiles' loads, cheap sums and flag-ring pushes
  kOutFlagClocks,       // ... the flag draw steps (and revenue-ring pushes)
  kOutRevClocks,        // ... the revenue draw steps (uniforms, sorted by log1p branch)
  kOutErfClocks,        // ... the erf_inv steps (revenue cents and their sums)
  kOutWriteClocks,      // ... the block barrier and the write-out
  kOutWarpsRun,         // warps run
  kOutFlagLanes,        // flag lanes drawn
  kOutRevLanes,         // revenue lanes drawn
  kOutFlagSteps,        // flag draw steps
  kOutRevSteps,
  kOutFlagPartial,      // flag draw steps of fewer than 32 lanes
  kOutRevPartial,
  kOutErfSteps,         // erf_inv steps
  kOutErfLogSteps,      // ... of them on log1p's log branch
  kOutErfPartial,       // ... of fewer than 32 lanes
  kFloatAClocks,        // lanes_gate_float: stage A (keys, loads, first and dense lanes, prefixes)
  kFloatBClocks,        // ... stage B (the decisions and writes)
  kFloatWarpsRun,       // envs walked
  kFloatWindows,        // windows drawn
  kFloatLanes,          // cost lanes after the first drawn in windows
  kFloatDead,           // cells walked after a stop in their sub-timestep (-1)
  kFloatNoClick,        // simulated cells without clicks
  kFloatOver,           // ... whose first lane is over the budget
  kFloatWhole,          // ... that accept all their clicks
  kFloatPartial,        // ... that accept some, resolved over their prefixes
  kFloatDeep,           // cells with more lanes than the buffer, walked alone
  kFloatBroken,         // days broken
  kFloatRuns,           // runs of cells decided by one ballot
  kFloatRedrawn,        // cells whose lanes were drawn alone, the budget having grown
  // lanes_counts per call, three each (the bidders', the impressions' and
  // the clicks' call): SM clocks of the whole call, its inversion loop's
  // passes, its BTRS loop's passes and clocks, the calls that ran BTRS,
  // the inversion loop's words (one per element a pass draws) and slot
  // steps; then the same seven of the calls at t = 0 alone
  kCallClocks,
  kCallInvPasses = kCallClocks + 3,
  kCallBtrsPasses = kCallInvPasses + 3,
  kCallBtrsClocks = kCallBtrsPasses + 3,
  kCallBtrsCalls = kCallBtrsClocks + 3,
  kCallInvWords = kCallBtrsCalls + 3,
  kCallInvSteps = kCallInvWords + 3,
  kCallFirstT = kCallInvSteps + 3,
  kCountsPrologueClocks = 2 * kCallFirstT - kCallClocks,  // a warp's keys, before its calls
  kCountsPrologueFirstT,  // ... of the warps at t = 0
  kCountsClocksFirstT,    // the whole warp's clocks at t = 0
  kCountsFlatWarps,       // lanes_counts' explicit instance: warps that drew t >= 1 flat
  kCountsFlatClocks,      // ... their clocks in that loop
  kNumStats
};

constexpr int kCallMeasures = kCallFirstT - kCallClocks;

#ifdef LANES_STAGE_CLOCKS
__device__ unsigned long long g_lanes_stats[kNumStats];
#endif

// per-warp statistics of a LANES_STAGE_CLOCKS build, added by lane 0
struct Stats {
#ifdef LANES_STAGE_CLOCKS
  unsigned long long v[kNumStats] = {};
  __device__ void add(int i, unsigned long long x) { v[i] += x; }
  __device__ void top(int i, unsigned long long x) { v[i] = x > v[i] ? x : v[i]; }
  __device__ void flush(int lane) {
    if (lane != 0) return;
    for (int i = 0; i < kNumStats; ++i) {
      if (i == kCountsInvMax || i == kCountsBtrsMax) {
        atomicMax(&g_lanes_stats[i], v[i]);
      } else if (v[i] != 0) {
        atomicAdd(&g_lanes_stats[i], v[i]);
      }
    }
  }
#else
  __device__ void add(int, unsigned long long) {}
  __device__ void top(int, unsigned long long) {}
  __device__ void flush(int) {}
#endif
};

// int32 arithmetic that wraps, as the plain version's (XLA's) int32 sums do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// implicit_single_win_prob: P(|Laplace(loc, scale)| < bid - 0.005) in [0, 1]
__device__ __forceinline__ float win_prob(float bid, float loc, float scale) {
  const float y0 = __fsub_rn(bid, 0.005f);
  return fminf(fmaxf(__fsub_rn(laplace_cdf(y0, loc, scale), laplace_cdf(-y0, loc, scale)), 0.0f),
               1.0f);
}

// a call's passes and clocks; `which` 0 the bidders' call, 1 the
// impressions', 2 the clicks'; `first_t` a call at t = 0
__device__ __forceinline__ void count_passes(Stats& st, const BinomialPasses& p, int which,
                                             unsigned long long clocks, bool first_t) {
  for (int base = kCallClocks; base <= (first_t ? kCallFirstT : kCallClocks);
       base += kCallMeasures) {
    st.add(base + which, clocks);
    st.add(base + kCallInvPasses - kCallClocks + which, p.inversion);
    st.add(base + kCallBtrsPasses - kCallClocks + which, p.btrs);
    st.add(base + kCallBtrsClocks - kCallClocks + which, p.btrs_clocks);
    st.add(base + kCallBtrsCalls - kCallClocks + which, p.btrs > 0);
    st.add(base + kCallInvWords - kCallClocks + which, p.inversion_words);
    st.add(base + kCallInvSteps - kCallClocks + which, p.inversion_steps);
  }
  st.add(kCountsCalls, 1);
  st.add(kCountsInvClocks, p.inversion_clocks);
  st.add(kCountsBtrsClocks, p.btrs_clocks);
  if (p.inversion > 0) {
    st.add(kCountsInvCalls, 1);
    st.add(kCountsInvPasses, p.inversion);
    st.top(kCountsInvMax, p.inversion);
  }
  if (p.btrs > 0) {
    st.add(kCountsBtrsCalls, 1);
    st.add(kCountsBtrsPasses, p.btrs);
    st.top(kCountsBtrsMax, p.btrs);
  }
}

// lanes_counts' instances: implicit single-competitor keywords, explicit
// ones, the binomial pool
enum { kCountsImplicit, kCountsExplicit, kCountsPool };

__device__ __forceinline__ Key shfl_key(Key k, int src) {
  return Key{__shfl_sync(kFull, k.k0, src), __shfl_sync(kFull, k.k1, src)};
}

// The impressions' call of one (env, t), then the clicks' on them, under
// the exact sampler, through one copy of the binomial's code: rate(k) is
// keyword k's impression rate, candidates(i) the clicks' count at i
// impressions; a lane reads back only the draws it wrote: the impressions
// from its registers (prev, its slots' loads all come before their
// stores) or, past one group, from the row. state is the warp's loop state.
template <int R, class Rate, class Candidates>
__device__ __forceinline__ void exact_calls(Key k_imp, Key k_click, int K, Rate rate,
                                            Candidates candidates, const float* bctr,
                                            const int* n_row, int* imp_row, int* ncl_row,
                                            float* state, Stats& st, bool first_t) {
  int prev[R];
  const bool one_group = K <= 32 * R;
#pragma unroll 1
  for (int which = 1; which < 3; ++which) {
    int* row = which == 1 ? imp_row : ncl_row;
    const Key key = which == 1 ? k_imp : k_click;
    const unsigned long long call_start = stage_clock();
    const BinomialPasses passes = binomial_warp<R>(
        key, K,
        [&](int k, int r) {
          if (which == 2) {
            return make_float2(static_cast<float>(candidates(one_group ? prev[r] : imp_row[k])),
                               bctr[k]);
          }
          return make_float2(static_cast<float>(n_row[k]), rate(k));
        },
        [&](int k, int r, int x) {
          prev[r] = x;
          row[k] = x;
        },
        state);
    count_passes(st, passes, which, stage_clock() - call_start, first_t);
  }
}

// One warp per (env, sub-timestep): the impressions' call, then the clicks'
// on those impressions. R slots a lane; a call of more than 32 R keywords
// runs in groups (binomial.cuh). The explicit instance takes the
// impression rate from the threshold sigmoid of the bid and draws the
// clicks over max(impressions, 1) candidates (the phantom click). The
// pool's (implicit_pool_auction: k_bidders, k_imp, k_cost = split(k_auc,
// 3)) draws its impressions at F(bid)^k (1 at k = 0) for each keyword's
// bidder count k in kout: under the exact sampler the bidders' calls ran
// before, in lanes_bidders_kernel; under "inversion" it draws them here,
// one uniform against the keyword's ladder of kmax levels (the walk).
template <int R, int kMode>
__global__ void __launch_bounds__(32 * kCountsWarps, kCountsBlocks)
    lanes_counts_kernel(const float* __restrict__ params, const int* __restrict__ n_auc01,
                        const long long* __restrict__ keys, long long key_stride,
                        int* __restrict__ imp, int* __restrict__ ncl, int* __restrict__ kout,
                        int E, int K, int T, int m0, int m1, int bits, int exact, int kmax,
                        int cent_bids) {
  constexpr bool kExplicit = kMode == kCountsExplicit;
  constexpr bool kPool = kMode == kCountsPool;
  const int lane = threadIdx.x % 32;
  const long long call = static_cast<long long>(blockIdx.x) * kCountsWarps + threadIdx.x / 32;
  if (call >= static_cast<long long>(E) * T) return;
  const unsigned long long start = stage_clock();
  Stats st;
  const int e = static_cast<int>(call / T), t = static_cast<int>(call % T);
  const long long EK = static_cast<long long>(E) * K;
  const long long eK = static_cast<long long>(e) * K;
  const Key kt = child(load_key(keys, key_stride, e), static_cast<uint32_t>(t));
  const Key k_auc = child(kt, 0), k_click = child(kt, 1);
  const Key k_imp = child(k_auc, kPool ? 1 : 0);
  const Key k_bidders = child(k_auc, 0);  // the pool's
  const float* bid = params + BID * EK + eK;
  const float* loc = params + LOC * EK + eK;
  const float* scale = params + SCALE * EK + eK;
  const float* bctr = params + BCTR * EK + eK;
  const float* thresh = params + IMP_THRESH * EK + eK;
  const float* intercept = params + IMP_INTERCEPT * EK + eK;
  const float* slope = params + IMP_SLOPE * EK + eK;
  const float* max_bidders = params + MAX_BIDDERS * EK + eK;
  const float* participation = params + PARTICIPATION * EK + eK;
  // the pool's win probability at kb bidders: F(bid)^k (XLA's powf), 1 at k = 0
  const auto pool_rate = [&](int k, int kb) {
    return kb > 0 ? xla_pow(bid_cdf(bid[k], loc[k], scale[k], cent_bids != 0),
                            static_cast<float>(kb))
                  : 1.0f;
  };
  const auto rate = [&](int k) {
    return kExplicit ? threshold_sigmoid(bid[k], thresh[k], intercept[k], slope[k])
                     : win_prob(bid[k], loc[k], scale[k]);
  };
  const auto candidates = [](int im) { return kExplicit ? max(im, 1) : im; };
  const int* n_row = n_auc01 + (t == 0 ? 0 : EK) + eK;
  int* imp_row = imp + call * K;
  int* ncl_row = ncl + call * K;
  int* k_row = kPool ? kout + call * K : nullptr;
  const unsigned long long prologue = stage_clock() - start;
  st.add(kCountsPrologueClocks, prologue);
  if (t == 0) st.add(kCountsPrologueFirstT, prologue);
  if (exact) {
    __shared__ float loop_state[kCountsWarps][kBtFields * R * 32];
    exact_calls<R>(
        k_imp, k_click, K, [&](int k) { return kPool ? pool_rate(k, k_row[k]) : rate(k); },
        candidates, bctr, n_row, imp_row, ncl_row, loop_state[threadIdx.x / 32], st, t == 0);
  } else {
    const int m = t == 0 ? m0 : m1;
    auto recip = [](int j) { return __fdiv_rn(1.0f, static_cast<float>(j)); };
    for (int k = lane; k < K; k += 32) {
      float p;
      if (kPool) {
        const int kb = ladder_draw(max_bidders[k], participation[k], kmax,
                                   lane_uniform(k_bidders, k, bits));
        k_row[k] = kb;
        p = pool_rate(k, kb);
      } else {
        p = rate(k);
      }
      const int i = binomial_walk(lane_uniform(k_imp, k, bits), n_row[k], p, m, recip);
      imp_row[k] = i;
      ncl_row[k] = binomial_walk(lane_uniform(k_click, k, bits), candidates(i), bctr[k], m, recip);
    }
  }
  const unsigned long long clocks = stage_clock() - start;
  st.add(kCountsClocks, clocks);
  if (t == 0) st.add(kCountsClocksFirstT, clocks);
  st.flush(lane);
}

// lanes_counts' explicit instance under the exact sampler (EnvConfig()'s
// default day): two warps per env, warp e its t = 0 call pair, warp E + e
// those of t >= 1. split_volume gives each t >= 1 a keyword's daily volume
// // T, 0 or 1 for the explicit keywords' volumes (means of 14 to 29), and
// t = 0 the rest, so one warp per (env, t) spent most of its time on calls
// that draw one word per element (and on each call's keys and rates).
// Where every keyword's count at t >= 1 is 0 or 1, each of those calls'
// elements is an inversion element of count 0 or 1 (the clicks' max(imp,
// 1) is 1); such an element's draw takes at most its first pass's word
// (binomial.cuh: a walk stops once its sum reaches its count, each step
// being at least 1): 0 words and a draw of 0 at count 0, and at count 1 a
// draw of 1 where its first step ceil(log u / log(1 - q)) is 1, else 0. So
// that warp computes each keyword's rates, log(1 - q) and flips once for
// the day (a group of 32 R keywords at a time, into the warp's shared
// memory), derives each sub-timestep's first-pass subkeys one sub-timestep
// a lane (32 sub-timesteps a chunk), and draws the chunk's words 32 a step
// in one flat loop: per sub-timestep the impressions' words of the
// keywords of count 1, then the clicks' of every keyword. Elsewhere (a
// count above 1) it runs its calls one after the other through
// exact_calls, as the t = 0 warp runs its own. Capped for 8 blocks per SM
// (64 registers) it spilled more and measured slower, and so did t = 0's
// inversion subkeys tabled for both calls at once (more spills).
template <int R>
__global__ void __launch_bounds__(32 * kCountsWarps, kCountsBlocks)
    lanes_counts_explicit_kernel(const float* __restrict__ params,
                                 const int* __restrict__ n_auc01,
                                 const long long* __restrict__ keys, long long key_stride,
                                 int* __restrict__ imp, int* __restrict__ ncl, int E, int K,
                                 int T) {
  __shared__ float loop_state[kCountsWarps][kBtFields * R * 32];
  static_assert(kBtFields >= 4, "the flat loop's four tables fit the loop state");
  const int lane = threadIdx.x % 32;
  const long long w = static_cast<long long>(blockIdx.x) * kCountsWarps + threadIdx.x / 32;
  if (w >= 2LL * E) return;
  const unsigned long long start = stage_clock();
  Stats st;
  // warps 0..E-1 take t = 0, the longer ones, dispatched first; E..2E-1 t >= 1
  const bool later = w >= E;
  const int e = static_cast<int>(later ? w - E : w);
  const long long EK = static_cast<long long>(E) * K;
  const long long eK = static_cast<long long>(e) * K;
  const float* bid = params + BID * EK + eK;
  const float* bctr = params + BCTR * EK + eK;
  const float* thresh = params + IMP_THRESH * EK + eK;
  const float* intercept = params + IMP_INTERCEPT * EK + eK;
  const float* slope = params + IMP_SLOPE * EK + eK;
  const auto rate = [&](int k) {
    return threshold_sigmoid(bid[k], thresh[k], intercept[k], slope[k]);
  };
  const int* n_row = n_auc01 + (later ? EK : 0) + eK;
  float* state = loop_state[threadIdx.x / 32];
  const Key ke = load_key(keys, key_stride, e);
  bool small = later;
  for (int k = lane; k < K && small; k += 32) small = n_row[k] == 0 || n_row[k] == 1;
  const bool flat = __all_sync(kFull, small);
  const unsigned long long prologue = stage_clock() - start;
  st.add(kCountsPrologueClocks, prologue);
  if (!later) st.add(kCountsPrologueFirstT, prologue);
  if (flat) {
    const unsigned long long flat_start = stage_clock();
    // per keyword j of the group: log(1 - q) of its impressions' and
    // clicks' elements, how their draws finish (bits 0-1 the impressions'
    // flip and NaN, 2-3 the clicks', 4 a count of 1), and the group's
    // keywords of count 1
    float* log1mq_imp = state;
    float* log1mq_click = state + 32 * R;
    int* flags = reinterpret_cast<int*>(state + 64 * R);
    int* live = reinterpret_cast<int*>(state + 96 * R);
#pragma unroll 1
    for (int g0 = 0; g0 < K; g0 += 32 * R) {
      const int G = min(K - g0, 32 * R);
      int L = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = r * 32 + lane;
        const bool one = j < G && n_row[g0 + j] == 1;
        if (j < G) {
          const BinomialElem ei = binomial_elem(one ? 1.0f : 0.0f, rate(g0 + j), true);
          const BinomialElem ec = binomial_elem(1.0f, bctr[g0 + j], true);
          log1mq_imp[j] = xla_log1p(-ei.q);
          log1mq_click[j] = xla_log1p(-ec.q);
          flags[j] = (ei.flip ? 1 : 0) | (ei.nan_out ? 2 : 0) | (ec.flip ? 4 : 0) |
                     (ec.nan_out ? 8 : 0) | (one ? 16 : 0);
        }
        const unsigned m = __ballot_sync(kFull, one);
        if (one) live[L + __popc(m & ((1u << lane) - 1u))] = j;
        L += __popc(m);
      }
      __syncwarp();
#pragma unroll 1
      for (int t0 = 1; t0 < T; t0 += 32) {
        // lane i: sub-timestep t0 + i's first-pass subkeys, split(k_imp)[0]
        // and split(k_click)[0]
        Key s_imp{0u, 0u}, s_click{0u, 0u};
        if (t0 + lane < T) {
          const Key kt = child(ke, static_cast<uint32_t>(t0 + lane));
          s_imp = child(child(child(kt, 0), 0), 0);
          s_click = child(child(kt, 1), 0);
        }
        // the chunk's words, per sub-timestep the W = L + G of its two
        // calls, 32 a step
        const int W = L + G, tn = min(T - t0, 32);
#pragma unroll 1
        for (int i0 = 0; i0 < tn * W; i0 += 32) {
          const int i = i0 + lane;
          const int tt = i / W, j = i - tt * W;
          const Key si = shfl_key(s_imp, tt & 31), sc = shfl_key(s_click, tt & 31);
          if (i < tn * W) {
            const bool is_imp = j < L;
            const int x = is_imp ? live[j] : j - L;
            const float u = uniform32(bits32(is_imp ? si : sc, static_cast<uint32_t>(g0 + x)));
            const float step =
                ceilf(__fdiv_rn(xla_log(u), is_imp ? log1mq_imp[x] : log1mq_click[x]));
            const int f = flags[x];
            const int fl = is_imp ? f : f >> 2;
            const int inv = step <= 1.0f ? 1 : 0;  // the walk's draw at a count of 1
            const int d = (fl & 2) ? 0 : (fl & 1) ? 1 - inv : inv;
            const long long at = (static_cast<long long>(e) * T + t0 + tt) * K + g0 + x;
            if (is_imp) {
              imp[at] = d;
            } else {
              ncl[at] = d;
              if (!(f & 16)) imp[at] = 0;  // no auction, no impression
            }
          }
        }
#ifdef LANES_STAGE_CLOCKS
        for (int i = 0; i < tn; ++i) {
          BinomialPasses pi, pc;
          pi.inversion = L > 0;
          pi.inversion_words = L;
          pc.inversion = 1;
          pc.inversion_words = G;
          pc.inversion_steps = i == 0 ? (tn * W + 31) / 32 : 0;  // the chunk's, both calls'
          count_passes(st, pi, 1, 0, false);
          count_passes(st, pc, 2, 0, false);
        }
#endif
      }
      __syncwarp();  // the tables, before the next group's
    }
    st.add(kCountsFlatWarps, 1);
    st.add(kCountsFlatClocks, stage_clock() - flat_start);
  } else {
#pragma unroll 1
    for (int t = later ? 1 : 0; t < (later ? T : 1); ++t) {
      const Key kt = child(ke, static_cast<uint32_t>(t));
      const long long call = static_cast<long long>(e) * T + t;
      exact_calls<R>(
          child(child(kt, 0), 0), child(kt, 1), K, rate, [](int i) { return max(i, 1); }, bctr,
          n_row, imp + call * K, ncl + call * K, state, st, t == 0);
    }
  }
  const unsigned long long clocks = stage_clock() - start;
  st.add(kCountsClocks, clocks);
  if (!later) st.add(kCountsClocksFirstT, clocks);
  st.flush(lane);
}

// The pool instance's bidders' calls under the exact sampler
// (implicit_pool_auction's Binomial(max_bidders, participation) per (env,
// t), keyed by k_bidders): one lane per call, each call whole on its lane
// (binomial_lane), the counts into kout for lanes_counts_kernel. A
// warp's lockstep call ran every element through each of the call's P
// BTRS passes, over 32 ceil(K / 32) slots (at the pool's default, n q = 12
// puts every element in BTRS: 4.5 passes of 128 slots at K = 100); here an
// element is tried about 2.4 times, and 32 calls fill a warp.
__global__ void __launch_bounds__(32 * kBiddersWarps, kBiddersBlocks)
    lanes_bidders_kernel(const float* __restrict__ params, const long long* __restrict__ keys,
                         long long key_stride, int* __restrict__ kout, int E, int K, int T) {
  __shared__ Key pass_keys[kBiddersWarps][2 * kLanePassCap][32];
  const long long call = static_cast<long long>(blockIdx.x) * (32 * kBiddersWarps) + threadIdx.x;
  if (call >= static_cast<long long>(E) * T) return;
  const unsigned long long start = stage_clock();
  Stats st;
  const int e = static_cast<int>(call / T), t = static_cast<int>(call % T);
  const long long EK = static_cast<long long>(E) * K;
  const long long eK = static_cast<long long>(e) * K;
  const Key kt = child(load_key(keys, key_stride, e), static_cast<uint32_t>(t));
  const Key k_bidders = child(child(kt, 0), 0);
  const float* max_bidders = params + MAX_BIDDERS * EK + eK;
  const float* participation = params + PARTICIPATION * EK + eK;
  int* k_row = kout + call * K;
  LanePassKeys pass{&pass_keys[threadIdx.x / 32][0][threadIdx.x % 32], Key{0u, 0u}};
  const BinomialPasses passes = binomial_lane(
      k_bidders, K, [&](int k) { return make_float2(max_bidders[k], participation[k]); },
      [&](int k, int x) { k_row[k] = x; }, pass);
  count_passes(st, passes, 0, stage_clock() - start, t == 0);
  st.flush(0);  // every lane its own call's
}

// Dynamic shared memory of a lanes_gate block: per warp the T cost keys
// (first, 8-byte aligned), then per warp its window's buffer of cost-lane
// prefixes and the window cells' totals and wrap flags.
struct GateWindow {
  int pre[kGateCap];  // per-cell running prefixes of lanes 1.. of the window's cells
  int total[32];      // each cell's last prefix
  int wrapped[32];    // 1 where a cell's prefixes passed INT32_MAX
};

size_t gate_smem(int T) {
  return kGateWarps * (static_cast<size_t>(T) * sizeof(Key) + sizeof(GateWindow));
}

// A cell's lane costs in cents: the implicit keywords' truncated Laplace
// (a, b, c, d: loc, scale and the truncation's CDF bounds), or the python
// model's generic_cost of the bid (a: the bid, b: 1 for a phantom cell,
// which costs nothing), lane j at counter j K + k.
struct CellCost {
  float a, b, c, d;
};

template <bool kPython>
__device__ __forceinline__ CellCost cell_cost(float bid, float loc, float scale, int imp) {
  if (kPython) return CellCost{bid, imp == 0 ? 1.0f : 0.0f, 0.0f, 0.0f};
  const float y0 = __fsub_rn(bid, 0.005f);
  return CellCost{loc, scale, laplace_cdf(-y0, loc, scale), laplace_cdf(y0, loc, scale)};
}

template <bool kPython>
__device__ __forceinline__ int lane_cents(Key key, uint32_t ctr, const CellCost& c, int bits) {
  if (kPython) return c.b != 0.0f ? 0 : explicit_cost(false, xla_normal_erfinv(key, ctr), c.a);
  return lane_cost(lane_uniform(key, ctr, bits), c.a, c.b, c.c, c.d);
}

__device__ __forceinline__ CellCost shfl_cost(const CellCost& c, int src) {
  return CellCost{__shfl_sync(kFull, c.a, src), __shfl_sync(kFull, c.b, src),
                  __shfl_sync(kFull, c.c, src), __shfl_sync(kFull, c.d, src)};
}

// One cell's accepted clicks p and spend s at budget B, its lanes drawn 32
// at a time up to its first prefix over B: a cell too deep for the buffer,
// or one whose lanes stage A skipped.
template <bool kPython>
__device__ void walk_cell(Key key, int n, int k, int K, const CellCost& cc, int bits, int B,
                          int lane, int& p, int& s) {
  p = 0;
  s = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    int v = 0;
    if (j < n) v = lane_cents<kPython>(key, static_cast<uint32_t>(j) * K + k, cc, bits);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v = wrap_add(v, up);
    }
    const int pre = wrap_add(s, v);
    const unsigned over = __ballot_sync(kFull, j < n && pre > B);
    if (over != 0u) {
      const int first = __ffs(over) - 1;
      const int before = __shfl_sync(kFull, pre, first > 0 ? first - 1 : 0);
      p = j0 + first;
      s = first > 0 ? before : s;
      return;
    }
    const int last = (n - j0 < 32 ? n - j0 : 32) - 1;
    s = __shfl_sync(kFull, pre, last);
    p = j0 + last + 1;
  }
}

// One warp per env: the cells in (t, k) order. A cell accepts its longest
// prefix of clicks whose running cost sums all stay <= the budget; the day
// breaks once the budget is <= 0, and no cell at or past the break is
// written (n_sim counts the simulated cells). The python instance
// (kPython) draws the python model's cents and reads the impressions
// (imp) for its phantom cells.
template <bool kPython>
__global__ void __launch_bounds__(32 * kGateWarps)
    lanes_gate_kernel(const float* __restrict__ params, const long long* __restrict__ keys,
                      long long key_stride, const int* __restrict__ ncl,
                      const int* __restrict__ imp, const int* __restrict__ budget_c,
                      int* __restrict__ acc,
                      int* __restrict__ spend, int* __restrict__ n_sim, int E, int K, int T,
                      int m0, int m1, int bits) {
  extern __shared__ unsigned long long gate_smem_raw[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * kGateWarps + w;
  if (e >= E) return;
  Stats st;
  Key* tkeys = reinterpret_cast<Key*>(gate_smem_raw) + static_cast<size_t>(w) * T;
  GateWindow& win =
      reinterpret_cast<GateWindow*>(reinterpret_cast<Key*>(gate_smem_raw) + kGateWarps * T)[w];
  const long long EK = static_cast<long long>(E) * K;
  const long long eK = static_cast<long long>(e) * K;
  const int TK = T * K;
  const int* ncl_e = ncl + static_cast<long long>(e) * TK;
  const int* imp_e = kPython ? imp + static_cast<long long>(e) * TK : nullptr;
  int* acc_e = acc + static_cast<long long>(e) * TK;
  int* spend_e = spend + static_cast<long long>(e) * TK;

  unsigned long long mark = stage_clock();
  const auto lap = [&](int stage) {
    const unsigned long long now = stage_clock();
    st.add(stage, now - mark);
    mark = now;
  };
  // the per-t cost keys, a sub-timestep per lane
  const Key kc = load_key(keys, key_stride, e);
  for (int t = lane; t < T; t += 32) {
    tkeys[t] = child(child(child(kc, static_cast<uint32_t>(t)), 0), 1);
  }
  // a window's clicks and keyword parameters, loaded one window ahead
  int ld_cell = -1, ld_n = 0, ld_imp = 1;
  float ld_bid = 0.0f, ld_loc = 0.0f, ld_scale = 1.0f;
  int t0 = 0, k0 = 0;  // the next cell to decide, as t0 K + k0
  // (t, k) of the cell `add` after t0 K + k0, without a division
  const auto cell_tk = [&](int add, int& t, int& k) {
    t = t0;
    k = k0 + add;
    while (k >= K) {
      k -= K;
      ++t;
    }
  };
  const auto load = [&](int start, int add) {
    const int c = start + lane;
    if (c < TK) {
      int t, k;
      cell_tk(add + lane, t, k);
      ld_n = ncl_e[c];
      ld_bid = params[BID * EK + eK + k];
      if (kPython) {
        ld_imp = imp_e[c];
      } else {
        ld_loc = params[LOC * EK + eK + k];
        ld_scale = params[SCALE * EK + eK + k];
      }
    }
    ld_cell = start;
  };
  load(0, 0);
  __syncwarp();
  lap(kGateKeyClocks);

  int B = budget_c[e];
  int cell = 0;  // the next cell to decide
  bool broken = false;
  while (cell < TK && !broken) {
    __syncwarp();  // the last window's reads of the buffer are done
    // ---- stage A: the window from `cell`, lane i its cell i
    if (ld_cell != cell) load(cell, 0);
    const int c = cell + lane;
    const bool in = c < TK;
    int t, k;
    cell_tk(lane, t, k);
    if (!in) t = k = 0;
    const int n = in ? min(max(ld_n, 0), t == 0 ? m0 : m1) : 0;  // lanes past m do not exist
    const CellCost cc = cell_cost<kPython>(ld_bid, ld_loc, ld_scale, ld_imp);
    load(cell + 32, 32);  // the next window, if this one takes all 32 cells
    // each cell's first lane; the rest only where the first is within the
    // budget (a cell whose first lane is over it accepts nothing while the
    // budget does not grow)
    const Key key = tkeys[t];
    const int first = n > 0 ? lane_cents<kPython>(key, static_cast<uint32_t>(k), cc, bits) : 0;
    const bool skipped = n > 1 && first > B;
    const int rest = n > 1 && !skipped ? n - 1 : 0;
    int end = min(rest, kGateCap + 1);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end = min(end + up, kGateCap + 1);
    }
    const int off = end - rest;
    const unsigned fits = __ballot_sync(kFull, in && end <= kGateCap);
    const int nc = fits == kFull ? 32 : __ffs(~fits) - 1;
    if (nc == 0) {  // a deep cell: more lanes than the buffer
      int p, s;
      walk_cell<kPython>(shfl_key(key, 0), __shfl_sync(kFull, n, 0), __shfl_sync(kFull, k, 0),
                         K, shfl_cost(cc, 0), bits, B, lane, p, s);
      if (lane == 0) {
        acc_e[cell] = p;
        spend_e[cell] = s;
      }
      st.add(kGateDeep, 1);
      B = wrap_sub(B, s);
      ++cell;
      cell_tk(1, t0, k0);
      broken = B <= 0;
      lap(kGateAClocks);
      continue;
    }
#ifdef LANES_STAGE_CLOCKS
    st.add(kGateWindows, 1);
    if (nc < 32 && __shfl_sync(kFull, in, nc)) st.add(kGateCut, 1);
    st.add(kGateSkipped, __popc(__ballot_sync(kFull, lane < nc && skipped)));
    st.add(kGateLanes, __popc(__ballot_sync(kFull, n > 0)));
#endif
    win.wrapped[lane] = 0;
    __syncwarp();
    // the window's lanes after the first, 32 a step: buffer lane g belongs
    // to the last cell whose offset is <= g (bisection over the offsets);
    // a cell's prefix is its first lane plus the running sum since the
    // cell began, and a prefix below the one before marks a wrap
    const int lanes = __shfl_sync(kFull, end, nc - 1);
    st.add(kGateLanes, lanes);
    const int off_key = lane < nc ? off : 0x7FFFFFFF;
    int run = 0, carry_cell = -1, carry_base = 0, carry_pre = 0;
    for (int g0 = 0; g0 < lanes; g0 += 32) {
      const int g = g0 + lane;
      int i = 0;
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) {
        if (__shfl_sync(kFull, off_key, i + s) <= g) i += s;
      }
      const int off_i = __shfl_sync(kFull, off, i);
      const int j = g - off_i + 1;  // the cell's lane, from 1
      const int ki = __shfl_sync(kFull, k, i), ni = __shfl_sync(kFull, n, i);
      const int first_i = __shfl_sync(kFull, first, i);
      const Key key_i = shfl_key(key, i);
      const CellCost cc_i = shfl_cost(cc, i);
      int v = 0;
      if (g < lanes) v = lane_cents<kPython>(key_i, static_cast<uint32_t>(j) * K + ki, cc_i, bits);
      int S = v;  // the running sum over the window's lanes, wrapping
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, S, d);
        if (lane >= d) S = wrap_add(S, up);
      }
      S = wrap_add(S, run);
      // the running sum before the cell's first lane after its first
      const int head = __shfl_sync(kFull, wrap_sub(S, v), max(off_i - g0, 0));
      const int base = off_i >= g0 ? head : carry_base;
      const int pre = wrap_add(first_i, wrap_sub(S, base));
      const int up_pre = __shfl_up_sync(kFull, pre, 1);
      const int before = j == 1 ? first_i : lane > 0 ? up_pre : carry_pre;
      if (g < lanes) {
        win.pre[g] = pre;
        if (pre < before) win.wrapped[i] = 1;
        if (j == ni - 1) win.total[i] = pre;
      }
      run = __shfl_sync(kFull, S, 31);
      carry_cell = __shfl_sync(kFull, i, 31);
      carry_base = __shfl_sync(kFull, base, 31);
      carry_pre = __shfl_sync(kFull, pre, 31);
    }
    __syncwarp();
    // each window cell's total, and whether its prefixes are known and
    // below their total (no wrap), which a run of whole cells needs
    const int total = rest > 0 ? win.total[lane] : first;
    const bool plain = !skipped && !(rest > 0 && win.wrapped[lane]);
    lap(kGateAClocks);

    // ---- stage B: the window's decisions from cell q of the window on
    int q = 0;
    while (q < nc) {
      const bool inq = lane + q < nc;  // lane l looks at window cell q + l
      const int n_l = __shfl_down_sync(kFull, n, q);
      const int total_s = __shfl_down_sync(kFull, total, q);
      const int total_l = inq ? total_s : 0;
      const int first_l = __shfl_down_sync(kFull, first, q);
      const bool plain_l = __shfl_down_sync(kFull, plain, q);
      int S = total_l;  // totals of cells q..q+l, for a run of whole cells
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, S, d);
        if (lane >= d) S = wrap_add(S, up);
      }
      const int B_l = wrap_sub(B, wrap_sub(S, total_l));
      const unsigned whole = __ballot_sync(
          kFull, inq && plain_l && total_l <= B_l && wrap_sub(B_l, total_l) > 0);
      const unsigned passive = __ballot_sync(kFull, inq && B > 0 && (n_l == 0 || first_l > B));
      const int n_whole = whole == kFull ? 32 : __ffs(~whole) - 1;
      const int n_passive = passive == kFull ? 32 : __ffs(~passive) - 1;
      const int span = max(n_whole, n_passive);
      const bool take = n_whole >= n_passive;
      if (lane < span) {
        acc_e[cell + q + lane] = take ? n_l : 0;
        spend_e[cell + q + lane] = take ? total_l : 0;
      }
      if (take && span > 0) B = wrap_sub(B, __shfl_sync(kFull, S, span - 1));
      st.add(take ? kGateWhole : kGatePassive, span);
      q += span;
      if (q >= nc) break;
      // window cell q, decided alone
      const int n_a = __shfl_sync(kFull, n, q), total_a = __shfl_sync(kFull, total, q);
      const int first_a = __shfl_sync(kFull, first, q);
      const bool plain_a = __shfl_sync(kFull, plain, q);
      const bool skipped_a = __shfl_sync(kFull, skipped, q);
      int p, s;
      if (n_a == 0 || first_a > B) {
        p = s = 0;
        st.add(kGateAlonePassive, 1);
      } else if (skipped_a) {  // the budget grew past its first lane: its lanes now
        walk_cell<kPython>(shfl_key(key, q), n_a, __shfl_sync(kFull, k, q), K, shfl_cost(cc, q),
                           bits, B, lane, p, s);
        st.add(kGateRedrawn, 1);
      } else if (plain_a && total_a <= B) {  // every prefix within the budget
        p = n_a;
        s = total_a;
        st.add(kGateAloneWhole, 1);
      } else {  // the first prefix over the budget, 32 lanes a step
        const int off_a = __shfl_sync(kFull, off, q);
        p = n_a;
        for (int j0 = 1; j0 < n_a; j0 += 32) {
          const int j = j0 + lane;
          const unsigned over = __ballot_sync(kFull, j < n_a && win.pre[off_a + j - 1] > B);
          if (over != 0u) {
            p = j0 + __ffs(over) - 1;
            break;
          }
        }
        s = p == n_a ? total_a : p == 1 ? first_a : win.pre[off_a + p - 2];
        st.add(kGateResolved, 1);
      }
      if (lane == 0) {
        acc_e[cell + q] = p;
        spend_e[cell + q] = s;
      }
      B = wrap_sub(B, s);
      ++q;
      if (B <= 0) {
        broken = true;
        break;
      }
    }
    cell += q;
    cell_tk(q, t0, k0);
    lap(kGateBClocks);
  }
  if (lane == 0) n_sim[e] = cell;
  st.add(kGateWarpsRun, 1);
  st.add(kGateSimulated, cell);
  st.flush(lane);
}

// ---- lanes_gate_float: the rust model's float32 gate ----

constexpr int kFloatCap = 256;    // lanes of a float gate window, a warp's shared buffer
// lanes_gate_float blocks per SM its registers are capped for: 64
// registers and a few bytes of spills; uncapped it takes 72 registers,
// no spills and 7 blocks per SM, and measured slower (its pool mode too)
constexpr int kFloatBlocks = 8;
constexpr int kScanFixed = 256;   // a sub-timestep's spends before the first whose zero may
                                  // move XLA's scan (a 16-block's start past element 256)

// A float gate warp's window: its cells' lanes after the first, drawn
// densely, then each cell's prefixes of them in XLA's order, in place;
// and each window cell's lanes, first lane, total, largest prefix (the
// pool's, whose lanes can be negative; the rust model's is its total) and
// offset in pre.
struct FloatWindow {
  float pre[kFloatCap];  // prefix j + 1 of a cell's lanes at off + j - 1, j >= 1
  float first[32], total[32], peak[32];
  int n[32], off[32];
};

// the pool mode keeps each keyword's F(bid) in shared memory, computed
// once per env, for up to kFloatBidTable keywords (more: once per window)
constexpr int kFloatBidTable = 2048;

size_t gate_float_smem(int T, int K, bool pool) {
  const size_t table = pool && K <= kFloatBidTable ? K * sizeof(float) : 0;
  return kGateWarps * (static_cast<size_t>(T) * sizeof(Key) + sizeof(FloatWindow) + table);
}

// A float gate cell's lane law: the rust model's bid (a) and whether it
// is a phantom cell (d != 0), or the pool's F(bid), loc, scale (a, b, c)
// and its bidder count's reciprocal (d, pool_recip: computed once a cell,
// not once a lane).
struct FloatCost {
  float a, b, c, d;
};

__device__ __forceinline__ FloatCost shfl_float_cost(const FloatCost& c, int src) {
  return FloatCost{__shfl_sync(kFull, c.a, src), __shfl_sync(kFull, c.b, src),
                   __shfl_sync(kFull, c.c, src), __shfl_sync(kFull, c.d, src)};
}

// lanes_day.cost_dollars: one rust lane cost, cost_create at the lane's
// normal, 0 for a phantom cell; or lanes_day.cost_pool_dollars: one pool
// lane cost at the lane's 32-bit uniform
template <bool kPool>
__device__ __forceinline__ float float_lane(Key key, uint32_t ctr, const FloatCost& c) {
  if (kPool) return pool_cost_inv(lane_uniform(key, ctr, 32), c.a, c.b, c.c, c.d);
  return c.d != 0.0f ? 0.0f : cost_create_e(xla_normal_erfinv(key, ctr), c.a);
}

// One cell's accepted clicks p and spend s at budget B from its lanes
// drawn 32 at a time, their prefixes scanned in XLA's order by every lane
// alike, up to the first prefix over B: a cell too deep for the window's
// buffer, or one whose lanes stage A skipped.
template <bool kPool>
__device__ void walk_cell_float(Key key, int n, int k, int K, const FloatCost& cc, float B,
                                int lane, int& p, float& s) {
  XlaScan<false> scan;
  p = n;
  s = 0.0f;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const float x = j0 + lane < n
                        ? float_lane<kPool>(key, static_cast<uint32_t>(j0 + lane) * K + k, cc)
                        : 0.0f;
    const int live = min(n - j0, 32);
    for (int i = 0; i < live; ++i) {
      const float pre = scan.push(__shfl_sync(kFull, x, i));
      if (pre > B) {
        p = j0 + i;
        return;
      }
      s = pre;
    }
  }
}

// One warp per env: _gate_keywords_jacobi (step.py:152), which JAX runs
// per sub-timestep for costs that are not cents, in float32 dollars. Its
// fixed point is unique, since a cell depends only on the cells before it,
// so one pass in (t, k) order finds it, provided every sum is XLA's: cell
// k starts from B_k = b - excl_k, excl the XLA scan (blocks of 16) of the
// sub-timestep's spends before k; it accepts its longest run of lanes
// whose prefixes (the XLA scan of its lane costs) are <= B_k, and is
// simulated if no cell before it in the sub-timestep left B_j - spend_j <=
// 0 ("alive"); the next sub-timestep starts from b - (the scan of all K
// spends, 0 for a cell not simulated), and the day breaks after a
// sub-timestep in which b - (the scan up to some cell) <= 0. A cell not
// simulated before a later simulated one gets accepted clicks -1. It
// writes every cell of the sub-timesteps it walks (to the end of the one
// after which the day breaks, or all T K), and no other.
//
// The decisions form one chain of float sums in XLA's order, so what
// bounds the walk is the work per cell of that chain. Stage A (all 32
// lanes) takes a window of up to 32 cells: each cell's first lane and, for
// the cells whose first lane is within the budget, its other lanes
// densely into the warp's buffer, where each cell's lane then scans its
// own lanes in XLA's order; each cell's lanes, first lane and total go to
// shared memory. Stage B decides the window from cell q on in rounds:
// each lane guesses its cell's spend from the current B (0 if passive: no
// click or a first lane over B; else its total), the lanes scan the
// guesses in XLA's order (a block's elements in order, each lane adding
// its block's guesses before it, at most 15; the blocks' totals up a level
// as XlaScan sends them), so each lane has its cell's exact B_k if every
// guess before it holds; one ballot then takes the run of cells whose
// decision at their B_k is the guess (passive, or whole with B_k - total >
// 0). A cell that breaks the run is decided alone (partial, by one ballot
// over its prefixes; deep or redrawn, by its lanes drawn 32 at a time: a
// cell skipped in stage A whose first lane a grown budget admits). Once a
// cell has stopped the sub-timestep, the rest of it is not simulated: one
// run, the spend scan skipping its zeros in closed form (a finished
// block's unchanged total up a level, XlaScan::skip_zeros); past element
// 256 of a sub-timestep a zero that starts a block of 16 takes the next
// level's carry, which adds the blocks' totals in another order and can
// move the scan's value, so such a run ends there and the day's break is
// tested on every value. The first form of this kernel's stage B took
// only runs of passive cells by one ballot and every other cell alone:
// at $1000 a third of the cells are whole and none partial, and it
// measured 0.99 against the first version's 1.04 ms (chip_smoke.py phase
// 12's stage clocks: stage B 1.29M SM clocks per warp against 1.40M, for
// 2.98M whole cells alone), so the runs take whole cells too.
//
// The pool mode (kPool, the binomial pool: aux is its cells' bidder
// counts, not the impressions) draws the pool's lanes from k_cost =
// split(k_auc, 3)[2], F(bid) with cent_bids as the env's program computes
// it. Its lanes can be negative, so a cell's prefixes can
// fall after one over the budget, and the budget can grow: a cell is
// whole where its largest prefix, not its total, is within B_k, and a
// cell that stage A skipped (first lane over the budget then) is drawn
// alone if a grown budget admits its first lane.
template <bool kPool>
__global__ void __launch_bounds__(32 * kGateWarps, kFloatBlocks)
    lanes_gate_float_kernel(const float* __restrict__ params, const long long* __restrict__ keys,
                            long long key_stride, const int* __restrict__ ncl,
                            const int* __restrict__ aux, const float* __restrict__ budget,
                            int* __restrict__ acc, float* __restrict__ spend,
                            int* __restrict__ n_sim, int E, int K, int T, int m0, int m1,
                            int cent_bids) {
  extern __shared__ unsigned long long gate_smem_raw[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * kGateWarps + w;
  if (e >= E) return;
  Stats st;
  unsigned long long mark = stage_clock();
  const auto lap = [&](int stage) {
    const unsigned long long now = stage_clock();
    st.add(stage, now - mark);
    mark = now;
  };
  Key* tkeys = reinterpret_cast<Key*>(gate_smem_raw) + static_cast<size_t>(w) * T;
  FloatWindow* windows =
      reinterpret_cast<FloatWindow*>(reinterpret_cast<Key*>(gate_smem_raw) + kGateWarps * T);
  FloatWindow& win = windows[w];
  float* f_table = reinterpret_cast<float*>(windows + kGateWarps) + static_cast<size_t>(w) * K;
  const long long EK = static_cast<long long>(E) * K;
  const long long eK = static_cast<long long>(e) * K;
  const int TK = T * K;
  const int* ncl_e = ncl + static_cast<long long>(e) * TK;
  const int* aux_e = aux + static_cast<long long>(e) * TK;
  int* acc_e = acc + static_cast<long long>(e) * TK;
  float* spend_e = spend + static_cast<long long>(e) * TK;
  const Key kc = load_key(keys, key_stride, e);
  for (int t = lane; t < T; t += 32) {  // k_cost
    tkeys[t] = child(child(child(kc, static_cast<uint32_t>(t)), 0), kPool ? 2 : 1);
  }
  // the pool's F(bid) of keyword k (bid_cdf, the same at every t)
  const bool bid_table = kPool && K <= kFloatBidTable;
  const auto f_bid = [&](int k) {
    return bid_cdf(params[BID * EK + eK + k], params[LOC * EK + eK + k],
                   params[SCALE * EK + eK + k], cent_bids != 0);
  };
  if (bid_table) {
    for (int k = lane; k < K; k += 32) f_table[k] = f_bid(k);
  }
  __syncwarp();

  float b = budget[e];  // the sub-timestep's budget
  float B = b;          // the next cell's, b - excl
  XlaScan<false> excl;  // the sub-timestep's spends so far
  float V = 0.0f;       // the scan's value after them (b - V is B)
  bool alive = true;    // no cell of the sub-timestep has left B - spend <= 0
  bool low = false;     // some b - (scan up to a cell) <= 0 in the sub-timestep
  bool broken = false;
  int cell = 0, nsim = 0;
  int t0 = 0, k0 = 0;  // the next cell as t0 K + k0
  const auto cell_tk = [&](int add, int& t, int& k) {
    t = t0;
    k = k0 + add;
    while (k >= K) {
      k -= K;
      ++t;
    }
  };
  while (cell < TK && !broken) {
    // ---- stage A: the window from `cell`, lane i its cell i
    const int c = cell + lane;
    const bool in = c < TK;
    int t, k;
    cell_tk(lane, t, k);
    if (!in) t = k = 0;
    const int n = in ? min(max(ncl_e[c], 0), t == 0 ? m0 : m1) : 0;
    const float bid = params[BID * EK + eK + k];
    FloatCost cost{bid, 0.0f, 0.0f, in && aux_e[c] == 0 ? 1.0f : 0.0f};
    if (kPool) {
      const float loc = params[LOC * EK + eK + k], scale = params[SCALE * EK + eK + k];
      cost = FloatCost{bid_table ? f_table[k] : f_bid(k), loc, scale,
                       pool_recip(in ? aux_e[c] : 0)};
    }
    const Key key = tkeys[t];
    const float first = n > 0 ? float_lane<kPool>(key, static_cast<uint32_t>(k), cost) : 0.0f;
    const int rest = n > 1 && first <= B ? n - 1 : 0;  // first > B: accepts nothing from here on
    int end = min(rest, kFloatCap + 1);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end = min(end + up, kFloatCap + 1);
    }
    const int off = end - rest;
    const unsigned fits = __ballot_sync(kFull, in && end <= kFloatCap);
    // a deep cell (more lanes than the buffer) is a window of its own,
    // whose lanes stage B draws
    const bool deep = fits == 0u;
    const int nc = deep ? 1 : fits == kFull ? 32 : __ffs(~fits) - 1;
    float total = first, peak = first;
    if (!deep) {
      // the window's lanes after the first, drawn 32 a step (buffer lane
      // g belongs to the last cell whose offset is <= g), then each
      // cell's prefixes scanned by its own lane
      const int lanes = __shfl_sync(kFull, end, nc - 1);
      st.add(kFloatLanes, lanes);
      const int off_key = lane < nc ? off : 0x7FFFFFFF;
      for (int g0 = 0; g0 < lanes; g0 += 32) {
        const int g = g0 + lane;
        int i = 0;
#pragma unroll
        for (int sh = 16; sh >= 1; sh >>= 1) {
          if (__shfl_sync(kFull, off_key, i + sh) <= g) i += sh;
        }
        const int j = g - __shfl_sync(kFull, off, i) + 1;  // the cell's lane, from 1
        const int ki = __shfl_sync(kFull, k, i);
        const Key key_i = shfl_key(key, i);
        const FloatCost cost_i = shfl_float_cost(cost, i);
        if (g < lanes) win.pre[g] = float_lane<kPool>(key_i, static_cast<uint32_t>(j) * K + ki,
                                                      cost_i);
      }
      __syncwarp();
      if (lane < nc && rest > 0) {
        XlaScan<false> scan;
        scan.push(first);
        for (int j = 1; j < n; ++j) {
          total = scan.push(win.pre[off + j - 1]);
          win.pre[off + j - 1] = total;
          if (kPool) peak = fmaxf(peak, total);
        }
      }
    }
    // cells whose lanes stage B draws: the deep one, and those skipped here
    // that a grown budget admits
    const unsigned walk = __ballot_sync(kFull, lane < nc && n > 1 && (deep || rest == 0));
    if (lane < nc) {
      win.n[lane] = n;
      win.first[lane] = first;
      win.total[lane] = total;
      if (kPool) win.peak[lane] = peak;
      win.off[lane] = off;
    }
    __syncwarp();
    st.add(kFloatWindows, 1);
    lap(kFloatAClocks);

    // ---- stage B: the window's cells from q on, in runs or alone
    int my_p = 0;
    float my_s = 0.0f;
    const int start = cell;
    int q = 0, kq = k0;  // window cell q is sub-timestep cell kq
    while (q < nc && !broken) {
      const int room = min(nc - q, K - kq);  // the window's cells left in the sub-timestep
      int run = 0;
      if (!alive) {  // not simulated: -1, a zero spend; the run ends at the
                     // first cell that may move the scan
        run = kq + room <= kScanFixed
                  ? room
                  : min(room, (kq <= kScanFixed ? kScanFixed : (kq + 15) & ~15) - kq + 1);
        if (lane >= q && lane < q + run) my_p = -1;
        st.add(kFloatDead, run);
        V = excl.skip_zeros(run);
        B = __fsub_rn(b, V);
        low = low || B <= 0.0f;
      } else {
        // guess each cell's spend from B (0 where passive, its total
        // else), scan the guesses in XLA's order across the lanes, and
        // take the run of cells whose decision at their own B_k is the
        // guess: those spends, and so every B_k up to the first miss, are
        // exact
        const bool mine = lane >= q && lane < q + room;
        const bool guess_passive = n == 0 || first > B;
        const float x = mine && !guess_passive ? total : 0.0f;
        const int pos = kq + lane - q;  // the lane's element of the spends' scan
        const int base = kq & ~15;      // the first element of the scan's current block
        const bool based = (kq & 15) != 0 && pos < base + 16;  // continues that block
        const int from = max(q, lane - (pos & 15));            // its block's first lane here
        float wsum = based ? excl.w[0] : 0.0f;
#pragma unroll
        for (int d = 0; d < 16; ++d) {  // the block's running sum, in order
          const int src = from + d;
          const float v = __shfl_sync(kFull, x, src & 31);
          if (src <= lane) wsum = d == 0 && !based ? v : __fadd_rn(wsum, v);
        }
        // the carries of the blocks the round finishes, their totals up a
        // level, the scan left as it is
        const int end0 = q + 15 - (kq & 15);  // the lane that finishes the current block
        const float total0 = __shfl_sync(kFull, wsum, min(end0, 31));
        const float total1 = __shfl_sync(kFull, wsum, min(end0 + 16, 31));
        float carry1, carry2;
        excl.peek_carries(total0, total1, carry1, carry2);
        const float carry = pos >= base + 32 ? carry2 : pos >= base + 16 ? carry1 : excl.carry[0];
        const float incl = pos >= 16 ? __fadd_rn(wsum, carry) : wsum;
        const float up_incl = __shfl_up_sync(kFull, incl, 1);
        const float Bk = __fsub_rn(b, lane == q ? V : up_incl);
        const bool passive = n == 0 || first > Bk;
        const bool ok = mine && Bk > 0.0f &&
                        (passive ? guess_passive
                                 : !guess_passive && !((walk >> lane) & 1u) &&
                                       (kPool ? peak : total) <= Bk &&
                                       __fsub_rn(Bk, total) > 0.0f);
        const unsigned fine = __ballot_sync(kFull, ok) >> q;
        run = min(fine == kFull ? 32 : __ffs(~fine) - 1, room);
        if (run > 0) {
          if (lane >= q && lane < q + run) {
            my_p = passive ? 0 : n;
            my_s = x;
          }
#ifdef LANES_STAGE_CLOCKS
          const unsigned in_run = (run < 32 ? 1u << run : 0u) - 1u;
          const int whole = __popc((__ballot_sync(kFull, !passive) >> q) & in_run);
          const int clickless = __popc((__ballot_sync(kFull, n == 0) >> q) & in_run);
          st.add(kFloatWhole, whole);
          st.add(kFloatNoClick, clickless);
          st.add(kFloatOver, run - whole - clickless);
          st.add(kFloatRuns, 1);
#endif
          // the scan after the run's last cell
          const int last = q + run - 1;
          if (end0 <= last) excl.up(total0);
          if (end0 + 16 <= last) excl.up(total1);
          excl.w[0] = __shfl_sync(kFull, wsum, last);
          excl.count[0] += run;
          V = __shfl_sync(kFull, incl, last);
          B = __fsub_rn(b, V);
          low = low || B <= 0.0f;
          nsim = cell + run;
        }
      }
      if (run == 0) {  // cell q alone
        run = 1;
        const int n_q = win.n[q];
        const float first_q = win.first[q];
        int p = 0;
        float s = 0.0f;
        if (n_q == 0 || first_q > B) {  // accepts nothing (B <= 0 here)
          st.add(n_q == 0 ? kFloatNoClick : kFloatOver, 1);
        } else if ((walk >> q) & 1u) {
          walk_cell_float<kPool>(shfl_key(key, q), n_q, kq, K, shfl_float_cost(cost, q), B, lane,
                                 p, s);
          st.add(deep ? kFloatDeep : kFloatRedrawn, 1);
        } else if ((kPool ? win.peak[q] : win.total[q]) <= B) {  // whole, but B - total <= 0
          p = n_q;
          s = win.total[q];
          st.add(kFloatWhole, 1);
        } else {  // the first prefix over the budget, 32 lanes a step
          const int off_q = win.off[q];
          p = n_q;
          for (int j0 = 1; j0 < n_q; j0 += 32) {
            const int j = j0 + lane;
            const unsigned over = __ballot_sync(kFull, j < n_q && win.pre[off_q + j - 1] > B);
            if (over != 0u) {
              p = j0 + __ffs(over) - 1;
              break;
            }
          }
          s = p == 1 ? first_q : win.pre[off_q + p - 2];
          st.add(kFloatPartial, 1);
        }
        alive = __fsub_rn(B, s) > 0.0f;
        V = excl.push(s);
        B = __fsub_rn(b, V);
        low = low || B <= 0.0f;
        nsim = cell + 1;
        if (lane == q) {
          my_p = p;
          my_s = s;
        }
      }
      cell += run;
      q += run;
      kq += run;
      if (kq == K) {  // the sub-timestep's end: B is b - the scan of all K spends
        kq = 0;
        b = B;
        broken = low;
        low = false;
        alive = true;
        excl = XlaScan<false>();
        V = 0.0f;
      }
    }
    const int decided = cell - start;
    if (lane < decided) {
      acc_e[start + lane] = my_p;
      spend_e[start + lane] = my_s;
    }
    cell_tk(decided, t0, k0);
    lap(kFloatBClocks);
  }
  if (lane == 0) n_sim[e] = nsim;
  st.add(kFloatWarpsRun, 1);
  st.add(kFloatBroken, broken);
  st.flush(lane);
}

// ---- lanes_outcomes: one block per env, warp tiles of cells, per-warp lane rings ----

// A warp's ring of cells whose lanes wait for a draw step. Entry i sits at
// slot i mod kRing; its lanes are the warp's stream positions off .. off + n
// - 1 (positions wrap as uint32; only differences are read). Between tiles
// fewer than 32 lanes wait, so at most 31 entries, and a tile or a flag
// step adds at most 32.
struct LaneRing {
  uint32_t off[kRing];
  int n[kRing];
  int k[kRing];
  int t[kRing];
  int conv[kRing];  // the flag ring: the cell's set flags drawn so far
};

// A ring's cursors, warp-uniform: entries [head, tail) and stream
// positions [head_lane, tail_lane) wait.
struct RingCursor {
  int head = 0, tail = 0;
  uint32_t head_lane = 0, tail_lane = 0;
  __device__ int waiting() const { return static_cast<int>(tail_lane - head_lane); }
};

// Appends this lane's cell to the ring if it has n > 0 lanes, in lane
// order, its lanes after the ring's last.
__device__ __forceinline__ void ring_push(LaneRing& r, RingCursor& c, int n, int k, int t,
                                          int lane) {
  const bool take = n > 0;
  const unsigned mask = __ballot_sync(kFull, take);
  int incl = take ? n : 0;  // inclusive scan of the lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (take) {
    const int slot = (c.tail + __popc(mask & ((1u << lane) - 1u))) & (kRing - 1);
    r.off[slot] = c.tail_lane + static_cast<uint32_t>(incl - n);
    r.n[slot] = n;
    r.k[slot] = k;
    r.t[slot] = t;
    r.conv[slot] = 0;
  }
  c.tail += __popc(mask);
  c.tail_lane += static_cast<uint32_t>(__shfl_sync(kFull, incl, 31));
}

// This lane's place in a draw step of `live` <= 32 lanes from the ring's
// head: stream lane head_lane + lane is lane j of the entry at `slot`,
// whose lanes in this step are [start, end); `done` if its last lane is in
// this step. Lane l loads entry head + l (each entry has a lane, so the
// step's lanes lie in those 32); an OR over the warp of the lanes at which
// they start (the head entry's at 0) gives each lane its entry: the number
// of starts at or below it, less one.
struct StepLane {
  int slot, j, k, t, start, end;
  bool done;
};

__device__ __forceinline__ StepLane step_lane(const LaneRing& r, const RingCursor& c, int live,
                                              int lane) {
  const int e = c.head + lane;
  const int slot_l = e & (kRing - 1);
  const bool valid = e < c.tail;
  const int rel_l = valid ? static_cast<int>(r.off[slot_l] - c.head_lane) : 32;
  const int n_l = valid ? r.n[slot_l] : 0;
  const int k_l = valid ? r.k[slot_l] : 0, t_l = valid ? r.t[slot_l] : 0;
  const unsigned starts = __reduce_or_sync(kFull, rel_l < 32 ? 1u << max(rel_l, 0) : 0u);
  const unsigned upto = starts & (kFull >> (31 - lane));
  const int i = __popc(upto) - 1;
  StepLane out;
  const int rel = __shfl_sync(kFull, rel_l, i), n = __shfl_sync(kFull, n_l, i);
  out.slot = (c.head + i) & (kRing - 1);
  out.j = lane - rel;
  out.k = __shfl_sync(kFull, k_l, i);
  out.t = __shfl_sync(kFull, t_l, i);
  out.start = 31 - __clz(upto);
  out.end = min(rel + n, live);
  out.done = rel + n <= live;
  return out;
}

// A warp's staging ring of drawn revenue uniforms (and their keywords) for
// one branch of XLA's log1p in erf_inv: [0] its rational function, [1] the
// log. Between draw steps fewer than 32 wait; a draw step adds at most 32.
struct ErfStage {
  float u[kRing];
  int k[kRing];
};

// Appends this lane's uniform (if `take`) to the stage, in lane order.
__device__ __forceinline__ void stage_push(ErfStage& st, int& tail, bool take, float u, int k,
                                           int lane) {
  const unsigned mask = __ballot_sync(kFull, take);
  if (take) {
    const int slot = (tail + __popc(mask & ((1u << lane) - 1u))) & (kRing - 1);
    st.u[slot] = u;
    st.k[slot] = k;
  }
  tail += __popc(mask);
}

// The rows of the day sums
enum { kSumImp, kSumClicks, kSumCost, kSumConv, kSumRev, kSumElig, kSums };

// The keywords' constants and the day sums of one env: in shared memory
// (kShared: std already times sqrt(2), sums rows K apart) or in device
// memory (the parameters as given, the sums the output's rows, E K apart).
struct OutTables {
  const float* sctr;
  const float* mean;
  const float* stdv;
  const int* n0;
  const int* n1;
  int* sums;
  long long row;
};

// One flag draw step of `live` lanes: each lane draws its cell's flag
// word; a ballot counts each cell's set flags over its lanes of the step,
// added by the cell's first lane in the step to its count; a cell whose
// last lane is drawn adds its conversions to the keyword's sum and, if it
// converts, joins the revenue ring.
__device__ __forceinline__ void flag_step(LaneRing& fr, RingCursor& fc, LaneRing& rr,
                                          RingCursor& rc, const Key* conv_keys,
                                          const OutTables& tab, int K, int live, int lane) {
  __syncwarp();  // the ring's pushes and the last step's counts are written
  const StepLane s = step_lane(fr, fc, live, lane);
  const bool in = lane < live;
  bool flag = false;
  if (in) {
    const uint32_t ctr = static_cast<uint32_t>(s.j) * static_cast<uint32_t>(K) + s.k;
    flag = uniform32(bits32(conv_keys[s.t], ctr)) <= tab.sctr[s.k];
  }
  const unsigned set = __ballot_sync(kFull, flag);
  const bool first = in && lane == s.start;
  int nconv = 0;
  if (first) {
    const unsigned below_end = s.end == 32 ? kFull : (1u << s.end) - 1u;
    nconv = fr.conv[s.slot] + __popc(set & below_end & ~((1u << s.start) - 1u));
    if (!s.done) fr.conv[s.slot] = nconv;
  }
  const bool finished = first && s.done;
  if (finished && nconv != 0) atomicAdd(&tab.sums[kSumConv * tab.row + s.k], nconv);
  ring_push(rr, rc, finished ? nconv : 0, s.k, s.t, lane);
  fc.head += __popc(__ballot_sync(kFull, finished));
  fc.head_lane += static_cast<uint32_t>(live);
}

// The cursors of a warp's two erf_inv stages, warp-uniform.
struct StageCursor {
  int head[2] = {0, 0}, tail[2] = {0, 0};
  __device__ int waiting(int b) const { return tail[b] - head[b]; }
};

// One revenue draw step of `live` lanes: each lane draws its cell's
// revenue uniform and stages it by the branch of log1p that its erf_inv
// takes, so that an erf_inv step runs one branch on 32 lanes.
__device__ __forceinline__ void revenue_step(const LaneRing& rr, RingCursor& rc,
                                             ErfStage* stage, StageCursor& sc,
                                             const Key* rev_keys, int K, int live, int lane) {
  __syncwarp();  // the ring's pushes are written
  const StepLane s = step_lane(rr, rc, live, lane);
  const bool in = lane < live;
  float u = 0.0f;
  bool rational = false;
  if (in) {
    const uint32_t ctr = static_cast<uint32_t>(s.j) * static_cast<uint32_t>(K) + s.k;
    u = uniform_open(rev_keys[s.t], ctr);
    rational = xla_log1p_rational_at(__fmul_rn(u, -u));
  }
  stage_push(stage[0], sc.tail[0], in && rational, u, s.k, lane);
  stage_push(stage[1], sc.tail[1], in && !rational, u, s.k, lane);
  rc.head += __popc(__ballot_sync(kFull, in && lane == s.end - 1 && s.done));
  rc.head_lane += static_cast<uint32_t>(live);
}

// One erf_inv step of `live` staged uniforms of log1p branch kBranch: each
// lane's normal (XLA's erf_inv polynomial), revenue in cents, added to
// its keyword's sum.
template <bool kShared, int kBranch>
__device__ __forceinline__ void erf_step(const ErfStage& st, StageCursor& sc,
                                         const OutTables& tab, int live, int lane) {
  __syncwarp();  // the stage's pushes are written
  if (lane < live) {
    const int slot = (sc.head[kBranch] + lane) & (kRing - 1);
    const float u = st.u[slot];
    const int k = st.k[slot];
    const float x = __fmul_rn(u, -u);
    const float l1p = kBranch == 0 ? xla_log1p_rational(x) : xla_log(__fadd_rn(x, 1.0f));
    const float std_sqrt2 = kShared ? tab.stdv[k] : __fmul_rn(tab.stdv[k], 1.41421354f);
    const float draw =
        fmaxf(fma32(std_sqrt2, xla_erfinv_of(u, l1p), tab.mean[k]), static_cast<float>(0.01));
    const int v = static_cast<int>(rintf(__fmul_rn(draw, 100.0f)));
    if (v != 0) atomicAdd(&tab.sums[kSumRev * tab.row + k], v);
  }
  sc.head[kBranch] += live;
}

// Dynamic shared memory of a lanes_outcomes block: the keys (k_conv per
// sub-timestep, then k_rev), each warp's flag and revenue rings and its two
// erf_inv stages, and, with
// the tables in shared memory, the keywords' constants (sctr, the revenue
// mean, std sqrt(2), both auction counts) and the six sums.
enum { kTabSctr, kTabMean, kTabStd, kTabN0, kTabN1, kTabRows };

size_t outcomes_smem(int K, int T, bool tables) {
  size_t bytes = sizeof(Key) * 2 * static_cast<size_t>(T) +
                 (sizeof(LaneRing) + sizeof(ErfStage)) * 2 * kOutWarps;
  if (tables) bytes += sizeof(int) * static_cast<size_t>(kTabRows + kSums) * K;
  return bytes;
}

// One block per env: its simulated cells c = t K + k < n_sim in warp tiles
// of 32 consecutive cells (coalesced, each tile's loads issued one tile
// ahead); the cheap sums (impressions, clicks, cost, eligible volume) by
// atomics, zeros skipped; the cells' flag lanes into the warp's flag ring,
// drawn 32 a step whenever 32 wait, each finished cell's revenue lanes
// into the revenue ring, drawn 32 a step whenever 32 wait, their uniforms
// into the erf_inv stages, run 32 a step whenever 32 wait; the partial
// rests drained once at the end. The steps are chains of dependent
// latency (threefry rounds, fused multiply-adds), so registers are
// capped for kOutBlocks blocks (40 warps) per SM, a few spilled. A cell
// whose accepted clicks are -1 (the float gate's) was not simulated. In
// the float mode (spend_f, the rust model's dollars, for spend) each
// keyword's float cost is summed by one thread in XLA's order, t >= 1 in
// order and then t = 0, into cost_f, and the int cost row stays 0.
template <bool kShared>
__global__ void __launch_bounds__(32 * kOutWarps, kOutBlocks)
    lanes_outcomes_kernel(const float* __restrict__ params, const long long* __restrict__ keys,
                          long long key_stride, const int* __restrict__ imp,
                          const int* __restrict__ acc, const int* __restrict__ spend,
                          const float* __restrict__ spend_f, const int* __restrict__ n_sim,
                          const int* __restrict__ n_auc01, int* __restrict__ out,
                          float* __restrict__ cost_f, int E, int K, int T) {
  extern __shared__ unsigned long long out_smem_raw[];
  Key* conv_keys = reinterpret_cast<Key*>(out_smem_raw);
  Key* rev_keys = conv_keys + T;
  LaneRing* rings = reinterpret_cast<LaneRing*>(rev_keys + T);  // [warp][flag, revenue]
  ErfStage* stages = reinterpret_cast<ErfStage*>(rings + 2 * kOutWarps);  // [warp][branch]
  const int e = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long EK = static_cast<long long>(E) * K;
  const long long eK = static_cast<long long>(e) * K;
  Stats st;
  unsigned long long mark = stage_clock();
  const auto lap = [&](int stage) {
    const unsigned long long now = stage_clock();
    st.add(stage, now - mark);
    mark = now;
  };

  // the prologue: the keys of the sub-timesteps with a simulated cell, the
  // keywords' constants and the zeroed sums
  const int nsim = n_sim[e];
  const int t_end = min(T, nsim / K + (nsim % K != 0 ? 1 : 0));
  const Key kc = load_key(keys, key_stride, e);
  for (int j = tid; j < 2 * t_end; j += 32 * kOutWarps) {
    const int t = j < t_end ? j : j - t_end;
    (j < t_end ? conv_keys : rev_keys)[t] = child(child(kc, static_cast<uint32_t>(t)),
                                                  j < t_end ? 2u : 3u);
  }
  OutTables tab;
  if constexpr (kShared) {
    float* kwf = reinterpret_cast<float*>(stages + 2 * kOutWarps);
    int* kwi = reinterpret_cast<int*>(kwf);
    tab = OutTables{kwf + kTabSctr * K, kwf + kTabMean * K, kwf + kTabStd * K, kwi + kTabN0 * K,
                    kwi + kTabN1 * K, kwi + kTabRows * K, K};
    for (int k = tid; k < K; k += 32 * kOutWarps) {
      const long long ek = eK + k;
      kwf[kTabSctr * K + k] = params[SCTR * EK + ek];
      kwf[kTabMean * K + k] = params[REV_MEAN * EK + ek];
      kwf[kTabStd * K + k] = __fmul_rn(params[REV_STD * EK + ek], 1.41421354f);
      kwi[kTabN0 * K + k] = n_auc01[ek];
      kwi[kTabN1 * K + k] = n_auc01[EK + ek];
#pragma unroll
      for (int i = 0; i < kSums; ++i) tab.sums[i * K + k] = 0;
    }
  } else {
    tab = OutTables{params + SCTR * EK + eK, params + REV_MEAN * EK + eK,
                    params + REV_STD * EK + eK, n_auc01 + eK, n_auc01 + EK + eK, out + eK, EK};
    for (int k = tid; k < K; k += 32 * kOutWarps) {
#pragma unroll
      for (int i = 0; i < kSums; ++i) tab.sums[i * EK + k] = 0;
    }
  }
  __syncthreads();
  lap(kOutPrologueClocks);

  LaneRing& fr = rings[2 * warp];
  LaneRing& rr = rings[2 * warp + 1];
  ErfStage* stage = stages + 2 * warp;
  RingCursor fc, rc;
  StageCursor sc;
  const long long row = static_cast<long long>(e) * T * K;
  const int step_t = 32 * kOutWarps / K, step_k = 32 * kOutWarps % K;
  int t = (warp * 32 + lane) / K;
  int k = warp * 32 + lane - t * K;
  int a_next = 0, im_next = 0, sp_next = 0;
  if (warp * 32 + lane < nsim) {
    a_next = acc[row + warp * 32 + lane];
    im_next = imp[row + warp * 32 + lane];
    sp_next = spend != nullptr ? spend[row + warp * 32 + lane] : 0;
  }
  // the erf_inv stages' full steps (at most one each) after a revenue draw
  // step, and with `drain` their rests
  const auto erf_steps = [&](bool drain) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      while (sc.waiting(b) >= 32 || (drain && sc.waiting(b) > 0)) {
        const int live = min(sc.waiting(b), 32);
        if (b == 0) {
          erf_step<kShared, 0>(stage[0], sc, tab, live, lane);
        } else {
          erf_step<kShared, 1>(stage[1], sc, tab, live, lane);
        }
        st.add(kOutErfSteps, 1);
        st.add(kOutErfLogSteps, b);
        st.add(kOutErfPartial, live < 32 ? 1 : 0);
      }
    }
    lap(kOutErfClocks);
  };
  // the revenue ring's full steps after a flag step
  const auto revenue_steps = [&]() {
    while (rc.waiting() >= 32) {
      revenue_step(rr, rc, stage, sc, rev_keys, K, 32, lane);
      st.add(kOutRevSteps, 1);
      st.add(kOutRevLanes, 32);
      lap(kOutRevClocks);
      erf_steps(false);
    }
  };
  for (int base = warp * 32; base < nsim; base += 32 * kOutWarps) {
    const int a = a_next, im = a >= 0 ? im_next : 0, sp = sp_next;
    const int c = base + 32 * kOutWarps + lane;
    const bool in = c < nsim;
    a_next = in ? acc[row + c] : 0;
    im_next = in ? imp[row + c] : 0;
    sp_next = in && spend != nullptr ? spend[row + c] : 0;
    if (im != 0) atomicAdd(&tab.sums[kSumImp * tab.row + k], im);
    if (im >= 1) {
      const int n = t == 0 ? tab.n0[k] : tab.n1[k];
      if (n != 0) atomicAdd(&tab.sums[kSumElig * tab.row + k], n);
    }
    if (a > 0) atomicAdd(&tab.sums[kSumClicks * tab.row + k], a);
    if (sp != 0 && a >= 0) atomicAdd(&tab.sums[kSumCost * tab.row + k], sp);
    // a cell past the tile's end has a = 0, and no flag lane
    ring_push(fr, fc, a > 0 ? a : 0, k, t, lane);
    lap(kOutTileClocks);
    while (fc.waiting() >= 32) {
      flag_step(fr, fc, rr, rc, conv_keys, tab, K, 32, lane);
      st.add(kOutFlagSteps, 1);
      st.add(kOutFlagLanes, 32);
      lap(kOutFlagClocks);
      revenue_steps();
    }
    t += step_t;
    k += step_k;
    if (k >= K) {
      k -= K;
      ++t;
    }
  }
  // the rests, fewer than 32 lanes each: one partial step each
  if (fc.waiting() > 0) {
    const int live = fc.waiting();
    flag_step(fr, fc, rr, rc, conv_keys, tab, K, live, lane);
    st.add(kOutFlagSteps, 1);
    st.add(kOutFlagLanes, live);
    st.add(kOutFlagPartial, 1);
    lap(kOutFlagClocks);
    revenue_steps();
  }
  if (rc.waiting() > 0) {
    const int live = rc.waiting();
    revenue_step(rr, rc, stage, sc, rev_keys, K, live, lane);
    st.add(kOutRevSteps, 1);
    st.add(kOutRevLanes, live);
    st.add(kOutRevPartial, 1);
    lap(kOutRevClocks);
  }
  erf_steps(true);
  if (cost_f != nullptr) {
    for (int j = tid; j < K; j += 32 * kOutWarps) {
      float total = 0.0f;
      for (int t1 = 1; t1 <= T; ++t1) {  // t = 0 last
        const int c = (t1 % T) * K + j;
        if (c < nsim && acc[row + c] >= 0) total = __fadd_rn(total, spend_f[row + c]);
      }
      cost_f[eK + j] = total;
    }
  }
  __syncthreads();
  if constexpr (kShared) {
    for (int j = tid; j < K; j += 32 * kOutWarps) {
#pragma unroll
      for (int i = 0; i < kSums; ++i) out[i * EK + eK + j] = tab.sums[i * K + j];
    }
  }
  lap(kOutWriteClocks);
  st.add(kOutWarpsRun, 1);
  st.flush(lane);
}

// The dynamic shared memory a lanes_outcomes block may take on `device`,
// into *limit; the first call for a device also lets both instances take
// it.
cudaError_t outcomes_configure(int device, int* limit) {
  static std::mutex mu;
  static int limits[kMaxDevices] = {};
  const bool known = device >= 0 && device < kMaxDevices;
  std::lock_guard<std::mutex> lock(mu);
  if (known && limits[device] > 0) {
    *limit = limits[device];
    return cudaSuccess;
  }
  cudaError_t err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(lanes_outcomes_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(lanes_outcomes_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  }
  if (err == cudaSuccess && known) limits[device] = *limit;
  return err;
}

// lanes_outcomes' instance and dynamic shared memory at (K, T) on the
// current device, `device`: the tables in shared memory where a block can
// hold them, else in device memory; an error only if not even the keys and
// rings fit (T in the tens of thousands).
cudaError_t outcomes_plan(int K, int T, int device, bool* tables, size_t* smem) {
  int limit = 0;
  const cudaError_t err = outcomes_configure(device, &limit);
  if (err != cudaSuccess) return err;
  *tables = outcomes_smem(K, T, true) <= static_cast<size_t>(limit);
  *smem = outcomes_smem(K, T, *tables);
  return *smem <= static_cast<size_t>(limit) ? cudaSuccess : cudaErrorInvalidValue;
}

// lanes_counts: imp and ncl (E, T, K); exact 1 for jax.random.binomial, 0
// for the inverse-CDF walk on `bits`-bit uniforms. lanes_counts_explicit_launch
// runs the explicit instance, with the same arguments (under the exact
// sampler lanes_counts_explicit_kernel, two warps per env); lanes_counts_pool_launch
// the pool's, which also writes the bidder counts kout (E, T, K), its ladder
// kmax levels, F(bid) with cent_bids as the env's program computes it;
// under the exact sampler it is two launches, lanes_bidders_kernel's
// bidders' calls, then lanes_counts_kernel's impressions and clicks.
template <int kMode>
int counts_launch(const float* params, const int* n_auc01, const long long* keys,
                  long long key_stride, int* imp, int* ncl, int* kout, int E, int K, int T,
                  int m0, int m1, int bits, int exact, int kmax, int cent_bids, int device,
                  void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || T < 1 || m0 < 1 || m1 < 1 || (kMode == kCountsPool && (kmax < 1 || !kout))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long calls = static_cast<long long>(E) * T;
  const unsigned blocks = static_cast<unsigned>((calls + kCountsWarps - 1) / kCountsWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kMode == kCountsPool && exact) {
    constexpr int threads = 32 * kBiddersWarps;
    const unsigned bidder_blocks = static_cast<unsigned>((calls + threads - 1) / threads);
    lanes_bidders_kernel<<<bidder_blocks, threads, 0, s>>>(params, keys, key_stride, kout, E, K,
                                                            T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slots = K < 32 * kMaxSlots ? (K + 31) / 32 : kMaxSlots;
  static_assert(kMaxSlots == 4, "one instance per slot count");
  if (kMode == kCountsExplicit && exact) {  // two warps per env
    const unsigned env_blocks =
        static_cast<unsigned>((2LL * E + kCountsWarps - 1) / kCountsWarps);
    switch (slots) {
      case 1:
        lanes_counts_explicit_kernel<1><<<env_blocks, 32 * kCountsWarps, 0, s>>>(
            params, n_auc01, keys, key_stride, imp, ncl, E, K, T);
        break;
      case 2:
        lanes_counts_explicit_kernel<2><<<env_blocks, 32 * kCountsWarps, 0, s>>>(
            params, n_auc01, keys, key_stride, imp, ncl, E, K, T);
        break;
      case 3:
        lanes_counts_explicit_kernel<3><<<env_blocks, 32 * kCountsWarps, 0, s>>>(
            params, n_auc01, keys, key_stride, imp, ncl, E, K, T);
        break;
      default:
        lanes_counts_explicit_kernel<4><<<env_blocks, 32 * kCountsWarps, 0, s>>>(
            params, n_auc01, keys, key_stride, imp, ncl, E, K, T);
    }
    return static_cast<int>(cudaGetLastError());
  }
  switch (slots) {
    case 1:
      lanes_counts_kernel<1, kMode><<<blocks, 32 * kCountsWarps, 0, s>>>(
          params, n_auc01, keys, key_stride, imp, ncl, kout, E, K, T, m0, m1, bits, exact, kmax,
          cent_bids);
      break;
    case 2:
      lanes_counts_kernel<2, kMode><<<blocks, 32 * kCountsWarps, 0, s>>>(
          params, n_auc01, keys, key_stride, imp, ncl, kout, E, K, T, m0, m1, bits, exact, kmax,
          cent_bids);
      break;
    case 3:
      lanes_counts_kernel<3, kMode><<<blocks, 32 * kCountsWarps, 0, s>>>(
          params, n_auc01, keys, key_stride, imp, ncl, kout, E, K, T, m0, m1, bits, exact, kmax,
          cent_bids);
      break;
    default:
      lanes_counts_kernel<4, kMode><<<blocks, 32 * kCountsWarps, 0, s>>>(
          params, n_auc01, keys, key_stride, imp, ncl, kout, E, K, T, m0, m1, bits, exact, kmax,
          cent_bids);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gates' checks, device and shared memory: `smem` per block of
// `kernel`, above 48 KB only once allowed
cudaError_t gate_prepare(const void* kernel, int K, int T, int m0, int m1, size_t smem,
                         int device) {
  if (K < 1 || T < 1 || m0 < 1 || m1 < 1 || static_cast<long long>(T) * K > 0x7FFFFFFFLL) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  return err;
}

// lanes_gate: acc and spend (E, T, K) of the simulated cells (t K + k <
// n_sim[e]; the others are not written) and n_sim (E,); the python
// instance reads imp (E, T, K) for its phantom cells.
template <bool kPython>
int gate_launch(const float* params, const long long* keys, long long key_stride, const int* ncl,
                const int* imp, const int* budget_c, int* acc, int* spend, int* n_sim, int E,
                int K, int T, int m0, int m1, int bits, int device, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = gate_smem(T);
  const cudaError_t err = gate_prepare(reinterpret_cast<const void*>(lanes_gate_kernel<kPython>),
                                       K, T, m0, m1, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (E + kGateWarps - 1) / kGateWarps;
  lanes_gate_kernel<kPython><<<blocks, 32 * kGateWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      params, keys, key_stride, ncl, imp, budget_c, acc, spend, n_sim, E, K, T, m0, m1, bits);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPool>
int gate_float_launch(const float* params, const long long* keys, long long key_stride,
                      const int* ncl, const int* aux, const float* budget, int* acc, float* spend,
                      int* n_sim, int E, int K, int T, int m0, int m1, int cent_bids, int device,
                      void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = gate_float_smem(T, K, kPool);
  const cudaError_t err = gate_prepare(
      reinterpret_cast<const void*>(lanes_gate_float_kernel<kPool>), K, T, m0, m1, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (E + kGateWarps - 1) / kGateWarps;
  lanes_gate_float_kernel<kPool>
      <<<blocks, 32 * kGateWarps, smem, static_cast<cudaStream_t>(stream)>>>(
          params, keys, key_stride, ncl, aux, budget, acc, spend, n_sim, E, K, T, m0, m1,
          cent_bids);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` of `device` and returns cudaGetLastError()
// right after the launch (the library's runtime has its own current device).

int lanes_counts_launch(const float* params, const int* n_auc01, const long long* keys,
                        long long key_stride, int* imp, int* ncl, int E, int K, int T, int m0,
                        int m1, int bits, int exact, int device, void* stream) {
  return counts_launch<kCountsImplicit>(params, n_auc01, keys, key_stride, imp, ncl, nullptr, E,
                                        K, T, m0, m1, bits, exact, 0, 0, device, stream);
}

int lanes_counts_explicit_launch(const float* params, const int* n_auc01, const long long* keys,
                                 long long key_stride, int* imp, int* ncl, int E, int K, int T,
                                 int m0, int m1, int bits, int exact, int device, void* stream) {
  return counts_launch<kCountsExplicit>(params, n_auc01, keys, key_stride, imp, ncl, nullptr, E,
                                        K, T, m0, m1, bits, exact, 0, 0, device, stream);
}

int lanes_counts_pool_launch(const float* params, const int* n_auc01, const long long* keys,
                             long long key_stride, int* imp, int* ncl, int* kout, int E, int K,
                             int T, int m0, int m1, int bits, int exact, int kmax, int cent_bids,
                             int device, void* stream) {
  return counts_launch<kCountsPool>(params, n_auc01, keys, key_stride, imp, ncl, kout, E, K, T,
                                    m0, m1, bits, exact, kmax, cent_bids, device, stream);
}

int lanes_gate_launch(const float* params, const long long* keys, long long key_stride,
                      const int* ncl, const int* budget_c, int* acc, int* spend, int* n_sim, int E,
                      int K, int T, int m0, int m1, int bits, int device, void* stream) {
  return gate_launch<false>(params, keys, key_stride, ncl, nullptr, budget_c, acc, spend, n_sim,
                            E, K, T, m0, m1, bits, device, stream);
}

int lanes_gate_python_launch(const float* params, const long long* keys, long long key_stride,
                             const int* ncl, const int* imp, const int* budget_c, int* acc,
                             int* spend, int* n_sim, int E, int K, int T, int m0, int m1, int bits,
                             int device, void* stream) {
  return gate_launch<true>(params, keys, key_stride, ncl, imp, budget_c, acc, spend, n_sim, E, K,
                           T, m0, m1, bits, device, stream);
}

// lanes_gate_float: acc (-1 in a cell not simulated) and spend (E, T, K)
// float32 of the cells in the sub-timesteps up to that of cell n_sim[e] - 1
// (the others are not written), n_sim (E,), one past the last simulated
// cell, from budget (E,) float32 dollars; imp (E, T, K) for the rust
// model's phantom cells. lanes_gate_float_pool_launch runs the pool mode,
// which reads the cells' bidder counts (E, T, K) in imp's place.
int lanes_gate_float_launch(const float* params, const long long* keys, long long key_stride,
                            const int* ncl, const int* imp, const float* budget, int* acc,
                            float* spend, int* n_sim, int E, int K, int T, int m0, int m1,
                            int device, void* stream) {
  return gate_float_launch<false>(params, keys, key_stride, ncl, imp, budget, acc, spend, n_sim,
                                  E, K, T, m0, m1, 0, device, stream);
}

int lanes_gate_float_pool_launch(const float* params, const long long* keys, long long key_stride,
                                 const int* ncl, const int* bidders, const float* budget,
                                 int* acc, float* spend, int* n_sim, int E, int K, int T, int m0,
                                 int m1, int cent_bids, int device, void* stream) {
  return gate_float_launch<true>(params, keys, key_stride, ncl, bidders, budget, acc, spend,
                                 n_sim, E, K, T, m0, m1, cent_bids, device, stream);
}

// Resident blocks per SM of the cost model's (0 implicit, 1 rust, 2
// python, 3 the pool) lanes_counts instance under the exact sampler (at K
// keywords; the pool's lanes_bidders_kernel too, else 0), its gate
// (lanes_gate's instance, or for the rust model and the pool
// lanes_gate_float's, at T sub-timesteps)
// and lanes_outcomes (at K and T), and the gate's and lanes_outcomes'
// dynamic shared memory per block; *out_tables is 1 where lanes_outcomes
// keeps its tables in shared memory.
int lanes_day_occupancy(int model, int K, int T, int device, int* counts_blocks,
                        int* bidders_blocks, int* gate_blocks, long long* gate_smem_bytes,
                        int* out_blocks, long long* out_smem_bytes, int* out_tables) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = K < 32 * kMaxSlots ? (K + 31) / 32 : kMaxSlots;
  if (model < 0 || model > 3) return static_cast<int>(cudaErrorInvalidValue);
  const void* counts[3][4] = {
      {reinterpret_cast<const void*>(lanes_counts_kernel<1, kCountsImplicit>),
       reinterpret_cast<const void*>(lanes_counts_kernel<2, kCountsImplicit>),
       reinterpret_cast<const void*>(lanes_counts_kernel<3, kCountsImplicit>),
       reinterpret_cast<const void*>(lanes_counts_kernel<4, kCountsImplicit>)},
      {reinterpret_cast<const void*>(lanes_counts_explicit_kernel<1>),
       reinterpret_cast<const void*>(lanes_counts_explicit_kernel<2>),
       reinterpret_cast<const void*>(lanes_counts_explicit_kernel<3>),
       reinterpret_cast<const void*>(lanes_counts_explicit_kernel<4>)},
      {reinterpret_cast<const void*>(lanes_counts_kernel<1, kCountsPool>),
       reinterpret_cast<const void*>(lanes_counts_kernel<2, kCountsPool>),
       reinterpret_cast<const void*>(lanes_counts_kernel<3, kCountsPool>),
       reinterpret_cast<const void*>(lanes_counts_kernel<4, kCountsPool>)}};
  const int counts_mode = model == 0 ? kCountsImplicit : model == 3 ? kCountsPool : kCountsExplicit;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(counts_blocks, counts[counts_mode][slots - 1],
                                                      32 * kCountsWarps, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bidders_blocks = 0;
  if (model == 3) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(bidders_blocks, lanes_bidders_kernel,
                                                        32 * kBiddersWarps, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool float_gate = model == 1 || model == 3;
  const void* gate = model == 1   ? reinterpret_cast<const void*>(lanes_gate_float_kernel<false>)
                     : model == 3 ? reinterpret_cast<const void*>(lanes_gate_float_kernel<true>)
                     : model == 2 ? reinterpret_cast<const void*>(lanes_gate_kernel<true>)
                                  : reinterpret_cast<const void*>(lanes_gate_kernel<false>);
  const size_t smem = float_gate ? gate_float_smem(T, K, model == 3) : gate_smem(T);
  *gate_smem_bytes = static_cast<long long>(smem);
  err = gate_prepare(gate, 1, T, 1, 1, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(gate_blocks, gate, 32 * kGateWarps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool tables = false;
  size_t out_smem = 0;
  err = outcomes_plan(K, T, device, &tables, &out_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out_smem_bytes = static_cast<long long>(out_smem);
  *out_tables = tables ? 1 : 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out_blocks,
      tables ? reinterpret_cast<const void*>(lanes_outcomes_kernel<true>)
             : reinterpret_cast<const void*>(lanes_outcomes_kernel<false>),
      32 * kOutWarps, out_smem));
}

#ifdef LANES_STAGE_CLOCKS
// g_lanes_stats summed since the last call into out (kNumStats values),
// synchronizing with the device first; zeroes them.
int lanes_day_stats(int device, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_lanes_stats, sizeof(g_lanes_stats));
  const unsigned long long zero[kNumStats] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_lanes_stats, zero, sizeof(g_lanes_stats));
  return static_cast<int>(err);
}
#endif

// lanes_outcomes: the six (E, K) day sums into out (6, E, K) from the
// simulated cells; any K >= 1 (past a block's shared memory, the keyword
// tables and sums stay in device memory).
static int outcomes_launch(const float* params, const long long* keys, long long key_stride,
                    const int* imp, const int* acc, const int* spend, const float* spend_f,
                    const int* n_sim, const int* n_auc01, int* out, float* cost_f, int E, int K,
                    int T, int m0, int m1, int device, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || T < 1 || m0 < 1 || m1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool tables = false;
  size_t smem = 0;
  err = outcomes_plan(K, T, device, &tables, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables) {
    lanes_outcomes_kernel<true><<<E, 32 * kOutWarps, smem, s>>>(
        params, keys, key_stride, imp, acc, spend, spend_f, n_sim, n_auc01, out, cost_f, E, K, T);
  } else {
    lanes_outcomes_kernel<false><<<E, 32 * kOutWarps, smem, s>>>(
        params, keys, key_stride, imp, acc, spend, spend_f, n_sim, n_auc01, out, cost_f, E, K, T);
  }
  return static_cast<int>(cudaGetLastError());
}

int lanes_outcomes_launch(const float* params, const long long* keys, long long key_stride,
                          const int* imp, const int* acc, const int* spend, const int* n_sim,
                          const int* n_auc01, int* out, int E, int K, int T, int m0, int m1,
                          int device, void* stream) {
  return outcomes_launch(params, keys, key_stride, imp, acc, spend, nullptr, n_sim, n_auc01, out,
                         nullptr, E, K, T, m0, m1, device, stream);
}

// lanes_outcomes' float mode (the rust model): spend_f (E, T, K) float32
// dollars, the float cost sums into cost_f (E, K), out's cost row 0.
int lanes_outcomes_float_launch(const float* params, const long long* keys, long long key_stride,
                                const int* imp, const int* acc, const float* spend_f,
                                const int* n_sim, const int* n_auc01, int* out, float* cost_f,
                                int E, int K, int T, int m0, int m1, int device, void* stream) {
  return outcomes_launch(params, keys, key_stride, imp, acc, nullptr, spend_f, n_sim, n_auc01,
                         out, cost_f, E, K, T, m0, m1, device, stream);
}

const char* lanes_day_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
