// The lanes day on Hopper (sm_90a): three kernels for the three phases of
// adcraft_tpu/step.py:simulate_day (:991) in the JAX package's default
// configuration (cost, conversion and revenue lanes, jax.random.binomial,
// implicit single-competitor keywords). The JAX package left these phases
// to XLA, so no Pallas kernel constrains them:
//
// * lanes_counts replaces _cell_tables' impressions and clicks
//   (run_cell_auctions -> implicit_single_auction, auction.py:126, and the
//   clicks binomial, step.py:934): one warp per (env, sub-timestep), four
//   such warps a block with no block barrier, each binomial one warp-wide
//   lockstep call of K elements, R = ceil(K / 32) slots a lane up to 4
//   (binomial.cuh), or the inverse-CDF walk (sampler "inversion");
// * lanes_gate replaces the cost lanes (implicit_single_auction's truncated
//   Laplace, in cents) and the budget gate over the T K cells in (t, k)
//   order (_gate_keywords, step.py:115; the lazy and Jacobi TPU schedules
//   are bit-identical to it): one warp per env walks the cells through
//   windows of up to 32 (below);
// * lanes_outcomes replaces _append_conv_rev_tables (:953) and phase 3's
//   gathers and sums (:1400-1502): one block per env, one thread per
//   simulated cell at a time, drawing the conversion flags below the
//   accepted clicks and the revenue below the conversions, with integer
//   atomics into the keywords' sums in shared memory.
//
// The plain PyTorch versions are adcraft_tpu_torch/lanes_day.py:
// lanes_counts_reference, lanes_gate_reference, lanes_outcomes_reference.
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
// polynomial and its log1p); all three issue more instructions than the
// work needs, lanes_gate most of all, since its decisions are one chain per
// env. The gate's window splits the chain: stage A (all 32 lanes) takes up
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
// (binomial.cuh).
//
// Built with -DLANES_STAGE_CLOCKS (chip_smoke.py builds it so beside the
// plain build), lane 0 of each warp also counts its SM clocks per stage
// and the walk's cells and the loops' passes into g_lanes_stats, read with
// lanes_day_stats.

#include <cuda_runtime.h>
#include <stdint.h>

#include "binomial.cuh"
#include "jax_random.cuh"
#include "threefry.cuh"
#include "xla_math.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCountsWarps = 4;       // (env, t) calls per lanes_counts block, one warp each
constexpr int kMaxSlots = 4;          // R, the slots a lane holds of a group of 32 R elements
constexpr int kCountsBlocks = 5;      // lanes_counts blocks per SM its registers are capped for
constexpr int kGateWarps = 4;         // envs per lanes_gate block, one warp each
constexpr int kGateCap = 256;         // cost lanes of a window, a warp's shared buffer
constexpr int kOutcomeThreads = 256;  // threads of a lanes_outcomes block
constexpr int kIntMin = static_cast<int>(0x80000000u);

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
  kNumStats
};

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

__device__ __forceinline__ void count_passes(Stats& st, const BinomialPasses& p) {
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

// One warp per (env, sub-timestep): the impressions' call, then the clicks'
// on those impressions. R slots a lane; a call of more than 32 R keywords
// runs in groups (binomial.cuh).
template <int R>
__global__ void __launch_bounds__(32 * kCountsWarps, kCountsBlocks)
    lanes_counts_kernel(const float* __restrict__ params, const int* __restrict__ n_auc01,
                        const long long* __restrict__ keys, long long key_stride,
                        int* __restrict__ imp, int* __restrict__ ncl, int E, int K, int T, int m0,
                        int m1, int bits, int exact) {
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
  const Key k_imp = child(k_auc, 0);
  const float* bid = params + BID * EK + eK;
  const float* loc = params + LOC * EK + eK;
  const float* scale = params + SCALE * EK + eK;
  const float* bctr = params + BCTR * EK + eK;
  const int* n_row = n_auc01 + (t == 0 ? 0 : EK) + eK;
  int* imp_row = imp + call * K;
  int* ncl_row = ncl + call * K;
  if (exact) {
    // the impressions' call, then the clicks' on them, through one copy of
    // the binomial's code; a lane reads back only the impressions it wrote
    __shared__ float loop_state[kCountsWarps][kBtFields * R * 32];
    int im[R];
    const bool one_group = K <= 32 * R;
#pragma unroll 1
    for (int which = 0; which < 2; ++which) {
      const bool clicks = which == 1;
      int* row = clicks ? ncl_row : imp_row;
      count_passes(st, binomial_warp<R>(
          clicks ? k_click : k_imp, K,
          [&](int k, int r) {
            if (clicks) {
              return make_float2(static_cast<float>(one_group ? im[r] : imp_row[k]), bctr[k]);
            }
            return make_float2(static_cast<float>(n_row[k]), win_prob(bid[k], loc[k], scale[k]));
          },
          [&](int k, int r, int x) {
            im[r] = x;
            row[k] = x;
          },
          loop_state[threadIdx.x / 32]));
    }
  } else {
    const int m = t == 0 ? m0 : m1;
    auto recip = [](int j) { return __fdiv_rn(1.0f, static_cast<float>(j)); };
    for (int k = lane; k < K; k += 32) {
      const int i = binomial_walk(lane_uniform(k_imp, k, bits), n_row[k],
                                  win_prob(bid[k], loc[k], scale[k]), m, recip);
      imp_row[k] = i;
      ncl_row[k] = binomial_walk(lane_uniform(k_click, k, bits), i, bctr[k], m, recip);
    }
  }
  st.add(kCountsClocks, stage_clock() - start);
  st.flush(lane);
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

__device__ __forceinline__ Key shfl_key(Key k, int src) {
  return Key{__shfl_sync(kFull, k.k0, src), __shfl_sync(kFull, k.k1, src)};
}

// One cell's accepted clicks p and spend s at budget B, its lanes drawn 32
// at a time up to its first prefix over B: a cell too deep for the buffer,
// or one whose lanes stage A skipped.
__device__ void walk_cell(Key key, int n, int k, int K, float loc, float scale, float f_lo,
                          float f_hi, int bits, int B, int lane, int& p, int& s) {
  p = 0;
  s = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    int v = 0;
    if (j < n) {
      v = lane_cost(lane_uniform(key, static_cast<uint32_t>(j) * K + k, bits), loc, scale, f_lo,
                    f_hi);
    }
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
// written (n_sim counts the simulated cells).
__global__ void __launch_bounds__(32 * kGateWarps)
    lanes_gate_kernel(const float* __restrict__ params, const long long* __restrict__ keys,
                      long long key_stride, const int* __restrict__ ncl,
                      const int* __restrict__ budget_c, int* __restrict__ acc,
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
  int ld_cell = -1, ld_n = 0;
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
      ld_loc = params[LOC * EK + eK + k];
      ld_scale = params[SCALE * EK + eK + k];
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
    const float loc = ld_loc, scale = ld_scale;
    const float y0 = __fsub_rn(ld_bid, 0.005f);
    const float f_lo = laplace_cdf(-y0, loc, scale), f_hi = laplace_cdf(y0, loc, scale);
    load(cell + 32, 32);  // the next window, if this one takes all 32 cells
    // each cell's first lane; the rest only where the first is within the
    // budget (a cell whose first lane is over it accepts nothing while the
    // budget does not grow)
    const Key key = tkeys[t];
    const int first = n > 0 ? lane_cost(lane_uniform(key, static_cast<uint32_t>(k), bits), loc,
                                        scale, f_lo, f_hi)
                            : 0;
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
      walk_cell(shfl_key(key, 0), __shfl_sync(kFull, n, 0), __shfl_sync(kFull, k, 0),
                K, __shfl_sync(kFull, loc, 0), __shfl_sync(kFull, scale, 0),
                __shfl_sync(kFull, f_lo, 0), __shfl_sync(kFull, f_hi, 0), bits, B, lane, p, s);
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
      const float loc_i = __shfl_sync(kFull, loc, i), scale_i = __shfl_sync(kFull, scale, i);
      const float lo_i = __shfl_sync(kFull, f_lo, i), hi_i = __shfl_sync(kFull, f_hi, i);
      int v = 0;
      if (g < lanes) {
        v = lane_cost(lane_uniform(key_i, static_cast<uint32_t>(j) * K + ki, bits), loc_i,
                      scale_i, lo_i, hi_i);
      }
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
        walk_cell(shfl_key(key, q), n_a, __shfl_sync(kFull, k, q), K,
                  __shfl_sync(kFull, loc, q), __shfl_sync(kFull, scale, q),
                  __shfl_sync(kFull, f_lo, q), __shfl_sync(kFull, f_hi, q), bits, B, lane, p, s);
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

// One block per env over its simulated cells: conversions, revenue and the
// six day sums, accumulated per keyword in shared memory.
__global__ void lanes_outcomes_kernel(const float* __restrict__ params,
                                      const long long* __restrict__ keys, long long key_stride,
                                      const int* __restrict__ imp, const int* __restrict__ acc,
                                      const int* __restrict__ spend,
                                      const int* __restrict__ n_sim,
                                      const int* __restrict__ n_auc01, int* __restrict__ out,
                                      int E, int K, int T) {
  extern __shared__ int smem[];
  int* sums = smem;                                       // (6, K)
  Key* tkeys = reinterpret_cast<Key*>(smem + 6 * K);      // (T, 2): k_conv, k_rev
  const int e = blockIdx.x;
  const long long EK = static_cast<long long>(E) * K;
  for (int i = threadIdx.x; i < 6 * K; i += blockDim.x) sums[i] = 0;
  const Key kc = load_key(keys, key_stride, e);
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const Key kt = child(kc, static_cast<uint32_t>(t));
    tkeys[2 * t] = child(kt, 2);
    tkeys[2 * t + 1] = child(kt, 3);
  }
  __syncthreads();
  const int cells = n_sim[e];
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int t = c / K, k = c % K;
    const long long ek = static_cast<long long>(e) * K + k;
    const long long cell = static_cast<long long>(e) * T * K + c;
    const int im = imp[cell], a = acc[cell];
    int nconv = 0, rev = 0;
    if (a > 0) {
      const float sctr = params[SCTR * EK + ek];
      const Key k_conv = tkeys[2 * t];
      for (int j = 0; j < a; ++j) {
        nconv += uniform32(bits32(k_conv, static_cast<uint32_t>(j * K + k))) <= sctr ? 1 : 0;
      }
      const float mean = params[REV_MEAN * EK + ek];
      const float std_sqrt2 = __fmul_rn(params[REV_STD * EK + ek], 1.41421354f);
      const Key k_rev = tkeys[2 * t + 1];
      for (int j = 0; j < nconv; ++j) {
        const float erf = xla_erfinv(uniform_open(k_rev, static_cast<uint32_t>(j * K + k)));
        const float draw = fmaxf(fma32(std_sqrt2, erf, mean), static_cast<float>(0.01));
        rev = wrap_add(rev, static_cast<int>(rintf(__fmul_rn(draw, 100.0f))));
      }
    }
    atomicAdd(&sums[k], im);
    atomicAdd(&sums[K + k], a);
    atomicAdd(&sums[2 * K + k], spend[cell]);
    atomicAdd(&sums[3 * K + k], nconv);
    atomicAdd(&sums[4 * K + k], rev);
    if (im >= 1) atomicAdd(&sums[5 * K + k], n_auc01[(t == 0 ? 0 : EK) + ek]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * K; i += blockDim.x) {
    out[(i / K) * EK + static_cast<long long>(e) * K + i % K] = sums[i];
  }
}

size_t outcomes_smem(int K, int T) {
  return static_cast<size_t>(6 * K) * sizeof(int) + static_cast<size_t>(2 * T) * sizeof(Key);
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` of `device` and returns cudaGetLastError()
// right after the launch (the library's runtime has its own current device).

// lanes_counts: imp and ncl (E, T, K); exact 1 for jax.random.binomial, 0
// for the inverse-CDF walk on `bits`-bit uniforms.
int lanes_counts_launch(const float* params, const int* n_auc01, const long long* keys,
                        long long key_stride, int* imp, int* ncl, int E, int K, int T, int m0,
                        int m1, int bits, int exact, int device, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || T < 1 || m0 < 1 || m1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long calls = static_cast<long long>(E) * T;
  const unsigned blocks = static_cast<unsigned>((calls + kCountsWarps - 1) / kCountsWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = K < 32 * kMaxSlots ? (K + 31) / 32 : kMaxSlots;
  static_assert(kMaxSlots == 4, "one instance per slot count");
  switch (slots) {
    case 1:
      lanes_counts_kernel<1><<<blocks, 32 * kCountsWarps, 0, s>>>(
          params, n_auc01, keys, key_stride, imp, ncl, E, K, T, m0, m1, bits, exact);
      break;
    case 2:
      lanes_counts_kernel<2><<<blocks, 32 * kCountsWarps, 0, s>>>(
          params, n_auc01, keys, key_stride, imp, ncl, E, K, T, m0, m1, bits, exact);
      break;
    case 3:
      lanes_counts_kernel<3><<<blocks, 32 * kCountsWarps, 0, s>>>(
          params, n_auc01, keys, key_stride, imp, ncl, E, K, T, m0, m1, bits, exact);
      break;
    default:
      lanes_counts_kernel<4><<<blocks, 32 * kCountsWarps, 0, s>>>(
          params, n_auc01, keys, key_stride, imp, ncl, E, K, T, m0, m1, bits, exact);
  }
  return static_cast<int>(cudaGetLastError());
}

// lanes_gate: acc and spend (E, T, K) of the simulated cells (t K + k <
// n_sim[e]; the others are not written) and n_sim (E,).
int lanes_gate_launch(const float* params, const long long* keys, long long key_stride,
                      const int* ncl, const int* budget_c, int* acc, int* spend, int* n_sim, int E,
                      int K, int T, int m0, int m1, int bits, int device, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || T < 1 || m0 < 1 || m1 < 1 || static_cast<long long>(T) * K > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = gate_smem(T);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lanes_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (E + kGateWarps - 1) / kGateWarps;
  lanes_gate_kernel<<<blocks, 32 * kGateWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      params, keys, key_stride, ncl, budget_c, acc, spend, n_sim, E, K, T, m0, m1, bits);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of lanes_counts (at K keywords) and lanes_gate (at
// T sub-timesteps), and lanes_gate's dynamic shared memory per block.
int lanes_day_occupancy(int K, int T, int device, int* counts_blocks, int* gate_blocks,
                        long long* gate_smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = K < 32 * kMaxSlots ? (K + 31) / 32 : kMaxSlots;
  const void* counts = slots == 1   ? reinterpret_cast<const void*>(lanes_counts_kernel<1>)
                       : slots == 2 ? reinterpret_cast<const void*>(lanes_counts_kernel<2>)
                       : slots == 3 ? reinterpret_cast<const void*>(lanes_counts_kernel<3>)
                                    : reinterpret_cast<const void*>(lanes_counts_kernel<4>);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(counts_blocks, counts, 32 * kCountsWarps, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = gate_smem(T);
  *gate_smem_bytes = static_cast<long long>(smem);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lanes_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      gate_blocks, lanes_gate_kernel, 32 * kGateWarps, smem));
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
// simulated cells.
int lanes_outcomes_launch(const float* params, const long long* keys, long long key_stride,
                          const int* imp, const int* acc, const int* spend, const int* n_sim,
                          const int* n_auc01, int* out, int E, int K, int T, int m0, int m1,
                          int device, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || T < 1 || m0 < 1 || m1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = outcomes_smem(K, T);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lanes_outcomes_kernel<<<E, kOutcomeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, keys, key_stride, imp, acc, spend, n_sim, n_auc01, out, E, K, T);
  return static_cast<int>(cudaGetLastError());
}

const char* lanes_day_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
