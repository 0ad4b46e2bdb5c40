// The XLA day step on Hopper (sm_90a): two kernels for the three phases
// of adcraft_tpu/step.py:simulate_day (:991) in the configuration that
// bench.py:47-76 times (aggregate costs, conversion counts, revenue sums,
// inversion binomials; implicit single-competitor keywords, explicit
// keywords with either cost model, bench.py's dense_explicit regime, and
// the binomial pool, its dense_pool regime). The
// JAX package left these phases to XLA, so no Pallas kernel constrains
// them:
//
// * agg_cells_gate replaces the sampling phase, _cell_tables' agg
//   implicit-single and explicit branches (step.py:858-926) vmapped over
//   sub-timesteps,
//   with the day-hoisted impression ladder (:1263-1282), and the budget
//   gate (:1295-1391): the sequential rule of _gate_keywords_scan_agg
//   (:740) with _resolve_cell (:1087), to which the lazy, chunked and
//   compacted TPU gates are bit-identical;
// * agg_outcomes replaces the post-gate phase (:1392-1500): conversion
//   counts, revenue (rev_sampling="sum": a draw per cell with conversions;
//   "day", :1407-1411 and :1476-1488: one draw per keyword from the day's
//   conversions, keyed by split(fold_in(k_cells, T), 4)[3]), cell_out's
//   masks and the day sums.
//
// The plain PyTorch versions are adcraft_tpu_torch/agg_day.py:
// agg_cells_gate_reference (agg_cells_reference, then agg_gate_reference)
// and agg_outcomes_reference. Every float operation here is the one that
// version's tensor ops perform on the card, spelled so that nvcc cannot
// contract or reorder it: __fmul_rn, __fadd_rn, __fdiv_rn, IEEE sqrtf,
// rintf, XLA's powf (xla_pow, float64 on glibc's tables, xla_math.cuh),
// and fused multiply-adds (XLA's contractions) as __fmaf_rn, which
// rounds once as the plain version's fma32 does. So the kernels equal it
// exactly.
//
// Keys follow jax.random's tree (threefry.cuh): per env and sub-timestep
// kt = fold_in(k_cells, t); k_auc, k_click, k_conv, k_rev = split(kt, 4);
// k_imp, k_cost = split(k_auc); k_sfull, k_lanes = split(k_cost); k_lite,
// k_rest = split(k_lanes); a deep lane column's key is fold_in(k_rest, k).
// A (K,) draw takes the word at counter k, the (L, K) lite table lane l's
// at l * K + k, a deep column lane i's at i.
//
// What bounds them: threefry words (integer ALU) and the walks' float
// work for agg_cells_gate, which keeps the cell tables on chip and writes
// 12 bytes per simulated cell; those bytes, which agg_outcomes reads back,
// for agg_outcomes on a day whose budget binds (its words are then few).
//
// agg_cells_gate runs one block per env. Its prologue computes each
// keyword's constants once into shared memory: the win probability, the
// truncation bounds, the cost moments and the t >= 1 CDF ladder's m1
// levels. The sub-timesteps then run in chunks of chunk_t, each in three
// stages over the chunk's cells c = (t - t0) * K + k, in the gate's (t, k)
// order:
//
// * Stage A (all threads, one cell per index, so no thread idles on K mod
//   the block size): the impressions (the walk at t = 0; at t >= 1 a
//   bisection of the shared ladder, which never falls), the clicks (the
//   walk, with 1/j from a shared table), the aggregate spend and the L lite
//   lane costs, into shared memory. A draw is made only where it can
//   matter: an impression word where there are auctions, a click word
//   where there are impressions, the spend normal and the lite lanes where
//   there are clicks (a walk over zero trials counts zero, zero clicks
//   spend zero, and the gate reads no lane of a cell without clicks).
// * Stage B (warp 0): the gate over the chunk's cells from shared memory,
//   through a window of the next 32: a saturating warp scan of the
//   aggregate spends and a ballot find the run of full cells that leave
//   budget, a second ballot the run of cells that leave a positive budget
//   as it is (full at no cost, or accepting nothing: not full, and no click
//   or a first lite lane above the budget, the budget-decay tail of a day);
//   the longer run is taken, and the cell after it is decided on its own:
//   full, or lane-resolved, by a running sum if all its lanes are lite,
//   else by the warp's lanes in parallel with a ballot for the first
//   over-budget prefix. A walk is a chain of dependent warp operations that
//   the SM's other warps slow down, so the design keeps its steps few. The
//   budget carries across chunks in warp 0's registers.
// * Stage C (all threads): imp, acc and spend of the chunk's simulated
//   cells to device memory. After the chunk in which the day breaks the
//   block stops: no later sub-timestep is sampled, and no cell at or past
//   the break is written.
//
// chunk_t trades barriers and gate walks (3 barriers and one walk per
// chunk) against waste and occupancy: a break leaves the rest of its chunk
// sampled for nothing, and shared memory grows by (3 + L) * 4 bytes per
// cell and 40 bytes of keys per sub-timestep, which bounds the blocks per
// SM. The wrapper takes the largest chunk_t that keeps kMinBlocks resident
// blocks per SM, or as many as a chunk of one sub-timestep keeps
// (agg_cells_gate_default_chunk_t; the pool's blocks of 8 warps keep 4 at
// chunk_t 8 for K = 100). Outputs do not depend on it. Stage B is a chain
// of dependent warp operations that runs while the block's other warps
// wait at the barrier; sampling the next chunk during stage B, with two
// buffers and so half the chunk, was tried and measured slower. Built
// with -DAGG_STAGE_CLOCKS (chip_smoke.py builds it so beside the plain
// build), thread 0 also counts its SM clocks in each stage, read with
// agg_cells_gate_stage_clocks, and the pool's by part of stage A
// (agg_cells_gate_pool_clocks).
//
// agg_outcomes runs one block per env over its simulated cells, never
// past n_sim. Its prologue, by all threads, derives the keys (k_conv per
// sub-timestep with a simulated cell, and k_rev or the day key, two blocks
// each) and each keyword's constants into shared memory: the walk's 1 - q,
// r = q / (1 - q) and flip, the revenue moments and the auction counts,
// beside a table of 1/j, so no per-cell or per-level division remains
// (the walk's pmf0 = (1 - q)^a is one xla_pow per cell with clicks, since
// it depends on the cell's a: a table over a = 0..m0 would take (m0 + 1) K
// of them per block, 4800 at the main path's m0 = 47 and K = 100, against at
// most T K = 2400 cells with clicks). Then each warp reads tiles of 32
// consecutive cells (coalesced, each tile's loads issued while the tile
// before is summed and drawn; no lane idles on K mod 32, no thread loops
// over t), adds the cheap sums (impressions, clicks, cost, eligible
// volume) to shared memory with integer atomics, and puts the cells with
// accepted clicks in a queue of its own by ballot; each time 32 wait,
// every lane draws one cell's conversion word and walks. In "sum" mode the
// cells that convert go to a second queue, whose revenue normals are drawn
// 32 at a time the same way; in "day" mode, after the block's barrier, one
// thread per keyword with conversions draws the day's normal. Integer sums
// are exact in any order, so neither the queues' order nor the atomics
// change the outputs. Measured on the card, the draws' arithmetic beyond
// threefry (pow, log1pf and the erfinv polynomial, sqrtf, the fused
// multiply-adds) bounds it when most cells
// have clicks; splitting an env's keywords over several blocks, two cells
// per lane, packing the sums into 64-bit atomics, and capping registers
// for more blocks per SM were each measured slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "jax_random.cuh"
#include "threefry.cuh"
#include "xla_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;  // resident blocks per SM agg_cells_gate's registers are capped for
// the pool's instance: blocks of 8 warps, 4 resident (its per-env tables
// hold 5 blocks of 4 warps per SM at most: its stage A waits on its long
// chains' latency, and twice the warps a block hide more of it)
constexpr int kPoolThreads = 256;
constexpr int kPoolMinBlocks = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kIntMax = 0x7FFFFFFF;
constexpr int kQuadNodes = 48;  // the pool moments' Gauss-Legendre nodes
constexpr int kMaxDevices = 64;  // devices whose agg_cells_gate configuration is remembered

#ifdef AGG_STAGE_CLOCKS
// per stage (the prologue and keys, stage A, stage B, stage C) the sum over
// blocks of thread 0's SM clocks between the block's barriers, then the
// number of blocks
constexpr int kStages = 4;
__device__ unsigned long long g_stage_clocks[kStages + 1];
// agg_outcomes' stages, counted the same way: the prologue; the cell tiles
// (loads, sums, queueing); the draws of full queues; the rest (the partial
// queues' draws, the barrier, the day draws and the writes)
constexpr int kOutStages = 4;
__device__ unsigned long long g_outcomes_clocks[kOutStages + 1];
// the pool's stage A by part, thread 0's SM clocks summed over blocks: the
// bidder count and F(bid)^k, the impression and click walks, the spend's
// moments, the lite lanes
constexpr int kPoolParts = 4;
__device__ unsigned long long g_pool_clocks[kPoolParts];
#endif

// thread 0's SM clocks by part of a pool cell (a build with
// -DAGG_STAGE_CLOCKS; else nothing)
struct PoolClocks {
#ifdef AGG_STAGE_CLOCKS
  unsigned long long v[kPoolParts] = {}, mark = 0;
  __device__ void start() { mark = clock64(); }
  __device__ void lap(int part) {
    const unsigned long long now = clock64();
    v[part] += now - mark;
    mark = now;
  }
#else
  __device__ void start() {}
  __device__ void lap(int) {}
#endif
};

// agg_cells_gate's per-keyword float rows in shared memory. An explicit
// model keeps the lite lanes' bid in kLoc and the deep lanes' bid, (bid -
// 0.005) + 0.005 as the JAX resolver rebuilds it, in kScale; it reads
// neither truncation bound.
enum { kPWin, kFLo, kFHi, kMu, kSigma, kCmax, kLoc, kScale, kBctr, kKwRows };
enum { kBidLite = kLoc, kBidDeep = kScale };
// The pool keeps F(bid) in kPWin, the deep lanes' F((bid - 0.005) +
// 0.005) in kFLo, round(1000 bid) in kCmax, and its ladder's n and p
// (max_bidders and the participation rate) in kMu and kSigma.
enum { kFBid = kPWin, kFBidDeep = kFLo, kLadderN = kMu, kLadderP = kSigma };
// the day's cost model (agg_day.IMPLICIT, EXPLICIT_RUST, EXPLICIT_PYTHON, POOL)
enum { kImplicit, kExplicitRust, kExplicitPython, kPool, kModels };
// agg_cells_gate's keys per sub-timestep: k_imp, k_click, k_sfull, k_lite,
// k_rest, and the pool's k_bidders
__host__ __device__ constexpr int chunk_keys(int model) { return model == kPool ? 6 : 5; }
// agg_cells_gate's threads per block
__host__ __device__ constexpr int cells_gate_threads(int model) {
  return model == kPool ? kPoolThreads : kThreads;
}

// distributions.agg_cost_cents_z (the pool's k >= 3 cells floored at n
// cmin = -n cmax) and rev_sum_cents_z
__device__ __forceinline__ int agg_cost(int n, float mu, float sigma, float cmax, float z,
                                        float cmin = 0.0f) {
  const float nf = static_cast<float>(n);
  const float s = rintf(fma32(nf, mu, __fmul_rn(__fmul_rn(sqrtf(nf), sigma), z)));
  return static_cast<int>(fminf(fmaxf(s, __fmul_rn(nf, cmin)), __fmul_rn(nf, cmax)));
}

// A pool lane's cost in decicents: round(1000 pool_cost) as XLA converts it
__device__ __forceinline__ int pool_units(float u, float f_bid, float loc, float scale, int k) {
  return xla_int32(rintf(__fmul_rn(pool_cost(u, f_bid, loc, scale, k), 1000.0f)));
}

// A pool cell's aggregate spend in decicents given its k >= 1 bidders
// (distributions.pool_deci_moments_of): the moments' 48-node chains of
// fused multiply-adds in node order at column k - 1 (the last column for a
// k past kmax), g floored at 0 where k < 3, read from the prologue's rows
// g (row q at g[q * K]); quad holds the nodes, the weights omega and the
// node powers W (Q x kmax).
__device__ int pool_spend(int n, int kb, const float* g, int K, const float* __restrict__ quad,
                          int kmax, float cmax, float z) {
  const float* omega = quad + kQuadNodes;
  const float* W = omega + kQuadNodes + min(kb, kmax) - 1;
  float a1 = 0.0f, a2 = 0.0f;
#pragma unroll 8
  for (int q = 0; q < kQuadNodes; ++q) {
    const float gq = kb < 3 ? fmaxf(g[q * K], 0.0f) : g[q * K];
    const float w = __ldg(W + q * kmax), o = __ldg(omega + q);
    a1 = fma32(w, __fmul_rn(o, gq), a1);
    a2 = fma32(w, __fmul_rn(o, __fmul_rn(gq, gq)), a2);
  }
  const float kf = static_cast<float>(kb);
  const float mu = __fmul_rn(kf, a1);
  const float var = fmaxf(fma32(-mu, mu, __fmul_rn(kf, a2)), 0.0f);
  const float sig = sqrtf(fma32(1e6f, var, static_cast<float>(1.0 / 12.0)));
  return agg_cost(n, __fmul_rn(1000.0f, mu), sig, cmax, z, kb >= 3 ? -cmax : 0.0f);
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
  __device__ float geo0(float n) const {
    return __fdiv_rn(-xla_expm1(__fmul_rn(-n, c)), em1);
  }
  __device__ float geo1(float n) const {
    const float e1 = xla_exp(__fmul_rn(-__fsub_rn(n, 1.0f), c));
    const float e2 = xla_exp(__fmul_rn(-n, c));
    const float x = fma32(__fsub_rn(n, 1.0f), e2, fma32(-n, e1, 1.0f));
    return __fdiv_rn(__fmul_rn(e_c, x), __fmul_rn(em1, em1));
  }
};

__device__ __forceinline__ float safe_exp(float x) { return xla_exp(fminf(x, 0.0f)); }

__device__ CostMoments cost_moments(float bid, float loc, float scale) {
  const float a = fabsf(loc);
  const float s = fmaxf(scale, 1e-12f);
  const float y0 = fmaxf(__fsub_rn(bid, 0.005f), 0.0f);
  Geo g;
  g.c = __fdiv_rn(1.0f, __fmul_rn(100.0f, s));
  const float bc = rintf(__fmul_rn(bid, 100.0f));
  const float big_i = fmaxf(__fsub_rn(bc, 1.0f), 0.0f);
  const float m = fminf(fmaxf(ceilf(fma32(a, 100.0f, -0.5f)), 0.0f), big_i);
  g.em1 = -xla_expm1(-g.c);
  g.e_c = xla_exp(-g.c);
  const float geo0_i = g.geo0(big_i), geo1_i = g.geo1(big_i);

  const float e_ay = safe_exp(__fdiv_rn(-__fsub_rn(a, y0), s));
  const float b_fac = safe_exp(__fdiv_rn(-__fadd_rn(a, 0.005f), s));
  const float b_cut = safe_exp(__fdiv_rn(-__fadd_rn(a, y0), s));
  const float half_ii = __fmul_rn(__fmul_rn(0.5f, big_i), __fsub_rn(big_i, 1.0f));
  const float sum_b = __fmul_rn(0.5f, fma32(b_fac, geo0_i, -__fmul_rn(big_i, b_cut)));
  const float sum_ib = __fmul_rn(0.5f, fma32(b_fac, geo1_i, -__fmul_rn(half_ii, b_cut)));

  // r2(n): t2 = safe_exp(-(100 a - n + 0.5) c); (t2 geo0(n), t2 ((n - 1) geo0(n) - geo1(n)))
  const float t2_i = safe_exp(__fmul_rn(-__fadd_rn(fma32(a, 100.0f, -big_i), 0.5f), g.c));
  const float r2_i = __fmul_rn(t2_i, geo0_i);
  const float r2w_i = __fmul_rn(t2_i, fma32(__fsub_rn(big_i, 1.0f), geo0_i, -geo1_i));
  const float sum_a_low = __fmul_rn(0.5f, fma32(big_i, e_ay, -r2_i));
  const float sum_ia_low = __fmul_rn(0.5f, fma32(half_ii, e_ay, -r2w_i));

  const float e_ya = safe_exp(__fdiv_rn(-__fsub_rn(y0, a), s));
  const float geo0_m = g.geo0(m), geo1_m = g.geo1(m);
  const float t2_m = safe_exp(__fmul_rn(-__fadd_rn(fma32(a, 100.0f, -m), 0.5f), g.c));
  const float r2_m = __fmul_rn(t2_m, geo0_m);
  const float r2w_m = __fmul_rn(t2_m, fma32(__fsub_rn(m, 1.0f), geo0_m, -geo1_m));
  const float keep = __fsub_rn(1.0f, __fmul_rn(0.5f, e_ya));
  const float sum_a_pre = fma32(m, keep, -__fmul_rn(0.5f, r2_m));
  const float sum_ia_pre = fma32(__fmul_rn(__fmul_rn(0.5f, m), __fsub_rn(m, 1.0f)), keep,
                                 -__fmul_rn(0.5f, r2w_m));
  const float n_top = __fsub_rn(big_i, m);
  const float t3 = xla_exp(fminf(__fmul_rn(-fma32(a, -100.0f, __fadd_rn(m, 0.5f)), g.c), 30.0f));
  const float geo0_top = g.geo0(n_top);
  const float s3 = __fmul_rn(t3, geo0_top);
  const float s3w = fma32(m, s3, __fmul_rn(t3, g.geo1(n_top)));
  const float sum_a_top = __fmul_rn(0.5f, fma32(t3, geo0_top, -__fmul_rn(n_top, e_ya)));
  // XLA's std recomputes the first moment's sums in a fusion in which s3
  // has two uses, so there n_top e_ya is the product contracted
  const float sum_a_top_std = __fmul_rn(0.5f, fma32(-n_top, e_ya, s3));
  const float sum_i_top =
      __fmul_rn(__fmul_rn(0.5f, __fadd_rn(__fsub_rn(big_i, 1.0f), m)), n_top);
  const float sum_ia_top =
      __fsub_rn(__fmul_rn(0.5f, s3w), __fmul_rn(__fmul_rn(0.5f, sum_i_top), e_ya));

  const bool low = y0 <= a;
  const float sum_a = low ? sum_a_low : __fadd_rn(sum_a_pre, sum_a_top);
  const float sum_a_std = low ? sum_a_low : __fadd_rn(sum_a_pre, sum_a_top_std);
  const float sum_ia = low ? sum_ia_low : __fadd_rn(sum_ia_pre, sum_ia_top);
  const float z = __fsub_rn(laplace_cdf(y0, a, s), laplace_cdf(-y0, a, s));
  const float zsafe = fmaxf(z, 1e-12f);
  const float tail0 = fmaxf(__fadd_rn(sum_a, sum_b), 0.0f);
  const float tail1 = fmaxf(__fadd_rn(sum_ia, sum_ib), 0.0f);
  const float mu = __fdiv_rn(tail0, zsafe);
  const float tail0_std = fmaxf(__fadd_rn(sum_a_std, sum_b), 0.0f);
  const float m2 = __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, tail1), tail0_std), zsafe);
  const float var = fmaxf(fma32(-mu, mu, m2), 0.0f);
  return CostMoments{mu, sqrtf(var), fmaxf(__fsub_rn(bc, 1.0f), 0.0f)};
}

// The ladder's levels below u, by bisection over its m1 levels (level j
// at ladder[j * stride]; Ladder, xla_math.cuh: the t >= 1 impression
// ladder, or the pool's bidder ladder): each level adds a non-negative
// float, so the ladder never falls and this is the count
// binomial_inv_from_cdf_u takes.
__device__ __forceinline__ int ladder_count(const float* ladder, int stride, int m1, float u) {
  int lo = 0, hi = m1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ladder[mid * stride] < u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// distributions.rev_sum_moments: (100 m1, sqrt((100 s1)^2 + 1/12)) of the
// censored normal max(N(mean, std), 0.01), on XLA's ndtr and pdf with its
// contractions (distributions.censored_normal_moments)
__device__ float2 rev_moments(float mean, float std) {
  const float low = 0.01f;
  const float safe = fmaxf(std, 1e-20f);
  const float a = __fdiv_rn(__fsub_rn(low, mean), safe);
  const float big_f = xla_ndtr(a);
  const float small_f = xla_normal_pdf(a);
  const float rest = __fsub_rn(1.0f, big_f);
  float m1 = fma32(safe, small_f, fma32(low, big_f, __fmul_rn(mean, rest)));
  float m2 = fma32(1e-4f, big_f, __fmul_rn(fma32(mean, mean, __fmul_rn(safe, safe)), rest));
  m2 = fma32(__fmul_rn(safe, __fadd_rn(mean, low)), small_f, m2);
  float var = fmaxf(fma32(-m1, m1, m2), 0.0f);
  if (std <= 0.0f) {
    m1 = fmaxf(mean, low);
    var = 0.0f;
  }
  const float h = __fmul_rn(100.0f, sqrtf(var));
  return make_float2(__fmul_rn(100.0f, m1),
                     sqrtf(fma32(h, h, static_cast<float>(1.0 / 12.0))));
}

__device__ __forceinline__ long long warp_inclusive_sum(long long v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Inclusive warp scan of non-negative ints, saturating at kIntMax.
__device__ __forceinline__ int warp_saturating_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = v > kIntMax - o ? kIntMax : v + o;
  }
  return v;
}

// _resolve_cell on one warp: lanes < L from the cell's lite costs (lane l
// at lite_c[l * lite_stride]), the rest drawn from fold_in(k_rest, k),
// whose key and truncation bounds are derived only if a deep lane is
// reached; the first prefix over B (or lane min(n, m)) stops it, which for
// the pool's signed costs need not be the last prefix within B. An
// explicit model's deep lane is its cost model's draw at the normal's
// counter idx - L, the pool's its law for the cell's kb bidders. Returns
// the accepted clicks, and their spend in *spend (warp-uniform).
template <int kModel>
__device__ int resolve_cell(const int* lite_c, int lite_stride, const float* kw, int K, Key k_rest,
                            int k, int kb, int n, long long B, int m, int L, int bits, int lane,
                            long long* spend) {
  const int lanes = min(n, m);
  if (lanes <= L) {
    // only lite lanes (the common partial cell, with one or a few clicks):
    // their running sum, the same on every lane, without warp traffic
    long long carry = 0;
    int l = 0;
    for (; l < lanes; ++l) {
      const long long next = carry + lite_c[l * lite_stride];
      if (next > B) break;
      carry = next;
    }
    *spend = carry;
    return l;
  }
  bool have_deep = false;
  Key k_col{0u, 0u};
  float loc = 0.0f, scale = 1.0f, f_lo = 0.0f, f_hi = 0.0f, bid_deep = 0.0f;
  long long carry = 0;
  int accepted = 0;
  for (int base = 0; base < lanes; base += 32) {
    if (!have_deep && lanes > L && base + 31 >= L) {
      if (kModel == kImplicit || kModel == kPool) {
        loc = kw[kLoc * K + k];
        scale = kw[kScale * K + k];
        f_lo = kw[kFLo * K + k];  // the pool's F((bid - 0.005) + 0.005)
        f_hi = kw[kFHi * K + k];
      } else {
        bid_deep = kw[kBidDeep * K + k];
      }
      k_col = child(k_rest, static_cast<uint32_t>(k));
      have_deep = true;
    }
    const int idx = base + lane;
    const bool in = idx < lanes;
    long long c = 0;
    if (in && idx < L) {
      c = lite_c[idx * lite_stride];
    } else if (in && kModel == kImplicit) {
      c = lane_cost(lane_uniform(k_col, static_cast<uint32_t>(idx - L), bits), loc, scale, f_lo,
                    f_hi);
    } else if (in && kModel == kPool) {
      c = pool_units(lane_uniform(k_col, static_cast<uint32_t>(idx - L), bits), f_lo, loc, scale,
                     kb);
    } else if (in) {
      c = explicit_cost(kModel == kExplicitRust,
                        xla_normal_erfinv(k_col, static_cast<uint32_t>(idx - L)), bid_deep);
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

// Shared memory of one agg_cells_gate block, in bytes: the chunk's keys
// (8-byte aligned, first), then per keyword kKwRows floats and the two
// auction counts, the ladder (m1 x K; the pool's bidder ladder, kmax x K),
// the walk's table of 1/j (max(m0, m1)), the pool's moment rows g (48 x
// K), then per cell of a chunk the aggregate spend, the clicks, the
// impressions, the L lite costs and the pool's bidder count and list of
// cells to cost (stage A's second part).
__host__ __device__ inline size_t cells_gate_smem(int chunk_t, int K, int m0, int m1, int L,
                                                  int model, int kmax) {
  const bool pool = model == kPool;
  const size_t cells = static_cast<size_t>(chunk_t) * K;
  const size_t nmax = static_cast<size_t>(m0 > m1 ? m0 : m1);
  const size_t ladder = static_cast<size_t>(pool ? kmax : m1);
  return static_cast<size_t>(chunk_t) * chunk_keys(model) * sizeof(Key) +
         sizeof(int) * ((kKwRows + 2 + ladder + (pool ? kQuadNodes : 0)) * K + nmax +
                        (3 + static_cast<size_t>(L) + (pool ? 2 : 0)) * cells);
}

// Stage B of agg_cells_gate on warp 0: the gate over a chunk's `cells`
// cells in (t, k) order from the shared tables, through a window of the
// next 32 cells. Each cell's accepted clicks and spend replace its clicks
// and aggregate spend; B, the budget left, carries across chunks. Returns
// the cells simulated: all of them, or those up to and including the one
// that breaks the day. An explicit model's phantom cells (no impression,
// clicks that spend nothing) have s = 0 and take the passive run. The
// pool's spends can be negative: its scan is exact in 64 bits, and a cell
// is whole where its own inclusive sum is below B, as for the others; kb
// holds its cells' bidder counts.
template <int kModel>
__device__ int gate_chunk(int* sfull, int* ncl, const int* lite, int lite_stride, const int* kb,
                          const float* kw, const Key* tkeys, int cells, int t0, int K, int m0,
                          int m1, int L, int bits, int lane, long long& B, bool& broken) {
  for (int p = 0; p < cells;) {
    const int c = p + lane;
    const bool in = c < cells;
    const int s = in ? sfull[c] : 0;
    const int n = in ? ncl[c] : 0;
    const int c0 = n != 0 ? lite[c] : 0;  // a cell without clicks has no lanes
    // whole: this and every earlier cell of the window are full and leave
    // budget (the scan saturates only at or above it); passive: leaves a
    // positive budget as it is, being full at no cost or accepting nothing
    // (not full, and no click or a first lite lane above the budget: the
    // budget-decay tail of a day)
    const unsigned passive =
        __ballot_sync(kFull, in && B > 0 && (s == 0 || (s > B && (n == 0 || c0 > B))));
    // the pool's 64-bit scan is the window's longest chain; a window of
    // passive cells without a negative spend needs none (it is whole only
    // if its spends are all 0, which leaves it as the passive run does)
    if (kModel == kPool && passive == kFull && __ballot_sync(kFull, s < 0) == 0) {
      if (s != 0) {
        ncl[c] = 0;
        sfull[c] = 0;
      }
      p += 32;
      continue;
    }
    const long long S = kModel == kPool ? warp_inclusive_sum(s, lane)
                                        : static_cast<long long>(warp_saturating_sum(s, lane));
    const unsigned whole = __ballot_sync(kFull, in && S < B);
    const int n_whole = whole == kFull ? 32 : __ffs(~whole) - 1;
    const int n_passive = passive == kFull ? 32 : __ffs(~passive) - 1;
    const int run = max(n_whole, n_passive);
    if (lane < run && n_whole < n_passive && s != 0) {  // a taken cell keeps its values
      ncl[c] = 0;
      sfull[c] = 0;
    }
    if (n_whole >= n_passive && n_whole > 0) B -= __shfl_sync(kFull, S, n_whole - 1);
    p += run;
    if (run == 32 || p >= cells) continue;

    // the cell at p, decided on its own: full, accepting nothing (at the
    // budget a whole run left), or lane-resolved
    const int s_p = __shfl_sync(kFull, s, run);
    const int n_p = __shfl_sync(kFull, n, run);
    const int c0_p = __shfl_sync(kFull, c0, run);
    long long spend = s_p;
    int accepted = n_p;
    if (s_p > B && (n_p == 0 || c0_p > B)) {
      spend = 0;
      accepted = 0;
    } else if (s_p > B) {
      const int tt = p / K;
      const int k = p - tt * K;
      accepted = resolve_cell<kModel>(lite + p, lite_stride, kw, K, tkeys[chunk_keys(kModel) * tt + 4], k,
                                      kModel == kPool ? kb[p] : 0, n_p, B,
                                      t0 + tt == 0 ? m0 : m1, L, bits, lane, &spend);
    }
    if (lane == 0) {
      ncl[p] = accepted;
      sfull[p] = static_cast<int>(spend);
    }
    B -= spend;
    ++p;
    if (B <= 0) {
      broken = true;
      return p;
    }
  }
  return cells;
}

// The pool's prologue for keyword k (agg_day.pool_constants): F(bid)
// (bid_cdf, with cent_bids as the env's program computes it) and the deep
// lanes' F((bid - 0.005) + 0.005), round(1000 bid) and the bidder
// ladder's kmax levels (level j at ladder[j * K + k]; with consts_out,
// also there: F(bid) in row 0, the levels in rows 1 to kmax). The moment
// rows follow (pool_moment_rows).
__device__ void pool_prologue(const float* __restrict__ params, long long EK, long long ek, int k,
                              int K, int kmax, bool cent_bids, float* kw, float* ladder,
                              float* __restrict__ consts_out) {
  const float bid = params[BID * EK + ek];
  const float loc = params[LOC * EK + ek], scale = params[SCALE * EK + ek];
  const float f_bid = bid_cdf(bid, loc, scale, cent_bids);
  const float mb = params[MAX_BIDDERS * EK + ek], part = params[PARTICIPATION * EK + ek];
  kw[kFBid * K + k] = f_bid;
  kw[kFBidDeep * K + k] = laplace_cdf(__fadd_rn(__fsub_rn(bid, 0.005f), 0.005f), loc, scale);
  kw[kCmax * K + k] = rintf(__fmul_rn(1000.0f, bid));
  kw[kLoc * K + k] = loc;
  kw[kScale * K + k] = scale;
  kw[kLadderN * K + k] = mb;
  kw[kLadderP * K + k] = part;
  const Ladder lad = make_ladder(mb, part);
  XlaScan<true> cp;
  XlaScan<false> cdf;
  for (int j = 0; j < kmax; ++j) {
    const float pmf = j == 0 ? lad.pmf0 : xla_ftz(__fmul_rn(lad.pmf0, cp.push(lad.factor(j))));
    const float level = cdf.push(pmf);
    ladder[j * K + k] = level;
    if (consts_out != nullptr) consts_out[(1 + j) * EK + ek] = level;
  }
  if (consts_out != nullptr) consts_out[ek] = f_bid;
}

// The moment rows g_q = F^-1(F(bid) w_q) (row q at g[q * K + k]) from the
// prologue's rows, the block's threads over all (q, k)
__device__ void pool_moment_rows(const float* kw, int K, const float* __restrict__ quad,
                                 float* g) {
  for (int i = threadIdx.x; i < kQuadNodes * K; i += blockDim.x) {
    const int q = i / K, k = i - q * K;
    const float a =
        xla_ftz(fminf(fmaxf(__fmul_rn(kw[kFBid * K + k], __ldg(quad + q)), 1e-38f), 1.0f));
    g[i] = laplace_icdf(a, kw[kLoc * K + k], kw[kScale * K + k]);
  }
}

// One pool cell of stage A (agg_day.pool_cells_reference) for keyword k
// with n auctions and keys tk, its first part: its bidder count by the
// ladder (only where there are auctions: a cell without them wins no
// impression, whatever its k), its impressions and clicks by the walk.
template <class Recip>
__device__ void pool_counts(const float* kw, const float* ladder, int K, int k, int n,
                            const Key* tk, int m, int bits, int kmax, Recip table, int& kb,
                            int& im, int& nc, PoolClocks& pc) {
  kb = im = nc = 0;
  if (n == 0) return;
  pc.start();
  const float mb = kw[kLadderN * K + k], part = kw[kLadderP * K + k];
  const int ni = static_cast<int>(rintf(mb));
  const int cnt = min(ladder_count(ladder + k, K, kmax, lane_uniform(tk[5], k, bits)), ni);
  kb = part > 0.5f ? ni - cnt : cnt;
  const float p_win = kb > 0 ? xla_pow(kw[kFBid * K + k], static_cast<float>(kb)) : 1.0f;
  pc.lap(0);
  im = binomial_walk(lane_uniform(tk[0], k, bits), n, p_win, m, table);
  if (im != 0) nc = binomial_walk(lane_uniform(tk[1], k, bits), im, kw[kBctr * K + k], m, table);
  pc.lap(1);
}

// Its second part, for a cell with nc > 0 clicks and kb > 0 bidders (one
// with kb = 0 spends 0 and its lanes cost 0): its spend from the moments
// and its lite lanes.
__device__ void pool_costs(const float* kw, const float* g, int K, int k, int nc, int kb,
                           const Key* tk, int L, int bits, int kmax,
                           const float* __restrict__ quad, int* lite_c, int lite_stride, int& s,
                           PoolClocks& pc) {
  pc.start();
  const float f_bid = kw[kFBid * K + k], loc = kw[kLoc * K + k], scale = kw[kScale * K + k];
  s = pool_spend(nc, kb, g + k, K, quad, kmax, kw[kCmax * K + k], xla_normal(tk[2], k));
  pc.lap(2);
  for (int l = 0; l < L; ++l) {
    lite_c[l * lite_stride] =
        pool_units(lane_uniform(tk[3], static_cast<uint32_t>(l * K + k), bits), f_bid, loc, scale,
                   kb);
  }
  pc.lap(3);
}

// ---- agg_cells_gate: one block per env, the sub-timesteps in chunks ----
// One instance per cost model. The explicit ones (explicit keywords, the
// rust or python cost model) differ in three places: the prologue's win
// probability is the threshold sigmoid and its cost moments are the
// model's (xla_math.cuh: the clipped normal's, or the python model's
// cost_grid-cell Abel sums, by each keyword's thread); stage A draws
// clicks over max(impressions, 1) candidates, a phantom cell (no
// impression) spending nothing, and the lite lanes from the cost model's
// normals at counter l * K + k; and resolve_cell's deep lanes. The pool's
// (the binomial pool: k_auc split three ways, k_bidders first) has no day
// ladder of impressions, its win probability varying with each cell's
// bidder count: its prologue builds the bidder ladder and the moments'
// rows (pool_prologue, pool_moment_rows), stage A draws each cell's bidder
// count and its impressions and clicks by the walk (pool_counts), then,
// after a barrier, the spends from the 48-node chains for their own k and
// the lite lanes of the cells with clicks and bidders only, listed by the
// first part (pool_costs: the chains are the longest part of a cell, and
// a warp of cells of which some have clicks ran them for all), and the
// gate runs on signed spends.
template <int kModel>
__global__ void __launch_bounds__(cells_gate_threads(kModel),
                                  kModel == kPool ? kPoolMinBlocks : kMinBlocks)
    agg_cells_gate_kernel(const float* __restrict__ params, const int* __restrict__ n_auc01,
                          const long long* __restrict__ keys, long long key_stride,
                          const int* __restrict__ budget_c, int* __restrict__ imp_out,
                          int* __restrict__ acc_out, int* __restrict__ spend_out,
                          int* __restrict__ n_sim, float* __restrict__ consts_out, int E, int K,
                          int T, int m0, int m1, int L, int bits, int chunk_t, int cost_grid,
                          const float* __restrict__ quad, int kmax, int cent_bids) {
  extern __shared__ unsigned long long smem[];
  constexpr bool kIsPool = kModel == kPool;
  constexpr int kBlock = cells_gate_threads(kModel);
  constexpr int kKeys = chunk_keys(kModel);
  const int max_cells = chunk_t * K;
  const int nmax = max(m0, m1);
  const int ladder_rows = kIsPool ? kmax : m1;
  Key* tkeys = reinterpret_cast<Key*>(smem);  // [chunk_t][kKeys]
  float* kw = reinterpret_cast<float*>(tkeys + kKeys * chunk_t);  // [kKwRows][K]
  int* n01 = reinterpret_cast<int*>(kw + kKwRows * K);            // [2][K]
  float* ladder = reinterpret_cast<float*>(n01 + 2 * K);           // [ladder_rows][K]
  float* walk_recip = ladder + ladder_rows * K;                    // [j]: __fdiv_rn(1, j)
  float* g = walk_recip + nmax;                                    // the pool's [48][K]
  int* sfull = reinterpret_cast<int*>(g + (kIsPool ? kQuadNodes * K : 0));  // spend after the gate
  int* ncl = sfull + max_cells;  // accepted clicks after the gate
  int* imp = ncl + max_cells;
  int* lite = imp + max_cells;            // [L][max_cells]
  int* kcell = lite + L * max_cells;      // the pool's bidder counts
  int* listed = kcell + max_cells;        // the pool's cells to cost
  __shared__ int s_end, s_broken, s_listed;

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const long long EK = static_cast<long long>(E) * K;
  const long long eK = static_cast<long long>(e) * K;
  const auto table = [walk_recip](int j) { return walk_recip[j]; };
  const int step_t = kBlock / K, step_k = kBlock % K;  // a stride of cells as (t, k)
  PoolClocks pc;
#ifdef AGG_STAGE_CLOCKS
  unsigned long long mark = clock64(), spent[kStages] = {};
  const auto lap = [&](int stage) {
    if (tid == 0) {
      const unsigned long long now = clock64();
      spent[stage] += now - mark;
      mark = now;
    }
  };
#else
  const auto lap = [](int) {};
#endif

  for (int j = tid; j < nmax; j += kBlock) {
    walk_recip[j] = __fdiv_rn(1.0f, static_cast<float>(j));
  }
  __syncthreads();

  // the prologue: each keyword's constants for the day
  for (int k = tid; k < K; k += kBlock) {
    const long long ek = eK + k;
    n01[k] = n_auc01[ek];
    n01[K + k] = n_auc01[EK + ek];
    kw[kBctr * K + k] = params[BCTR * EK + ek];
    if (kIsPool) {
      pool_prologue(params, EK, ek, k, K, kmax, cent_bids != 0, kw, ladder, consts_out);
      continue;
    }
    const float bid = params[BID * EK + ek];
    const float loc = params[LOC * EK + ek], scale = params[SCALE * EK + ek];
    const int n1 = n_auc01[EK + ek];
    const float y0 = __fsub_rn(bid, 0.005f);
    float p_win;
    CostMoments cm;
    if (kModel == kImplicit) {
      const float f_lo = laplace_cdf(-y0, loc, scale), f_hi = laplace_cdf(y0, loc, scale);
      p_win = fminf(fmaxf(__fsub_rn(f_hi, f_lo), 0.0f), 1.0f);
      cm = cost_moments(bid, loc, scale);
      kw[kFLo * K + k] = f_lo;
      kw[kFHi * K + k] = f_hi;
      kw[kLoc * K + k] = loc;
      kw[kScale * K + k] = scale;
    } else {
      p_win = threshold_sigmoid(bid, params[IMP_THRESH * EK + ek], params[IMP_INTERCEPT * EK + ek],
                                params[IMP_SLOPE * EK + ek]);
      const ExplicitMoments em = kModel == kExplicitRust
                                     ? cost_create_deci_moments(bid)
                                     : generic_cost_cent_moments(bid, cost_grid);
      cm = CostMoments{em.mu, em.sigma, em.cmax};
      kw[kBidLite * K + k] = bid;
      kw[kBidDeep * K + k] = __fadd_rn(y0, 0.005f);
    }
    kw[kPWin * K + k] = p_win;
    kw[kMu * K + k] = cm.mu;
    kw[kSigma * K + k] = cm.sigma;
    kw[kCmax * K + k] = cm.cmax;
    const Ladder lad = make_ladder(static_cast<float>(n1), p_win);
    XlaScan<true> cp;
    XlaScan<false> cdf;
    for (int j = 0; j < m1; ++j) {
      const float pmf = j == 0 ? lad.pmf0 : xla_ftz(__fmul_rn(lad.pmf0, cp.push(lad.factor(j))));
      const float level = cdf.push(pmf);
      ladder[j * K + k] = level;
      if (consts_out != nullptr) consts_out[(4 + j) * EK + ek] = level;
    }
    if (consts_out != nullptr) {
      consts_out[ek] = p_win;
      consts_out[EK + ek] = cm.mu;
      consts_out[2 * EK + ek] = cm.sigma;
      consts_out[3 * EK + ek] = cm.cmax;
    }
  }

  if (kIsPool) {
    __syncthreads();
    pool_moment_rows(kw, K, quad, g);
  }

  const Key kc = load_key(keys, key_stride, e);
  long long B = budget_c[e];  // warp 0's
  bool broken = false;
  int nsim = T * K;
  for (int t0 = 0; t0 < T; t0 += chunk_t) {
    const int nt = min(chunk_t, T - t0);
    const int cells = nt * K;
    for (int tt = tid; tt < nt; tt += kBlock) {
      const Key kt = child(kc, static_cast<uint32_t>(t0 + tt));
      const Key k_auc = child(kt, 0);
      // the pool: k_bidders, k_imp, k_cost = split(k_auc, 3)
      const Key k_cost = child(k_auc, kIsPool ? 2 : 1);
      const Key k_lanes = child(k_cost, 1);
      Key* tk = tkeys + kKeys * tt;
      tk[0] = child(k_auc, kIsPool ? 1 : 0);  // k_imp
      tk[1] = child(kt, 1);                   // k_click
      tk[2] = child(k_cost, 0);               // k_sfull
      tk[3] = child(k_lanes, 0);              // k_lite
      tk[4] = child(k_lanes, 1);              // k_rest
      if (kIsPool) tk[kKeys - 1] = child(k_auc, 0);  // k_bidders
    }
    if (kIsPool && tid == 0) s_listed = 0;
    __syncthreads();
    lap(0);

    // Stage A: the chunk's cell tables; cell c is (tt, k) = divmod(c, K)
    if constexpr (kIsPool) {
      const int lane = tid % 32;
      for (int c = tid, tt = tid / K, k = tid % K; c - lane < cells;
           c += kBlock, tt += step_t, k += step_k) {
        if (k >= K) {
          k -= K;
          ++tt;
        }
        int kb = 0, im = 0, nc = 0;
        if (c < cells) {
          const bool first_t = t0 + tt == 0;
          pool_counts(kw, ladder, K, k, n01[first_t ? k : K + k], tkeys + kKeys * tt,
                      first_t ? m0 : m1, bits, kmax, table, kb, im, nc, pc);
          kcell[c] = kb;
          imp[c] = im;
          ncl[c] = nc;
          sfull[c] = 0;
          if (nc != 0 && kb == 0) {  // no bidder: no spend, lite lanes 0
            for (int l = 0; l < L; ++l) lite[l * max_cells + c] = 0;
          }
        }
        const bool costed = nc != 0 && kb > 0;
        const unsigned m = __ballot_sync(kFull, costed);
        int base = 0;
        if (lane == 0 && m != 0) base = atomicAdd(&s_listed, __popc(m));
        base = __shfl_sync(kFull, base, 0);
        if (costed) listed[base + __popc(m & ((1u << lane) - 1u))] = c;
      }
      __syncthreads();
      const int n_listed = s_listed;
      for (int i = tid; i < n_listed; i += kBlock) {
        const int c = listed[i], tt = c / K, k = c - tt * K;
        int s;
        pool_costs(kw, g, K, k, ncl[c], kcell[c], tkeys + kKeys * tt, L, bits, kmax, quad,
                   lite + c, max_cells, s, pc);
        sfull[c] = s;
      }
    } else {
      for (int c = tid, tt = tid / K, k = tid % K; c < cells;
           c += kBlock, tt += step_t, k += step_k) {
        if (k >= K) {
          k -= K;
          ++tt;
        }
        const bool first_t = t0 + tt == 0;
        const Key* tk = tkeys + kKeys * tt;
        const float p_win = kw[kPWin * K + k];
        int im = 0;
        if (first_t) {
          const int n0 = n01[k];
          if (n0 != 0) im = binomial_walk(lane_uniform(tk[0], k, bits), n0, p_win, m0, table);
        } else {
          const int n1 = n01[K + k];
          if (n1 != 0) {
            const int cnt = min(ladder_count(ladder + k, K, m1, lane_uniform(tk[0], k, bits)), n1);
            im = p_win > 0.5f ? n1 - cnt : cnt;
          }
        }
        // an explicit cell without impressions still flips one phantom
        // candidate
        const int candidates = kModel == kImplicit ? im : max(im, 1);
        int nc = 0, s = 0;
        if (candidates != 0) {
          nc = binomial_walk(lane_uniform(tk[1], k, bits), candidates, kw[kBctr * K + k],
                             first_t ? m0 : m1, table);
        }
        if (nc != 0 && im == 0) {  // phantom clicks: no spend, lite lanes 0
          for (int l = 0; l < L; ++l) lite[l * max_cells + c] = 0;
        } else if (nc != 0) {
          s = agg_cost(nc, kw[kMu * K + k], kw[kSigma * K + k], kw[kCmax * K + k],
                       xla_normal(tk[2], k));
          if (kModel == kImplicit) {
            const float loc = kw[kLoc * K + k], scale = kw[kScale * K + k];
            const float f_lo = kw[kFLo * K + k], f_hi = kw[kFHi * K + k];
            for (int l = 0; l < L; ++l) {
              const float u = lane_uniform(tk[3], static_cast<uint32_t>(l * K + k), bits);
              lite[l * max_cells + c] = lane_cost(u, loc, scale, f_lo, f_hi);
            }
          } else {
            const float bid = kw[kBidLite * K + k];
            for (int l = 0; l < L; ++l) {
              lite[l * max_cells + c] = explicit_cost(
                  kModel == kExplicitRust,
                  xla_normal_erfinv(tk[3], static_cast<uint32_t>(l * K + k)), bid);
            }
          }
        }
        imp[c] = im;
        ncl[c] = nc;
        sfull[c] = s;
      }
    }
    __syncthreads();
    lap(1);

    // Stage B: the gate
    if (tid < 32) {
      const int end = gate_chunk<kModel>(sfull, ncl, lite, max_cells, kcell, kw, tkeys, cells, t0,
                                         K, m0, m1, L, bits, tid, B, broken);
      if (tid == 0) {
        s_end = end;
        s_broken = broken;
      }
    }
    __syncthreads();
    lap(2);

    // Stage C: the simulated cells out; the next chunk's keys overwrite
    // nothing read here, and its tables wait for the barrier after them
    const int end = s_end;
    const long long row = (static_cast<long long>(e) * T + t0) * K;
    for (int c = tid; c < end; c += kBlock) {
      imp_out[row + c] = imp[c];
      acc_out[row + c] = ncl[c];
      spend_out[row + c] = sfull[c];
    }
    lap(3);
    if (s_broken) {
      nsim = t0 * K + end;
      break;
    }
  }
  if (tid == 0) {
    n_sim[e] = nsim;
#ifdef AGG_STAGE_CLOCKS
    for (int i = 0; i < kStages; ++i) atomicAdd(&g_stage_clocks[i], spent[i]);
    atomicAdd(&g_stage_clocks[kStages], 1ull);
    if (kIsPool) {
      for (int i = 0; i < kPoolParts; ++i) atomicAdd(&g_pool_clocks[i], pc.v[i]);
    }
#endif
  }
}

// ---- agg_outcomes: one block per env, its simulated cells in warp tiles ----

// Per warp a queue of cells waiting for a draw: up to 31 waiting and 32
// new ones. Each entry is ((t << 16) | k, count).
constexpr int kQueue = 64;
constexpr int kOutWarps = kThreads / 32;
// agg_outcomes' per-keyword rows in shared memory: floats, then ints, then
// the day sums
enum { kOneMinusQ, kRatio, kMeanC, kStdC, kRevStd, kOutFloatRows };
enum { kN0, kN1, kFlip, kOutIntRows };
enum { kSumImp, kSumClicks, kSumCost, kSumConv, kSumRev, kSumElig, kSums };

// Shared memory of one agg_outcomes block, in bytes: the keys (k_conv per
// sub-timestep, then k_rev per sub-timestep or the day key), the warps'
// two queues, the per-keyword rows and sums, and the table of 1/j.
__host__ __device__ inline size_t outcomes_smem(int K, int T, int m0, int m1) {
  const size_t nmax = static_cast<size_t>(m0 > m1 ? m0 : m1);
  return sizeof(Key) * (2 * static_cast<size_t>(T) + 1) + sizeof(int2) * 2 * kQueue * kOutWarps +
         sizeof(int) * ((kOutFloatRows + kOutIntRows + kSums) * static_cast<size_t>(K) + nmax);
}

// Appends this lane's entry (if `take`) to a warp's queue of length n
// (warp-uniform), at the slot the ballot's prefix gives it.
__device__ __forceinline__ void enqueue(int2* queue, int& n, bool take, int2 entry, int lane) {
  const unsigned mask = __ballot_sync(kFull, take);
  if (take) queue[n + __popc(mask & ((1u << lane) - 1u))] = entry;
  n += __popc(mask);
}

// One agg_outcomes block's shared state and its per-cell steps.
struct Outcomes {
  const Key* conv_keys;  // [T]
  const Key* rev_keys;   // [T] ("sum"), or [0] the day key ("day")
  const float* kwf;      // [kOutFloatRows][K]
  const int* kwi;        // [kOutIntRows][K]
  int* sums;             // [kSums][K]
  const float* recip;    // [j]: __fdiv_rn(1, j)
  int K, m0, m1, bits;

  // the conversion count of a cell with `a` accepted clicks
  __device__ int conversions(int tk, int a) const {
    const int t = tk >> 16, k = tk & 0xFFFF;
    const WalkConsts w{kwf[kOneMinusQ * K + k], kwf[kRatio * K + k], kwi[kFlip * K + k] != 0};
    const float* table = recip;
    const int nconv = walk_count(lane_uniform(conv_keys[t], k, bits), a, w, t == 0 ? m0 : m1,
                                 [table](int j) { return table[j]; });
    if (nconv != 0) atomicAdd(&sums[kSumConv * K + k], nconv);
    return nconv;
  }

  // the revenue cents of n > 0 conversions at the normal of `key` at k
  __device__ int revenue(Key key, int k, int n) const {
    return rev_sum(n, kwf[kMeanC * K + k], kwf[kStdC * K + k], kwf[kRevStd * K + k],
                   xla_normal(key, static_cast<uint32_t>(k)));
  }
};

// The revenue queue's last `count` entries (the lanes below it), one per lane.
__device__ __forceinline__ void drain_revenue(const Outcomes& o, int2* qr, int first, int count,
                                              int lane) {
  const int2 entry = lane < count ? qr[first + lane] : make_int2(0, 0);
  __syncwarp();
  if (lane < count) {
    const int t = entry.x >> 16, k = entry.x & 0xFFFF;
    atomicAdd(&o.sums[kSumRev * o.K + k], o.revenue(o.rev_keys[t], k, entry.y));
  }
}

// The conversion queue's last `count` entries, one per lane; in "sum" mode
// the cells that convert join the revenue queue, which is drained 32 at a
// time.
__device__ __forceinline__ void drain_conversions(const Outcomes& o, int2* qc, int first,
                                                  int count, int2* qr, int& nr, bool rev_day,
                                                  int lane) {
  const int2 entry = lane < count ? qc[first + lane] : make_int2(0, 0);
  __syncwarp();
  const int nconv = lane < count ? o.conversions(entry.x, entry.y) : 0;
  if (rev_day) return;
  enqueue(qr, nr, nconv > 0, make_int2(entry.x, nconv), lane);
  if (nr >= 32) {
    __syncwarp();
    nr -= 32;
    drain_revenue(o, qr, nr, 32, lane);
  }
}

// agg_outcomes: the post-gate phase of one env per block. Its simulated
// cells c = t * K + k < n_sim are read in warp tiles of 32 consecutive
// cells (coalesced, no lane idle on K mod 32); the cheap sums
// go to shared memory by integer atomics, and the cells with accepted
// clicks join the warp's queue, whose conversion draws run 32 at a time,
// one per lane; in "sum" mode the cells that convert join a second queue
// for their revenue normals. In "day" mode (rev_day) one revenue normal
// per keyword with conversions follows the sums. Integer sums are exact in
// any order, so the outputs are the plain version's.
__global__ void __launch_bounds__(kThreads)
    agg_outcomes_kernel(const float* __restrict__ params, const long long* __restrict__ keys,
                        long long key_stride, const int* __restrict__ imp,
                        const int* __restrict__ acc, const int* __restrict__ spend,
                        const int* __restrict__ n_sim, const int* __restrict__ n_auc01,
                        int* __restrict__ out, int E, int K, int T, int m0, int m1, int bits,
                        int rev_day) {
  extern __shared__ unsigned long long smem[];
  Key* conv_keys = reinterpret_cast<Key*>(smem);
  Key* rev_keys = conv_keys + T;
  int2* queues = reinterpret_cast<int2*>(rev_keys + T + 1);  // [warp][2][kQueue]
  float* kwf = reinterpret_cast<float*>(queues + 2 * kQueue * kOutWarps);
  int* kwi = reinterpret_cast<int*>(kwf + kOutFloatRows * K);
  int* sums = kwi + kOutIntRows * K;
  float* recip = reinterpret_cast<float*>(sums + kSums * K);

  const int e = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long EK = static_cast<long long>(E) * K;
  const long long eK = static_cast<long long>(e) * K;
  const int nsim = n_sim[e];
  const int nmax = max(m0, m1);

  // the prologue, all threads: the keys of the sub-timesteps with a
  // simulated cell (k_conv, and k_rev or the day key), two blocks each;
  // each keyword's walk constants, revenue moments and auction counts; the
  // sums zeroed; the table of 1/j
  const Key kc = load_key(keys, key_stride, e);
  const int t_end = min(T, (nsim + K - 1) / K);
  for (int j = tid; j < (rev_day ? t_end + 1 : 2 * t_end); j += kThreads) {
    if (j < t_end) {
      conv_keys[j] = child(child(kc, static_cast<uint32_t>(j)), 2);
    } else if (rev_day) {
      rev_keys[0] = child(child(kc, static_cast<uint32_t>(T)), 3);
    } else {
      rev_keys[j - t_end] = child(child(kc, static_cast<uint32_t>(j - t_end)), 3);
    }
  }
  for (int k = tid; k < K; k += kThreads) {
    const long long ek = eK + k;
    const WalkConsts w = walk_consts(params[SCTR * EK + ek]);
    const float rev_std = params[REV_STD * EK + ek];
    const float2 moments = rev_moments(params[REV_MEAN * EK + ek], rev_std);
    kwf[kOneMinusQ * K + k] = w.omq;
    kwf[kRatio * K + k] = w.r;
    kwf[kMeanC * K + k] = moments.x;
    kwf[kStdC * K + k] = moments.y;
    kwf[kRevStd * K + k] = rev_std;
    kwi[kN0 * K + k] = n_auc01[ek];
    kwi[kN1 * K + k] = n_auc01[EK + ek];
    kwi[kFlip * K + k] = w.flip;
#pragma unroll
    for (int i = 0; i < kSums; ++i) sums[i * K + k] = 0;
  }
  for (int j = tid; j < nmax; j += kThreads) recip[j] = __fdiv_rn(1.0f, static_cast<float>(j));
#ifdef AGG_STAGE_CLOCKS
  unsigned long long mark = clock64(), spent[kOutStages] = {};
  const auto lap = [&](int stage) {
    if (tid == 0) {
      const unsigned long long now = clock64();
      spent[stage] += now - mark;
      mark = now;
    }
  };
#else
  const auto lap = [](int) {};
#endif
  __syncthreads();
  lap(0);

  const Outcomes o{conv_keys, rev_keys, kwf, kwi, sums, recip, K, m0, m1, bits};
  int2* qc = queues + warp * 2 * kQueue;
  int2* qr = qc + kQueue;
  int nc = 0, nr = 0;  // the queues' lengths, warp-uniform
  const long long row = static_cast<long long>(e) * T * K;
  const int step_t = kThreads / K, step_k = kThreads % K;
  int t = (warp * 32 + lane) / K;
  int k = warp * 32 + lane - t * K;
  // each tile's loads are issued one tile ahead, so they are in flight
  // while the warp adds up and draws the tile before
  int a_next = 0, im_next = 0, sp_next = 0;
  if (warp * 32 + lane < nsim) {
    a_next = acc[row + warp * 32 + lane];
    im_next = imp[row + warp * 32 + lane];
    sp_next = spend[row + warp * 32 + lane];
  }
  for (int base = warp * 32; base < nsim; base += kThreads) {
    const int a = a_next, im = im_next, sp = sp_next;
    const int c = base + kThreads + lane;
    const bool in = c < nsim;
    a_next = in ? acc[row + c] : 0;
    im_next = in ? imp[row + c] : 0;
    sp_next = in ? spend[row + c] : 0;
    if (im != 0) {
      atomicAdd(&sums[kSumImp * K + k], im);
      atomicAdd(&sums[kSumElig * K + k], kwi[(t == 0 ? kN0 : kN1) * K + k]);
    }
    if (a != 0) atomicAdd(&sums[kSumClicks * K + k], a);
    if (sp != 0) atomicAdd(&sums[kSumCost * K + k], sp);
    // a walk over zero trials counts zero: only cells with clicks draw
    enqueue(qc, nc, a > 0, make_int2((t << 16) | k, a), lane);
    if (nc >= 32) {
      lap(1);
      __syncwarp();
      nc -= 32;
      drain_conversions(o, qc, nc, 32, qr, nr, rev_day, lane);
      lap(2);
    }
    t += step_t;
    k += step_k;
    if (k >= K) {
      k -= K;
      ++t;
    }
  }
  lap(1);
  // what is left in the queues, fewer than 32 each
  __syncwarp();
  if (nc > 0) drain_conversions(o, qc, 0, nc, qr, nr, rev_day, lane);
  __syncwarp();
  if (nr > 0) drain_revenue(o, qr, 0, nr, lane);
  __syncthreads();

  for (int j = tid; j < K; j += kThreads) {
    const long long ek = eK + j;
    const int conv = sums[kSumConv * K + j];
    // "day": one draw per keyword from the day's conversions
    const int rev = !rev_day ? sums[kSumRev * K + j] : conv > 0 ? o.revenue(rev_keys[0], j, conv) : 0;
    out[ek] = sums[kSumImp * K + j];
    out[EK + ek] = sums[kSumClicks * K + j];
    out[2 * EK + ek] = sums[kSumCost * K + j];
    out[3 * EK + ek] = conv;
    out[4 * EK + ek] = rev;
    out[5 * EK + ek] = sums[kSumElig * K + j];
  }
  lap(3);
#ifdef AGG_STAGE_CLOCKS
  if (tid == 0) {
    for (int i = 0; i < kOutStages; ++i) atomicAdd(&g_outcomes_clocks[i], spent[i]);
    atomicAdd(&g_outcomes_clocks[kOutStages], 1ull);
  }
#endif
}

// agg_cells_gate's instance for a cost model
const void* cells_gate_kernel(int model) {
  switch (model) {
    case kExplicitRust:
      return reinterpret_cast<const void*>(agg_cells_gate_kernel<kExplicitRust>);
    case kExplicitPython:
      return reinterpret_cast<const void*>(agg_cells_gate_kernel<kExplicitPython>);
    case kPool:
      return reinterpret_cast<const void*>(agg_cells_gate_kernel<kPool>);
    default:
      return reinterpret_cast<const void*>(agg_cells_gate_kernel<kImplicit>);
  }
}

// The dynamic shared memory an agg_cells_gate block may take on `device`:
// the device's opt-in shared memory per block less the largest static
// shared memory of the kernel's instances.
cudaError_t smem_limit(int device, int* bytes) {
  cudaError_t err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  int most = 0;
  for (int model = 0; err == cudaSuccess && model < kModels; ++model) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, cells_gate_kernel(model));
    if (err == cudaSuccess && static_cast<int>(attr.sharedSizeBytes) > most) {
      most = static_cast<int>(attr.sharedSizeBytes);
    }
  }
  if (err == cudaSuccess) *bytes -= most;
  return err;
}

// Lets agg_cells_gate blocks of every instance on the current device,
// `device`, take up to smem_limit, with shared memory preferred over L1
// (the kernel reads device memory only to stage); done once per device.
cudaError_t cells_gate_configure(int device) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  const bool known = device >= 0 && device < kMaxDevices;
  std::lock_guard<std::mutex> lock(mu);
  if (known && done[device]) return cudaSuccess;
  int limit = 0;
  cudaError_t err = smem_limit(device, &limit);
  for (int model = 0; err == cudaSuccess && model < kModels; ++model) {
    err = cudaFuncSetAttribute(cells_gate_kernel(model),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(cells_gate_kernel(model),
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
  }
  if (err == cudaSuccess && known) done[device] = true;
  return err;
}

// Resident blocks per SM of the cost model's agg_cells_gate instance (the
// instances share their shared memory but not their registers); 0 when a
// block needs more shared memory than the device gives one.
cudaError_t cells_gate_occupancy(int model, int chunk_t, int K, int m0, int m1, int L, int kmax,
                                 int device, int* blocks_per_sm) {
  int limit = 0;
  cudaError_t err = smem_limit(device, &limit);
  if (err != cudaSuccess) return err;
  const size_t smem = cells_gate_smem(chunk_t, K, m0, m1, L, model, kmax);
  *blocks_per_sm = 0;
  if (smem > static_cast<size_t>(limit)) return cudaSuccess;
  err = cells_gate_configure(device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, cells_gate_kernel(model), cells_gate_threads(model), smem);
}

// Lets agg_outcomes blocks take `smem` bytes of dynamic shared memory: past
// the default 48 KB only after opting in (K above about 700).
cudaError_t outcomes_allow(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(agg_outcomes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` of `device` and returns cudaGetLastError()
// right after the launch (the library's runtime has its own current device).

// agg_cells_gate: imp, acc, spend (E, T, K) of the simulated cells (those
// with t * K + k < n_sim[e]; the others are not written) and n_sim (E,),
// for the cost model `model` (0 implicit, 1 explicit rust, 2 explicit
// python, whose moments sum cost_grid cent cells, 3 the binomial pool,
// whose quadrature `quad` (agg_day.pool_quad_rows: the 48 nodes and
// weights, then the node powers, 48 x kmax) and bidder bound kmax the
// others ignore). consts_out, if not null, receives the (4 + m1, E, K)
// constants the day used: p_win, cost mu, sigma, cmax, then the ladder's m1
// levels; for the pool (1 + kmax, E, K): F(bid), then the bidder ladder's
// kmax levels. cent_bids (the pool's): F(bid) as the env's program
// computes it from its rounded bids (bid_cdf).
int agg_cells_gate_launch(const float* params, const int* n_auc01, const long long* keys,
                          long long key_stride, const int* budget_c, int* imp, int* acc,
                          int* spend, int* n_sim, float* consts_out, int E, int K, int T, int m0,
                          int m1, int L, int bits, int chunk_t, int model, int cost_grid,
                          const float* quad, int kmax, int cent_bids, int device, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || T < 1 || m0 < 1 || m1 < 1 || L < 1 || L > m1 || chunk_t < 1 || model < 0 ||
      model >= kModels || (model == kExplicitPython && (cost_grid <= 32 || cost_grid > 1024)) ||
      (model == kPool && (kmax < 1 || quad == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_t = chunk_t < T ? chunk_t : T;
  const size_t smem = cells_gate_smem(chunk_t, K, m0, m1, L, model, kmax);
  err = cells_gate_configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  decltype(&agg_cells_gate_kernel<kImplicit>) kernel = agg_cells_gate_kernel<kImplicit>;
  if (model == kExplicitRust) kernel = agg_cells_gate_kernel<kExplicitRust>;
  if (model == kExplicitPython) kernel = agg_cells_gate_kernel<kExplicitPython>;
  if (model == kPool) kernel = agg_cells_gate_kernel<kPool>;
  kernel<<<E, cells_gate_threads(model), smem, static_cast<cudaStream_t>(stream)>>>(
      params, n_auc01, keys, key_stride, budget_c, imp, acc, spend, n_sim, consts_out, E, K, T,
      m0, m1, L, bits, chunk_t, cost_grid, quad, kmax, cent_bids);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the cost model's agg_cells_gate at chunk_t into
// *blocks_per_sm; 0 when a block needs more shared memory than the device
// gives one.
int agg_cells_gate_occupancy(int model, int chunk_t, int K, int m0, int m1, int L, int kmax,
                             int device, int* blocks_per_sm) {
  if (model < 0 || model >= kModels) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cells_gate_occupancy(model, chunk_t, K, m0, m1, L, kmax, device, blocks_per_sm));
}

// The largest chunk_t <= T that keeps kMinBlocks blocks of the cost model's
// instance resident per SM (or as many as chunk_t = 1 keeps) into
// *chunk_t; 0 if not even chunk_t = 1 fits the device's shared memory per
// block.
int agg_cells_gate_default_chunk_t(int model, int K, int T, int m0, int m1, int L, int kmax,
                                   int device, int* chunk_t) {
  if (model < 0 || model >= kModels) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int target = 0, blocks = 0;
  err = cells_gate_occupancy(model, 1, K, m0, m1, L, kmax, device, &target);
  *chunk_t = 0;
  if (err != cudaSuccess || target == 0) return static_cast<int>(err);
  if (target > kMinBlocks) target = kMinBlocks;
  for (*chunk_t = 1; err == cudaSuccess && *chunk_t < T; ++*chunk_t) {
    err = cells_gate_occupancy(model, *chunk_t + 1, K, m0, m1, L, kmax, device, &blocks);
    if (blocks < target) break;
  }
  return static_cast<int>(err);
}

// Bytes of dynamic shared memory a block of the cost model's agg_cells_gate
// takes at chunk_t.
long long agg_cells_gate_smem_bytes(int chunk_t, int K, int m0, int m1, int L, int model,
                                    int kmax) {
  return static_cast<long long>(cells_gate_smem(chunk_t, K, m0, m1, L, model, kmax));
}

// The dynamic shared memory an agg_cells_gate block may take into *bytes.
int agg_cells_gate_smem_limit(int device, int* bytes) {
  return static_cast<int>(smem_limit(device, bytes));
}

#ifdef AGG_STAGE_CLOCKS
// A kernel's stage clocks summed since the last call into out (per stage,
// then the number of blocks), synchronizing with the device first; zeroes
// them.
static int take_clocks(int device, const void* symbol, size_t bytes, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, symbol, bytes);
  unsigned long long zero[(kStages > kOutStages ? kStages : kOutStages) + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(symbol, zero, bytes);
  return static_cast<int>(err);
}

int agg_cells_gate_stage_clocks(int device, unsigned long long* out) {
  return take_clocks(device, g_stage_clocks, sizeof(g_stage_clocks), out);
}

int agg_outcomes_stage_clocks(int device, unsigned long long* out) {
  return take_clocks(device, g_outcomes_clocks, sizeof(g_outcomes_clocks), out);
}

// The pool instance's stage A clocks by part (g_pool_clocks), as above.
int agg_cells_gate_pool_clocks(int device, unsigned long long* out) {
  return take_clocks(device, g_pool_clocks, sizeof(g_pool_clocks), out);
}
#endif

// agg_outcomes: the six (E, K) day sums into out (6, E, K) from the
// simulated cells; revenue per cell (rev_day 0) or per keyword and day (1).
int agg_outcomes_launch(const float* params, const long long* keys, long long key_stride,
                        const int* imp, const int* acc, const int* spend, const int* n_sim,
                        const int* n_auc01, int* out, int E, int K, int T, int m0, int m1,
                        int bits, int rev_day, int device, void* stream) {
  if (E <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  if (K > 0xFFFF || T < 1 || T > 0x7FFF || m0 < 1 || m1 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = outcomes_smem(K, T, m0, m1);
  err = outcomes_allow(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  agg_outcomes_kernel<<<E, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, keys, key_stride, imp, acc, spend, n_sim, n_auc01, out, E, K, T, m0, m1, bits,
      rev_day);
  return static_cast<int>(cudaGetLastError());
}

// Resident agg_outcomes blocks per SM into *blocks_per_sm, and its shared
// memory per block into *smem_bytes.
int agg_outcomes_occupancy(int K, int T, int m0, int m1, int device, int* blocks_per_sm,
                           long long* smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = outcomes_smem(K, T, m0, m1);
  *smem_bytes = static_cast<long long>(smem);
  err = outcomes_allow(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, agg_outcomes_kernel, kThreads, smem));
}

const char* agg_day_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
