// The lanes day on Hopper (sm_90a): three kernels for the three phases of
// adcraft_tpu/step.py:simulate_day (:991) in the JAX package's default
// configuration (cost, conversion and revenue lanes, jax.random.binomial,
// implicit single-competitor keywords). The JAX package left these phases
// to XLA, so no Pallas kernel constrains them:
//
// * lanes_counts replaces _cell_tables' impressions and clicks
//   (run_cell_auctions -> implicit_single_auction, auction.py:126, and the
//   clicks binomial, step.py:934): one block per (env, sub-timestep), one
//   thread per keyword, each binomial one block-wide lockstep call of K
//   elements (binomial.cuh), or the inverse-CDF walk (sampler "inversion");
// * lanes_gate replaces the cost lanes (implicit_single_auction's truncated
//   Laplace, in cents) and the budget gate over the T K cells in (t, k)
//   order (_gate_keywords, step.py:115; the lazy and Jacobi TPU schedules
//   are bit-identical to it): one warp per env walks the cells, drawing a
//   cell's cost lanes 32 at a time, a warp scan and a ballot finding the
//   first prefix over the budget;
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
// polynomial and its log1p). A first version: lanes_gate's walk is one
// warp's dependent chain per env, and lanes_counts' loops run to the
// slowest element of each call, as jax.random.binomial's do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "binomial.cuh"
#include "jax_random.cuh"
#include "threefry.cuh"
#include "xla_math.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kGateWarps = 4;        // envs per lanes_gate block, one warp each
constexpr int kOutcomeThreads = 256;  // threads of a lanes_outcomes block
constexpr int kMaxK = 1024;          // keywords of a lanes_counts call: one block

// int32 arithmetic that wraps, as the plain version's (XLA's) int32 sums do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// implicit_single_win_prob: P(|Laplace(loc, scale)| < bid - 0.005) in [0, 1]
__device__ __forceinline__ float win_prob(float bid, float loc, float scale) {
  const float y0 = __fsub_rn(bid, 0.005f);
  return fminf(fmaxf(__fsub_rn(laplace_cdf(y0, loc, scale), laplace_cdf(-y0, loc, scale)), 0.0f),
               1.0f);
}

__global__ void lanes_counts_kernel(const float* __restrict__ params,
                                    const int* __restrict__ n_auc01,
                                    const long long* __restrict__ keys, long long key_stride,
                                    int* __restrict__ imp, int* __restrict__ ncl, int E, int K,
                                    int T, int m0, int m1, int bits, int exact) {
  const int e = blockIdx.x / T, t = blockIdx.x % T;
  const int k = threadIdx.x;
  const bool in_call = k < K;
  const long long EK = static_cast<long long>(E) * K;
  const long long ek = static_cast<long long>(e) * K + (in_call ? k : 0);
  const Key kt = child(load_key(keys, key_stride, e), static_cast<uint32_t>(t));
  const Key k_auc = child(kt, 0), k_click = child(kt, 1);
  const Key k_imp = child(k_auc, 0);
  const float p_win = win_prob(params[BID * EK + ek], params[LOC * EK + ek],
                               params[SCALE * EK + ek]);
  const float bctr = params[BCTR * EK + ek];
  const int n = n_auc01[(t == 0 ? 0 : EK) + ek];
  int im, cl;
  if (exact) {
    im = binomial_call(k_imp, in_call, static_cast<float>(n), p_win);
    cl = binomial_call(k_click, in_call, static_cast<float>(im), bctr);
  } else {
    const int m = t == 0 ? m0 : m1;
    auto recip = [](int j) { return __fdiv_rn(1.0f, static_cast<float>(j)); };
    im = binomial_walk(lane_uniform(k_imp, k, bits), n, p_win, m, recip);
    cl = binomial_walk(lane_uniform(k_click, k, bits), im, bctr, m, recip);
  }
  if (in_call) {
    const long long cell = (static_cast<long long>(e) * T + t) * K + k;
    imp[cell] = im;
    ncl[cell] = cl;
  }
}

// One warp per env: the cells in (t, k) order. A cell accepts its longest
// prefix of clicks whose running cost sums all stay <= the budget; the day
// breaks once the budget is <= 0, and no cell at or past the break is
// written (n_sim counts the simulated cells).
__global__ void lanes_gate_kernel(const float* __restrict__ params,
                                  const long long* __restrict__ keys, long long key_stride,
                                  const int* __restrict__ ncl, const int* __restrict__ budget_c,
                                  int* __restrict__ acc, int* __restrict__ spend,
                                  int* __restrict__ n_sim, int E, int K, int T, int bits) {
  const int e = blockIdx.x * kGateWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= E) return;
  const long long EK = static_cast<long long>(E) * K;
  const Key kc = load_key(keys, key_stride, e);
  int b = budget_c[e];
  int cells = 0;
  bool broken = false;
  for (int t = 0; t < T && !broken; ++t) {
    const Key k_cost = child(child(child(kc, static_cast<uint32_t>(t)), 0), 1);
    for (int k = 0; k < K && !broken; ++k) {
      const long long ek = static_cast<long long>(e) * K + k;
      const long long cell = (static_cast<long long>(e) * T + t) * K + k;
      const int n = ncl[cell];
      int p = 0, run = 0;
      if (n > 0) {
        const float bid = params[BID * EK + ek];
        const float loc = params[LOC * EK + ek], scale = params[SCALE * EK + ek];
        const float y0 = __fsub_rn(bid, 0.005f);
        const float f_lo = laplace_cdf(-y0, loc, scale), f_hi = laplace_cdf(y0, loc, scale);
        for (int j0 = 0; j0 < n; j0 += 32) {
          const int j = j0 + lane;
          int c = 0;
          if (j < n) {
            c = lane_cost(lane_uniform(k_cost, static_cast<uint32_t>(j * K + k), bits), loc,
                          scale, f_lo, f_hi);
          }
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(kFull, c, d);
            if (lane >= d) c = wrap_add(c, up);
          }
          const int pre = wrap_add(run, c);
          const unsigned over = __ballot_sync(kFull, j < n && pre > b);
          if (over != 0u) {
            const int first = __ffs(over) - 1;
            const int before = __shfl_sync(kFull, pre, first > 0 ? first - 1 : 0);
            p = j0 + first;
            run = first > 0 ? before : run;
            break;
          }
          const int last = (n - j0 < 32 ? n - j0 : 32) - 1;
          run = __shfl_sync(kFull, pre, last);
          p = j0 + last + 1;
        }
      }
      if (lane == 0) {
        acc[cell] = p;
        spend[cell] = run;
      }
      b = static_cast<int>(static_cast<uint32_t>(b) - static_cast<uint32_t>(run));
      ++cells;
      broken = b <= 0;
    }
  }
  if (lane == 0) n_sim[e] = cells;
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
  if (K < 1 || K > kMaxK || T < 1 || m0 < 1 || m1 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (K + 31) / 32 * 32;
  lanes_counts_kernel<<<static_cast<unsigned>(E) * T, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(params, n_auc01, keys, key_stride,
                                                             imp, ncl, E, K, T, m0, m1, bits,
                                                             exact);
  return static_cast<int>(cudaGetLastError());
}

// lanes_gate: acc and spend (E, T, K) of the simulated cells (t K + k <
// n_sim[e]; the others are not written) and n_sim (E,).
int lanes_gate_launch(const float* params, const long long* keys, long long key_stride,
                      const int* ncl, const int* budget_c, int* acc, int* spend, int* n_sim, int E,
                      int K, int T, int m0, int m1, int bits, int device, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || T < 1 || m0 < 1 || m1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (E + kGateWarps - 1) / kGateWarps;
  lanes_gate_kernel<<<blocks, 32 * kGateWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      params, keys, key_stride, ncl, budget_c, acc, spend, n_sim, E, K, T, bits);
  return static_cast<int>(cudaGetLastError());
}

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
