// Day kernel for Hopper (sm_90a): a whole lanes-semantics day of bidding
// for a batch of envs, implicit single-competitor keywords.
//
// Replaces the TPU kernel adcraft_tpu/pallas_kernels.py:_day_kernel (:92),
// launched there by pallas_simulate_day (:237). The plain PyTorch version
// of the same function is adcraft_tpu_torch/day_kernel.py:
// simulate_day_reference; adcraft_tpu_torch/day_kernel.py documents the
// semantics step by step.
//
// What bounds it: integer and transcendental work on random words, not
// bytes. Per env-day it reads 8*K + T*K + 1 words and writes 6*K + 1,
// while every active lane costs one to five threefry2x32 blocks (about
// 100 integer operations each) plus logf/cosf/sqrtf. The design keeps all
// intermediate state on chip and draws only for lanes that need a draw
// (counter-based words make skipping free).
//
// Design:
// * One block per env. The TPU kernel's sequential grid axis over
//   sub-timesteps becomes a loop inside the block; the remaining budget
//   and the broken flag stay in shared memory across t.
// * Phase A, one warp per keyword (strided): the lanes of a cell, 32 at a
//   time, draw the competitor bid and the click; a warp scan gives each
//   lane its running clicked cost, kept in shared memory (K*m ints).
// * Phase B, warp 0: the budget gate as a sequential walk over keywords.
//   A cell whose full clicked cost fits the budget is accepted whole;
//   otherwise its lanes are resolved against the shared running sums.
//   This is the exact forward substitution that the TPU kernel's Jacobi
//   sweeps converge to, so the gate_converged flag is always 1; the
//   output is kept for the interface.
// * Phase C, one warp per keyword: conversions and Box-Muller revenue on
//   accepted clicks, and the per-keyword day sums in shared memory,
//   written to device memory once at the end.
//
// Random numbers: the TPU's hardware bits have no GPU twin. Each draw is
// the word y0 ^ y1 of threefry2x32(key = (seed, global env index),
// count = (t * 5 + draw, k * m + lane)). The TPU kernel seeds per env
// block, so its results depend on the block size; keying by the global
// env index makes these results independent of the launch layout. The
// word becomes (bits & 0xFFFFFF) * 2^-24 clipped to [1e-7, 1 - 1e-7], the
// TPU kernel's transform (unsigned bits: no sign-extension hazard).
//
// Numerics match PyTorch's eager CUDA ops bit for bit: every product and
// sum is spelled __fmul_rn / __fadd_rn, which nvcc never contracts into an
// FMA (PyTorch rounds a + b*c twice, one op per kernel); no fast math, so
// logf, cosf and sqrtf are the same library functions PyTorch's kernels
// call, built with the same default flags; rounding is rintf (half to
// even, as torch.round and jnp.round).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNumDraws = 5;
constexpr int kDrawComp = 0, kDrawClick = 1, kDrawConv = 2, kDrawRev1 = 3, kDrawRev2 = 4;
constexpr float kInv24 = 1.0f / 16777216.0f;
constexpr float kULo = 1.0000000116860974e-07f;  // f32(1e-7)
constexpr float kUHi = 0.9999998807907104f;      // f32(1 - 1e-7)
constexpr float kTwoPi = 6.2831854820251465f;    // f32(2 * pi)
constexpr int kNotClicked = -1;                  // running sums of clicks are >= 0

struct Rng {
  uint32_t k0, k1;  // (seed, env)
  int m;
  __device__ __forceinline__ float uniform(int t, int draw, int k, int lane) const {
    const uint32_t bits = threefry::word(k0, k1, static_cast<uint32_t>(t * kNumDraws + draw),
                                         static_cast<uint32_t>(k * m + lane));
    const float u = static_cast<float>(bits & 0x00FFFFFFu) * kInv24;
    return fminf(fmaxf(u, kULo), kUHi);
  }
};

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Shared memory layout (ints): prefix[K*m], then K-long arrays.
enum KArray {
  kLanes,   // min(n_auc, m): the cell's lanes this t
  kWon,     // won auctions
  kClicks,  // clicked lanes
  kSFull,   // all clicked cost
  kSim,     // 1 if the cell is simulated
  kStart,   // budget at the cell's start
  kAccP,    // accepted clicks
  kSpend,   // accepted cost
  kSumImp,  // day sums: impressions, clicks, cost, conversions, revenue,
  kSumClk,  //   eligible volume
  kSumCost,
  kSumConv,
  kSumRev,
  kSumElig,
  kNumKArrays
};

__global__ void __launch_bounds__(kThreads)
    day_kernel(const float* __restrict__ params, const int* __restrict__ n_auc,
               const int* __restrict__ budget, const int* __restrict__ seed,
               int* __restrict__ out_imp, int* __restrict__ out_clicks,
               int* __restrict__ out_cost, int* __restrict__ out_convs,
               int* __restrict__ out_rev, int* __restrict__ out_elig,
               int* __restrict__ out_flag, int E, int K, int T, int m) {
  extern __shared__ int smem[];
  int* prefix = smem;
  int* karr = smem + K * m;
  auto ka = [&](KArray a, int k) -> int& { return karr[a * K + k]; };
  __shared__ int s_budget, s_broken;

  const int e = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane_id = threadIdx.x % 32;
  const long long EK = static_cast<long long>(E) * K;
  const Rng rng{static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(e), m};

  for (int i = threadIdx.x; i < kNumKArrays * K; i += kThreads) karr[i] = 0;
  if (threadIdx.x == 0) {
    s_budget = budget[e];
    s_broken = 0;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (s_broken) break;  // a broken day simulates nothing more

    // Phase A: competitor bids, wins, clicks, running clicked cost.
    for (int k = warp; k < K; k += kWarps) {
      const long long ek = static_cast<long long>(e) * K + k;
      const int n = n_auc[t * EK + ek];
      const int lanes = max(0, min(n, m));
      const int bid_c = static_cast<int>(params[0 * EK + ek]);
      const float loc = params[1 * EK + ek];
      const float scale = params[2 * EK + ek];
      const float bctr = params[3 * EK + ek];
      int carry = 0, won_n = 0, click_n = 0;
      for (int base = 0; base < lanes; base += 32) {
        const int lane = base + lane_id;
        bool won = false, clicked = false;
        int cost = 0;
        if (lane < lanes) {
          const float u = rng.uniform(t, kDrawComp, k, lane);
          const float lap = u < 0.5f ? logf(__fmul_rn(2.0f, u))
                                     : -logf(__fmul_rn(2.0f, __fsub_rn(1.0f, u)));
          const float x = __fadd_rn(loc, __fmul_rn(scale, lap));
          const int c = static_cast<int>(rintf(__fmul_rn(100.0f, fabsf(x))));
          won = c < bid_c;
          if (won) clicked = rng.uniform(t, kDrawClick, k, lane) <= bctr;
          cost = clicked ? c : 0;
        }
        int x = cost;  // inclusive warp scan
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, x, o);
          if (lane_id >= o) x += y;
        }
        const int run = carry + x;
        if (lane < lanes) prefix[k * m + lane] = clicked ? run : kNotClicked;
        carry = __shfl_sync(kFull, run, 31);
        won_n += __popc(__ballot_sync(kFull, won));
        click_n += __popc(__ballot_sync(kFull, clicked));
      }
      if (lane_id == 0) {
        ka(kLanes, k) = lanes;
        ka(kWon, k) = won_n;
        ka(kClicks, k) = click_n;
        ka(kSFull, k) = carry;
      }
    }
    __syncthreads();

    // Phase B: the budget gate, keyword by keyword (warp 0).
    if (warp == 0) {
      int b = s_budget;
      bool broken = false;
      for (int k = 0; k < K; ++k) {
        if (broken) {
          if (lane_id == 0) ka(kSim, k) = 0;
          continue;
        }
        const int start = b;
        int spend, accepted;
        if (ka(kSFull, k) <= start) {
          spend = ka(kSFull, k);
          accepted = ka(kClicks, k);
        } else {
          // accepted lanes: clicked with running sum within the start
          // budget; they are the first clicked lanes, so the accepted
          // cost is the largest accepted running sum
          const int lanes = ka(kLanes, k);
          int cnt = 0, top = 0;
          for (int base = 0; base < lanes; base += 32) {
            const int lane = base + lane_id;
            const int run = lane < lanes ? prefix[k * m + lane] : kNotClicked;
            const bool acc = run != kNotClicked && run <= start;
            cnt += __popc(__ballot_sync(kFull, acc));
            if (acc) top = max(top, run);
          }
          spend = warp_max(top);
          accepted = cnt;
        }
        b = start - spend;
        broken = b <= 0;  // the breaking cell itself counts
        if (lane_id == 0) {
          ka(kSim, k) = 1;
          ka(kStart, k) = start;
          ka(kAccP, k) = accepted;
          ka(kSpend, k) = spend;
        }
      }
      if (lane_id == 0) {
        s_budget = b;
        s_broken = broken ? 1 : 0;
      }
    }
    __syncthreads();

    // Phase C: conversions and revenue on accepted clicks; day sums.
    for (int k = warp; k < K; k += kWarps) {
      if (!ka(kSim, k)) continue;
      const long long ek = static_cast<long long>(e) * K + k;
      int conv_n = 0, rev_sum = 0;
      if (ka(kAccP, k) > 0) {
        const float sctr = params[4 * EK + ek];
        const float rev_mean = params[5 * EK + ek];
        const float rev_std = params[6 * EK + ek];
        const int start = ka(kStart, k);
        const int lanes = ka(kLanes, k);
        for (int base = 0; base < lanes; base += 32) {
          const int lane = base + lane_id;
          bool conv = false;
          if (lane < lanes) {
            const int run = prefix[k * m + lane];
            if (run != kNotClicked && run <= start) {
              conv = rng.uniform(t, kDrawConv, k, lane) <= sctr;
            }
          }
          if (conv) {
            const float u1 = rng.uniform(t, kDrawRev1, k, lane);
            const float u2 = rng.uniform(t, kDrawRev2, k, lane);
            const float normal = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                                           cosf(__fmul_rn(kTwoPi, u2)));
            const float rev = fmaxf(__fadd_rn(rev_mean, __fmul_rn(rev_std, normal)), 0.01f);
            rev_sum += static_cast<int>(rintf(__fmul_rn(100.0f, rev)));
          }
          conv_n += __popc(__ballot_sync(kFull, conv));
        }
        rev_sum = warp_sum(rev_sum);
      }
      if (lane_id == 0) {
        const int won_n = ka(kWon, k);
        ka(kSumImp, k) += won_n;
        ka(kSumClk, k) += ka(kAccP, k);
        ka(kSumCost, k) += ka(kSpend, k);
        ka(kSumConv, k) += conv_n;
        ka(kSumRev, k) += rev_sum;
        if (won_n >= 1) ka(kSumElig, k) += n_auc[t * EK + ek];
      }
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < K; k += kThreads) {
    const long long ek = static_cast<long long>(e) * K + k;
    out_imp[ek] = ka(kSumImp, k);
    out_clicks[ek] = ka(kSumClk, k);
    out_cost[ek] = ka(kSumCost, k);
    out_convs[ek] = ka(kSumConv, k);
    out_rev[ek] = ka(kSumRev, k);
    out_elig[ek] = ka(kSumElig, k);
  }
  if (threadIdx.x == 0) out_flag[e] = 1;
}

}  // namespace

extern "C" {

// Launches on `stream` of `device`; returns cudaGetLastError() right after
// the launch. The library links its own CUDA runtime, whose current device
// is not PyTorch's, so the caller names the device.
int day_kernel_launch(const float* params, const int* n_auc, const int* budget, const int* seed,
                      int* out_imp, int* out_clicks, int* out_cost, int* out_convs,
                      int* out_rev, int* out_elig, int* out_flag, int E, int K, int T, int m,
                      int device, void* stream) {
  if (E == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(K) * m + kNumKArrays * static_cast<size_t>(K));
  err = cudaFuncSetAttribute(day_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  day_kernel<<<E, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, n_auc, budget, seed, out_imp, out_clicks, out_cost, out_convs, out_rev, out_elig,
      out_flag, E, K, T, m);
  return static_cast<int>(cudaGetLastError());
}

const char* day_kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
