// Day kernel for Hopper (sm_90a): a whole lanes-semantics day of bidding
// for a batch of envs, implicit single-competitor keywords.
//
// Replaces the TPU kernel adcraft_tpu/pallas_kernels.py:_day_kernel (:92),
// launched there by pallas_simulate_day (:237). The plain PyTorch version
// of the same function is adcraft_tpu_torch/day_kernel.py:
// simulate_day_reference; adcraft_tpu_torch/day_kernel.py documents the
// semantics step by step.
//
// What bounds it: operations on random words, not bytes. Per env-day it
// reads 7*K + T*K + 1 words and writes 6*K + 1, while every active lane
// costs one to five threefry2x32 words (about 75 integer instructions
// each, on the integer ALU and FMA pipes) plus logf, and every conversion
// logf/cosf/sqrtf. Counter-based words make skipping free, so the kernel
// draws only the words a lane needs, and it keeps every lane busy on them.
//
// Design: one block of kThreads threads per env; the env's 7 x K keyword
// params and its 6 x K day sums live in shared memory for the whole day.
// The T sub-timesteps run in chunks of chunk_t, each in three stages over
// the chunk's cells c = (t - t0) * K + k, in the gate's (t, k) order:
//
// * Stage A, dense lanes (all threads): the competitor word of every
//   active lane and the click word of every won lane do not depend on the
//   budget, so they are drawn for the whole chunk at once. A block scan of
//   min(n_auc, m) gives each cell its offset in one dense lane index space,
//   and each thread takes an equal contiguous run of it: no thread idles on
//   a short cell. Per-cell summaries (won, clicks, full clicked cost, the
//   click mask, the first clicked lane's cost) gather in shared memory by
//   integer atomics, which give the same result in any order.
// * Stage B, the budget gate (warp 0): a walk over the chunk's cells, 32 at
//   a time. A saturating warp scan of the full costs and a ballot accept
//   the leading cells that fit whole and leave budget; in the binding
//   regime a second ballot passes the cells that cannot change the budget
//   (no clicked cost, or a first clicked cost above it). The first other
//   cell is decided on its own; only a cell accepted in part re-draws its
//   clicked lanes' competitor words (one warp, at most m lanes) to find
//   its accepted prefix. The first cell that leaves a budget <= 0 counts
//   and ends the day.
// * Stage C, dense accepted clicks (all threads): a block scan of the
//   accepted counts, then one accepted click per index, mapped to its lane
//   by selecting the j-th set bit of its cell's click mask (the accepted
//   lanes are a prefix of the clicked lanes): the conversion word, and for
//   a conversion both revenue words and Box-Muller. Day sums are integers
//   in shared memory, written to device memory once at the end.
//
// chunk_t trades barriers against waste: each chunk costs 8 block barriers
// and one serial gate walk, and more cells per chunk give stage A and C
// more parallel work; but when the day breaks, stage A has drawn the
// competitor and click words of the chunk's later sub-timesteps for
// nothing (at most chunk_t - 1 of them), and shared memory grows by about
// 24 + 4 * ceil(m / 32) bytes per cell, which bounds the blocks per SM.
// The wrapper takes the largest chunk_t that keeps kMinBlocks resident
// blocks per SM (day_kernel_occupancy). Outputs do not depend on it.
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

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;  // resident blocks per SM the registers are capped for
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kIntMax = 0x7FFFFFFF;
constexpr int kNumDraws = 5;
constexpr int kDrawComp = 0, kDrawClick = 1, kDrawConv = 2, kDrawRev1 = 3, kDrawRev2 = 4;
constexpr float kInv24 = 1.0f / 16777216.0f;
constexpr float kULo = 1.0000000116860974e-07f;  // f32(1e-7)
constexpr float kUHi = 0.9999998807907104f;      // f32(1 - 1e-7)
constexpr float kTwoPi = 6.2831854820251465f;    // f32(2 * pi)
// a cell's won count and its clicks (accepted clicks after the gate) share
// one int: won | clicks << kCountShift, so m must stay below 2^15
constexpr int kCountShift = 16;
constexpr int kCountMask = (1 << kCountShift) - 1;
constexpr int kMaxLanes = 1 << 15;
// first clicked lane of a cell as (lane << 32 | cost), so that atomicMin
// keeps the lowest lane; no clicked lane leaves the all-ones value
constexpr unsigned long long kNoClick = ~0ull;

// float rows of the keyword params in shared memory (params rows 1-6)
enum Param { kLoc, kScale, kBctr, kSctr, kRevMean, kRevStd, kNumParams };
// day sums: impressions, clicks, cost, conversions, revenue, eligible volume
enum Sum { kSumImp, kSumClk, kSumCost, kSumConv, kSumRev, kSumElig, kNumSums };

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

// The competitor bid in cents: round(100 * |loc + scale * Laplace(u)|).
__device__ __forceinline__ int competitor_cents(const Rng& rng, int t, int k, int lane, float loc,
                                                float scale) {
  const float u = rng.uniform(t, kDrawComp, k, lane);
  const bool low = u < 0.5f;  // one logf for both branches: no divergence
  const float l = logf(__fmul_rn(2.0f, low ? u : __fsub_rn(1.0f, u)));
  const float x = __fadd_rn(loc, __fmul_rn(scale, low ? l : -l));
  return static_cast<int>(rintf(__fmul_rn(100.0f, fabsf(x))));
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int inclusive_warp_scan(int x, int lane_id) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane_id >= o) x += y;
  }
  return x;
}

// The cell c with off[c] <= i < off[c + 1], for 0 <= i < off[count].
__device__ __forceinline__ int find_cell(const int* off, int count, int i) {
  int lo = 0, hi = count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// Exclusive scan of value(c) over c < count into off[0..count]; returns the
// total. Each thread scans a contiguous run of cells. Every thread calls it;
// it ends with a barrier.
template <class Value>
__device__ int block_scan(int* off, int count, Value value, int* s_warp) {
  const int lane_id = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (count + kThreads - 1) / kThreads;
  const int lo = min(count, static_cast<int>(threadIdx.x) * per);
  const int hi = min(count, lo + per);
  int sum = 0;
  for (int c = lo; c < hi; ++c) sum += value(c);
  const int x = inclusive_warp_scan(sum, lane_id);
  if (lane_id == 31) s_warp[warp] = x;
  __syncthreads();
  int base = x - sum, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) base += s_warp[w];
    total += s_warp[w];
  }
  for (int c = lo; c < hi; ++c) {
    off[c] = base;
    base += value(c);
  }
  if (threadIdx.x == 0) off[count] = total;
  __syncthreads();
  return total;
}

// Shared memory of one block, in bytes: the first-click words (8-byte
// aligned, first), then bid cents, the float params and the day sums (K
// each), then per cell n_auc, won|clicks, cost, the scan offsets (one
// more) and the click mask (ceil(m / 32) words).
__host__ __device__ inline size_t smem_bytes(int chunk_t, int K, int m) {
  const size_t cells = static_cast<size_t>(chunk_t) * K;
  const size_t words = (m + 31) / 32;
  return cells * sizeof(unsigned long long) +
         sizeof(int) * ((1 + kNumParams + kNumSums) * static_cast<size_t>(K) +
                        cells * (4 + words) + 1);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    day_kernel(const float* __restrict__ params, const int* __restrict__ n_auc,
               const int* __restrict__ budget, const int* __restrict__ seed,
               int* __restrict__ out_imp, int* __restrict__ out_clicks,
               int* __restrict__ out_cost, int* __restrict__ out_convs,
               int* __restrict__ out_rev, int* __restrict__ out_elig,
               int* __restrict__ out_flag, int E, int K, int T, int m, int chunk_t) {
  extern __shared__ unsigned long long smem[];
  const int max_cells = chunk_t * K;
  const int words = (m + 31) / 32;
  unsigned long long* first = smem;
  int* bid = reinterpret_cast<int*>(first + max_cells);
  float* prm = reinterpret_cast<float*>(bid + K);
  int* sums = reinterpret_cast<int*>(prm + kNumParams * K);
  int* n = sums + kNumSums * K;
  int* wc = n + max_cells;    // won | clicks << 16; won | accepted << 16 after the gate
  int* cost = wc + max_cells;  // full clicked cost; accepted cost after the gate
  int* off = cost + max_cells;
  unsigned* mask = reinterpret_cast<unsigned*>(off + max_cells + 1);
  __shared__ int s_budget, s_end, s_broken;
  __shared__ int s_warp[kWarps];

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane_id = tid % 32;
  const long long EK = static_cast<long long>(E) * K;
  const long long eK = static_cast<long long>(e) * K;
  const Rng rng{static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(e), m};

  for (int k = tid; k < K; k += kThreads) {
    bid[k] = static_cast<int>(params[eK + k]);
#pragma unroll
    for (int r = 0; r < kNumParams; ++r) prm[r * K + k] = params[(r + 1) * EK + eK + k];
#pragma unroll
    for (int s = 0; s < kNumSums; ++s) sums[s * K + k] = 0;
  }
  if (tid == 0) {
    s_budget = budget[e];
    s_broken = 0;
  }

  for (int t0 = 0; t0 < T; t0 += chunk_t) {
    const int cells = min(chunk_t, T - t0) * K;

    // the chunk's n_auc rows (K contiguous ints per t) and cleared summaries
    for (int c = tid; c < cells; c += kThreads) {
      const int tt = c / K;
      n[c] = n_auc[(t0 + tt) * EK + eK + (c - tt * K)];
      wc[c] = 0;
      cost[c] = 0;
      first[c] = kNoClick;
    }
    for (int i = tid; i < cells * words; i += kThreads) mask[i] = 0u;
    __syncthreads();

    // Stage A: competitor bids, wins and clicks over the dense lanes.
    const int lanes_total =
        block_scan(off, cells, [&](int c) { return min(max(n[c], 0), m); }, s_warp);
    {
      const int lo = static_cast<int>(static_cast<long long>(lanes_total) * tid / kThreads);
      const int hi = static_cast<int>(static_cast<long long>(lanes_total) * (tid + 1) / kThreads);
      if (lo < hi) {
        int c = find_cell(off, cells, lo);
        int cell_end = off[c + 1];
        int lane = lo - off[c];
        int won_n = 0, click_n = 0, s_full = 0;
        unsigned long long fst = kNoClick;
        int t, k, bid_c;
        float loc, scale, bctr;
        auto enter = [&]() {  // the cell's sub-timestep, keyword and params
          t = c / K;
          k = c - t * K;
          t += t0;
          bid_c = bid[k];
          loc = prm[kLoc * K + k];
          scale = prm[kScale * K + k];
          bctr = prm[kBctr * K + k];
        };
        auto flush = [&]() {
          if (won_n) atomicAdd(&wc[c], won_n | click_n << kCountShift);
          if (s_full) atomicAdd(&cost[c], s_full);
          if (fst != kNoClick) atomicMin(&first[c], fst);
        };
        enter();
        for (int i = lo; i < hi; ++i, ++lane) {
          if (i == cell_end) {
            flush();
            won_n = click_n = s_full = 0;
            fst = kNoClick;
            do {
              cell_end = off[++c + 1];
            } while (cell_end == i);  // skip cells without lanes
            lane = 0;
            enter();
          }
          const int cents = competitor_cents(rng, t, k, lane, loc, scale);
          if (cents < bid_c) {
            ++won_n;
            if (rng.uniform(t, kDrawClick, k, lane) <= bctr) {
              ++click_n;
              s_full += cents;
              if (fst == kNoClick) {
                fst = static_cast<unsigned long long>(lane) << 32 | static_cast<unsigned>(cents);
              }
              atomicOr(&mask[c * words + lane / 32], 1u << (lane % 32));
            }
          }
        }
        flush();
      }
    }
    __syncthreads();

    // Stage B: the budget gate over the chunk's cells in (t, k) order.
    if (warp == 0) {
      int b = s_budget;
      int end = cells;
      int broken = 0;
      for (int p = 0; p < cells;) {
        const int c = p + lane_id;
        const bool in = c < cells;
        const int sf = in ? cost[c] : 0;
        const int w = in ? wc[c] : 0;
        const unsigned long long f = in ? first[c] : kNoClick;
        const int fcost = f == kNoClick ? kIntMax : static_cast<int>(static_cast<unsigned>(f));
        int S = sf;  // inclusive scan of the full costs, saturating at kIntMax
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, S, o);
          if (lane_id >= o) S = S > kIntMax - y ? kIntMax : S + y;
        }
        // whole: this and every earlier cell of the group fit whole and
        // leave budget; passive: accepts nothing that costs, so the budget
        // stays (with a budget left)
        const unsigned whole = __ballot_sync(kFull, in && S < b);
        const unsigned passive = __ballot_sync(kFull, in && b > 0 && (sf == 0 || fcost > b));
        const int n_whole = whole == kFull ? 32 : __ffs(~whole) - 1;
        const int n_passive = passive == kFull ? 32 : __ffs(~passive) - 1;
        const int run = max(n_whole, n_passive);
        if (lane_id < run) {
          // in a passive run, a cell with no clicked cost is accepted whole
          // (its clicks cost 0) and any other accepts nothing
          const bool take = n_whole >= n_passive || sf == 0;
          wc[c] = (w & kCountMask) | (take ? w >> kCountShift : 0) << kCountShift;
          cost[c] = take ? sf : 0;
        }
        if (n_whole >= n_passive && n_whole > 0) b -= __shfl_sync(kFull, S, n_whole - 1);
        p += run;
        if (run == 32 || p >= cells) continue;

        // the cell at p, decided on its own
        const int f_sf = __shfl_sync(kFull, sf, run);
        const int f_w = __shfl_sync(kFull, w, run);
        const int f_cost = __shfl_sync(kFull, fcost, run);
        const int start = b;
        int spend = 0, accepted = 0;
        if (f_sf <= start) {
          spend = f_sf;
          accepted = f_w >> kCountShift;
        } else if (f_cost <= start) {
          // accepted in part: the clicked lanes whose running cost stays
          // within the start budget, from re-drawn competitor words
          const int tt = p / K;
          const int k = p - tt * K;
          const int lanes = off[p + 1] - off[p];
          const float loc = prm[kLoc * K + k], scale = prm[kScale * K + k];
          int carry = 0, top = 0;
          for (int base = 0; base < lanes && carry <= start; base += 32) {
            const int lane = base + lane_id;
            const bool clicked =
                lane < lanes && (mask[p * words + base / 32] >> lane_id & 1u) != 0;
            const int cents = clicked ? competitor_cents(rng, t0 + tt, k, lane, loc, scale) : 0;
            const int running = carry + inclusive_warp_scan(cents, lane_id);
            const bool acc = clicked && running <= start;
            accepted += __popc(__ballot_sync(kFull, acc));
            if (acc) top = max(top, running);
            carry = __shfl_sync(kFull, running, 31);
          }
          spend = warp_max(top);
        }
        b = start - spend;
        if (lane_id == 0) {
          wc[p] = (f_w & kCountMask) | accepted << kCountShift;
          cost[p] = spend;
        }
        ++p;
        if (b <= 0) {  // the breaking cell itself counts
          end = p;
          broken = 1;
          break;
        }
      }
      if (lane_id == 0) {
        s_budget = b;
        s_end = end;
        s_broken = broken;
      }
    }
    __syncthreads();

    // Stage C: conversions and revenue over the dense accepted clicks.
    const int end = s_end;
    const int acc_total = block_scan(off, end, [&](int c) { return wc[c] >> kCountShift; }, s_warp);
    {
      const int lo = static_cast<int>(static_cast<long long>(acc_total) * tid / kThreads);
      const int hi = static_cast<int>(static_cast<long long>(acc_total) * (tid + 1) / kThreads);
      if (lo < hi) {
        int c = find_cell(off, end, lo);
        int cell_end = off[c + 1];
        // the (lo - off[c])-th clicked lane of cell c: skip whole mask
        // words, then clear the lower set bits of the word that holds it
        int word = 0;
        unsigned bits = mask[c * words];
        for (int j = lo - off[c];;) {
          const int pc = __popc(bits);
          if (j < pc) {
            for (; j > 0; --j) bits &= bits - 1;
            break;
          }
          j -= pc;
          bits = mask[c * words + ++word];
        }
        int conv_n = 0, rev_sum = 0;
        int t, k;
        float sctr, rev_mean, rev_std;
        auto enter = [&]() {
          t = c / K;
          k = c - t * K;
          t += t0;
          sctr = prm[kSctr * K + k];
          rev_mean = prm[kRevMean * K + k];
          rev_std = prm[kRevStd * K + k];
        };
        auto flush = [&]() {
          if (conv_n) {
            atomicAdd(&sums[kSumConv * K + k], conv_n);
            atomicAdd(&sums[kSumRev * K + k], rev_sum);
          }
        };
        enter();
        for (int i = lo; i < hi; ++i) {
          if (i == cell_end) {
            flush();
            conv_n = rev_sum = 0;
            do {
              cell_end = off[++c + 1];
            } while (cell_end == i);
            word = 0;
            bits = mask[c * words];
            enter();
          }
          while (bits == 0u) bits = mask[c * words + ++word];
          const int lane = word * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          if (rng.uniform(t, kDrawConv, k, lane) <= sctr) {
            const float u1 = rng.uniform(t, kDrawRev1, k, lane);
            const float u2 = rng.uniform(t, kDrawRev2, k, lane);
            const float normal = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                                           cosf(__fmul_rn(kTwoPi, u2)));
            const float rev = fmaxf(__fadd_rn(rev_mean, __fmul_rn(rev_std, normal)), 0.01f);
            ++conv_n;
            rev_sum += static_cast<int>(rintf(__fmul_rn(100.0f, rev)));
          }
        }
        flush();
      }
    }
    // the simulated cells' counts, one thread per keyword
    for (int k = tid; k < K; k += kThreads) {
      int imp = 0, clk = 0, spent = 0, elig = 0;
      for (int c = k; c < end; c += K) {
        const int won = wc[c] & kCountMask;
        imp += won;
        clk += wc[c] >> kCountShift;
        spent += cost[c];
        if (won >= 1) elig += n[c];
      }
      sums[kSumImp * K + k] += imp;
      sums[kSumClk * K + k] += clk;
      sums[kSumCost * K + k] += spent;
      sums[kSumElig * K + k] += elig;
    }
    __syncthreads();
    if (s_broken) break;  // a broken day simulates nothing more
  }

  for (int k = tid; k < K; k += kThreads) {
    out_imp[eK + k] = sums[kSumImp * K + k];
    out_clicks[eK + k] = sums[kSumClk * K + k];
    out_cost[eK + k] = sums[kSumCost * K + k];
    out_convs[eK + k] = sums[kSumConv * K + k];
    out_rev[eK + k] = sums[kSumRev * K + k];
    out_elig[eK + k] = sums[kSumElig * K + k];
  }
  if (tid == 0) out_flag[e] = 1;
}

// Sets the kernel's dynamic shared memory for `smem` bytes, with shared
// memory preferred over L1 (the kernel reads device memory only to stage).
cudaError_t configure(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(day_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(day_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Resident blocks per SM at (chunk_t, K, m) on the current device; 0 when a
// block needs more shared memory than the device gives one.
cudaError_t occupancy(int chunk_t, int K, int m, int device, int* blocks_per_sm) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(chunk_t, K, m);
  *blocks_per_sm = 0;
  if (smem > static_cast<size_t>(limit)) return cudaSuccess;
  err = configure(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, day_kernel, kThreads, smem);
}

}  // namespace

extern "C" {

// Launches on `stream` of `device`; returns cudaGetLastError() right after
// the launch. The library links its own CUDA runtime, whose current device
// is not PyTorch's, so the caller names the device.
int day_kernel_launch(const float* params, const int* n_auc, const int* budget, const int* seed,
                      int* out_imp, int* out_clicks, int* out_cost, int* out_convs,
                      int* out_rev, int* out_elig, int* out_flag, int E, int K, int T, int m,
                      int chunk_t, int device, void* stream) {
  if (E == 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || T < 1 || m < 1 || m >= kMaxLanes || chunk_t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(chunk_t, K, m);
  err = configure(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  day_kernel<<<E, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, n_auc, budget, seed, out_imp, out_clicks, out_cost, out_convs, out_rev, out_elig,
      out_flag, E, K, T, m, chunk_t);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at (chunk_t, K, m) into *blocks_per_sm; 0 when a
// block needs more shared memory than the device gives one.
int day_kernel_occupancy(int chunk_t, int K, int m, int device, int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(occupancy(chunk_t, K, m, device, blocks_per_sm));
}

// The largest chunk_t <= T that keeps kMinBlocks blocks resident per SM (or
// as many as chunk_t = 1 keeps) into *chunk_t.
int day_kernel_default_chunk_t(int K, int T, int m, int device, int* chunk_t) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int target = 0, blocks = 0;
  err = occupancy(1, K, m, device, &target);
  if (target > kMinBlocks) target = kMinBlocks;
  for (*chunk_t = 1; err == cudaSuccess && *chunk_t < T; ++*chunk_t) {
    err = occupancy(*chunk_t + 1, K, m, device, &blocks);
    if (blocks < target) break;
  }
  return static_cast<int>(err);
}

// Bytes of dynamic shared memory a block takes at (chunk_t, K, m).
long long day_kernel_smem_bytes(int chunk_t, int K, int m) {
  return static_cast<long long>(smem_bytes(chunk_t, K, m));
}

const char* day_kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
