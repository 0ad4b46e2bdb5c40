// threefry2x32 words on Hopper (sm_90a): the port's counter-based RNG run
// inside a kernel, in place of the TPU's hardware PRNG probes.
//
// Replaces the TPU kernels of scripts/probe_prng.py:
// * threefry_words replaces `kernel` (:21, words seeded per (seed, program
//   id)) and `kernel2` (:56, successive draws from one seed): keys are
//   explicit and the stream advances by the counter. It is also the word
//   source of adcraft_tpu_torch/prng.py (split, fold_in, random_bits, and
//   normal, whose float transform threefry_normal_kernel runs in the same
//   launch), so the env step's key tree runs as one launch per call.
// * threefry_rate replaces `kernel3` (:88), the PRNG throughput probe.
// The plain PyTorch versions are adcraft_tpu_torch/prng_kernel.py:
// threefry_words_reference and threefry_rate_reference.
//
// What bounds them: integer operations. A word costs about 75 32-bit
// integer instructions in SASS (20 rounds of add, funnel-shift rotate and
// xor, six key injections): 48 on the integer ALU pipe, 27 IMAD on the
// FMA pipe beside it, so the ALU pipe sets the pace. A word moves at most
// 16 bytes, so at the step's sizes the card is compute- (or launch-)
// bound, never memory-bound. The design is
// the simplest that keeps every lane busy: one thread per (key, counter),
// grid-stride loops, no shared memory, each word written once as int64
// (the port keeps uint32 words in int64 tensors) so no cast follows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "xla_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxGrid = 65535;

// keys: N rows of two int64 words, `key_stride` elements apart.
// pair: out (N, n, 2) = (y0, y1) at counter (0, base + i) -- split, fold_in.
// else: out (N, n) = (y0 ^ y1) & mask at counter (i >> 32, i mod 2^32) --
//       random_bits, 32-bit (mask 0xFFFFFFFF) or 16-bit (0xFFFF).
// threadIdx.x / blockIdx.x walk the counters, threadIdx.y / blockIdx.y
// the keys, both grid-stride.
__global__ void __launch_bounds__(kThreads)
    threefry_words_kernel(const long long* __restrict__ keys, long long key_stride, long long N,
                          long long n, int pair, uint32_t base, uint32_t mask,
                          long long* __restrict__ out) {
  const long long key_step = static_cast<long long>(gridDim.y) * blockDim.y;
  const long long count_step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y; k < N;
       k += key_step) {
    const uint32_t k0 = static_cast<uint32_t>(keys[k * key_stride]);
    const uint32_t k1 = static_cast<uint32_t>(keys[k * key_stride + 1]);
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += count_step) {
      const long long o = k * n + i;
      if (pair) {
        const uint2 y = threefry::block(k0, k1, 0u, base + static_cast<uint32_t>(i));
        reinterpret_cast<longlong2*>(out)[o] =
            make_longlong2(static_cast<long long>(y.x), static_cast<long long>(y.y));
      } else {
        const uint32_t w = threefry::word(k0, k1, static_cast<uint32_t>(i >> 32),
                                          static_cast<uint32_t>(i));
        out[o] = static_cast<long long>(w & mask);
      }
    }
  }
}

// normal: out (N, n) float32 = jax.random.normal's draw from the word at
// counter (0, i), sqrt(2) erf_inv(u) on XLA's log1p and erf_inv
// (prng_kernel.normal_from_words), for n < 2^32. A kernel of its own, so
// threefry_words_kernel's loop stays one threefry body.
__global__ void __launch_bounds__(kThreads)
    threefry_normal_kernel(const long long* __restrict__ keys, long long key_stride, long long N,
                           long long n, float* __restrict__ out) {
  const long long key_step = static_cast<long long>(gridDim.y) * blockDim.y;
  const long long count_step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y; k < N;
       k += key_step) {
    const Key key{static_cast<uint32_t>(keys[k * key_stride]),
                  static_cast<uint32_t>(keys[k * key_stride + 1])};
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += count_step) {
      out[k * n + i] = xla_normal(key, static_cast<uint32_t>(i));
    }
  }
}

// out (P, cells) int32: out[p, c] is the xor of the words at counters
// (j, c), j < draws, under key (seed[0], p). The probe's rate counts every
// one of those words, so every one is folded into the result: nothing is
// drawn and discarded, and the compiler cannot drop any of them.
// One block row per program (blockIdx.y), so programs never share an
// output block.
__global__ void __launch_bounds__(kThreads)
    threefry_rate_kernel(const int* __restrict__ seed, int draws, int cells,
                         int* __restrict__ out) {
  const uint32_t k0 = static_cast<uint32_t>(seed[0]);
  const uint32_t p = blockIdx.y;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < cells; c += gridDim.x * blockDim.x) {
    uint32_t acc = 0;
#pragma unroll 1
    for (int j = 0; j < draws; ++j) {
      acc ^= threefry::word(k0, p, static_cast<uint32_t>(j), static_cast<uint32_t>(c));
    }
    out[static_cast<long long>(p) * cells + c] = static_cast<int>(acc);
  }
}

// xla_math.cuh's functions on float32 arrays, for holding them to the
// plain xla_math on the card: op kFma out = fma32(a, b, c), kExpm1
// xla_expm1(a), kPow xla_pow(a, b), kTanh xla_tanh(a), kLaplaceCdf
// laplace_cdf(a, b, c) over n elements; kCumsum and kCumprod XlaScan along
// each of the `rows` rows of n elements of a (n elements per row).
enum { kFma, kExpm1, kPow, kTanh, kLaplaceCdf, kCumsum, kCumprod };

__global__ void __launch_bounds__(kThreads)
    xla_math_probe_kernel(int op, const float* __restrict__ a, const float* __restrict__ b,
                          const float* __restrict__ c, float* __restrict__ out, long long n,
                          long long rows) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (op == kCumsum || op == kCumprod) {
    for (long long r = first; r < rows; r += stride) {
      XlaScan<false> sum;
      XlaScan<true> prod;
      for (long long i = 0; i < n; ++i) {
        const float x = a[r * n + i];
        out[r * n + i] = op == kCumsum ? sum.push(x) : prod.push(x);
      }
    }
    return;
  }
  for (long long i = first; i < n; i += stride) {
    float v = 0.0f;
    switch (op) {
      case kFma: v = fma32(a[i], b[i], c[i]); break;
      case kExpm1: v = xla_expm1(a[i]); break;
      case kPow: v = xla_pow(a[i], b[i]); break;
      case kTanh: v = xla_tanh(a[i]); break;
      default: v = laplace_cdf(a[i], b[i], c[i]);
    }
    out[i] = v;
  }
}

unsigned grid_for(long long work, unsigned per_block) {
  const long long blocks = (work + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

// counters across x, keys across y: a block of tx x ty threads with tx the
// power of two >= n (at most kThreads), so short rows (split's 4,
// randint's 1) still fill the block with keys
void words_shape(long long N, long long n, dim3* threads, dim3* grid) {
  unsigned tx = 1;
  while (tx < kThreads && tx < n) tx <<= 1;
  *threads = dim3(tx, kThreads / tx);
  *grid = dim3(grid_for(n, threads->x), grid_for(N, threads->y));
}

}  // namespace

extern "C" {

// Each launcher runs on `stream` of `device` and returns cudaGetLastError()
// right after the launch. The library links its own CUDA runtime, whose
// current device is not PyTorch's, so the caller names the device.

int threefry_words_launch(const long long* keys, long long key_stride, long long N, long long n,
                          int pair, unsigned base, unsigned mask, long long* out, int device,
                          void* stream) {
  if (N <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 threads, grid;
  words_shape(N, n, &threads, &grid);
  threefry_words_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, key_stride, N, n, pair, base, mask, out);
  return static_cast<int>(cudaGetLastError());
}

int threefry_normal_launch(const long long* keys, long long key_stride, long long N, long long n,
                           float* out, int device, void* stream) {
  if (N <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 threads, grid;
  words_shape(N, n, &threads, &grid);
  threefry_normal_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, key_stride, N, n, out);
  return static_cast<int>(cudaGetLastError());
}

int threefry_rate_launch(const int* seed, int programs, int draws, int cells, int* out, int device,
                         void* stream) {
  if (programs <= 0 || cells <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_for(cells, kThreads), static_cast<unsigned>(programs));
  threefry_rate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, draws, cells, out);
  return static_cast<int>(cudaGetLastError());
}

// xla_math_probe: see xla_math_probe_kernel; `rows` rows for the scans
int xla_math_probe_launch(int op, const float* a, const float* b, const float* c, float* out,
                          long long n, long long rows, int device, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = op == kCumsum || op == kCumprod ? rows : n;
  xla_math_probe_kernel<<<grid_for(work, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(op, a, b, c, out, n, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* prng_kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
