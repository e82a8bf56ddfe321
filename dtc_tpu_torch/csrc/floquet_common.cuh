// Pieces shared by the Floquet kernels (floquet_*.cu): constants, the
// factorized diagonal angle, the deterministic block sum, and the state
// init, terminal measurement and fixed-order reduction kernels.
//
// Every state is n_pairs x 2^L complex64 (float2) in device memory, qubit j
// on bit j of the amplitude index, z_j(s) = 1 - 2 bit_j(s). Offsets are
// 64-bit. Included by one .cu file per library, inside nothing: the
// definitions sit in an anonymous namespace of their own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kW = 4;          // low columns per pass-hi block (32 B runs)
constexpr int kRowWidth = 128; // compact row width (lanes)
constexpr int kMeasureChunk = 4096;  // amplitudes per measure block
constexpr float kHalfPi = 1.5707963267948966f;

__device__ __forceinline__ float zsign(int64_t s, int bit) {
  return 1.0f - 2.0f * (float)((s >> bit) & 1);
}

// sum_{k<n} cz[q0+k] z_k(x) + sum_{1<=k<n} cb[q0+k-1] z_{k-1}(x) z_k(x)
__device__ __forceinline__ float angle_bits(const float* cz, const float* cb,
                                            int64_t x, int q0, int n) {
  float th = 0.0f;
  float zp = 0.0f;
  for (int k = 0; k < n; ++k) {
    float z = zsign(x, k);
    th += cz[q0 + k] * z;
    if (k > 0) th += cb[q0 + k - 1] * zp * z;
    zp = z;
  }
  return th;
}

// Block sum in a fixed order (warp shuffles, then warp 0 over the warps).
__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  }
  return total;
}

__global__ void init_kernel(float2* __restrict__ st, int64_t N, int64_t b0) {
  const int64_t pair = blockIdx.y;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (int64_t)gridDim.x * blockDim.x) {
    st[pair * N + i] = make_float2(i == b0 ? 1.0f : 0.0f, 0.0f);
  }
}

// Terminal measurement (echo): partials[pair * gridDim.x + bx].
__global__ void measure_kernel(const float2* __restrict__ st, int L, int q,
                               int chunk, float* __restrict__ partials) {
  __shared__ float red[kThreads / 32];
  const int64_t N = (int64_t)1 << L;
  const int pair = blockIdx.y;
  const int64_t base = (int64_t)blockIdx.x * chunk;
  const float2* g = st + (int64_t)pair * N;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const int64_t s = base + i;
    const float2 v = g[s];
    acc += (v.x * v.x + v.y * v.y) * zsign(s, q);
  }
  const float tot = block_sum(acc, red);
  if (threadIdx.x == 0) partials[(int64_t)pair * gridDim.x + blockIdx.x] = tot;
}

// out[i] = sum_b partials[i * nb + b] in fixed order.
__global__ void reduce_kernel(const float* __restrict__ partials,
                              float* __restrict__ out, int64_t n_rows,
                              int nb) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  double acc = 0.0;
  for (int b = 0; b < nb; ++b) acc += partials[i * nb + b];
  out[i] = (float)acc;
}

int lo_bits(int L) { return L - L / 2; }

// Measure blocks of one state: one per kMeasureChunk amplitudes, at most
// 4096 (from L = 25 a block measures 2^(L-12) amplitudes), so that the
// reduce, one thread a pair, sums at most 4096 partials.
int measure_blocks(int L) {
  return L <= 24 ? (1 << L) / kMeasureChunk : 4096;
}

// Echo tail: measure every pair's state, then sum its partials in order.
cudaError_t measure_and_reduce(const float2* st, int L, int q, int n_pairs,
                               float* partials, float* out,
                               cudaStream_t stream) {
  const int nb = measure_blocks(L);
  measure_kernel<<<dim3(nb, n_pairs), kThreads, 0, stream>>>(
      st, L, q, (int)(((int64_t)1 << L) / nb), partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_kernel<<<(n_pairs + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partials, out, n_pairs, nb);
  return cudaGetLastError();
}

}  // namespace
