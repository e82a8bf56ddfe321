// The two passes of one lab-frame step of K4's forward over whole
// trajectories (floquet_general.cu, its only user), and the step rows that
// floquet_general.cu's PairRows (K4's echo) and ObsRows (K5) read on the
// step passes of floquet_echo.cuh:
//   pass lo: a block owns 2^k1 consecutive amplitudes and applies the
//            [pre diagonal and] kick on bits [0, k1) in shared memory;
//   pass hi: a block owns kW low columns x all 2^n2 high values, applies
//            the kick on bits [k1, L), the (post) diagonal and the forward
//            partial sum.
// A step's rows: forward, row `step` is the kick and diagonal row and the
// partial goes where its MPOS lane says (-1: none); echo, rows 2*step (pre)
// and 2*step+1 (post), while step < COUNT (lane FO+10 of the pair's row 0).
//
// Include after floquet_common.cuh and floquet_lab.cuh; the definitions sit
// in an anonymous namespace of their own.

#pragma once

#include "floquet_common.cuh"
#include "floquet_lab.cuh"

namespace {

constexpr int kMaxL = 32;

// The rows of one pair's step. Forward (echo == 0): row `step` is both the
// kick row and the diagonal row. Echo: rows 2*step (pre: pre diagonal and
// kick) and 2*step+1 (post diagonal); the pair runs while step < COUNT.
struct StepRows {
  const float* pre;   // nullptr when there is no pre diagonal
  const float* kick;
  const float* post;
  bool active;
};

__device__ __forceinline__ StepRows step_rows(const float* rows, int L,
                                              int64_t rows_per_pair, int pair,
                                              int step, int echo) {
  const float* base = rows + (int64_t)pair * rows_per_pair * kRowWidth;
  StepRows r;
  if (echo) {
    const int count = (int)base[4 * L - 1 + kLaneCount];
    r.active = step < count;
    r.pre = base + (int64_t)(2 * step) * kRowWidth;
    r.kick = r.pre;
    r.post = r.pre + kRowWidth;
  } else {
    r.active = true;
    r.pre = nullptr;
    r.kick = base + (int64_t)step * kRowWidth;
    r.post = r.kick;
  }
  return r;
}

// Pass lo: [pre diagonal] then the kick on bits [0, k1).
__global__ void pass_lo_kernel(float2* __restrict__ st, int L, int k1,
                               const float* __restrict__ rows,
                               int64_t rows_per_pair, int step, int echo) {
  extern __shared__ float2 tile[];
  __shared__ float cz[kMaxL], cb[kMaxL], c0;
  __shared__ Mat2 mats[kMaxL];
  const int pair = blockIdx.y;
  const StepRows r = step_rows(rows, L, rows_per_pair, pair, step, echo);
  if (!r.active) return;
  const int64_t N = (int64_t)1 << L;
  const int64_t hi = blockIdx.x;
  const int n = 1 << k1;
  float2* g = st + (int64_t)pair * N + (hi << k1);
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = g[i];
  load_mats(r.kick, L, mats);
  if (r.pre != nullptr) {
    load_coeffs(r.pre, L, cz, cb, &c0);
    __syncthreads();
    // factorized phase: high part and straddle sign fixed per block
    const float th_hi = c0 + angle_bits(cz, cb, hi, k1, L - k1);
    const float cs = cb[k1 - 1] * zsign(hi, 0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float th = th_hi + angle_bits(cz, cb, i, 0, k1)
                       + cs * zsign(i, k1 - 1);
      tile[i] = cmul_phase(tile[i], th);
    }
  }
  __syncthreads();
  kick_bits(tile, k1, 0, k1, mats);
  for (int i = threadIdx.x; i < n; i += blockDim.x) g[i] = tile[i];
}

// Pass hi: the kick on bits [k1, L), the (post) diagonal, and (forward, on
// a row with MPOS >= 0, when partials are given) the partial sum of
// |psi|^2 z_q into partials[(pair * T + MPOS) * nblk + bx].
__global__ void pass_hi_kernel(float2* __restrict__ st, int L, int k1,
                               const float* __restrict__ rows,
                               int64_t rows_per_pair, int step, int echo,
                               int q, float* __restrict__ partials, int T) {
  extern __shared__ float2 tile[];  // [2^n2][kW]
  __shared__ float cz[kMaxL], cb[kMaxL], c0, th_lo[kW], red[kThreads / 32];
  __shared__ Mat2 mats[kMaxL];
  const int pair = blockIdx.y;
  const StepRows r = step_rows(rows, L, rows_per_pair, pair, step, echo);
  if (!r.active) return;
  const int n2 = L - k1;
  const int64_t N = (int64_t)1 << L;
  const int64_t o = (int64_t)blockIdx.x * kW;
  const int n = (1 << n2) * kW;
  float2* g = st + (int64_t)pair * N + o;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    tile[i] = g[((int64_t)(i / kW) << k1) + (i % kW)];
  }
  load_coeffs(r.post, L, cz, cb, &c0);
  load_mats(r.kick, L, mats);
  __syncthreads();
  if (threadIdx.x < kW) {
    th_lo[threadIdx.x] = c0 + angle_bits(cz, cb, o + threadIdx.x, 0, k1);
  }
  // tile index = h * kW + w: the high bits sit at tile bits [2, 2 + n2)
  kick_bits(tile, n2 + 2, 2, n2, mats + k1);  // ends in __syncthreads
  const int mpos = (echo || partials == nullptr)
                       ? -1 : (int)r.kick[4 * L - 1 + kLaneMpos];
  float acc = 0.0f;
  const bool zq_lo = q < k1;
  for (int h = threadIdx.x; h < (1 << n2); h += blockDim.x) {
    const float th_h = angle_bits(cz, cb, h, k1, n2);
    const float cs = cb[k1 - 1] * zsign(h, 0);
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const int64_t lo = o + w;
      const float th = th_lo[w] + th_h + cs * zsign(lo, k1 - 1);
      const float2 v = cmul_phase(tile[h * kW + w], th);
      tile[h * kW + w] = v;
      if (mpos >= 0) {
        const float z = zq_lo ? zsign(lo, q) : zsign(h, q - k1);
        acc += (v.x * v.x + v.y * v.y) * z;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    g[((int64_t)(i / kW) << k1) + (i % kW)] = tile[i];
  }
  if (mpos >= 0) {  // uniform over the block: every thread reads one row
    const float tot = block_sum(acc, red);
    if (threadIdx.x == 0) {
      partials[((int64_t)pair * T + mpos) * gridDim.x + blockIdx.x] = tot;
    }
  }
}

// One step's two passes.
cudaError_t launch_step(float2* st, int L, const float* rows,
                        int64_t rows_per_pair, int n_pairs, int step, int echo,
                        int q, float* partials, int T, cudaStream_t stream) {
  const int k1 = lo_bits(L);
  const int n2 = L - k1;
  const size_t smem_lo = sizeof(float2) << k1;
  const size_t smem_hi = (sizeof(float2) * kW) << n2;
  cudaError_t e = cudaFuncSetAttribute(
      pass_lo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_lo);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(pass_hi_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_hi);
  if (e != cudaSuccess) return e;
  pass_lo_kernel<<<dim3(1u << n2, n_pairs), kThreads, smem_lo, stream>>>(
      st, L, k1, rows, rows_per_pair, step, echo);
  pass_hi_kernel<<<dim3((1u << k1) / kW, n_pairs), kThreads, smem_hi,
                   stream>>>(st, L, k1, rows, rows_per_pair, step, echo, q,
                             partials, T);
  return cudaGetLastError();
}

}  // namespace
