// The first pass kernels of the streamed x family: one step of the
// sigma-frame x drive (RX(theta) on every qubit, then the step's diagonal)
// on a batch of 2^L states in device memory, cut by the pass plan of
// floquet_plan.cuh. Their only user is floquet_cycle_hi.cu (K9a/K9b: one
// cycle a launch on a shard's local bits, with the caller's torch ops
// between cycles, so they cannot take the folded rows of the step passes of
// floquet_echo.cuh). floquet_x_streamed.cu (K6/K7) runs those step passes
// for its forward and echo and reads only step_rows here;
// floquet_x_streamed.cu says what bounds the passes and why the plan is cut
// so.
//
// Rows are compact rows (ops/params.py) of a run-time `width`, 128 or 256
// lanes; the echo's flags sit at width-4 (trip count, first row of a pair)
// and width-3 (the step's kick sign).
//
// Include after floquet_common.cuh, floquet_plan.cuh and floquet_rx.cuh;
// the definitions sit in an anonymous namespace of their own.

#pragma once

#include "floquet_common.cuh"
#include "floquet_plan.cuh"
#include "floquet_rx.cuh"

namespace {

// Per-pair row pointers and trip gate. Forward (echo == 0): row `step` of
// the trajectory, kick sign +1, every step measured. Echo: rows 2*step
// (pre) and 2*step+1 (post); the pair runs while step < trip (lane
// width-4 of its first row) and is measured on its last step.
struct StepRows {
  const float* pre;  // nullptr when there is no pre diagonal
  const float* post;
  float sign;
  bool active;
  bool measured;
};

__device__ __forceinline__ StepRows step_rows(const float* rows, int width,
                                              int64_t rows_per_pair, int pair,
                                              int step, int echo) {
  const float* base = rows + (int64_t)pair * rows_per_pair * width;
  StepRows r;
  if (echo) {
    const int trip = (int)base[width - 4];
    r.active = step < trip;
    r.measured = step == trip - 1;
    r.pre = base + (int64_t)(2 * step) * width;
    r.post = r.pre + width;
    r.sign = r.pre[width - 3];
  } else {
    r.active = true;
    r.measured = true;
    r.pre = nullptr;
    r.post = base + (int64_t)step * width;
    r.sign = 1.0f;
  }
  return r;
}

// Pass lo: [pre diagonal] then the kick on bits [0, a).
__global__ void lo_kernel(float2* __restrict__ st, int L, int a,
                          const float* __restrict__ rows, int width,
                          int64_t rows_per_pair, int step, int echo, float c,
                          float s) {
  extern __shared__ float2 tile[];
  __shared__ float cz[32], cb[32], c0;
  const int pair = blockIdx.y;
  const StepRows r = step_rows(rows, width, rows_per_pair, pair, step, echo);
  if (!r.active) return;
  const int64_t hi = blockIdx.x;
  const int n = 1 << a;
  float2* g = st + ((int64_t)pair << L) + (hi << a);
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = g[i];
  if (r.pre != nullptr) {
    load_coeffs(r.pre, L, cz, cb, &c0);
    __syncthreads();
    // factorized phase: the high part and the straddle sign fixed per block
    const float th_hi = c0 + angle_bits(cz, cb, hi, a, L - a);
    const float cs = cb[a - 1] * zsign(hi, 0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float th = th_hi + angle_bits(cz, cb, i, 0, a)
                       + cs * zsign(i, a - 1);
      tile[i] = cmul_phase(tile[i], th);
    }
  }
  __syncthreads();
  kick_bits(tile, a, 0, a, c, s * r.sign);
  for (int i = threadIdx.x; i < n; i += blockDim.x) g[i] = tile[i];
}

// Pass over bits [k0, k0 + n) on a tile of 2^n rows x kW columns: tile
// index h * kW + w holds amplitude col + w + (h << k0) + (top << (k0 + n)),
// col the block's kW-aligned low index below 2^k0, top its bits above.
// LAST (k0 + n == L): then the post diagonal and, where the step is
// measured, the block's partial of |psi|^2 z_q into
// partials[pair * gridDim.x + blockIdx.x].
template <bool LAST>
__global__ void strided_kernel(float2* __restrict__ st, int L, int k0, int n,
                               const float* __restrict__ rows, int width,
                               int64_t rows_per_pair, int step, int echo,
                               float c, float s, int q,
                               float* __restrict__ partials) {
  extern __shared__ float2 tile[];
  __shared__ float cz[32], cb[32], c0, th_lo[kW], red[kThreads / 32];
  const int pair = blockIdx.y;
  const StepRows r = step_rows(rows, width, rows_per_pair, pair, step, echo);
  if (!r.active) return;
  const int64_t cols = ((int64_t)1 << k0) / kW;
  const int64_t col = ((int64_t)blockIdx.x % cols) * kW;
  const int64_t top = (int64_t)blockIdx.x / cols;
  const int nrow = 1 << n;
  const int nt = nrow * kW;
  float2* g = st + ((int64_t)pair << L) + col + (top << (k0 + n));
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    tile[i] = g[((int64_t)(i / kW) << k0) + (i % kW)];
  }
  if (LAST) load_coeffs(r.post, L, cz, cb, &c0);
  __syncthreads();
  if (LAST && threadIdx.x < kW) {
    th_lo[threadIdx.x] = c0 + angle_bits(cz, cb, col + threadIdx.x, 0, k0);
  }
  // the rows sit at tile bits [2, 2 + n); ends in __syncthreads
  kick_bits(tile, n + 2, 2, n, c, s * r.sign);
  if (LAST) {
    float acc = 0.0f;
    for (int h = threadIdx.x; h < nrow; h += blockDim.x) {
      const float th_h = angle_bits(cz, cb, h, k0, n);
      const float cs = cb[k0 - 1] * zsign(h, 0);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const int64_t lo = col + w;
        const float th = th_lo[w] + th_h + cs * zsign(lo, k0 - 1);
        const float2 v = cmul_phase(tile[h * kW + w], th);
        tile[h * kW + w] = v;
        if (r.measured) {
          const float z = q < k0 ? zsign(lo, q) : zsign(h, q - k0);
          acc += (v.x * v.x + v.y * v.y) * z;
        }
      }
    }
    __syncthreads();
    if (r.measured) {
      const float tot = block_sum(acc, red);
      if (threadIdx.x == 0) {
        partials[(int64_t)pair * gridDim.x + blockIdx.x] = tot;
      }
    }
  }
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    g[((int64_t)(i / kW) << k0) + (i % kW)] = tile[i];
  }
}

// One step of every pair: pass lo, [pass mid], pass hi.
cudaError_t launch_step(float2* st, int L, const float* rows, int width,
                        int64_t rows_per_pair, int n_pairs, int step, int echo,
                        float c, float s, int q, float* partials,
                        cudaStream_t stream) {
  const Plan p = plan_for(L);
  const size_t smem_lo = sizeof(float2) << p.a;
  const size_t smem_mid = (sizeof(float2) * kW) << p.b;
  const size_t smem_hi = (sizeof(float2) * kW) << p.c;
  cudaError_t e = allow_smem(lo_kernel, smem_lo);
  if (e != cudaSuccess) return e;
  lo_kernel<<<dim3(1u << (L - p.a), n_pairs), kThreads, smem_lo, stream>>>(
      st, L, p.a, rows, width, rows_per_pair, step, echo, c, s);
  if (p.b > 0) {
    e = allow_smem(strided_kernel<false>, smem_mid);
    if (e != cudaSuccess) return e;
    strided_kernel<false><<<dim3((1u << (L - p.b)) / kW, n_pairs), kThreads,
                            smem_mid, stream>>>(
        st, L, p.a, p.b, rows, width, rows_per_pair, step, echo, c, s, q,
        nullptr);
  }
  e = allow_smem(strided_kernel<true>, smem_hi);
  if (e != cudaSuccess) return e;
  strided_kernel<true><<<dim3((unsigned)hi_blocks(L), n_pairs), kThreads,
                         smem_hi, stream>>>(
      st, L, p.a + p.b, p.c, rows, width, rows_per_pair, step, echo, c, s, q,
      partials);
  return cudaGetLastError();
}

}  // namespace
