// The pass kernels of the streamed lab-frame family's shard-local forms:
// one kick slot of any drive (the X-mask row fold of the slot's 2x2, then
// the slot's diagonal) on a batch of 2^L states in device memory, cut by
// the pass plan of floquet_plan.cuh, a sincos per amplitude for the
// diagonal and the tile staged whole through shared memory. Run by
// floquet_cycle_hi.cu (K10's shard-local forms: one cycle on a shard's
// local bits, 22 <= L_loc <= 30). The one-card family,
// floquet_general_streamed.cu (K10a's forward and K10b's echo of whole
// trajectories, 22 <= L <= 29), runs the step passes of floquet_echo.cuh
// instead and takes from here only the step rows (StepRows, step_rows);
// it says what bounds them.
//
// Rows are K4's step rows (ops/params_general.py) of W lanes, a template
// argument: 128, or 256 where the flag lanes from FO = 4L-1 pass lane 127
// (L = 30). Only the row stride depends on W; the lanes sit where they do
// at 128.
//
// Include after floquet_common.cuh, floquet_plan.cuh and floquet_lab.cuh;
// the definitions sit in an anonymous namespace of their own.

#pragma once

#include "floquet_common.cuh"
#include "floquet_lab.cuh"
#include "floquet_plan.cuh"

namespace {

constexpr int kMaxL = 32;

// The rows of one pair's step. Forward (echo == 0): row `step` is the kick
// and the diagonal row, measured where its MPOS >= 0. Echo: rows 2*step
// (pre: pre diagonal and kick) and 2*step+1 (post diagonal); the pair runs
// while step < COUNT and is measured on its last step.
struct StepRows {
  const float* pre;   // nullptr when there is no pre diagonal
  const float* kick;
  const float* post;
  bool active;
  bool measured;
};

template <int W>
__device__ __forceinline__ StepRows step_rows(const float* rows, int L,
                                              int64_t rows_per_pair, int pair,
                                              int step, int echo) {
  const float* base = rows + (int64_t)pair * rows_per_pair * W;
  const int fo = 4 * L - 1;
  StepRows r;
  if (echo) {
    const int count = (int)base[fo + kLaneCount];
    r.active = step < count;
    r.measured = step == count - 1;
    r.pre = base + (int64_t)(2 * step) * W;
    r.kick = r.pre;
    r.post = r.pre + W;
  } else {
    r.active = true;
    r.pre = nullptr;
    r.kick = base + (int64_t)step * W;
    r.post = r.kick;
    r.measured = r.kick[fo + kLaneMpos] >= 0.0f;
  }
  return r;
}

// Pass lo: [pre diagonal] then the kick on bits [0, a).
template <int W>
__global__ void general_lo_kernel(float2* __restrict__ st, int L, int a,
                                  const float* __restrict__ rows,
                                  int64_t rows_per_pair, int step, int echo) {
  extern __shared__ float2 tile[];
  __shared__ float cz[kMaxL], cb[kMaxL], c0;
  __shared__ Mat2 mats[kMaxL];
  const int pair = blockIdx.y;
  const StepRows r = step_rows<W>(rows, L, rows_per_pair, pair, step, echo);
  if (!r.active) return;
  const int64_t hi = blockIdx.x;
  const int n = 1 << a;
  float2* g = st + ((int64_t)pair << L) + (hi << a);
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = g[i];
  load_mats(r.kick, L, mats);
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
  kick_bits(tile, a, 0, a, mats);
  for (int i = threadIdx.x; i < n; i += blockDim.x) g[i] = tile[i];
}

// Pass over bits [k0, k0 + n) on a tile of 2^n rows x kW columns: tile
// index h * kW + w holds amplitude col + w + (h << k0) + (top << (k0 + n)),
// col the block's kW-aligned low index below 2^k0, top its bits above.
// LAST (k0 + n == L): then the post diagonal and, where the step is
// measured, the block's partial of |psi|^2 z_q into
// partials[pair * gridDim.x + blockIdx.x].
template <bool LAST, int W>
__global__ void general_strided_kernel(float2* __restrict__ st, int L, int k0,
                                       int n, const float* __restrict__ rows,
                                       int64_t rows_per_pair, int step,
                                       int echo, int q,
                                       float* __restrict__ partials) {
  extern __shared__ float2 tile[];
  __shared__ float cz[kMaxL], cb[kMaxL], c0, th_lo[kW], red[kThreads / 32];
  __shared__ Mat2 mats[kMaxL];
  const int pair = blockIdx.y;
  const StepRows r = step_rows<W>(rows, L, rows_per_pair, pair, step, echo);
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
  load_mats(r.kick, L, mats);
  if (LAST) load_coeffs(r.post, L, cz, cb, &c0);
  __syncthreads();
  if (LAST && threadIdx.x < kW) {
    th_lo[threadIdx.x] = c0 + angle_bits(cz, cb, col + threadIdx.x, 0, k0);
  }
  // the rows sit at tile bits [2, 2 + n); ends in __syncthreads
  kick_bits(tile, n + 2, 2, n, mats + k0);
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
    if (r.measured) {  // uniform over the block: every thread reads one row
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
template <int W>
cudaError_t launch_step(float2* st, int L, const float* rows,
                        int64_t rows_per_pair, int n_pairs, int step, int echo,
                        int q, float* partials, cudaStream_t stream) {
  const Plan p = plan_for(L);
  const size_t smem_lo = sizeof(float2) << p.a;
  const size_t smem_mid = (sizeof(float2) * kW) << p.b;
  const size_t smem_hi = (sizeof(float2) * kW) << p.c;
  cudaError_t e = allow_smem(general_lo_kernel<W>, smem_lo);
  if (e != cudaSuccess) return e;
  general_lo_kernel<W><<<dim3(1u << (L - p.a), n_pairs), kThreads, smem_lo,
                      stream>>>(st, L, p.a, rows, rows_per_pair, step, echo);
  if (p.b > 0) {
    e = allow_smem(general_strided_kernel<false, W>, smem_mid);
    if (e != cudaSuccess) return e;
    general_strided_kernel<false, W><<<dim3((1u << (L - p.b)) / kW, n_pairs),
                                    kThreads, smem_mid, stream>>>(
        st, L, p.a, p.b, rows, rows_per_pair, step, echo, q, nullptr);
  }
  e = allow_smem(general_strided_kernel<true, W>, smem_hi);
  if (e != cudaSuccess) return e;
  general_strided_kernel<true, W><<<dim3((unsigned)hi_blocks(L), n_pairs),
                                 kThreads, smem_hi, stream>>>(
      st, L, p.a + p.b, p.c, rows, rows_per_pair, step, echo, q, partials);
  return cudaGetLastError();
}

}  // namespace
