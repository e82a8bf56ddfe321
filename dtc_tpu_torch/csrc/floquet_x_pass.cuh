// The two passes of one forward x-drive step in the sigma frame, shared by
// floquet_x.cu (K1: a constant kick) and floquet_x_resident.cu (K3a: a
// constant or per-cycle kick read from a table):
//   pass lo: a block owns 2^k1 consecutive amplitudes (fixed high bits),
//            the kick on bits [0, k1) in shared memory;
//   pass hi: a block owns kW = 4 consecutive low columns x all 2^n2 high
//            values, the kick on bits [k1, L), the cycle's diagonal and
//            the A(t+1) partial sum of |psi|^2 z_q.
// The kernels take the step's RX through a template parameter `Kick`, whose
// at(pre, step) gives (cos theta/2, sin theta/2) before the step's sign:
// ConstKick (floquet_rx.cuh) for one angle (the pre row is not read),
// TableKick for a (tu, 2) device table, indexed by the forward's cycle or
// by lane 127 of an echo step's pre row (read as an int, bounded by tu).
// The echoes K2 and K3b, and the per-shard cycles K8a/K8b
// (floquet_cycle.cu), run the passes of floquet_echo.cuh instead; K2 and
// K3b read their (pre, post) step rows through PairRows below.
//
// Include after floquet_common.cuh and floquet_rx.cuh; the definitions sit
// in an anonymous namespace of their own.

#pragma once

#include "floquet_common.cuh"
#include "floquet_rx.cuh"

namespace {

// Row `step` (forward) or the row the pre row names (echo) of a (tu, 2)
// table of (cos, sin) of theta_t / 2.
struct TableKick {
  const float* __restrict__ cs;
  int tu;
  __device__ __forceinline__ float2 at(const float* pre, int step) const {
    int ui = pre != nullptr ? (int)pre[kRowWidth - 1] : step;
    ui = min(max(ui, 0), tu - 1);
    return make_float2(cs[2 * ui], cs[2 * ui + 1]);
  }
};

// An echo step's pre row, 2*step of the pair (its diagonals come folded,
// ops/echo_fold.py); the pair runs only while step < trip (lane 124 of row
// 0), with the kick sign of lane 125 of its pre row.
struct StepRows {
  const float* pre;
  float sign;
  bool active;
};

__device__ __forceinline__ StepRows step_rows(const float* rows,
                                              int64_t rows_per_pair, int pair,
                                              int step) {
  const float* base = rows + (int64_t)pair * rows_per_pair * kRowWidth;
  StepRows r;
  const int trip = (int)base[kRowWidth - 4];
  r.active = step < trip;
  r.pre = base + (int64_t)(2 * step) * kRowWidth;
  r.sign = r.pre[kRowWidth - 3];
  return r;
}

// K2's and K3b's echo step rows for XEcho (floquet_x_echo.cuh), which runs
// them on the passes of floquet_echo.cuh: 128 lanes.
struct PairRows {
  __device__ __forceinline__ StepRows at(const float* rows,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return step_rows(rows, rows_per_pair, pair, step);
  }
};

// Pass lo: the kick of cycle `step` on bits [0, k1).
template <class Kick>
__global__ void pass_lo_kernel(float2* __restrict__ st, int L, int k1,
                               int step, Kick kick) {
  extern __shared__ float2 tile[];
  const int pair = blockIdx.y;
  const float2 k = kick.at(nullptr, step);
  const int64_t N = (int64_t)1 << L;
  const int64_t hi = blockIdx.x;
  const int n = 1 << k1;
  float2* g = st + (int64_t)pair * N + (hi << k1);
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = g[i];
  __syncthreads();
  kick_bits(tile, k1, 0, k1, k.x, k.y);
  for (int i = threadIdx.x; i < n; i += blockDim.x) g[i] = tile[i];
}

// Pass hi: the kick on bits [k1, L), the diagonal of row `step` of the
// pair's rows_per_pair rows, and the partial sum of |psi|^2 z_q into
// partials[(pair * T + step + 1) * nblk + bx].
template <class Kick>
__global__ void pass_hi_kernel(float2* __restrict__ st, int L, int k1,
                               const float* __restrict__ rows,
                               int64_t rows_per_pair, int step, Kick kick,
                               int q, float* __restrict__ partials, int T) {
  extern __shared__ float2 tile[];  // [2^n2][kW]
  __shared__ float cz[64], cb[64], c0, th_lo[kW], red[kThreads / 32];
  const int pair = blockIdx.y;
  const float* post =
      rows + ((int64_t)pair * rows_per_pair + step) * kRowWidth;
  const float2 k = kick.at(nullptr, step);
  const int n2 = L - k1;
  const int64_t N = (int64_t)1 << L;
  const int64_t o = (int64_t)blockIdx.x * kW;
  const int n = (1 << n2) * kW;
  float2* g = st + (int64_t)pair * N + o;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    tile[i] = g[((int64_t)(i / kW) << k1) + (i % kW)];
  }
  load_coeffs(post, L, cz, cb, &c0);
  __syncthreads();
  if (threadIdx.x < kW) {
    th_lo[threadIdx.x] = c0 + angle_bits(cz, cb, o + threadIdx.x, 0, k1);
  }
  // tile index = h * kW + w: the high bits sit at tile bits [2, 2 + n2)
  kick_bits(tile, n2 + 2, 2, n2, k.x, k.y);  // ends in __syncthreads
  float acc = 0.0f;
  const int64_t zq_lo = q < k1 ? q : -1;
  for (int h = threadIdx.x; h < (1 << n2); h += blockDim.x) {
    const float th_h = angle_bits(cz, cb, h, k1, n2);
    const float cs = cb[k1 - 1] * zsign(h, 0);
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const int64_t lo = o + w;
      const float th = th_lo[w] + th_h + cs * zsign(lo, k1 - 1);
      const float2 v = cmul_phase(tile[h * kW + w], th);
      tile[h * kW + w] = v;
      const float z = zq_lo >= 0 ? zsign(lo, q) : zsign(h, q - k1);
      acc += (v.x * v.x + v.y * v.y) * z;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    g[((int64_t)(i / kW) << k1) + (i % kW)] = tile[i];
  }
  const float tot = block_sum(acc, red);
  if (threadIdx.x == 0) {
    partials[((int64_t)pair * T + step + 1) * gridDim.x + blockIdx.x] = tot;
  }
}

// Forward cycle `step` (both passes) of n_pairs states, row `step` of each
// pair's rows_per_pair rows, measured into time step + 1.
template <class Kick>
cudaError_t launch_step(float2* st, int L, const float* rows,
                        int64_t rows_per_pair, int n_pairs, int step,
                        Kick kick, int q, float* partials, int T,
                        cudaStream_t stream) {
  const int k1 = lo_bits(L);
  const int n2 = L - k1;
  const size_t smem_lo = sizeof(float2) << k1;
  const size_t smem_hi = (sizeof(float2) * kW) << n2;
  cudaError_t e = cudaFuncSetAttribute(
      pass_lo_kernel<Kick>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_lo);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(pass_hi_kernel<Kick>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_hi);
  if (e != cudaSuccess) return e;
  pass_lo_kernel<Kick><<<dim3(1u << n2, n_pairs), kThreads, smem_lo,
                         stream>>>(st, L, k1, step, kick);
  pass_hi_kernel<Kick><<<dim3((1u << k1) / kW, n_pairs), kThreads, smem_hi,
                         stream>>>(st, L, k1, rows, rows_per_pair, step, kick,
                                   q, partials, T);
  return cudaGetLastError();
}

}  // namespace
