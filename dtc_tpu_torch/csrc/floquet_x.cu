// Constant x-drive Floquet kernels for Hopper (sm_90a): forward A(t) (K1)
// and echo A0(t) (K2) of the kicked-Ising chain in the sigma frame.
//
// Replaces
//   K1 dtc_tpu/ops/pallas_resident_blocked.py::_make_blocked_kernel
//      (entry blocked_forward_batch)
//   K2 dtc_tpu/ops/pallas_resident_blocked.py::_make_blocked_echo_kernel
//      (entry blocked_echo_batch)
//
// What is ported is the math, not the TPU design:
// - sigma frame: the Pauli X-parts of the sampled noise live in a host-side
//   XOR frame; a cycle sees only its compact parameter row (noise Z bits,
//   sigma bits, bond flips, h, phi) and the host applies (1 - 2 sigma_q);
// - the whole per-cycle diagonal (RZZ + RZ, the sampled Z-signs, the sigma
//   correction) is ONE angle linear in the bits,
//     theta(s) = c0 + sum_q cz_q z_q(s) + sum_j cb_j z_j(s) z_{j+1}(s),
//   factorized over the bit split s = (hi << k1) | lo into a low part, a
//   high part and the one straddling bond, so each amplitude costs one add
//   and one sincos;
// - the diagonal is fused into the pass that applies the kick, so it costs
//   no memory pass of its own (forward: after the top kick; echo: the pre
//   diagonal before the low kick, the post diagonal after the top kick);
// - the echo turnaround conj-correction is in the (pre, post) rows built by
//   the host (ops/params.py::echo_pair_tiles); the inverse kick is RX with
//   its imaginary part sign-flipped (lane 125 of the pre row).
//
// What bounds it on this card: the state is 2^L complex64 per trajectory
// (8 MiB at L=20), far above shared memory, so it lives in device memory
// and every cycle must stream it. The kick is RX on every qubit, 2L
// flops-ish per amplitude per bit; the design keeps that work on-chip so a
// cycle costs two read+write sweeps of the state (16 B per amplitude each):
//   pass lo: a block owns 2^k1 consecutive amplitudes (fixed high bits),
//            applies the kick to bits [0, k1) in shared memory;
//   pass hi: a block owns W consecutive low columns x all 2^n2 high values,
//            applies the kick to bits [k1, L), then the diagonal phase and
//            (forward) the A(t+1) partial sum of |psi|^2 z_q.
// With k1 = L - L/2 and n2 = L/2 the tiles are at most 32 KiB (lo) and
// 64 KiB (hi) at L=23. Butterflies run three bits per shared-memory round
// (8 amplitudes in registers), which cuts shared traffic and barriers 3x
// against one bit per round. The byte floor is 32 B per amplitude per
// cycle; shared-memory rounds (ceil(k/3) per pass) are the second limit.
//
// Reductions are deterministic: one partial per block, summed in a fixed
// order by a second kernel (double accumulator). Offsets are 64-bit. The
// pieces shared with floquet_general.cu are in floquet_common.cuh, the RX
// kick and the row coefficients shared with floquet_x_streamed.cu in
// floquet_rx.cuh.

#include "floquet_common.cuh"
#include "floquet_rx.cuh"

namespace {

// Per-pair row pointer and trip gate. Forward (echo == 0): row `step` is
// the cycle's row, the kick sign is +1. Echo: rows 2*step (pre) and
// 2*step+1 (post); the pair runs only while step < trip (lane 124 of row 0).
struct StepRows {
  const float* pre;   // nullptr when there is no pre diagonal
  const float* post;
  float sign;
  bool active;
};

__device__ __forceinline__ StepRows step_rows(const float* rows,
                                              int64_t rows_per_pair, int pair,
                                              int step, int echo) {
  const float* base = rows + (int64_t)pair * rows_per_pair * kRowWidth;
  StepRows r;
  if (echo) {
    const int trip = (int)base[kRowWidth - 4];
    r.active = step < trip;
    r.pre = base + (int64_t)(2 * step) * kRowWidth;
    r.post = r.pre + kRowWidth;
    r.sign = r.pre[kRowWidth - 3];
  } else {
    r.active = true;
    r.pre = nullptr;
    r.post = base + (int64_t)step * kRowWidth;
    r.sign = 1.0f;
  }
  return r;
}

// Pass lo: [pre diagonal] then the kick on bits [0, k1).
__global__ void pass_lo_kernel(float2* __restrict__ st, int L, int k1,
                               const float* __restrict__ rows,
                               int64_t rows_per_pair, int step, int echo,
                               float c, float s) {
  extern __shared__ float2 tile[];
  __shared__ float cz[64], cb[64], c0;
  const int pair = blockIdx.y;
  const StepRows r = step_rows(rows, rows_per_pair, pair, step, echo);
  if (!r.active) return;
  const int64_t N = (int64_t)1 << L;
  const int64_t hi = blockIdx.x;
  const int n = 1 << k1;
  float2* g = st + (int64_t)pair * N + (hi << k1);
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = g[i];
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
  kick_bits(tile, k1, 0, k1, c, s * r.sign);
  for (int i = threadIdx.x; i < n; i += blockDim.x) g[i] = tile[i];
}

// Pass hi: the kick on bits [k1, L), the post diagonal, and (forward) the
// partial sum of |psi|^2 z_q into partials[(pair * T + step + 1) * nblk + bx].
__global__ void pass_hi_kernel(float2* __restrict__ st, int L, int k1,
                               const float* __restrict__ rows,
                               int64_t rows_per_pair, int step, int echo,
                               float c, float s, int q,
                               float* __restrict__ partials, int T) {
  extern __shared__ float2 tile[];  // [2^n2][kW]
  __shared__ float cz[64], cb[64], c0, th_lo[kW], red[kThreads / 32];
  const int pair = blockIdx.y;
  const StepRows r = step_rows(rows, rows_per_pair, pair, step, echo);
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
  __syncthreads();
  if (threadIdx.x < kW) {
    th_lo[threadIdx.x] = c0 + angle_bits(cz, cb, o + threadIdx.x, 0, k1);
  }
  // tile index = h * kW + w: the high bits sit at tile bits [2, 2 + n2)
  kick_bits(tile, n2 + 2, 2, n2, c, s * r.sign);  // ends in __syncthreads
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
      if (!echo) {
        const float z = zq_lo >= 0 ? zsign(lo, q) : zsign(h, q - k1);
        acc += (v.x * v.x + v.y * v.y) * z;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    g[((int64_t)(i / kW) << k1) + (i % kW)] = tile[i];
  }
  if (!echo) {
    const float tot = block_sum(acc, red);
    if (threadIdx.x == 0) {
      partials[((int64_t)pair * T + step + 1) * gridDim.x + blockIdx.x] = tot;
    }
  }
}

cudaError_t launch_step(float2* st, int L, const float* rows,
                        int64_t rows_per_pair, int n_pairs, int step, int echo,
                        float c, float s, int q, float* partials, int T,
                        cudaStream_t stream) {
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
      st, L, k1, rows, rows_per_pair, step, echo, c, s);
  pass_hi_kernel<<<dim3((1u << k1) / kW, n_pairs), kThreads, smem_hi,
                   stream>>>(st, L, k1, rows, rows_per_pair, step, echo, c, s,
                             q, partials, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Sizes the wrapper allocates: partials of the forward entry.
int floquet_x_forward_partials(int L) { return (1 << lo_bits(L)) / kW; }

// Sizes the wrapper allocates: partials of the echo entry (per pair).
int floquet_x_echo_partials(int L) { return (1 << L) / kMeasureChunk; }

// K1. state: n_traj x 2^L complex64 scratch; rows: n_traj x T x 128 f32;
// partials: n_traj x T x floquet_x_forward_partials(L) f32;
// out: n_traj x T f32 (A(t) before the host's sigma/ancilla factor).
// Runs the T - 1 cycles whose results are measured.
int floquet_x_forward(void* state, const void* rows, void* partials,
                      void* out, int n_traj, int L, int T, int q, int64_t b0,
                      float c, float s, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float2* st = (float2*)state;
  const int64_t N = (int64_t)1 << L;
  init_kernel<<<dim3(256, n_traj), kThreads, 0, stream>>>(st, N, b0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int cyc = 0; cyc + 1 < T; ++cyc) {
    e = launch_step(st, L, (const float*)rows, T, n_traj, cyc, 0, c, s, q,
                    (float*)partials, T, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t n_rows = (int64_t)n_traj * T;
  const float a0 = 1.0f - 2.0f * (float)((b0 >> q) & 1);
  reduce_kernel<<<(unsigned)((n_rows + kThreads - 1) / kThreads), kThreads,
                  0, stream>>>((const float*)partials, (float*)out, n_rows,
                               floquet_x_forward_partials(L), T, a0);
  return (int)cudaGetLastError();
}

// K2. state: n_pairs x 2^L complex64 scratch; tiles: n_pairs x rows x 128
// f32 (interleaved pre/post step rows, trip count 2t at lane 124 of row 0);
// partials: n_pairs x floquet_x_echo_partials(L) f32; out: n_pairs f32.
// n_steps = the largest trip count of the batch.
int floquet_x_echo(void* state, const void* tiles, void* partials, void* out,
                   int n_pairs, int L, int rows_per_pair, int n_steps, int q,
                   int64_t b0, float c, float s, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float2* st = (float2*)state;
  const int64_t N = (int64_t)1 << L;
  init_kernel<<<dim3(256, n_pairs), kThreads, 0, stream>>>(st, N, b0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int k = 0; k < n_steps; ++k) {
    e = launch_step(st, L, (const float*)tiles, rows_per_pair, n_pairs, k, 1,
                    c, s, q, nullptr, 0, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)measure_and_reduce(st, L, q, n_pairs, (float*)partials,
                                 (float*)out, stream);
}

}  // extern "C"
