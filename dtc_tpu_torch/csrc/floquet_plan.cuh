// The pass plan of the streamed families, floquet_x_streamed.cu (constant
// x) and floquet_general_streamed.cu (lab frame, any drive), and of the
// per-shard cycle kernels from L_loc = 22 (floquet_cycle_hi.cu, and K10's
// shard-local forms in floquet_general_streamed.cu): how a step cuts
// a 2^L state in device memory into shared-memory tiles up to L=30; and the
// fixed-order reductions of the per-block partials, shared with every
// forward that measures in pass hi's store (K1, K3a, K4, K8a).
//
//   pass lo:  bits [0, a), a tile of 2^a consecutive amplitudes;
//   pass mid: bits [a, a+b) (only when L >= 25), tiles of 2^b rows x kW
//             consecutive columns;
//   pass hi:  bits [a+b, L), tiles of 2^c rows x kW columns, which end the
//             step (the diagonal and the partial of |psi|^2 z_q).
// L <= 24 takes two passes (a <= 13, c <= 11: at most 64 KiB a tile), L =
// 25..30 three; floquet_x_streamed.cu says why. Every kernel on this plan
// runs it on the step passes of floquet_echo.cuh, whose strided tiles take
// 16 columns from L = 25 (tiles of 16-64 KiB).
//
// Include after floquet_common.cuh; the definitions sit in an anonymous
// namespace of their own.

#pragma once

#include "floquet_common.cuh"

namespace {

static_assert(kW == 4, "strided tiles keep the columns in tile bits 0..1");

// Bits per pass: lo [0, a), mid [a, a + b) (b = 0: no mid pass), hi
// [a + b, L), with the tiles of about equal size (2^a = 2^c * kW).
struct Plan {
  int a, b, c;
};

Plan plan_for(int L) {
  if (L <= 24) {
    const int c = (L - 2) / 2;
    return {L - c, 0, c};
  }
  const int c = (L - 2) / 3;
  return {L - 2 * c, c, c};
}

// The sum of p[0..nb) in a fixed order (a fixed strided share per thread,
// then a fixed tree, in double), in thread 0 of the block.
__device__ double fixed_sum(const float* __restrict__ p, int nb) {
  __shared__ double red[kThreads];
  double acc = 0.0;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) acc += p[b];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  return red[0];
}

// out[row * stride + off] = the sum of partials[row * nb + b] over b, in a
// fixed order.
__global__ void reduce_rows_kernel(const float* __restrict__ partials, int nb,
                                   float* __restrict__ out, int64_t stride,
                                   int64_t off) {
  const int64_t row = blockIdx.x;
  const double sum = fixed_sum(partials + row * nb, nb);
  if (threadIdx.x == 0) out[row * stride + off] = (float)sum;
}

// out[i * T] = a0: A(0) of every trajectory, its basis state's z_q.
__global__ void first_kernel(float* __restrict__ out, int n, int T, float a0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[(int64_t)i * T] = a0;
}

// A forward's tail: out (n_traj x T) = the fixed-order sums of its
// (n_traj, T, nb) partials (Times, floquet_echo.cuh), then A(0) = z_q of
// the basis state b0 (no step measures t = 0).
cudaError_t reduce_times(const float* partials, int nb, float* out,
                         int n_traj, int T, int q, int64_t b0,
                         cudaStream_t stream) {
  reduce_rows_kernel<<<(unsigned)((int64_t)n_traj * T), kThreads, 0,
                       stream>>>(partials, nb, out, 1, 0);
  const float a0 = 1.0f - 2.0f * (float)((b0 >> q) & 1);
  first_kernel<<<(n_traj + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      out, n_traj, T, a0);
  return cudaGetLastError();
}

}  // namespace
