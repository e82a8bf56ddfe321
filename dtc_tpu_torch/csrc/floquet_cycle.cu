// Per-shard cycle kernels for Hopper (sm_90a): ONE Floquet cycle on the
// shard-local bits of a batch of amplitude shards, 17 <= L_loc <= 23, for
// the amplitude-sharded engines (dtc_tpu_torch/parallel/sharded.py).
//
// Replaces (one CUDA family)
//   K8a dtc_tpu/ops/pallas_cycle.py::_make_cycle_kernel
//       (entry cycle_forward_apply)
//   K8b dtc_tpu/ops/pallas_cycle.py::_make_inverse_kernel
//       (entry cycle_inverse_apply)
//   K8c dtc_tpu/ops/pallas_cycle.py::_make_general_cycle_kernel
//       (entry general_cycle_forward_apply)
//   K8d dtc_tpu/ops/pallas_cycle.py::_make_general_inverse_cycle_kernel
//       (entry general_cycle_inverse_apply)
//
// K8 is K1/K2/K4 restricted to the local bits, so the passes are not
// forked: the entries run the existing passes for one cycle at L = L_loc.
// - K8a (sigma-frame x forward): K1's step (floquet_x_pass.cuh, ConstKick)
//   on one compact row: RX(theta) on every local bit, then that cycle's
//   diagonal (noise-Z signs, sigma-corrected h and phi of the local bits),
//   and the partial sum of |psi|^2 z_q, q < L_loc.
// - K8b (x inverse, pre-fold K.D): K2's echo step on a (pre, post) pair
//   whose pre row is the cycle's compact row (sign +1: the caller negated
//   the imaginary part once at the echo's turnaround, so each inverse cycle
//   is the un-negated forward operator in reverse order) and whose post row
//   is zero (the identity diagonal).
// - K8c (lab-frame forward): K4's forward steps for the cycle's K slot rows
//   (X-mask row swap, the cycle's diagonal on the final slot), the partial
//   on the final slot.
// - K8d (daggered lab-frame cycle): K4's echo steps for the K slots' (pre,
//   post) row pairs.
// Everything that touches a shard bit (the global kicks, the global
// diagonal, the boundary bond phi[L_loc-1]) is the caller's; measuring
// before it is exact because z_q of a local bit commutes with all of it.
//
// What bounds it on this card: as K1/K2/K4, the shard's 2^L_loc complex64
// amplitudes (64 MiB at L_loc=23) live in device memory and a step is two
// read+write sweeps (32 B per amplitude); the butterflies' operations are
// the second limit (6 flops per amplitude and bit for RX, 14 for a general
// 2x2). One launch pair per slot; the partials are summed in a fixed order
// by a second kernel. Offsets are 64-bit. The rows a wrapper hands in are
// n x 128 (K8a), n x 2 x 128 (K8b), n x K x 128 (K8c) and n x K x 2 x 128
// (K8d) f32, with the flag lanes set by the wrapper (ops/cycle.py).
//
// The x passes and the lab-frame passes both define load_coeffs, StepRows
// and the pass kernels, each in an anonymous namespace of its own header;
// here each family's headers are included inside a named namespace so that
// the two sets of names stay apart. floquet_common.cuh comes first, at file
// scope, so that the headers' own includes of it are skipped.

#include "floquet_common.cuh"

namespace xpass {
#include "floquet_rx.cuh"
#include "floquet_x_pass.cuh"
}  // namespace xpass

namespace labpass {
#include "floquet_lab.cuh"
#include "floquet_general_pass.cuh"
}  // namespace labpass

extern "C" {

// Partial slots per state of the forward entries (pass hi's blocks).
int floquet_cycle_partials(int L) { return (1 << lo_bits(L)) / kW; }

// K8a. state: n x 2^L complex64, updated in place; rows: n x 128 f32;
// partials: n x 2 x floquet_cycle_partials(L) f32 scratch; out: n x 2 f32,
// out[i][1] = sum |psi|^2 z_q of state i after the cycle (out[i][0] = 0).
int floquet_cycle_forward(void* state, const void* rows, void* partials,
                          void* out, int n, int L, int q, float c, float s,
                          void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // K1's forward step 0 of a T=2 run: its partial lands in slot 1
  cudaError_t e = xpass::launch_step(
      (float2*)state, L, (const float*)rows, 1, n, 0, 0,
      xpass::ConstKick{c, s}, q, (float*)partials, 2, stream);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_rows = 2 * (int64_t)n;
  reduce_kernel<<<(unsigned)((n_rows + kThreads - 1) / kThreads), kThreads,
                  0, stream>>>((const float*)partials, (float*)out, n_rows,
                               floquet_cycle_partials(L), 2, 0.0f);
  return (int)cudaGetLastError();
}

// K8b. state: n x 2^L complex64, updated in place; tiles: n x 2 x 128 f32
// (the pre row with trip count 1 at lane 124 and kick sign +1 at lane 125,
// then a zero post row).
int floquet_cycle_inverse(void* state, const void* tiles, int n, int L,
                          float c, float s, void* stream_ptr) {
  return (int)xpass::launch_step(
      (float2*)state, L, (const float*)tiles, 2, n, 0, 1,
      xpass::ConstKick{c, s}, 0, nullptr, 0, (cudaStream_t)stream_ptr);
}

// K8c. state: n x 2^L complex64, updated in place; rows: n x K x 128 f32
// (MPOS -1 on slots 0..K-2, 0 on slot K-1); partials: n x
// floquet_cycle_partials(L) f32 scratch; out: n f32, sum |psi|^2 z_q after
// the cycle.
int floquet_cycle_general_forward(void* state, const void* rows,
                                  void* partials, void* out, int n, int L,
                                  int K, int q, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  for (int k = 0; k < K; ++k) {
    cudaError_t e = labpass::launch_step((float2*)state, L,
                                         (const float*)rows, K, n, k, 0, q,
                                         (float*)partials, 1, stream);
    if (e != cudaSuccess) return (int)e;
  }
  reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                  stream>>>((const float*)partials, (float*)out, n,
                            floquet_cycle_partials(L), 0, 0.0f);
  return (int)cudaGetLastError();
}

// K8d. state: n x 2^L complex64, updated in place; tiles: n x K x 2 x 128
// f32, per slot (pre, post) rows, COUNT = K at lane FO+10 of row 0.
int floquet_cycle_general_inverse(void* state, const void* tiles, int n,
                                  int L, int K, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  for (int k = 0; k < K; ++k) {
    cudaError_t e = labpass::launch_step((float2*)state, L,
                                         (const float*)tiles, 2 * K, n, k, 1,
                                         0, nullptr, 0, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
