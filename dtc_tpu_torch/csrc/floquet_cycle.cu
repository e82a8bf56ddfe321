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
// K8a and K8b run the step passes of floquet_echo.cuh (launch_steps, one
// step from the states as they are) with the x family's policy
// (floquet_x_echo.cuh, XEcho on its CycleRows: every pair active, kick
// sign +1, one angle) on K2's plan at L = L_loc (a = L - L/2, b = 0, CW =
// kW = 4): the diagonal's phases from two small tables a block, the kick
// in swizzled 2-3-bit rounds whose first reads the state and whose last
// writes it, so each pass makes one read and one write.
// - K8a (sigma-frame x forward): RX(theta) on every local bit, then the
//   cycle's diagonal: folded row 1 of a pair (ops/cycle.py::
//   fold_cycle_rows; row 0 is not read, Fold::pre0 false), the local
//   noise-Z signs and sigma-corrected h and phi of the cycle's compact row
//   with the shard's global diagonal (a constant in c0 and the boundary
//   bond's Z term on the local top bit in cz[L-1]); with q >= 0 pass hi's
//   store writes one partial of |psi|^2 z_q a block (Times), summed in a
//   fixed order by one reduce; with q < 0 nothing is measured (NoTimes).
// - K8b (x inverse, pre-fold K.D): folded row 0 of a pair (the shard's
//   global and local diagonal of the step) in pass lo before the kick
//   (Fold::pre0 true), row 1 zero (the identity) in pass hi. The caller
//   negated the imaginary part once at the echo's turnaround, so each
//   inverse cycle is the un-negated forward operator in reverse order.
// - K8c (lab-frame forward): K4's forward steps for the cycle's K slot rows
//   (X-mask row swap, the cycle's diagonal on the final slot), the partial
//   on the final slot (floquet_general_pass.cuh).
// - K8d (daggered lab-frame cycle): K4's echo steps for the K slots' (pre,
//   post) row pairs (floquet_general_pass.cuh).
// The shard-bit kicks are the caller's, and for K8c/K8d the global diagonal
// and the boundary bond phi[L_loc-1] too. A shard's global diagonal commutes
// with nothing that touches its local top bit, but the shard-bit kicks
// commute with the local kick and the local diagonal, so the caller runs
// them before K8a and after K8b, and each launch still applies one
// diagonal; measuring z_q of a local bit after them is exact, because z_q
// commutes with them.
//
// What bounds it on this card: as K1/K2/K4, the shard's 2^L_loc complex64
// amplitudes (64 MiB at L_loc=23) live in device memory and a step is two
// read+write sweeps (32 B per amplitude); the butterflies' operations are
// the second limit (6 flops per amplitude and bit for RX, 14 for a general
// 2x2). Offsets are 64-bit. The rows a wrapper hands in are n x 2 x 2L
// (K8a, K8b: folded pairs), n x K x 128 (K8c) and n x K x 2 x 128 (K8d)
// f32, K8c's and K8d's flag lanes set by the wrapper (ops/cycle.py).

#include "floquet_common.cuh"
#include "floquet_plan.cuh"
#include "floquet_rx.cuh"
#include "floquet_x_echo.cuh"
#include "floquet_lab.cuh"
#include "floquet_general_pass.cuh"

extern "C" {

// Partial slots per state of the forward entries (pass hi's blocks).
int floquet_cycle_partials(int L) {
  return step_hi_blocks(lo_bits(L), 0, kW);
}

// K8a. state: n x 2^L complex64, updated in place; fold: n x 2 x 2L f32
// folded rows (row 1 the cycle's diagonal); partials: n x
// floquet_cycle_partials(L) f32 scratch; out: n f32, sum |psi|^2 z_q of
// state i after the cycle. q < 0: no measure (partials and out unused).
int floquet_cycle_forward(void* state, const void* fold, void* partials,
                          void* out, int n, int L, int q, float c, float s,
                          void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float* rows = (const float*)fold;
  const Fold f{rows, 4 * (int64_t)L, false};
  const CyclePolicy policy{{}, ConstKick{c, s}};
  if (q < 0) {
    return (int)launch_steps<kW>((float2*)state, L, lo_bits(L), 0, rows, 2,
                                 f, n, 0, 1, policy, NoTimes{}, stream);
  }
  cudaError_t e = launch_steps<kW>((float2*)state, L, lo_bits(L), 0, rows, 2,
                                   f, n, 0, 1, policy,
                                   Times{(float*)partials, q, 1}, stream);
  if (e != cudaSuccess) return (int)e;
  reduce_rows_kernel<<<(unsigned)n, kThreads, 0, stream>>>(
      (const float*)partials, floquet_cycle_partials(L), (float*)out, 1, 0);
  return (int)cudaGetLastError();
}

// K8b. state: n x 2^L complex64, updated in place; fold: n x 2 x 2L f32
// folded rows (row 0 the step's diagonal, row 1 zero).
int floquet_cycle_inverse(void* state, const void* fold, int n, int L,
                          float c, float s, void* stream_ptr) {
  const float* rows = (const float*)fold;
  return (int)launch_steps<kW>(
      (float2*)state, L, lo_bits(L), 0, rows, 2,
      Fold{rows, 4 * (int64_t)L, true}, n, 0, 1,
      CyclePolicy{{}, ConstKick{c, s}}, NoTimes{},
      (cudaStream_t)stream_ptr);
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
    cudaError_t e = launch_step((float2*)state, L, (const float*)rows,
                                K, n, k, 0, q, (float*)partials, 1,
                                stream);
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
    cudaError_t e = launch_step((float2*)state, L, (const float*)tiles,
                                2 * K, n, k, 1, 0, nullptr, 0, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
