// Per-shard x cycle kernels for Hopper (sm_90a): ONE sigma-frame x cycle
// on the shard-local bits of a batch of amplitude shards,
// 17 <= L_loc <= 23, for the amplitude-sharded engines
// (dtc_tpu_torch/parallel/sharded.py).
//
// Replaces (one CUDA family)
//   K8a dtc_tpu/ops/pallas_cycle.py::_make_cycle_kernel
//       (entry cycle_forward_apply)
//   K8b dtc_tpu/ops/pallas_cycle.py::_make_inverse_kernel
//       (entry cycle_inverse_apply)
// The lab-frame pair of the same reference file, K8c and K8d, are entries
// of floquet_general_streamed.cu (floquet_cycle_general_forward and
// floquet_cycle_general_inverse), beside K10's shard-local forms, whose
// kick policy and step rows they share.
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
// The shard-bit kicks are the caller's. A shard's global diagonal commutes
// with nothing that touches its local top bit, but the shard-bit kicks
// commute with the local kick and the local diagonal, so the caller runs
// them before K8a and after K8b, and each launch still applies one
// diagonal; measuring z_q of a local bit after them is exact, because z_q
// commutes with them.
//
// What bounds it on this card: as K1/K2, the shard's 2^L_loc complex64
// amplitudes (64 MiB at L_loc=23) live in device memory and a step is two
// read+write sweeps (32 B per amplitude); the butterflies' operations are
// the second limit (6 flops per amplitude and bit for RX). Offsets are
// 64-bit. The rows a wrapper hands in are n x 2 x 2L f32 folded pairs
// (ops/cycle.py).

#include "floquet_common.cuh"
#include "floquet_plan.cuh"
#include "floquet_rx.cuh"
#include "floquet_x_echo.cuh"

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

}  // extern "C"
