// Resident x-drive Floquet kernels for Hopper (sm_90a): forward A(t) (K3a)
// and echo A0(t) (K3b) of the kicked-Ising chain in the sigma frame, for a
// constant or a per-cycle x schedule at 14 <= L <= 21.
//
// Replaces
//   K3a dtc_tpu/ops/pallas_resident.py::_make_kernel
//       (entry resident_forward_batch)
//   K3b dtc_tpu/ops/pallas_resident.py::_make_echo_kernel
//       (entry resident_echo_batch)
//
// What is ported is the math, not the TPU design. The sigma frame, the
// compact rows, the fused diagonal angle and the host factor are K1/K2's
// (floquet_x.cu; ops/params.py builds K3's rows bit for bit). What K3 adds
// is the schedule: the TPU kernel carries (Tu, 128, 128) and (Tu, TOP, TOP)
// kick matrices, one per cycle of a per-cycle schedule (Tu = T) or one for
// a constant one (Tu = 1), because its kick is a matrix product. Here the
// kick is RX(theta_t) on every qubit, so the schedule is a device table of
// (cos theta_t/2, sin theta_t/2), Tu x 2 f32:
//   - the forward's cycle `cyc` reads row cyc, bounded by Tu (row 0 when
//     Tu = 1);
//   - an echo step reads the row its pre row names in lane 127 (forward
//     step k: k; inverse step: 2t-1-k; ops/params.py::echo_pair_tiles),
//     read as an int and bounded by Tu, with the imaginary sign of lane
//     125 (-1 on inverse steps), as K2.
// The TPU kernel's q < 14 limit (its probe on the column axis) is not
// carried over: any 0 <= q < L.
//
// Design: both entries run the step passes of floquet_echo.cuh with the
// kick policy of floquet_x_echo.cuh on K1/K2's plan (a = L - L/2, b = 0,
// CW = kW = 4): at L=14 a lo tile is 1 KiB and a hi tile 4 KiB, at L=21 16
// and 32 KiB. One diagonal per step, folded by the wrapper
// (ops/echo_fold.py), its phases from two small tables per block instead of
// a sincos per amplitude; the kick in rounds whose first reads the state
// and whose last writes it, on a swizzled tile without bank conflicts.
// The forward (XEcho<ForwardRows, TableKick>, K1's reader with the table
// where K1 takes one angle) applies cycle k's diagonal, fold row k+1 of
// forward_fold, in step k's pass hi and measures A(k+1) as it stores
// (Times), one fixed-order reduce at the end; the echo (XEcho<PairRows,
// TableKick>) folds each step's post diagonal and the next step's pre into
// one row and measures each pair after its last step.
//
// What bounds it on this card: two read+write sweeps of the state per step
// (32 B per amplitude and step) at the HBM rate (the rates: PERF.md section
// 6). At 14 <= L <= 16 a batch of 32 trajectories (4-16 MiB of states) sits
// in the L2 anyway, and each step still makes two launches of small
// blocks, so launch and latency, not bytes, set the forward's time there.

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_plan.cuh"
#include "floquet_rx.cuh"
#include "floquet_x_echo.cuh"
#include "floquet_x_pass.cuh"

namespace {

bool forward_in_range(int L, int q, int n_traj, int T, int tu,
                      int fold_rows) {
  return 14 <= L && L <= 21 && 0 <= q && q < L && n_traj >= 1 && T >= 1 &&
         tu >= 1 && fold_rows >= T;
}

}  // namespace

extern "C" {

// Sizes the wrapper allocates: partials of the forward entry, per
// trajectory and time (pass hi's blocks).
int floquet_x_resident_forward_partials(int L) {
  return step_hi_blocks(lo_bits(L), 0, kW);
}

// Sizes the wrapper allocates: partials of the echo entry (per pair).
int floquet_x_resident_echo_partials(int L) {
  return measure_blocks(L);
}

// K3a. state: n_traj x 2^L complex64 scratch; rows: n_traj x T x 128 f32
// (one compact row per cycle); fold: n_traj x fold_rows x 2L f32, the
// cycles' diagonals (ops/echo_fold.py::forward_fold of rows 0..T-2;
// fold_rows >= T); cs: tu x 2 f32 (cos, sin of theta_t / 2; cycle k reads
// row min(k, tu - 1)); partials: n_traj x T x
// floquet_x_resident_forward_partials(L) f32, zeroed; out: n_traj x T f32
// (A(t) before the host's sigma/ancilla factor). Runs the T - 1 cycles
// whose results are measured; out of range (14 <= L <= 21, 0 <= q < L,
// T >= 1, tu >= 1, fold_rows >= T) it launches nothing.
int floquet_x_resident_forward(void* state, const void* rows,
                               const void* fold, const void* cs,
                               void* partials, void* out, int n_traj, int L,
                               int T, int fold_rows, int tu, int q,
                               int64_t b0, void* stream_ptr) {
  if (!forward_in_range(L, q, n_traj, T, tu, fold_rows)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const cudaError_t e = run_steps<kW>(
      (float2*)state, L, lo_bits(L), 0, (const float*)rows, T,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L, false}, n_traj,
      T - 1,
      XEcho<ForwardRows, TableKick>{{}, TableKick{(const float*)cs, tu}},
      Times{(float*)partials, q, T}, b0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_times((const float*)partials,
                           floquet_x_resident_forward_partials(L),
                           (float*)out, n_traj, T, q, b0, stream);
}

// K3b. state: n_pairs x 2^L complex64 scratch; tiles: n_pairs x rows x 128
// f32 (interleaved pre/post step rows, trip count 2t at lane 124 of row 0,
// table row at lane 127 of each pre row); fold: n_pairs x fold_rows x 2L
// f32, the folded diagonals (ops/echo_fold.py); cs: tu x 2 f32; partials:
// n_pairs x floquet_x_resident_echo_partials(L) f32; out: n_pairs f32.
// n_steps = the largest trip count of the batch.
int floquet_x_resident_echo(void* state, const void* tiles, const void* fold,
                            const void* cs, void* partials, void* out,
                            int n_pairs, int L, int rows_per_pair,
                            int fold_rows, int n_steps, int tu, int q,
                            int64_t b0, void* stream_ptr) {
  return (int)run_echo<kW>(
      (float2*)state, L, lo_bits(L), 0, (const float*)tiles, rows_per_pair,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L}, n_pairs, n_steps,
      XEcho<PairRows, TableKick>{{}, TableKick{(const float*)cs, tu}}, q, b0,
      (float*)partials, (float*)out, (cudaStream_t)stream_ptr);
}

}  // extern "C"
