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
//   factorized over the bit split s = (hi << k1) | lo;
// - the diagonal is fused into the pass that applies the kick, so it costs
//   no memory pass of its own;
// - the echo turnaround conj-correction is in the (pre, post) rows built by
//   the host (ops/params.py::echo_pair_tiles); the inverse kick is RX with
//   its imaginary part sign-flipped (lane 125 of the pre row).
//
// What bounds it on this card: the state is 2^L complex64 per trajectory
// (8 MiB at L=20), far above shared memory, so it lives in device memory
// and every step must stream it, two read+write sweeps (16 B per amplitude
// each). Both entries run the step passes of floquet_echo.cuh with the
// kick policy of floquet_x_echo.cuh (XEcho, one angle: ConstKick), as K3
// does, on the plan a = L - L/2, b = 0, CW = kW = 4:
//   pass lo: a block owns 2^a consecutive amplitudes (fixed high bits)
//            and applies the kick to bits [0, a);
//   pass hi: a block owns kW consecutive low columns x all 2^(L/2) high
//            values, applies the kick to bits [a, L), then the step's
//            diagonal and (forward) the A(t+1) partial of |psi|^2 z_q.
// The tiles are at most 32 KiB (lo) and 64 KiB (hi) at L=23. The byte
// floor is 32 B per amplitude per step. One folded diagonal per step
// (ops/echo_fold.py), its phases from two small tables per block; the kick
// in swizzled 2-3-bit rounds whose first reads the state and whose last
// writes it, so each pass makes one read and one write.
// - K1 (forward, ForwardRows): step k is cycle k's kick, then fold row k+1
//   (forward_fold: cycle k's diagonal; row 0 not read), measured into
//   A(k+1) in pass hi's store (Times), one partial a block and step; one
//   fixed-order reduce at the end (floquet_plan.cuh).
// - K2 (echo, PairRows): step 0's pass lo applies the first pre diagonal,
//   every pass hi the step's post diagonal and the next step's pre; each
//   pair is measured after its last step.
//
// Reductions are deterministic: one partial per block, summed in a fixed
// order by a second kernel (double accumulator). Offsets are 64-bit. The
// pieces shared with floquet_general.cu are in floquet_common.cuh, the RX
// kick shared with the other x libraries in floquet_rx.cuh.

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_plan.cuh"
#include "floquet_rx.cuh"
#include "floquet_x_echo.cuh"
#include "floquet_x_pass.cuh"

namespace {

bool forward_in_range(int L, int q, int n_traj, int T, int fold_rows) {
  return 17 <= L && L <= 23 && 0 <= q && q < L && n_traj >= 1 && T >= 1 &&
         fold_rows >= T;
}

}  // namespace

extern "C" {

// Sizes the wrapper allocates: partials of the forward entry, per
// trajectory and time (pass hi's blocks).
int floquet_x_forward_partials(int L) {
  return step_hi_blocks(lo_bits(L), 0, kW);
}

// Sizes the wrapper allocates: partials of the echo entry (per pair).
int floquet_x_echo_partials(int L) { return measure_blocks(L); }

// K1. state: n_traj x 2^L complex64 scratch; rows: n_traj x T x 128 f32
// (one compact row per cycle); fold: n_traj x fold_rows x 2L f32, the
// cycles' diagonals (ops/echo_fold.py::forward_fold of rows 0..T-2;
// fold_rows >= T); partials: n_traj x T x floquet_x_forward_partials(L)
// f32, zeroed; out: n_traj x T f32 (A(t) before the host's sigma/ancilla
// factor). Runs the T - 1 cycles whose results are measured; out of range
// (17 <= L <= 23, 0 <= q < L, T >= 1, fold_rows >= T) it launches nothing.
int floquet_x_forward(void* state, const void* rows, const void* fold,
                      void* partials, void* out, int n_traj, int L, int T,
                      int fold_rows, int q, int64_t b0, float c, float s,
                      void* stream_ptr) {
  if (!forward_in_range(L, q, n_traj, T, fold_rows)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const cudaError_t e = run_steps<kW>(
      (float2*)state, L, lo_bits(L), 0, (const float*)rows, T,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L, false}, n_traj,
      T - 1, XEcho<ForwardRows, ConstKick>{{}, ConstKick{c, s}},
      Times{(float*)partials, q, T}, b0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_times((const float*)partials,
                           floquet_x_forward_partials(L), (float*)out, n_traj,
                           T, q, b0, stream);
}

// K2. state: n_pairs x 2^L complex64 scratch; tiles: n_pairs x rows x 128
// f32 (interleaved pre/post step rows, trip count 2t at lane 124 of row 0);
// fold: n_pairs x fold_rows x 2L f32, the folded diagonals
// (ops/echo_fold.py); partials: n_pairs x floquet_x_echo_partials(L) f32;
// out: n_pairs f32. n_steps = the largest trip count of the batch.
int floquet_x_echo(void* state, const void* tiles, const void* fold,
                   void* partials, void* out, int n_pairs, int L,
                   int rows_per_pair, int fold_rows, int n_steps, int q,
                   int64_t b0, float c, float s, void* stream_ptr) {
  return (int)run_echo<kW>(
      (float2*)state, L, lo_bits(L), 0, (const float*)tiles, rows_per_pair,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L}, n_pairs, n_steps,
      XEcho<PairRows, ConstKick>{{}, ConstKick{c, s}}, q, b0,
      (float*)partials, (float*)out, (cudaStream_t)stream_ptr);
}

}  // extern "C"
