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
// each):
//   pass lo: a block owns 2^k1 consecutive amplitudes (fixed high bits)
//            and applies the kick to bits [0, k1) in shared memory;
//   pass hi: a block owns W consecutive low columns x all 2^n2 high values,
//            applies the kick to bits [k1, L), then the diagonal phase and
//            (forward) the A(t+1) partial sum of |psi|^2 z_q.
// With k1 = L - L/2 and n2 = L/2 the tiles are at most 32 KiB (lo) and
// 64 KiB (hi) at L=23. The byte floor is 32 B per amplitude per step.
//
// The forward runs the passes of floquet_x_pass.cuh (shared with K3a): a
// sincos per amplitude for its diagonal, the tile staged whole
// through shared memory, three bits per round. The echo runs the passes of
// floquet_echo.cuh with the kick policy of floquet_x_echo.cuh (XEcho on
// PairRows, one angle: ConstKick), as K3b does: one folded diagonal per
// step (ops/echo_fold.py: step 0's pass lo applies the first pre diagonal,
// every pass hi the step's post diagonal and the next step's pre), its
// phases from two small tables per block, and the kick in swizzled 2-3-bit
// rounds whose first reads the state and whose last writes it, so each
// pass makes one read and one write; each pair is measured after its last
// step.
//
// Reductions are deterministic: one partial per block, summed in a fixed
// order by a second kernel (double accumulator). Offsets are 64-bit. The
// pieces shared with floquet_general.cu are in floquet_common.cuh, the RX
// kick and the row coefficients shared with floquet_x_streamed.cu in
// floquet_rx.cuh.

#include "floquet_common.cuh"
#include "floquet_rx.cuh"
#include "floquet_x_pass.cuh"
#include "floquet_x_echo.cuh"

extern "C" {

// Sizes the wrapper allocates: partials of the forward entry.
int floquet_x_forward_partials(int L) { return (1 << lo_bits(L)) / kW; }

// Sizes the wrapper allocates: partials of the echo entry (per pair).
int floquet_x_echo_partials(int L) { return measure_blocks(L); }

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
    e = launch_step(st, L, (const float*)rows, T, n_traj, cyc,
                    ConstKick{c, s}, q, (float*)partials, T, stream);
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
