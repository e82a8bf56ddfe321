// Lab-frame Floquet kernels for Hopper (sm_90a), any kick schedule: forward
// A(t) and echo A0(t) of the kicked-Ising chain under x, y, xy, yx,
// circular and xy-cycle drives (K kick slots per cycle), and the per-cycle
// observables of the energy study.
//
// Replaces (one CUDA family for both, which differ only in TPU blocking)
//   K4a dtc_tpu/ops/pallas_resident_general.py::_make_general_kernel
//   K4b dtc_tpu/ops/pallas_resident_general.py::_make_general_kernel_blocked
//   (entries general_forward_batch, general_echo_batch)
// and
//   K5 dtc_tpu/ops/pallas_observables.py::_make_obs_kernel
//   (entry observables_forward_batch), as the entry
//   floquet_general_observables; see the note above that entry.
//
// What is ported is the math, not the TPU design (no Karatsuba dots, no
// in-kernel 128x128 group build, no P-packing). One step of a trajectory:
// - kick B = X_m U^{(x)L}: U is the step's complex 2x2 (lanes FO+2..9 of the
//   kick row, FO = 4L-1), m its X-mask (lanes [L, 2L)). Per qubit j the
//   butterfly applies U, or X U (rows swapped) where m_j = 1: the per-bit
//   form of B[a, b] = prod_j u[a_j ^ m_j, b_j];
// - diagonal exp(i theta(s)), one angle linear in the bits,
//     theta(s) = c0 + sum_q cz_q z_q(s) + sum_j cb_j z_j(s) z_{j+1}(s),
//     cz_q = -h_q/2 - (pi/2) n_q,  cb_j = -phi_j/2,  c0 = (pi/2) sum_q n_q,
//   from the row's noise-Z bits n (lanes [0, L)), h ([2L, 3L)) and phi
//   ([3L, 4L-1)); there is no sigma frame, so no sigma or flip term.
// Forward: each step is kick then the row's diagonal; where MPOS >= 0
// (lane FO, the final slot of a cycle) sum |psi|^2 z_q into A(MPOS).
// Echo: rows come in (pre, post) pairs; a step is the pre diagonal, the
// kick of the pre row, then the post diagonal; each pair runs COUNT = 2tK
// steps (lane FO+10 of its row 0) and is measured at the end. The echo
// runs the two echo passes of floquet_echo.cuh, redesigned for this card,
// with the kick policy of floquet_general_echo.cuh: the post diagonal and
// the next step's pre are
// one folded row (ops/echo_fold.py), applied once per step from two small
// phase tables per block; the kick runs in rounds whose first reads the
// state and whose last writes it, on a swizzled tile without bank
// conflicts.
//
// What bounds it on this card: as for K1/K2 (floquet_x.cu), the 2^L
// complex64 state (8 MiB at L=20) lives in device memory, and a step is two
// read+write sweeps of it (32 B per amplitude):
//   pass lo: a block owns 2^k1 consecutive amplitudes and applies the
//            [pre diagonal and] kick on bits [0, k1) in shared memory;
//   pass hi: a block owns kW low columns x all 2^n2 high values, applies
//            the kick on bits [k1, L), the (post) diagonal and the forward
//            partial sum.
// The butterflies run three bits per shared-memory round with the eight
// amplitudes in registers; a general complex 2x2 costs 14 flops per
// amplitude and bit against RX's 6, so the kick's arithmetic weighs more
// than in K1/K2. The per-qubit matrices are built once per block in shared
// memory. Reductions are deterministic (floquet_common.cuh). The row lanes,
// the kick matrices and the butterflies are in floquet_lab.cuh, shared with
// the large-L lab-frame family (floquet_general_streamed.cu); the two passes
// in floquet_general_pass.cuh, shared with K8c/K8d (floquet_cycle.cu).

#include "floquet_common.cuh"
#include "floquet_lab.cuh"
#include "floquet_general_pass.cuh"
#include "floquet_general_echo.cuh"

namespace {

// K4's echo step rows for GeneralEcho (floquet_general_echo.cuh).
struct PairRows {
  __device__ __forceinline__ StepRows at(const float* rows, int L,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return step_rows(rows, L, rows_per_pair, pair, step, 1);
  }
};

}  // namespace

extern "C" {

// Sizes the wrapper allocates: partials of the forward entry.
int floquet_general_forward_partials(int L) {
  return (1 << lo_bits(L)) / kW;
}

// Sizes the wrapper allocates: partials of the echo entry (per pair).
int floquet_general_echo_partials(int L) {
  return measure_blocks(L);
}

// K4 forward. state: n_traj x 2^L complex64 scratch; rows: n_traj x
// rows_per_traj x 128 f32 (one row per kick slot, T*K of them); partials:
// n_traj x T x floquet_general_forward_partials(L) f32, zeroed; out: n_traj
// x T f32 (A(t) before the host's ancilla factor and sign). Runs the first
// n_steps = (T-1)*K steps, the ones whose results are measured.
int floquet_general_forward(void* state, const void* rows, void* partials,
                            void* out, int n_traj, int L, int rows_per_traj,
                            int T, int n_steps, int q, int64_t b0,
                            void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float2* st = (float2*)state;
  const int64_t N = (int64_t)1 << L;
  init_kernel<<<dim3(256, n_traj), kThreads, 0, stream>>>(st, N, b0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int k = 0; k < n_steps; ++k) {
    e = launch_step(st, L, (const float*)rows, rows_per_traj, n_traj, k, 0, q,
                    (float*)partials, T, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t n_rows = (int64_t)n_traj * T;
  const float a0 = 1.0f - 2.0f * (float)((b0 >> q) & 1);
  reduce_kernel<<<(unsigned)((n_rows + kThreads - 1) / kThreads), kThreads,
                  0, stream>>>((const float*)partials, (float*)out, n_rows,
                               floquet_general_forward_partials(L), T, a0);
  return (int)cudaGetLastError();
}

// K4 echo. state: n_pairs x 2^L complex64 scratch; tiles: n_pairs x
// rows_per_pair x 128 f32 (interleaved pre/post step rows, COUNT at lane
// 4L+9 of row 0); fold: n_pairs x fold_rows x 2L f32, the folded diagonals
// (ops/echo_fold.py); partials: n_pairs x floquet_general_echo_partials(L)
// f32; out: n_pairs f32. n_steps = the largest COUNT of the batch.
int floquet_general_echo(void* state, const void* tiles, const void* fold,
                         void* partials, void* out, int n_pairs, int L,
                         int rows_per_pair, int fold_rows, int n_steps, int q,
                         int64_t b0, void* stream_ptr) {
  return (int)run_echo<kW>(
      (float2*)state, L, lo_bits(L), 0, (const float*)tiles, rows_per_pair,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L}, n_pairs, n_steps,
      GeneralEcho<PairRows>{}, q, b0, (float*)partials, (float*)out,
      (cudaStream_t)stream_ptr);
}

// Sizes the wrapper allocates: block slots per lane of the K5 partials.
int floquet_general_observables_slots(int L) {
  return (1 << (L - lo_bits(L))) + (1 << lo_bits(L)) / kW;
}

// K5: per cycle t < T, the observables of the state before the cycle's
// kicks, then (t < T-1) the cycle's K forward steps of K4 (the MPOS lane of
// the rows is not read).
//
// What bounds it: the steps are K4's (two read+write sweeps of the state
// per step, the butterflies' operations); the measure adds no sweep of its
// own. It rides the passes of each cycle's first slot, which read the
// state anyway: pass lo, before its kick, sums |psi|^2 E(s), |psi|^2 z_q
// and the x pairs of the tile's low bits; pass hi, before its kick, the x
// pairs of the high bits. The last cycle runs the two passes as a measure
// only. Per cycle a fixed-order reduce turns the block slots into one row.
//
// state: n_traj x 2^L complex64 scratch; rows: n_traj x rows_per_traj x
// 128 f32 (K4 forward rows, T*K of them); erow: n_traj x 128 f32 energy
// rows; part: n_traj x (2+L) x floquet_general_observables_slots(L) f32,
// zeroed; out: T x n_traj x (2+L) f32, lanes e_diag, x_sum, z_0..z_{L-1}
// (x_sum = 0 when with_x == 0).
int floquet_general_observables(void* state, const void* rows,
                                const void* erow, void* part, void* out,
                                int n_traj, int L, int rows_per_traj, int T,
                                int with_x, int64_t b0, void* stream_ptr) {
  if (lo_bits(L) > kMaxLo || L - lo_bits(L) < 1 || rows_per_traj % T != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float2* st = (float2*)state;
  const int64_t N = (int64_t)1 << L;
  const int K = rows_per_traj / T;
  const int nq = 2 + L;
  init_kernel<<<dim3(256, n_traj), kThreads, 0, stream>>>(st, N, b0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Obs obs{(const float*)erow, (float*)part,
          floquet_general_observables_slots(L), with_x, 1};
  const int64_t n_rows = (int64_t)n_traj * nq;
  for (int t = 0; t < T; ++t) {
    obs.apply = t < T - 1;
    e = launch_passes<true>(st, L, (const float*)rows, rows_per_traj, n_traj,
                            t * K, 0, 0, nullptr, T, obs, stream);
    for (int k = 1; e == cudaSuccess && obs.apply && k < K; ++k) {
      e = launch_step(st, L, (const float*)rows, rows_per_traj, n_traj,
                      t * K + k, 0, 0, nullptr, T, stream);
    }
    if (e != cudaSuccess) return (int)e;
    reduce_kernel<<<(unsigned)((n_rows + kThreads - 1) / kThreads), kThreads,
                    0, stream>>>((const float*)part,
                                 (float*)out + (int64_t)t * n_rows, n_rows,
                                 obs.nb, 0, 0.0f);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
