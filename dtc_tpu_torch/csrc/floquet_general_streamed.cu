// Lab-frame Floquet kernels for large chains (22 <= L <= 29) on Hopper
// (sm_90a), any kick schedule: forward A(t) and echo A0(t) of the
// kicked-Ising chain under y, xy, yx, circular and xy-cycle drives and
// per-cycle x schedules (K kick slots per cycle), the state streamed
// through device memory.
//
// Replaces, as one family with a forward and an echo entry,
//   K10a dtc_tpu/ops/pallas_cycle_hi_general.py::_make_general_hi_cycle_kernel
//        (entry general_hi_cycle_forward_apply, one forward cycle)
//   K10b dtc_tpu/ops/pallas_cycle_hi_general.py::
//        _make_general_hi_inverse_cycle_kernel
//        (entry general_hi_cycle_inverse_apply, one daggered cycle)
// as the reference's single-chip route runs them (engine.py
// _singlechip_general_forward / _singlechip_general_echo: the cycle scans of
// parallel/sharded.py make_sharded_autocorr_forward_general and
// make_sharded_echo_general on one rank, where every bit is local).
//
// What is ported is K4's math (floquet_general.cu) on the streamed x
// family's pass plan (floquet_plan.cuh), not the TPU design (no r2 blocks,
// pass-A/B slabs, in-kernel 128x128 group builds, Karatsuba dots or DMA
// slot rings). It takes K4's step rows (ops/params_general.py, 128 lanes):
// a step is one kick slot,
// - kick B = X_m U^{(x)L}: U the slot's complex 2x2 (lanes FO+2..9, FO =
//   4L-1), rows swapped on qubit j where its X-mask bit m_j = 1; every pass
//   applies it to its own bits;
// - diagonal exp(i theta(s)), theta(s) = c0 + sum_q cz_q z_q(s)
//   + sum_j cb_j z_j(s) z_{j+1}(s), cz_q = -h_q/2 - (pi/2) n_q,
//   cb_j = -phi_j/2, c0 = (pi/2) sum_q n_q (lab frame: no sigma, no host
//   sign).
// Forward: step k of a trajectory is the kick of row k, then row k's
// diagonal; a row with MPOS >= 0 (lane FO, the final slot of each cycle
// t < T-1) is measured into A(MPOS). A(0) is the basis state's z_q. Echo:
// rows come in (pre, post) pairs; a step is the pre diagonal, the kick of
// the pre row, then the post diagonal; each pair runs the COUNT = 2tK steps
// of lane FO+10 of its row 0 and is measured after its last step (a pair
// with COUNT 0 keeps its basis state).
//
// Both entries run the step passes of floquet_echo.cuh (run_steps) on this
// plan with K4's kick policy (GeneralEcho, floquet_general_echo.cuh), the
// echo on PairRows, the forward on ForwardRows (every step active, the kick
// of row k, the time from MPOS): one diagonal per step from folded rows
// (ops/echo_fold.py: the echo's step 0 pass lo applies the first pre
// diagonal, every pass hi the step's post diagonal and the next step's pre;
// the forward's pass hi row k+1 = step k's diagonal, and no row 0), its
// phases from two small tables per block, and the kick in swizzled 2-3-bit
// rounds whose first reads the state and whose last writes it, so each
// pass makes one read and one write. The forward's pass hi writes, on a
// measured step, one partial of |psi|^2 z_q per block as it stores; one
// fixed-order reduce at the end sums them, in double. K10's shard-local
// forms (floquet_cycle_hi.cu) keep the passes of
// floquet_general_streamed_pass.cuh, whose step rows (step_rows) both
// readers here take.
//
// What bounds it on this card: a state is 2^L complex64, 32 MiB at L=22 and
// 4 GiB at L=29, so every step streams it from device memory: 32 B per
// amplitude and step at L <= 24 (two passes), 48 B from L=25 (three). A
// general 2x2 costs 14 flops per amplitude and bit against RX's 6, and the
// operation bound stays below the state floor. The kick's per-qubit
// matrices are built once per block in shared memory from the row.
//
// Every offset that can pass 2^31 (state, tile rows, blocks, rows of a
// batch, partials) is 64-bit.

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_general_echo.cuh"
#include "floquet_lab.cuh"
#include "floquet_plan.cuh"
#include "floquet_general_streamed_pass.cuh"

namespace {

bool in_range(int L, int q) { return 22 <= L && L <= 29 && 0 <= q && q < L; }

// K10's echo step rows for GeneralEcho (floquet_general_echo.cuh).
struct PairRows {
  __device__ __forceinline__ StepRows at(const float* rows, int L,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return step_rows<kRowWidth>(rows, L, rows_per_pair, pair, step, 1);
  }
};

// K10's forward step rows for GeneralEcho: every step active, the kick of
// row `step`, measured into the time its MPOS names (-1: none).
struct ForwardRows {
  __device__ __forceinline__ StepRows at(const float* rows, int L,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return step_rows<kRowWidth>(rows, L, rows_per_pair, pair, step, 0);
  }
  __device__ __forceinline__ int time(const float* rows, int L,
                                      int64_t rows_per_pair, int pair,
                                      int step) const {
    return (int)rows[((int64_t)pair * rows_per_pair + step) * kRowWidth +
                     4 * L - 1 + kLaneMpos];
  }
};

}  // namespace

extern "C" {

// Partials per trajectory and time the forward entry allocates.
int floquet_general_streamed_partials(int L) {
  const Plan p = plan_for(L);
  return streamed_hi_blocks(p.a, p.b);
}

// Partials per pair the echo entry allocates.
int floquet_general_streamed_echo_partials(int L) {
  return measure_blocks(L);
}

// State passes per step: 2 (L <= 24) or 3.
int floquet_general_streamed_passes(int L) {
  return plan_for(L).b > 0 ? 3 : 2;
}

// K10 forward. state: n_traj x 2^L complex64 scratch; rows: n_traj x
// rows_per_traj x 128 f32 (one row per kick slot, T*K of them); fold:
// n_traj x fold_rows x 2L f32, the step diagonals
// (ops/echo_fold.py::forward_fold); partials: n_traj x T x
// floquet_general_streamed_partials(L) f32, zeroed; out: n_traj x T f32
// (A(t) before the host's ancilla factor and sign). Runs the first
// n_steps = (T-1)*K steps, the ones whose results are measured.
int floquet_general_streamed_forward(void* state, const void* rows,
                                     const void* fold, void* partials,
                                     void* out, int n_traj, int L,
                                     int rows_per_traj, int fold_rows, int T,
                                     int n_steps, int q, int64_t b0,
                                     void* stream_ptr) {
  if (!in_range(L, q) || n_steps > rows_per_traj ||
      n_steps >= fold_rows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Plan p = plan_for(L);
  const auto run = p.b > 0
                       ? run_steps<kWideCols, GeneralEcho<ForwardRows>, Times>
                       : run_steps<kW, GeneralEcho<ForwardRows>, Times>;
  cudaError_t e = run(
      (float2*)state, L, p.a, p.b, (const float*)rows, rows_per_traj,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L, false}, n_traj,
      n_steps, GeneralEcho<ForwardRows>{}, Times{(float*)partials, q, T}, b0,
      stream);
  if (e != cudaSuccess) return (int)e;
  float* a = (float*)out;
  const int64_t n_rows = (int64_t)n_traj * T;
  reduce_rows_kernel<<<(unsigned)n_rows, kThreads, 0, stream>>>(
      (const float*)partials, floquet_general_streamed_partials(L), a, 1, 0);
  const float a0 = 1.0f - 2.0f * (float)((b0 >> q) & 1);
  first_kernel<<<(n_traj + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a, n_traj, T, a0);
  return (int)cudaGetLastError();
}

// K10 echo. state: n_pairs x 2^L complex64 scratch; tiles: n_pairs x
// rows_per_pair x 128 f32 (interleaved pre/post step rows, COUNT at lane
// 4L+9 of row 0); fold: n_pairs x fold_rows x 2L f32, the folded diagonals
// (ops/echo_fold.py); partials: n_pairs x
// floquet_general_streamed_echo_partials(L) f32 scratch; out: n_pairs f32.
// n_steps = the largest COUNT of the batch.
int floquet_general_streamed_echo(void* state, const void* tiles,
                                  const void* fold, void* partials, void* out,
                                  int n_pairs, int L, int rows_per_pair,
                                  int fold_rows, int n_steps, int q,
                                  int64_t b0, void* stream_ptr) {
  if (!in_range(L, q) || 2 * n_steps > rows_per_pair) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = plan_for(L);
  const auto run = p.b > 0 ? run_echo<kWideCols, GeneralEcho<PairRows>>
                           : run_echo<kW, GeneralEcho<PairRows>>;
  return (int)run(
      (float2*)state, L, p.a, p.b, (const float*)tiles, rows_per_pair,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L}, n_pairs, n_steps,
      GeneralEcho<PairRows>{}, q, b0, (float*)partials, (float*)out,
      (cudaStream_t)stream_ptr);
}

}  // extern "C"
