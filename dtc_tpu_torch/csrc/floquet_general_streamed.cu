// Lab-frame Floquet kernels for large chains (22 <= L <= 29) on Hopper
// (sm_90a), any kick schedule: forward A(t) and echo A0(t) of the
// kicked-Ising chain under y, xy, yx, circular and xy-cycle drives and
// per-cycle x schedules (K kick slots per cycle), the state streamed
// through device memory; and the per-shard lab-frame cycle kernels, one
// cycle on the local bits of a batch of amplitude shards, for the
// amplitude-sharded engines (dtc_tpu_torch/parallel/sharded.py): K8c/K8d
// at 17 <= L_loc <= 23 and K10's shard-local forms at 22 <= L_loc <= 30.
//
// Replaces, as one family with a forward and an echo entry and two
// per-shard forward and inverse entries,
//   K10a dtc_tpu/ops/pallas_cycle_hi_general.py::_make_general_hi_cycle_kernel
//        (entry general_hi_cycle_forward_apply, one forward cycle)
//   K10b dtc_tpu/ops/pallas_cycle_hi_general.py::
//        _make_general_hi_inverse_cycle_kernel
//        (entry general_hi_cycle_inverse_apply, one daggered cycle)
// as the reference's single-chip route runs them (engine.py
// _singlechip_general_forward / _singlechip_general_echo: the cycle scans of
// parallel/sharded.py make_sharded_autocorr_forward_general and
// make_sharded_echo_general on one rank, where every bit is local), and as
// its sharded engines run them, one cycle a launch on each shard; and
//   K8c  dtc_tpu/ops/pallas_cycle.py::_make_general_cycle_kernel
//        (entry general_cycle_forward_apply, one forward cycle)
//   K8d  dtc_tpu/ops/pallas_cycle.py::_make_general_inverse_cycle_kernel
//        (entry general_cycle_inverse_apply, one daggered cycle)
// the same per-shard cycle where a shard is small enough for K2's plan.
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
// The one-card entries run the step passes of floquet_echo.cuh (run_steps)
// on this plan with K4's kick policy (GeneralEcho,
// floquet_general_echo.cuh), the echo on PairRows, the forward on
// ForwardRows (every step active, the kick of row k, the time from MPOS):
// one diagonal per step from folded rows
// (ops/echo_fold.py: the echo's step 0 pass lo applies the first pre
// diagonal, every pass hi the step's post diagonal and the next step's pre;
// the forward's pass hi row k+1 = step k's diagonal, and no row 0), its
// phases from two small tables per block, and the kick in swizzled 2-3-bit
// rounds whose first reads the state and whose last writes it, so each
// pass makes one read and one write. The forward's pass hi writes, on a
// measured step, one partial of |psi|^2 z_q per block as it stores; one
// fixed-order reduce at the end sums them, in double. The readers, K4's
// and K5's too, are those of floquet_general_streamed_pass.cuh, on rows of
// W = 128 lanes (256 for the shard-local forms at L_loc = 30).
//
// The per-shard forms run K steps (one cycle) from the shard states as
// they are, on the same passes, K8c/K8d on K2's plan (floquet_echo.cuh: a
// = L - L/2, b = 0, 4 columns; for K1 it beat plan_for's two-pass split
// by 5-10 %, PERF.md section 6), K10's shard-local forms on the streamed plan:
// - K8c, K10a shard-local: the kick of slot row k, then folded row k + 1
//   (forward_fold of the K slot rows; row 0 not read, Fold::pre0 false);
//   the final slot's row K also carries the shard's global diagonal (th_sc
//   in c0, the boundary bond's th_bnd in cz[L-1], on the local top bit,
//   which lies in pass hi's tile; ops/cycle.py::fold_general_rows), and
//   its MPOS 0 is measured in pass hi's store (Times, T = 1), one reduce;
// - K8d, K10b shard-local: the K (pre, post) slot pairs' fold_rows (COUNT
//   = K), row 0 the first pre diagonal plus the shard's daggered global
//   diagonal, before the first kick in pass lo (Fold::pre0 true); every
//   step runs, so the rows need no COUNT, and nothing is measured.
// The shard-bit kicks, the rest of the cycle, are the caller's: they
// commute with the local kicks and diagonals, so the engines run them
// before each forward and after each inverse launch, and z_q of a local
// bit commutes with them.
//
// What bounds it on this card: a state is 2^L complex64, 32 MiB at L=22 and
// 4 GiB at L=29 (a shard 8 GiB at L_loc = 30), so every step streams it
// from device memory: 32 B per amplitude and step at L <= 24 (two passes),
// 48 B from L=25 (three). A
// step's kick runs the butterfly of its kind (floquet_lab.cuh): 8
// operations an amplitude and bit for an RX or RY, which every drive's slot
// is, 16 for a general 2x2, and the operation bound stays below the state
// floor. The kick sits in registers: U, its kind and the X-mask word of the
// row (LabKick, floquet_lab.cuh).
//
// Every offset that can pass 2^31 (state, tile rows, blocks, rows of a
// batch, partials) is 64-bit: one shard at L_loc = 30 is 2^30 amplitudes.
// K8c/K8d's shards (64 MiB at L_loc = 23) fit the L2 no better than a
// one-card state at L = 23: the same two sweeps a step bound them.

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_general_echo.cuh"
#include "floquet_lab.cuh"
#include "floquet_plan.cuh"
#include "floquet_general_streamed_pass.cuh"

namespace {

bool in_range(int L, int q) { return 22 <= L && L <= 29 && 0 <= q && q < L; }

// The shard-local forms' range: L_loc = 22..30, K >= 1 slots, rows of 128
// lanes, or 256 where the flag lanes up to FO + 10 = 4L + 9 pass lane 127
// (L_loc = 30, a three-pass plan).
bool local_range(int L, int q, int width, int K) {
  return 22 <= L && L <= 30 && 0 <= q && q < L && K >= 1 &&
         width == (4 * L + 9 < kRowWidth ? kRowWidth : 2 * kRowWidth);
}

// K8d's and K10b shard-local's slot pairs: the layout of PairRows
// (floquet_general_streamed_pass.cuh), every step active.
template <int W>
struct SlotPairRows {
  __device__ __forceinline__ StepRows at(const float* rows, int L,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return step_rows<W>(rows, L, rows_per_pair, pair, step, true, false);
  }
};

using Forward = GeneralEcho<ForwardRows<kRowWidth>>;
using Echo = GeneralEcho<PairRows<kRowWidth>>;

// K8c/K8d's range: L_loc = 17..23, K >= 1 slots, rows of 128 lanes (the
// flag lanes up to FO + 10 = 4L + 9 stay below lane 128).
bool cycle_range(int L, int q, int K) {
  return 17 <= L && L <= 23 && 0 <= q && q < L && K >= 1;
}

// K2's plan (floquet_echo.cuh): two passes, a = L - L/2, 4 columns.
Plan resident_plan(int L) { return {lo_bits(L), 0, L - lo_bits(L)}; }

// Steps [0, K) of n shard states on the plan p with GeneralEcho on rows of
// W lanes: 16-column strided tiles on a three-pass plan, 4 on a two-pass
// one (256-lane rows come only at L_loc = 30, three passes: local_range).
template <int W, template <int> class Rows, class M>
cudaError_t cycle_steps(float2* st, int L, Plan p, const float* rows,
                        int64_t rows_per_pair, Fold fold, int n, int K, M m,
                        cudaStream_t stream) {
  using P = GeneralEcho<Rows<W>>;
  if (p.b > 0) {
    return launch_steps<kWideCols, P, M>(st, L, p.a, p.b, rows,
                                         rows_per_pair, fold, n, 0, K, P{}, m,
                                         stream);
  }
  if constexpr (W == kRowWidth) {
    return launch_steps<kW, P, M>(st, L, p.a, p.b, rows, rows_per_pair, fold,
                                  n, 0, K, P{}, m, stream);
  }
  return cudaErrorInvalidValue;
}

// One forward cycle (K8c, K10a shard-local) on the plan p: the K slot
// steps on rows n x K x width with their folded rows n x (K+1) x 2L, the
// final slot measured into partials (n x streamed_hi_blocks(p.a, p.b)),
// one fixed-order reduce into out (n).
cudaError_t cycle_forward(void* state, const void* rows, const void* fold,
                          void* partials, void* out, int n, int L, Plan p,
                          int width, int K, int q, cudaStream_t stream) {
  const Fold f{(const float*)fold, (int64_t)(K + 1) * 2 * L, false};
  const Times m{(float*)partials, q, 1};
  const cudaError_t e =
      width == kRowWidth
          ? cycle_steps<kRowWidth, ForwardRows>((float2*)state, L, p,
                                                (const float*)rows, K, f, n,
                                                K, m, stream)
          : cycle_steps<2 * kRowWidth, ForwardRows>((float2*)state, L, p,
                                                    (const float*)rows, K, f,
                                                    n, K, m, stream);
  if (e != cudaSuccess) return e;
  reduce_rows_kernel<<<n, kThreads, 0, stream>>>(
      (const float*)partials, streamed_hi_blocks(p.a, p.b), (float*)out, 1,
      0);
  return cudaGetLastError();
}

// One daggered cycle (K8d, K10b shard-local) on the plan p: the K slot
// pairs' steps on tiles n x K x 2 x width with their folded rows n x
// (K+1) x 2L, row 0 before the first kick.
cudaError_t cycle_inverse(void* state, const void* tiles, const void* fold,
                          int n, int L, Plan p, int width, int K,
                          cudaStream_t stream) {
  const Fold f{(const float*)fold, (int64_t)(K + 1) * 2 * L, true};
  return width == kRowWidth
             ? cycle_steps<kRowWidth, SlotPairRows>(
                   (float2*)state, L, p, (const float*)tiles, 2 * K, f, n, K,
                   NoTimes{}, stream)
             : cycle_steps<2 * kRowWidth, SlotPairRows>(
                   (float2*)state, L, p, (const float*)tiles, 2 * K, f, n, K,
                   NoTimes{}, stream);
}

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
  const auto run = p.b > 0 ? run_steps<kWideCols, Forward, Times>
                           : run_steps<kW, Forward, Times>;
  cudaError_t e = run(
      (float2*)state, L, p.a, p.b, (const float*)rows, rows_per_traj,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L, false}, n_traj,
      n_steps, Forward{}, Times{(float*)partials, q, T}, b0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_times((const float*)partials,
                           floquet_general_streamed_partials(L), (float*)out,
                           n_traj, T, q, b0, stream);
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
  const auto run = p.b > 0 ? run_echo<kWideCols, Echo> : run_echo<kW, Echo>;
  return (int)run(
      (float2*)state, L, p.a, p.b, (const float*)tiles, rows_per_pair,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L}, n_pairs, n_steps,
      Echo{}, q, b0, (float*)partials, (float*)out, (cudaStream_t)stream_ptr);
}

// K10a, shard-local. state: n x 2^L complex64, updated in place; rows: n x
// K x width f32 slot rows (width 128, or 256 at L = 30; MPOS -1 on slots
// 0..K-2, 0 on slot K-1); fold: n x (K+1) x 2L f32, the slots' diagonals
// with the shard's global diagonal on row K
// (ops/cycle.py::fold_general_rows); partials: n x
// floquet_general_streamed_partials(L) f32 scratch; out: n f32, sum
// |psi|^2 z_q after the cycle.
int floquet_cycle_hi_general_forward(void* state, const void* rows,
                                     const void* fold, void* partials,
                                     void* out, int n, int L, int width,
                                     int K, int q, void* stream_ptr) {
  if (!local_range(L, q, width, K)) return (int)cudaErrorInvalidValue;
  return (int)cycle_forward(state, rows, fold, partials, out, n, L,
                            plan_for(L), width, K, q,
                            (cudaStream_t)stream_ptr);
}

// K10b, shard-local. state: n x 2^L complex64, updated in place; tiles: n x
// K x 2 x width f32, per slot the (pre, post) rows (the pre row's kick);
// fold: n x (K+1) x 2L f32, their folded diagonals with the shard's
// daggered global diagonal on row 0 (ops/cycle.py::fold_general_rows).
int floquet_cycle_hi_general_inverse(void* state, const void* tiles,
                                     const void* fold, int n, int L,
                                     int width, int K, void* stream_ptr) {
  if (!local_range(L, 0, width, K)) return (int)cudaErrorInvalidValue;
  return (int)cycle_inverse(state, tiles, fold, n, L, plan_for(L), width, K,
                            (cudaStream_t)stream_ptr);
}

// Partials per state K8c allocates (pass hi's blocks on K2's plan).
int floquet_cycle_general_partials(int L) {
  const Plan p = resident_plan(L);
  return streamed_hi_blocks(p.a, p.b);
}

// K8c. state: n x 2^L complex64, updated in place; rows: n x K x 128 f32
// slot rows (MPOS -1 on slots 0..K-2, 0 on slot K-1); fold: n x (K+1) x
// 2L f32, the slots' diagonals with the shard's global diagonal on row K
// (ops/cycle.py::fold_general_rows); partials: n x
// floquet_cycle_general_partials(L) f32 scratch; out: n f32, sum |psi|^2
// z_q after the cycle.
int floquet_cycle_general_forward(void* state, const void* rows,
                                  const void* fold, void* partials, void* out,
                                  int n, int L, int K, int q,
                                  void* stream_ptr) {
  if (!cycle_range(L, q, K)) return (int)cudaErrorInvalidValue;
  return (int)cycle_forward(state, rows, fold, partials, out, n, L,
                            resident_plan(L), kRowWidth, K, q,
                            (cudaStream_t)stream_ptr);
}

// K8d. state: n x 2^L complex64, updated in place; tiles: n x K x 2 x 128
// f32, per slot the (pre, post) rows (the pre row's kick); fold: n x
// (K+1) x 2L f32, their folded diagonals with the shard's daggered global
// diagonal on row 0 (ops/cycle.py::fold_general_rows).
int floquet_cycle_general_inverse(void* state, const void* tiles,
                                  const void* fold, int n, int L, int K,
                                  void* stream_ptr) {
  if (!cycle_range(L, 0, K)) return (int)cudaErrorInvalidValue;
  return (int)cycle_inverse(state, tiles, fold, n, L, resident_plan(L),
                            kRowWidth, K, (cudaStream_t)stream_ptr);
}

}  // extern "C"
