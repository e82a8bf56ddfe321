// Constant x-drive Floquet kernels for large chains (22 <= L <= 30) on
// Hopper (sm_90a): forward A(t) and echo A0(t) of the kicked-Ising chain in
// the sigma frame, the state streamed through device memory.
//
// Replaces, as one family with a forward and an echo entry,
//   K6a dtc_tpu/ops/pallas_streamed.py::_make_streamed_kernel
//       (entry streamed_forward_batch, 22 <= L <= 28)
//   K6b dtc_tpu/ops/pallas_streamed.py::_make_streamed_echo_kernel
//       (entry streamed_echo_batch)
//   K7a dtc_tpu/ops/pallas_streamed_hi.py::_make_hi_kernel
//       (entry streamed_hi_forward_batch, 22 <= L <= 30)
//   K7b dtc_tpu/ops/pallas_streamed_hi.py::_make_hi_echo_kernel
//       (entry streamed_hi_echo_batch)
// The four differ on the TPU only in how VMEM slabs cut a state held in
// HBM; their algebra is K1/K2's (floquet_x.cu): sigma frame, RX(theta) on
// every qubit, one diagonal angle linear in the bits, factorized over a bit
// split and fused into the pass that ends the step, and a deterministic
// two-stage A(t) sum. Compact rows are 128 or 256 lanes wide (run-time
// `width`; echo flags at width-4 and width-3).
//
// What bounds it on this card: a state is 2^L complex64, 32 MiB at L=22 and
// 8 GiB at L=30, so every step streams it from device memory. What is new
// against K1/K2 is a pass plan whose tiles fit a block's shared memory up to
// L=30 (K1/K2's pass-hi tile is 2^(L/2) x 4 amplitudes, 256 KiB at L=26):
//   pass lo:  bits [0, a), a tile of 2^a consecutive amplitudes;
//   pass mid: bits [a, a+b) (only when L >= 25), tiles of 2^b rows x CW
//             consecutive columns;
//   pass hi:  bits [a+b, L), tiles of 2^c rows x CW columns; the kick, the
//             step's diagonal [and the forward's partial of |psi|^2 z_q].
// L <= 24 takes two passes (a <= 13, c <= 11: at most 64 KiB a tile), L =
// 25..30 three (tiles of 16-64 KiB). Two passes would reach L=26 with 128
// KiB tiles, but at one block per SM they stream the state at half the
// rate of three passes of small tiles (H100 SXM: 627 GB/s at L=26 against
// 1,345 GB/s at L=28), which costs more than the third pass. The byte floor
// is 32 B per amplitude per step at L <= 24 and 48 B at L >= 25. The
// strided tiles take CW = kW = 4 columns (32-byte runs) on the two-pass
// plan and kWideCols = 16 (128-byte runs, whole L2 lines) on the three-pass
// one: on an H100 SXM the echo's passes mid and hi went from 1.6-1.8 to
// 2.5-3.0 TB/s at L=28 with them (PERF.md section 6).
//
// Both entries run the step passes of floquet_echo.cuh (run_steps) on this
// plan with the kick policy of floquet_x_echo.cuh (XEcho, shared with K1,
// K2 and K3; the echo on WideRows, the forward on ForwardRows, as K1's and
// K3a's: every step active, row k's diagonal, measured into A(k+1)): one
// diagonal per step from folded rows (ops/echo_fold.py: the echo's step 0
// pass lo applies the first pre diagonal, every pass hi the step's post
// diagonal and the next step's pre; the forward's pass hi row k+1 = step
// k's diagonal, and no row 0), its phases from two small tables per
// block, and the kick in swizzled 2-3-bit rounds whose first reads the
// state and whose last writes it, so each pass makes one read and one
// write. The echo measures
// each pair after its last step (one more read of the state a pair); the
// forward's pass hi writes, on every step, one partial of |psi|^2 z_q per
// block as it stores, into (n_traj, T, blocks). The echo's reader takes its
// step rows from floquet_x_streamed_pass.cuh (step_rows); the per-shard
// cycle kernels (floquet_cycle_hi.cu: K9a/K9b) run the same passes one step
// at a time on K8's CycleRows.
//
// A(t) and the echo value are summed without atomics: one partial per
// block (the forward's per pass-hi block and step, the echo's per measure
// block), then one fixed-order sum per output row in double. Every offset
// that can pass 2^31 (state, tile rows, blocks, partials) is 64-bit. The
// plan and the forward's reductions are in floquet_plan.cuh, shared with
// the lab-frame family (floquet_general_streamed.cu).

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_plan.cuh"
#include "floquet_rx.cuh"
#include "floquet_x_echo.cuh"
#include "floquet_x_streamed_pass.cuh"

namespace {

bool in_range(int L, int q, int width) {
  return 22 <= L && L <= 30 && 0 <= q && q < L &&
         (width == 128 || width == 256) && 5 * L - 2 <= width;
}

// The echo's step rows for XEcho (floquet_x_echo.cuh): `width` lanes.
struct WideRows {
  int width;
  __device__ __forceinline__ StepRows at(const float* rows,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return step_rows(rows, width, rows_per_pair, pair, step);
  }
};

}  // namespace

extern "C" {

// Partials per trajectory and time the forward entry allocates.
int floquet_x_streamed_partials(int L) {
  const Plan p = plan_for(L);
  return streamed_hi_blocks(p.a, p.b);
}

// Partials per pair the echo entry allocates.
int floquet_x_streamed_echo_partials(int L) { return measure_blocks(L); }

// State passes per step: 2 (L <= 24) or 3.
int floquet_x_streamed_passes(int L) { return plan_for(L).b > 0 ? 3 : 2; }

// Forward. state: n_traj x 2^L complex64 scratch; rows: n_traj x T x width
// f32 (one compact row per cycle); fold: n_traj x fold_rows x 2L f32, the
// cycles' diagonals (ops/echo_fold.py::forward_fold of rows 0..T-2;
// fold_rows >= T); partials: n_traj x T x floquet_x_streamed_partials(L)
// f32, zeroed; out: n_traj x T f32 (A(t) before the host's sigma/ancilla
// factor). Runs the T - 1 cycles whose results are measured.
int floquet_x_streamed_forward(void* state, const void* rows,
                               const void* fold, void* partials, void* out,
                               int n_traj, int L, int T, int width,
                               int fold_rows, int q, int64_t b0, float c,
                               float s, void* stream_ptr) {
  if (!in_range(L, q, width) || n_traj < 1 || T < 1 || fold_rows < T) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Plan p = plan_for(L);
  const auto run =
      p.b > 0 ? run_steps<kWideCols, XEcho<ForwardRows, ConstKick>, Times>
              : run_steps<kW, XEcho<ForwardRows, ConstKick>, Times>;
  const cudaError_t e = run(
      (float2*)state, L, p.a, p.b, (const float*)rows, T,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L, false}, n_traj,
      T - 1, XEcho<ForwardRows, ConstKick>{{}, ConstKick{c, s}},
      Times{(float*)partials, q, T}, b0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_times((const float*)partials,
                           floquet_x_streamed_partials(L), (float*)out,
                           n_traj, T, q, b0, stream);
}

// Echo. state: n_pairs x 2^L complex64 scratch; tiles: n_pairs x
// rows_per_pair x width f32 (interleaved pre/post step rows, trip count 2t
// at lane width-4 of row 0, the kick sign at lane width-3 of each pre row);
// fold: n_pairs x fold_rows x 2L f32, the folded diagonals
// (ops/echo_fold.py); partials: n_pairs x
// floquet_x_streamed_echo_partials(L) f32 scratch; out: n_pairs f32.
// n_steps = the largest trip count of the batch.
int floquet_x_streamed_echo(void* state, const void* tiles, const void* fold,
                            void* partials, void* out, int n_pairs, int L,
                            int rows_per_pair, int fold_rows, int width,
                            int n_steps, int q, int64_t b0, float c, float s,
                            void* stream_ptr) {
  const Plan p = plan_for(L);
  const auto run = p.b > 0 ? run_echo<kWideCols, XEcho<WideRows, ConstKick>>
                           : run_echo<kW, XEcho<WideRows, ConstKick>>;
  return (int)run(
      (float2*)state, L, p.a, p.b, (const float*)tiles, rows_per_pair,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L}, n_pairs, n_steps,
      XEcho<WideRows, ConstKick>{WideRows{width}, ConstKick{c, s}}, q, b0,
      (float*)partials, (float*)out, (cudaStream_t)stream_ptr);
}

}  // extern "C"
