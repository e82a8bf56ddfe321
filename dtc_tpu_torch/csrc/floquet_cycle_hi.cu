// Per-shard streamed x cycle kernels for Hopper (sm_90a): ONE Floquet
// cycle on the shard-local bits of a batch of amplitude shards,
// 22 <= L_loc <= 30, the shard in device memory, for the amplitude-sharded
// engines (dtc_tpu_torch/parallel/sharded.py) from L_loc = 24 on.
//
// Replaces (one CUDA family)
//   K9a dtc_tpu/ops/pallas_cycle_hi.py::_make_hi_cycle_kernel
//       (entry hi_cycle_forward_apply)
//   K9b dtc_tpu/ops/pallas_cycle_hi.py::_make_hi_inverse_cycle_kernel
//       (entry hi_cycle_inverse_apply)
// K10's shard-local forms, the lab-frame cycle of the same engines, are
// entries of floquet_general_streamed.cu, which holds their policy's
// instances of the same passes.
//
// Both run one cycle at L = L_loc on the pass plan of floquet_plan.cuh (two
// passes at L_loc <= 24, three above): the step passes of floquet_echo.cuh
// (launch_steps, one step from the states as they are) with the x family's
// policy on K8's step rows (floquet_x_echo.cuh: CyclePolicy, XEcho on
// CycleRows), as the one-card streamed x family does
// (floquet_x_streamed.cu): strided tiles of CW = kW = 4 columns on the
// two-pass plan and kWideCols = 16 (128-byte runs) on the three-pass one,
// the diagonal's phases from two small tables a block, the kick in swizzled
// 2-3-bit rounds whose first reads the state and whose last writes it, so
// each pass makes one read and one write. Their rows are K8's folded row
// pairs, n x 2 x 2L f32 (ops/cycle.py::fold_cycle_rows), which carry the
// shard's global diagonal (a constant in c0 and the boundary bond's Z term
// on the local top bit in cz[L-1]; that bit lies in pass hi's tile).
// - K9a (sigma-frame x forward): RX(theta) on every local bit, then folded
//   row 1 (the cycle's local and global diagonal; row 0 not read,
//   Fold::pre0 false) as pass hi stores; with q >= 0 pass hi's store
//   writes one partial of |psi|^2 z_q a block (Times), summed in a fixed
//   order by one reduce; with q < 0 nothing is measured (NoTimes).
// - K9b (x inverse, pre-fold K.D): folded row 0 (the step's global and
//   local diagonal) in pass lo before the kick (Fold::pre0 true), row 1
//   zero (the identity) in pass hi. The caller negated the imaginary part
//   once at the echo's turnaround, so each inverse cycle is the
//   un-negated forward operator in reverse order.
// The shard-bit kicks are the caller's: they commute with the local kick
// and diagonal, so the x engines run them before each K9a and after each
// K9b; measuring z_q of a local bit after them is exact, because z_q
// commutes with them.
//
// What bounds it on this card: as K6/K7, the shard's 2^L_loc complex64
// amplitudes (128 MiB at L_loc = 24, 8 GiB at 30) stream through device
// memory, 32 B per amplitude and step at L_loc <= 24 (two sweeps) and 48 B
// above (three); RX costs 6 flops per amplitude and bit, below the state
// floor. The partials are summed in a fixed order, in double, by a second
// kernel. Every offset that can pass 2^31 (state, batch stride, tile rows,
// blocks, partials) is 64-bit: one shard at L_loc = 30 is 2^30 amplitudes
// and a batch of them passes 2^31.

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_plan.cuh"
#include "floquet_rx.cuh"
#include "floquet_x_echo.cuh"

namespace {

bool in_range(int L, int q) { return 22 <= L && L <= 30 && 0 <= q && q < L; }

// The sum of each state's nb partials into out[i], in a fixed order.
cudaError_t reduce(const float* partials, int nb, float* out, int n,
                   cudaStream_t stream) {
  reduce_rows_kernel<<<n, kThreads, 0, stream>>>(partials, nb, out, 1, 0);
  return cudaGetLastError();
}

// One K9 step of n states on folded row pairs: pass lo applies row 0 with
// pre0, pass hi row 1; m says what pass hi measures.
template <class M>
cudaError_t cycle_step(void* state, const void* fold, bool pre0, int n,
                       int L, float c, float s, M m, cudaStream_t stream) {
  const Plan p = plan_for(L);
  const float* rows = (const float*)fold;
  const Fold f{rows, 4 * (int64_t)L, pre0};
  const CyclePolicy policy{{}, ConstKick{c, s}};
  const auto run = p.b > 0 ? launch_steps<kWideCols, CyclePolicy, M>
                           : launch_steps<kW, CyclePolicy, M>;
  return run((float2*)state, L, p.a, p.b, rows, 2, f, n, 0, 1, policy, m,
             stream);
}

}  // namespace

extern "C" {

// Partial slots per state of K9a (pass hi's blocks on the step passes).
int floquet_cycle_hi_partials(int L) {
  const Plan p = plan_for(L);
  return streamed_hi_blocks(p.a, p.b);
}

// K9a. state: n x 2^L complex64, updated in place; fold: n x 2 x 2L f32
// folded rows (row 1 the cycle's diagonal); partials: n x
// floquet_cycle_hi_partials(L) f32 scratch; out: n f32, sum |psi|^2 z_q of
// state i after the cycle. q < 0: no measure (partials and out unused).
int floquet_cycle_hi_forward(void* state, const void* fold, void* partials,
                             void* out, int n, int L, int q, float c,
                             float s, void* stream_ptr) {
  if (!in_range(L, q < 0 ? 0 : q)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (q < 0) {
    return (int)cycle_step(state, fold, false, n, L, c, s, NoTimes{},
                           stream);
  }
  const cudaError_t e = cycle_step(state, fold, false, n, L, c, s,
                                   Times{(float*)partials, q, 1}, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce((const float*)partials, floquet_cycle_hi_partials(L),
                     (float*)out, n, stream);
}

// K9b. state: n x 2^L complex64, updated in place; fold: n x 2 x 2L f32
// folded rows (row 0 the step's diagonal, row 1 zero).
int floquet_cycle_hi_inverse(void* state, const void* fold, int n, int L,
                             float c, float s, void* stream_ptr) {
  if (!in_range(L, 0)) return (int)cudaErrorInvalidValue;
  return (int)cycle_step(state, fold, true, n, L, c, s, NoTimes{},
                         (cudaStream_t)stream_ptr);
}

}  // extern "C"
