// Per-shard streamed cycle kernels for Hopper (sm_90a): ONE Floquet cycle
// on the shard-local bits of a batch of amplitude shards, 22 <= L_loc <= 30,
// the shard in device memory, for the amplitude-sharded engines
// (dtc_tpu_torch/parallel/sharded.py) from L_loc = 24 on.
//
// Replaces (one CUDA family)
//   K9a dtc_tpu/ops/pallas_cycle_hi.py::_make_hi_cycle_kernel
//       (entry hi_cycle_forward_apply)
//   K9b dtc_tpu/ops/pallas_cycle_hi.py::_make_hi_inverse_cycle_kernel
//       (entry hi_cycle_inverse_apply)
//   K10a, shard-local
//       dtc_tpu/ops/pallas_cycle_hi_general.py::_make_general_hi_cycle_kernel
//       (entry general_hi_cycle_forward_apply)
//   K10b, shard-local
//       dtc_tpu/ops/pallas_cycle_hi_general.py::
//       _make_general_hi_inverse_cycle_kernel
//       (entry general_hi_cycle_inverse_apply)
//
// All four run one cycle at L = L_loc on the pass plan of floquet_plan.cuh
// (two passes at L_loc <= 24, three above).
// - K9a and K9b run the step passes of floquet_echo.cuh (launch_steps, one
//   step from the states as they are) with the x family's policy on K8's
//   step rows (floquet_x_echo.cuh: CyclePolicy, XEcho on CycleRows), as
//   the one-card streamed x family does (floquet_x_streamed.cu): strided
//   tiles of CW = kW = 4 columns on the two-pass plan and kWideCols = 16
//   (128-byte runs) on the three-pass one, the diagonal's phases from two
//   small tables a block, the kick in swizzled 2-3-bit rounds whose first
//   reads the state and whose last writes it, so each pass makes one read
//   and one write. Their rows are K8's folded row pairs, n x 2 x 2L f32
//   (ops/cycle.py::fold_cycle_rows), which carry the shard's global
//   diagonal (a constant in c0 and the boundary bond's Z term on the local
//   top bit in cz[L-1]; that bit lies in pass hi's tile).
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
// - K10a (lab-frame forward): the streamed lab-frame steps of
//   floquet_general_streamed_pass.cuh for the cycle's K slot rows (X-mask
//   row fold, the cycle's diagonal on the final slot), the partial on the
//   final slot; then the fixed-order reduce.
// - K10b (daggered lab-frame cycle): the same passes' echo steps for the K
//   slots' (pre, post) row pairs.
// The lab-frame rows are 128 lanes, 256 at L_loc = 30 (4 L_loc + 9 lanes
// must fit). K10b measures nothing: its wrapper sets the pair's COUNT to
// K + 1, one past the steps launched, so no step is the pair's last and
// pass hi writes no partial. The shard-bit kicks are the caller's, and for
// K10 the global diagonal and the boundary bond phi[L_loc-1] too: the
// shard-bit kicks commute with the local kick and diagonal, so the x
// engines run them before each K9a and after each K9b; measuring z_q of a
// local bit after them is exact, because z_q commutes with them.
//
// What bounds it on this card: as K6/K7/K10, the shard's 2^L_loc complex64
// amplitudes (128 MiB at L_loc = 24, 8 GiB at 30) stream through device
// memory, 32 B per amplitude and step at L_loc <= 24 (two sweeps) and 48 B
// above (three); a slot of a general 2x2 costs 14 flops per amplitude and
// bit against RX's 6, below the state floor either way. The partials are
// summed in a fixed order, in double, by a second kernel. Every offset
// that can pass 2^31 (state, batch stride, tile rows, blocks, partials) is
// 64-bit: one shard at L_loc = 30 is 2^30 amplitudes and a batch of them
// passes 2^31.
//
// The x headers and the lab-frame passes both define load_coeffs,
// kick_bits and more, each in an anonymous namespace of its own header;
// here each family's headers are included inside a named namespace so
// that the two sets of names stay apart. floquet_echo.cuh is #pragma once:
// it is included once, by floquet_x_echo.cuh inside xs, the namespace that
// uses it. floquet_common.cuh and floquet_plan.cuh come first, at file
// scope, so that the headers' own includes of them are skipped.

#include "floquet_common.cuh"
#include "floquet_plan.cuh"

namespace xs {
#include "floquet_rx.cuh"
#include "floquet_x_echo.cuh"
}  // namespace xs

namespace ls {
#include "floquet_lab.cuh"
#include "floquet_general_streamed_pass.cuh"
}  // namespace ls

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
  using namespace xs;
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
  return xs::streamed_hi_blocks(p.a, p.b);
}

// Partial slots per state of K10a, shard-local (its pass hi's blocks).
int floquet_cycle_hi_general_partials(int L) { return hi_blocks(L); }

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
    return (int)cycle_step(state, fold, false, n, L, c, s, xs::NoTimes{},
                           stream);
  }
  const cudaError_t e = cycle_step(state, fold, false, n, L, c, s,
                                   xs::Times{(float*)partials, q, 1}, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce((const float*)partials, floquet_cycle_hi_partials(L),
                     (float*)out, n, stream);
}

// K9b. state: n x 2^L complex64, updated in place; fold: n x 2 x 2L f32
// folded rows (row 0 the step's diagonal, row 1 zero).
int floquet_cycle_hi_inverse(void* state, const void* fold, int n, int L,
                             float c, float s, void* stream_ptr) {
  if (!in_range(L, 0)) return (int)cudaErrorInvalidValue;
  return (int)cycle_step(state, fold, true, n, L, c, s, xs::NoTimes{},
                         (cudaStream_t)stream_ptr);
}

// K10a, shard-local. state: n x 2^L complex64, updated in place; rows: n x
// K x width f32 (width 128, or 256 at L = 30; MPOS -1 on slots 0..K-2, 0
// on slot K-1); partials: n x floquet_cycle_hi_general_partials(L) f32
// scratch; out: n f32, sum |psi|^2 z_q after the cycle.
int floquet_cycle_hi_general_forward(void* state, const void* rows,
                                     void* partials, void* out, int n, int L,
                                     int width, int K, int q,
                                     void* stream_ptr) {
  if (!in_range(L, q) || 4 * L + 9 >= width || (width != 128 && width != 256)
      || K < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  for (int k = 0; k < K; ++k) {
    cudaError_t e =
        width == 128
            ? ls::launch_step<128>((float2*)state, L, (const float*)rows, K,
                                   n, k, 0, q, (float*)partials, stream)
            : ls::launch_step<256>((float2*)state, L, (const float*)rows, K,
                                   n, k, 0, q, (float*)partials, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)reduce((const float*)partials, hi_blocks(L), (float*)out, n,
                     stream);
}

// K10b, shard-local. state: n x 2^L complex64, updated in place; tiles: n x
// K x 2 x width f32, per slot (pre, post) rows, COUNT = K + 1 at lane
// FO+10 of row 0 (FO = 4L-1).
int floquet_cycle_hi_general_inverse(void* state, const void* tiles, int n,
                                     int L, int width, int K,
                                     void* stream_ptr) {
  if (!in_range(L, 0) || 4 * L + 9 >= width || (width != 128 && width != 256)
      || K < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  for (int k = 0; k < K; ++k) {
    cudaError_t e =
        width == 128
            ? ls::launch_step<128>((float2*)state, L, (const float*)tiles,
                                   2 * K, n, k, 1, 0, nullptr, stream)
            : ls::launch_step<256>((float2*)state, L, (const float*)tiles,
                                   2 * K, n, k, 1, 0, nullptr, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
