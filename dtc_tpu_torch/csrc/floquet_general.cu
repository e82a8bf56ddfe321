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
//   butterfly applies U, then X where m_j = 1 (rows swapped, X U), which
//   only relabels the round's results: the per-bit form of B[a, b] =
//   prod_j u[a_j ^ m_j, b_j];
// - diagonal exp(i theta(s)), one angle linear in the bits,
//     theta(s) = c0 + sum_q cz_q z_q(s) + sum_j cb_j z_j(s) z_{j+1}(s),
//     cz_q = -h_q/2 - (pi/2) n_q,  cb_j = -phi_j/2,  c0 = (pi/2) sum_q n_q,
//   from the row's noise-Z bits n (lanes [0, L)), h ([2L, 3L)) and phi
//   ([3L, 4L-1)); there is no sigma frame, so no sigma or flip term.
// Forward: each step is kick then the row's diagonal; where MPOS >= 0
// (lane FO, the final slot of a cycle) sum |psi|^2 z_q into A(MPOS).
// Echo: rows come in (pre, post) pairs; a step is the pre diagonal, the
// kick of the pre row, then the post diagonal; each pair runs COUNT = 2tK
// steps (lane FO+10 of its row 0) and is measured at the end.
//
// Both run the step passes of floquet_echo.cuh, redesigned for this card,
// with the lab-frame kick policy of floquet_general_echo.cuh (GeneralEcho)
// on the step rows of floquet_general_streamed_pass.cuh: one diagonal a
// step from folded rows (ops/echo_fold.py; the echo's post diagonal and
// the next step's pre are one row, the forward's step k is row k + 1 of
// forward_fold), applied from two small phase tables per block; the kick
// runs in rounds of 2-3 bits whose first reads the state and whose last
// writes it, on a swizzled tile without bank conflicts. The forward
// measures in pass hi's store (Times: one partial of |psi|^2 z_q a block
// and time) and ends in one fixed-order reduce (reduce_times,
// floquet_plan.cuh). The echo is measured once, after its last step.
//
// K5 runs K4's forward steps on the same step passes (launch_steps of
// floquet_echo.cuh with GeneralEcho<ObsRows>, diagonals from forward_fold)
// and measures in them (Obs, pass lo's blocks each over a walk of tiles);
// see the note above its entry.
//
// What bounds it on this card: as for K1/K2 (floquet_x.cu), the 2^L
// complex64 state (8 MiB at L=20) lives in device memory, and a step is two
// read+write sweeps of it (32 B per amplitude), on K2's split
// (a = lo_bits(L) = L - L/2, b = 0, 4 columns):
//   pass lo: a block owns 2^a consecutive amplitudes and applies the kick
//            on bits [0, a) (and an echo's step 0 its first pre diagonal);
//   pass hi: a block owns kW low columns x all 2^(L-a) high values, applies
//            the kick on bits [a, L), the step's folded diagonal and the
//            forward's partial as it stores.
// The kick's arithmetic weighs more than in K1/K2 only where U is a general
// complex 2x2 (16 operations a butterfly). Each step's kick has a kind, read
// from its U (floquet_lab.cuh): RX or RY, which every slot of every drive
// is, runs an 8-operation butterfly as K1/K2's RX does; any other U the
// general 2x2. Each thread holds the step's kick in registers, U, its kind
// and the X-mask as one 32-bit word packed by a warp ballot of the row
// (LabKick, floquet_lab.cuh, shared with the large-L lab-frame family,
// floquet_general_streamed.cu); a pass's rounds take the kind's butterfly,
// chosen once a pass (swz_kick), and the X-mask becomes each round's flip
// word: no per-qubit table in shared memory, and the passes fit 64
// registers, four blocks an SM.
// Reductions are deterministic (floquet_common.cuh, floquet_plan.cuh).

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_general_echo.cuh"
#include "floquet_lab.cuh"
#include "floquet_plan.cuh"
#include "floquet_general_streamed_pass.cuh"

namespace {

using Forward = GeneralEcho<ForwardRows<kRowWidth>>;
using Echo = GeneralEcho<PairRows<kRowWidth>>;

// K5's step rows for GeneralEcho: K4's forward rows (ForwardRows), every
// step active, the kick of row `step` (the MPOS lane is not read); a step
// opens cycle step / K where step % K == 0.
struct ObsRows {
  int K;
  __device__ __forceinline__ StepRows at(const float* rows, int L,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return ForwardRows<kRowWidth>{}.at(rows, L, rows_per_pair, pair, step);
  }
  __device__ __forceinline__ int time(const float*, int, int64_t, int,
                                      int step) const {
    return step % K == 0 ? step / K : -1;
  }
};

// K5's fixed-order reduce of one chunk of cycles (Obs, floquet_echo.cuh):
// block (c, pair) turns the slots of cycle t0 + c into out[(pair * T + t0 +
// c) * (2 + L) + lane]: e_diag (lane 0 of pass lo's blocks), x_sum (2 x
// pass lo's lane 1 and pass hi's slots; 0 without x), z_q (lane 3 + q for
// q < a + tb, the tile's and the walk's bits; for q >= a + tb, sum_b
// z_q(b) P_b over pass lo's blocks b, P in lane 2). A warp a lane, its
// threads over the blocks in double, then the warp sum in a fixed order.
__global__ void obs_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int L, int a,
                                  int tb, int T, int t0, int slots,
                                  int with_x) {
  const int nb = (1 << (L - a)) >> tb;
  const int n_hi = slots - (3 + a + tb) * nb;
  const float* s = part + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) *
                              slots;
  float* o = out + ((int64_t)blockIdx.y * T + t0 + blockIdx.x) * (2 + L);
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < 2 + L; j += blockDim.x >> 5) {
    const int q = j - 2;
    double acc = 0.0;
    if (j == 1) {
      if (with_x) {
        for (int b = lane; b < nb; b += 32) acc += s[nb + b];
        for (int b = lane; b < n_hi; b += 32) {
          acc += s[(3 + a + tb) * nb + b];
        }
      }
    } else {
      const bool high = j > 1 && q >= a + tb;  // one sign a block
      const float* lo = s + (j == 0 ? 0 : high ? 2 : 3 + q) * nb;
      for (int b = lane; b < nb; b += 32) {
        acc += (high ? zsign(b, q - a - tb) : 1.0f) * lo[b];
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) o[j] = (float)(j == 1 ? 2.0 * acc : acc);
  }
}

// Log2 of a pass-lo walk of `tiles` tiles at L (Obs), -1 unless tiles is
// a power of two, 1 <= tiles <= 2^kMaxObsWalk and at most a pair's tiles.
int obs_walk_bits(int L, int tiles) {
  int tb = 0;
  while ((1 << tb) < tiles) ++tb;
  const bool ok = tiles >= 1 && tiles == (1 << tb) && tb <= kMaxObsWalk &&
                  tb <= L - lo_bits(L);
  return ok ? tb : -1;
}

}  // namespace

extern "C" {

// Sizes the wrapper allocates: partials of the forward entry, per
// trajectory and time (pass hi's blocks on K2's split).
int floquet_general_forward_partials(int L) {
  return step_hi_blocks(lo_bits(L), 0, kW);
}

// Sizes the wrapper allocates: partials of the echo entry (per pair).
int floquet_general_echo_partials(int L) {
  return measure_blocks(L);
}

// K4 forward. state: n_traj x 2^L complex64 scratch; rows: n_traj x
// rows_per_traj x 128 f32 (one row per kick slot, T*K of them); fold:
// n_traj x fold_rows x 2L f32, the step diagonals
// (ops/echo_fold.py::forward_fold of rows 0..n_steps-1, fold_rows >
// n_steps); partials: n_traj x T x floquet_general_forward_partials(L)
// f32, zeroed; out: n_traj x T f32 (A(t) before the host's ancilla factor
// and sign). Runs the first n_steps = (T-1)*K steps, the ones whose results
// are measured, on the step passes (run_steps on K2's split, the kick of
// row k, the time from its MPOS lane, measured in pass hi's store), then
// one fixed-order reduce. Returns cudaErrorInvalidValue without a launch
// outside 14 <= L <= 23, 0 <= q < L, n_traj >= 1, T >= 1,
// 0 <= n_steps <= rows_per_traj, fold_rows > n_steps.
int floquet_general_forward(void* state, const void* rows, const void* fold,
                            void* partials, void* out, int n_traj, int L,
                            int rows_per_traj, int fold_rows, int T,
                            int n_steps, int q, int64_t b0,
                            void* stream_ptr) {
  if (L < 14 || L > 23 || q < 0 || q >= L || n_traj < 1 || T < 1 ||
      n_steps < 0 || n_steps > rows_per_traj || fold_rows <= n_steps) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const cudaError_t e = run_steps<kW>(
      (float2*)state, L, lo_bits(L), 0, (const float*)rows, rows_per_traj,
      Fold{(const float*)fold, (int64_t)fold_rows * 2 * L, false}, n_traj,
      n_steps, Forward{}, Times{(float*)partials, q, T}, b0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_times((const float*)partials,
                           floquet_general_forward_partials(L), (float*)out,
                           n_traj, T, q, b0, stream);
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
      Echo{}, q, b0, (float*)partials, (float*)out,
      (cudaStream_t)stream_ptr);
}

// Sizes the wrapper allocates: K5's partial slots per trajectory and cycle
// (Obs, floquet_echo.cuh) for pass-lo blocks that walk `tiles` tiles: 3 + a
// + log2(tiles) lanes of pass lo's 2^(L-a) / tiles blocks, then pass hi's
// 2^a / kW, a = lo_bits(L); -1 for a walk out of range (obs_walk_bits).
int floquet_general_observables_slots(int L, int tiles) {
  const int a = lo_bits(L);
  const int tb = obs_walk_bits(L, tiles);
  if (tb < 0) return -1;
  return (3 + a + tb) * ((1 << (L - a)) >> tb) + (1 << a) / kW;
}

// K5: per cycle t < T, the observables of the state before the cycle's
// kicks, then (t < T-1) the cycle's K forward steps of K4 (the MPOS lane of
// the rows is not read).
//
// What bounds it: the steps are K4's (two read+write sweeps of the state
// per step, the butterflies' operations); the measure adds no sweep of its
// own. It runs the steps on the step passes of floquet_echo.cuh
// (launch_steps on the resident plan a = lo_bits(L), b = 0, with
// GeneralEcho<ObsRows>; one diagonal per step from the forward_fold rows,
// phase tables, swizzled rounds fused into the load and the store), and a
// cycle's first step measures the state it loads (Obs): pass lo's load
// round the energy, the probability and every z_q of its tile, each round
// of both passes the x pairs of its bits before its butterflies. A pass-lo
// block walks `tiles` consecutive tiles of its pair on every step, its
// sums in registers across them: the kick row, the energy row's tables and
// the block's reduce are paid once a walk (the wrapper picks `tiles` from
// L and the trajectories, ops/observables.py::walk_tiles). The last
// cycle's first step is measured only: its passes read the state and
// store nothing (the same two reads as a measure of its own; a whole step
// would write twice more for nothing). Cycles go in chunks of `chunk`,
// each ending in one fixed-order reduce (obs_reduce_kernel): the wrapper
// sizes the chunk so that the partials stay within a quarter of the
// states' bytes.
//
// state: n_traj x 2^L complex64 scratch; rows: n_traj x rows_per_traj x
// 128 f32 (K4 forward rows, T*K of them); fold: n_traj x fold_rows x 2L
// f32, the step diagonals (ops/echo_fold.py::forward_fold, fold_rows =
// T*K + 1); erow: n_traj x 128 f32 energy rows; part: n_traj x chunk x
// floquet_general_observables_slots(L, tiles) f32 scratch; out: n_traj x
// T x (2+L) f32, lanes e_diag, x_sum, z_0..z_{L-1} (x_sum = 0 when with_x
// == 0). Returns cudaErrorInvalidValue without a launch outside 14 <= L <=
// 23, T < 1, rows_per_traj not K per cycle, fold_rows short of the last
// step's row, chunk < 1, or a walk out of range (obs_walk_bits).
int floquet_general_observables(void* state, const void* rows,
                                const void* fold, const void* erow,
                                void* part, void* out, int n_traj, int L,
                                int rows_per_traj, int fold_rows, int T,
                                int chunk, int with_x, int tiles, int64_t b0,
                                void* stream_ptr) {
  if (L < 14 || L > 23 || T < 1 || rows_per_traj % T != 0 || chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int K = rows_per_traj / T;
  const int last = (T - 1) * K;  // the last cycle's first step
  const int tb = obs_walk_bits(L, tiles);
  if (K < 1 || fold_rows < last + 2 || tb < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float2* st = (float2*)state;
  const int a = lo_bits(L);
  const int slots = floquet_general_observables_slots(L, tiles);
  const Fold f{(const float*)fold, (int64_t)fold_rows * 2 * L, false};
  const GeneralEcho<ObsRows> policy{{K}};
  init_kernel<<<dim3(256, n_traj), kThreads, 0, stream>>>(
      st, (int64_t)1 << L, b0);
  cudaError_t e = cudaGetLastError();
  for (int t0 = 0; e == cudaSuccess && t0 < T; t0 += chunk) {
    const int c = T - t0 < chunk ? T - t0 : chunk;
    const int to = (t0 + c) * K < last + 1 ? (t0 + c) * K : last + 1;
    e = launch_steps<kW>(
        st, L, a, 0, (const float*)rows, rows_per_traj, f, n_traj, t0 * K,
        to, policy,
        Obs{(const float*)erow, (float*)part, t0, c, slots, last, with_x,
            tb},
        stream);
    if (e != cudaSuccess) break;
    obs_reduce_kernel<<<dim3(c, n_traj), kThreads, 0, stream>>>(
        (const float*)part, (float*)out, L, a, tb, T, t0, slots, with_x);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // extern "C"
