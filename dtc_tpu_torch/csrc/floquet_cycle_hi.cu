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
// K9 and K10's shard-local forms are the streamed families restricted to
// the local bits: the entries run the first passes of the one-card
// families, floquet_x_streamed_pass.cuh and
// floquet_general_streamed_pass.cuh (K6/K7 and K10 on one card now run the
// step passes of floquet_echo.cuh), for one cycle at
// L = L_loc, on the pass plan of floquet_plan.cuh (two passes at
// L_loc <= 24, three above).
// - K9a (sigma-frame x forward): the streamed x step on one compact row
//   (128 lanes, 256 from L_loc = 27): RX(theta) on every local bit, then
//   the cycle's post-fold diagonal (noise-Z signs, sigma-corrected h and
//   phi of the local bits), and the partial sum of |psi|^2 z_q, q < L_loc,
//   in the last pass; then the fixed-order reduce of the partials.
// - K9b (x inverse, pre-fold K.D): the streamed echo step on a (pre, post)
//   pair whose pre row is the cycle's row and whose post row is zero (the
//   identity diagonal), kick sign +1: K8b's convention
//   (floquet_cycle.cu) on the streamed plan. The pair's rows are 128 lanes,
//   256 from L_loc = 26, where the data lanes reach the flag lanes.
// - K10a (lab-frame forward): the streamed lab-frame steps for the cycle's
//   K slot rows (X-mask row fold, the cycle's diagonal on the final slot),
//   the partial on the final slot; then the fixed-order reduce.
// - K10b (daggered lab-frame cycle): the streamed lab-frame echo steps for
//   the K slots' (pre, post) row pairs.
// The lab-frame rows are 128 lanes, 256 at L_loc = 30 (4 L_loc + 9 lanes
// must fit). The inverse entries measure nothing: their wrappers set the
// pair's trip count (K9b: 2) or COUNT (K10b: K + 1) one past the steps
// launched, so no step is the pair's last and pass hi writes no partial.
// Everything that touches a shard bit (the global kicks, the global
// diagonal, the boundary bond phi[L_loc-1]) is the caller's; measuring
// before it is exact because z_q of a local bit commutes with all of it.
//
// What bounds it on this card: as K6/K7/K10, the shard's 2^L_loc complex64
// amplitudes (128 MiB at L_loc = 24, 8 GiB at 30) stream through device
// memory, 32 B per amplitude and step at L_loc <= 24 (two sweeps) and 48 B
// above (three); a slot of a general 2x2 costs 14 flops per amplitude and
// bit against RX's 6, below the state floor either way. One launch of the
// passes per slot of every state of the batch; the partials are summed in
// a fixed order, in double, by a second kernel. Every offset that can pass
// 2^31 (state, batch stride, tile rows, blocks, partials) is 64-bit: one
// shard at L_loc = 30 is 2^30 amplitudes and a batch of them passes 2^31.
//
// The x passes and the lab-frame passes both define StepRows, load_coeffs,
// kick_bits and launch_step, each in an anonymous namespace of its own
// header; here each family's headers are included inside a named
// namespace so that the two sets of names stay apart. floquet_common.cuh
// and floquet_plan.cuh come first, at file scope, so that the headers' own
// includes of them are skipped.

#include "floquet_common.cuh"
#include "floquet_plan.cuh"

namespace xs {
#include "floquet_rx.cuh"
#include "floquet_x_streamed_pass.cuh"
}  // namespace xs

namespace ls {
#include "floquet_lab.cuh"
#include "floquet_general_streamed_pass.cuh"
}  // namespace ls

namespace {

bool in_range(int L, int q) { return 22 <= L && L <= 30 && 0 <= q && q < L; }

// The sum of each state's partials into out[i], in a fixed order.
cudaError_t reduce(const float* partials, float* out, int n, int L,
                   cudaStream_t stream) {
  reduce_rows_kernel<<<n, kThreads, 0, stream>>>(partials, hi_blocks(L), out,
                                                 1, 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Partial slots per state of the forward entries (pass hi's blocks).
int floquet_cycle_hi_partials(int L) { return hi_blocks(L); }

// K9a. state: n x 2^L complex64, updated in place; rows: n x width f32
// compact cycle rows (width 128 or 256); partials: n x
// floquet_cycle_hi_partials(L) f32 scratch; out: n f32, sum |psi|^2 z_q of
// state i after the cycle.
int floquet_cycle_hi_forward(void* state, const void* rows, void* partials,
                             void* out, int n, int L, int width, int q,
                             float c, float s, void* stream_ptr) {
  if (!in_range(L, q) || 5 * L - 2 > width) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t e = xs::launch_step((float2*)state, L, (const float*)rows,
                                  width, 1, n, 0, 0, c, s, q,
                                  (float*)partials, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce((const float*)partials, (float*)out, n, L, stream);
}

// K9b. state: n x 2^L complex64, updated in place; tiles: n x 2 x width
// f32 (the pre row, trip count 2 at lane width-4 and kick sign +1 at lane
// width-3; then a zero post row).
int floquet_cycle_hi_inverse(void* state, const void* tiles, int n, int L,
                             int width, float c, float s, void* stream_ptr) {
  if (!in_range(L, 0) || 5 * L - 2 > width - 4) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)xs::launch_step((float2*)state, L, (const float*)tiles, width,
                              2, n, 0, 1, c, s, 0, nullptr,
                              (cudaStream_t)stream_ptr);
}

// K10a, shard-local. state: n x 2^L complex64, updated in place; rows: n x
// K x width f32 (width 128, or 256 at L = 30; MPOS -1 on slots 0..K-2, 0
// on slot K-1); partials: n x floquet_cycle_hi_partials(L) f32 scratch;
// out: n f32, sum |psi|^2 z_q after the cycle.
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
  return (int)reduce((const float*)partials, (float*)out, n, L, stream);
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
