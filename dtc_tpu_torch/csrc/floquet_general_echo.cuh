// The lab-frame kick policy for the step passes of floquet_echo.cuh: the
// step's kick (U, its kind and the X-mask word of the step's kick row,
// LabKick of floquet_lab.cuh) held in registers, nothing in shared memory,
// each pass's rounds on the butterfly of the step's kind (8 operations for
// an RX or RY, which every drive's slot is; 16 for a general 2x2), read
// through the step rows `Rows` of floquet_general_streamed_pass.cuh (K4's
// forward and echo rows and K5's in floquet_general.cu; K10's echo and
// forward rows and the slot rows of K8c/K8d and K10's shard-local forms in
// floquet_general_streamed.cu: the same layout, 128 lanes, or 256 at L_loc =
// 30). At most 64 registers a thread (four blocks of 256 threads an SM, the
// passes' launch bounds; the measuring pass hi on 16-column tiles keeps 3,
// hi_min_blocks): with the kick in registers no instance spills there
// (H100: K4's echo 133.9 -> 124.4 ms against 85 registers and three
// blocks, PERF.md section 6), where the old per-qubit table in shared memory
// spilled at 64.
//
// Include after floquet_common.cuh and floquet_lab.cuh; the definitions sit
// in an anonymous namespace of their own.

#pragma once

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_lab.cuh"

namespace {

// The lab-frame step policy (floquet_echo.cuh). rows.at(rows, L,
// rows_per_pair, pair, step) gives the pair's step (active, kick); a
// forward reader's rows.time(...) the time the step is measured into.
template <class Rows>
struct GeneralEcho {
  static constexpr int kMinBlocks = 4;
  struct Shared {};
  using Kick = LabKick;
  Rows rows;
  __device__ __forceinline__ bool begin(const float* r, int L,
                                        int64_t rows_per_pair, int pair,
                                        int step, Shared&,
                                        LabKick& kick) const {
    const auto s = rows.at(r, L, rows_per_pair, pair, step);
    if (!s.active) return false;
    kick = load_kick(s.kick, L);
    return true;
  }
  __device__ __forceinline__ int time(const float* r, int L,
                                      int64_t rows_per_pair, int pair,
                                      int step) const {
    return rows.time(r, L, rows_per_pair, pair, step);
  }
};

}  // namespace
