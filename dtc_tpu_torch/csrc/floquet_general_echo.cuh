// The lab-frame kick policy for the step passes of floquet_echo.cuh: the
// step's per-qubit 2x2 kicks (X-mask and U of the step's kick row), held in
// shared memory, read through the step rows `Rows` of
// floquet_general_streamed_pass.cuh (K4's forward and echo rows and K5's in
// floquet_general.cu; K10's echo and forward rows and the slot rows of
// K8c/K8d and K10's shard-local forms in floquet_general_streamed.cu: the
// same layout, 128 lanes, or 256 at L_loc = 30); at most 85
// registers a thread (three blocks of 256 threads an SM), which the 2x2
// butterflies would exceed unbounded.
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
  static constexpr int kMinBlocks = 3;
  struct Shared {
    Mat2 mats[kMaxEchoL];
  };
  using Kick = MatKick;
  Rows rows;
  __device__ __forceinline__ bool begin(const float* r, int L,
                                        int64_t rows_per_pair, int pair,
                                        int step, Shared& sh,
                                        MatKick& kick) const {
    const auto s = rows.at(r, L, rows_per_pair, pair, step);
    if (!s.active) return false;
    load_mats(s.kick, L, sh.mats);
    kick = MatKick{sh.mats};
    return true;
  }
  __device__ __forceinline__ int time(const float* r, int L,
                                      int64_t rows_per_pair, int pair,
                                      int step) const {
    return rows.time(r, L, rows_per_pair, pair, step);
  }
};

}  // namespace
