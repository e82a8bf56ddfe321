// The lab-frame step rows, the one reader of every lab-frame kernel on the
// step passes of floquet_echo.cuh: K4's forward and echo and K5
// (floquet_general.cu, 14 <= L <= 23), and the streamed lab-frame family
// (floquet_general_streamed.cu: K10a's forward and K10b's echo of whole
// trajectories, 22 <= L <= 29, and the per-shard cycles, one cycle on a
// shard's local bits: K8c/K8d at 17 <= L_loc <= 23, K10's shard-local forms
// at 22 <= L_loc <= 30): where a pair's step finds its kick row, whether the
// step runs, and the time a forward step is measured into. The passes read
// them through the family's kick policy (GeneralEcho,
// floquet_general_echo.cuh); the two .cu files say what bounds them.
//
// Rows are K4's step rows (ops/params_general.py) of W lanes, a template
// argument: 128, or 256 where the flag lanes from FO = 4L-1 pass lane 127
// (L = 30). Only the row stride depends on W; the lanes sit where they do
// at 128.
//
// Include after floquet_common.cuh and floquet_lab.cuh; the definitions sit
// in an anonymous namespace of their own.

#pragma once

#include "floquet_common.cuh"
#include "floquet_lab.cuh"

namespace {

// A pair's step: its kick row, and whether it runs.
struct StepRows {
  const float* kick;
  bool active;
};

// Step `step` of pair `pair` on rows of W lanes, rows_per_pair rows a pair.
// pairs: the rows come in (pre, post) pairs and the kick is the pre row
// 2 * step; else row `step`. counted: the step runs while step < the COUNT
// of the pair's row 0 (the one-card echo); else always.
template <int W>
__device__ __forceinline__ StepRows step_rows(const float* rows, int L,
                                              int64_t rows_per_pair, int pair,
                                              int step, bool pairs,
                                              bool counted) {
  const float* base = rows + (int64_t)pair * rows_per_pair * W;
  const bool active =
      !counted || step < (int)base[4 * L - 1 + kLaneCount];
  return {base + (int64_t)(pairs ? 2 * step : step) * W, active};
}

// The one-card echoes' step rows (K4's, K10b's): (pre, post) pairs, a pair
// running the COUNT steps of its row 0.
template <int W>
struct PairRows {
  __device__ __forceinline__ StepRows at(const float* rows, int L,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return step_rows<W>(rows, L, rows_per_pair, pair, step, true, true);
  }
};

// The forwards' step rows (K4's, K10a's; also K8c's and K10a
// shard-local's slot rows): every step active, the kick of row `step`,
// measured into the time its MPOS names (-1: none).
template <int W>
struct ForwardRows {
  __device__ __forceinline__ StepRows at(const float* rows, int L,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return step_rows<W>(rows, L, rows_per_pair, pair, step, false, false);
  }
  __device__ __forceinline__ int time(const float* rows, int L,
                                      int64_t rows_per_pair, int pair,
                                      int step) const {
    return (int)rows[((int64_t)pair * rows_per_pair + step) * W + 4 * L - 1 +
                     kLaneMpos];
  }
};

}  // namespace
