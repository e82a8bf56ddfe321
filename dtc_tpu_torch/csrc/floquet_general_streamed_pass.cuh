// The step rows of the streamed lab-frame family (floquet_general_streamed.cu:
// K10a's forward and K10b's echo of whole trajectories, 22 <= L <= 29, and
// the per-shard cycles, one cycle on a shard's local bits: K8c/K8d at
// 17 <= L_loc <= 23, K10's shard-local forms at 22 <= L_loc <= 30): where a pair's step finds its kick row, and whether
// the step runs. The step passes of floquet_echo.cuh read them through the
// family's readers (GeneralEcho, floquet_general_echo.cuh);
// floquet_general_streamed.cu says what bounds them.
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

}  // namespace
