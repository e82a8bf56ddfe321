// The streamed x family's echo step rows (floquet_x_streamed.cu): which
// compact rows a step of the echo reads, and whether it runs, for the kick
// policy of floquet_x_echo.cuh (WideRows; the forward reads no row:
// ForwardRows there).
//
// Rows are compact rows (ops/params.py) of a run-time `width`, 128 or 256
// lanes; the echo's flags sit at width-4 (trip count, first row of a pair)
// and width-3 (the step's kick sign).
//
// Include after floquet_common.cuh; the definitions sit in an anonymous
// namespace of their own.

#pragma once

#include "floquet_common.cuh"

namespace {

// A pair's echo step: rows 2*step (pre) and 2*step+1 (post, read through
// the folded rows); the pair runs while step < trip (lane width-4 of its
// first row), with the kick sign at lane width-3 of its pre row.
struct StepRows {
  const float* pre;
  float sign;
  bool active;
};

__device__ __forceinline__ StepRows step_rows(const float* rows, int width,
                                              int64_t rows_per_pair, int pair,
                                              int step) {
  const float* base = rows + (int64_t)pair * rows_per_pair * width;
  const float* pre = base + (int64_t)(2 * step) * width;
  return {pre, pre[width - 3], step < (int)base[width - 4]};
}

}  // namespace
