// The x family's kick table and 128-lane echo step rows, shared by
// floquet_x.cu (K1/K2) and floquet_x_resident.cu (K3a/K3b), whose entries
// run the step passes of floquet_echo.cuh with the kick policy of
// floquet_x_echo.cuh (XEcho):
//   TableKick: a (tu, 2) device table of (cos theta/2, sin theta/2), indexed
//              by a forward's step (the cycle: no pre row) or by lane 127
//              of an echo step's pre row (read as an int), bounded by tu;
//              K1 and K2 take one angle instead (ConstKick, floquet_rx.cuh);
//   PairRows:  K2's and K3b's echo step rows (step_rows): a pair's pre row,
//              kick sign and trip gate.
//
// Include after floquet_common.cuh; the definitions sit in an anonymous
// namespace of their own.

#pragma once

#include "floquet_common.cuh"

namespace {

// Row `step` (forward) or the row the pre row names (echo) of a (tu, 2)
// table of (cos, sin) of theta_t / 2.
struct TableKick {
  const float* __restrict__ cs;
  int tu;
  __device__ __forceinline__ float2 at(const float* pre, int step) const {
    int ui = pre != nullptr ? (int)pre[kRowWidth - 1] : step;
    ui = min(max(ui, 0), tu - 1);
    return make_float2(cs[2 * ui], cs[2 * ui + 1]);
  }
};

// An echo step's pre row, 2*step of the pair (its diagonals come folded,
// ops/echo_fold.py); the pair runs only while step < trip (lane 124 of row
// 0), with the kick sign of lane 125 of its pre row.
struct StepRows {
  const float* pre;
  float sign;
  bool active;
};

__device__ __forceinline__ StepRows step_rows(const float* rows,
                                              int64_t rows_per_pair, int pair,
                                              int step) {
  const float* base = rows + (int64_t)pair * rows_per_pair * kRowWidth;
  StepRows r;
  const int trip = (int)base[kRowWidth - 4];
  r.active = step < trip;
  r.pre = base + (int64_t)(2 * step) * kRowWidth;
  r.sign = r.pre[kRowWidth - 3];
  return r;
}

// K2's and K3b's echo step rows for XEcho (floquet_x_echo.cuh), which runs
// them on the passes of floquet_echo.cuh: 128 lanes.
struct PairRows {
  __device__ __forceinline__ StepRows at(const float* rows,
                                         int64_t rows_per_pair, int pair,
                                         int step) const {
    return step_rows(rows, rows_per_pair, pair, step);
  }
};

}  // namespace
