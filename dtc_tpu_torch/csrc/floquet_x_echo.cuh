// The x family's step policy for the passes of floquet_echo.cuh: RX(theta)
// on every qubit, read from the step's pre row through two template
// parameters, the family's step rows `Rows` (K2's and K3b's 128-lane echo
// rows, PairRows in floquet_x_pass.cuh; the streamed echo's rows of
// run-time width, WideRows in floquet_x_streamed.cu; and, below, the
// forwards' ForwardRows, shared by K1 (floquet_x.cu), K3a
// (floquet_x_resident.cu) and K6a/K7a (floquet_x_streamed.cu), and the
// per-shard cycle kernels' one step, CycleRows, shared by K8a/K8b
// (floquet_cycle.cu) and K9a/K9b (floquet_cycle_hi.cu)) and the angle
// `Table` (TableKick, floquet_x_pass.cuh, or ConstKick, floquet_rx.cuh);
// the kick's sign is lane width-3 of an echo's pre row, +1 in a forward (no
// pre row: TableKick then reads its row `step`, ConstKick nothing).
//
// Include after floquet_common.cuh and floquet_rx.cuh; the definitions sit
// in an anonymous namespace of their own.

#pragma once

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_rx.cuh"

namespace {

// The x family's step policy (floquet_echo.cuh): the kick lives in
// registers, nothing in shared memory. rows.at(rows, rows_per_pair, pair,
// step) gives the pair's step (active, pre, sign); a forward reader's
// rows.time(...) the time the step is measured into (only under Times).
template <class Rows, class Table>
struct XEcho {
  static constexpr int kMinBlocks = 1;
  struct Shared {};
  using Kick = RxKick;
  Rows rows;
  Table table;
  __device__ __forceinline__ bool begin(const float* r, int,
                                        int64_t rows_per_pair, int pair,
                                        int step, Shared&, RxKick& kick) const {
    const auto s = rows.at(r, rows_per_pair, pair, step);
    if (!s.active) return false;
    const float2 k = table.at(s.pre, step);
    kick = RxKick{k.x, k.y * s.sign};
    return true;
  }
  __device__ __forceinline__ int time(const float* r, int L,
                                      int64_t rows_per_pair, int pair,
                                      int step) const {
    return rows.time(r, L, rows_per_pair, pair, step);
  }
};

// The per-shard cycle kernels' step rows (K8a/K8b, K9a/K9b): one step,
// always active, no pre row (ConstKick does not read it), kick sign +1;
// the forward's step is measured into time 0 (under Times).
struct CycleRows {
  struct Step {
    const float* pre;
    float sign;
    bool active;
  };
  __device__ __forceinline__ Step at(const float*, int64_t, int, int) const {
    return {nullptr, 1.0f, true};
  }
  __device__ __forceinline__ int time(const float*, int, int64_t, int,
                                      int) const {
    return 0;
  }
};

using CyclePolicy = XEcho<CycleRows, ConstKick>;

// The x forwards' step rows (K1, K3a, K6a/K7a): every step active, no pre
// row, kick sign +1; step k (cycle k, its diagonal fold row k + 1) is
// measured into A(k + 1) (under Times). No compact row is read: the
// diagonals come folded (ops/echo_fold.py::forward_fold).
struct ForwardRows {
  __device__ __forceinline__ CycleRows::Step at(const float*, int64_t, int,
                                                int) const {
    return {nullptr, 1.0f, true};
  }
  __device__ __forceinline__ int time(const float*, int, int64_t, int,
                                      int step) const {
    return step + 1;
  }
};

}  // namespace
