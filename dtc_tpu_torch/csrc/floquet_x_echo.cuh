// K3b's echo on the folded rows: the passes of floquet_echo.cuh with the
// step's RX, read through a template parameter `Table` (ConstKick or
// TableKick, floquet_x_pass.cuh) from the echo step's pre row; its sign is
// lane 125 of that row.
//
// Include after floquet_common.cuh, floquet_rx.cuh and floquet_x_pass.cuh;
// the definitions sit in an anonymous namespace of their own.

#pragma once

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_rx.cuh"
#include "floquet_x_pass.cuh"

namespace {

// RX(theta) on every bit: the butterflies of a swizzled round.
struct RxRound {
  float c, s;
  __device__ __forceinline__ void operator()(int, float2& a, float2& b) const {
    rx_pair(a, b, c, s);
  }
};

struct RxKick {
  float c, s;
  __device__ __forceinline__ RxKick from(int) const { return *this; }
  template <int NB>
  __device__ __forceinline__ RxRound round(int) const {
    return {c, s};
  }
};

// The x family's echo policy (floquet_echo.cuh): the kick lives in
// registers, nothing in shared memory.
template <class Table>
struct XEcho {
  static constexpr int kMinBlocks = 1;
  struct Shared {};
  using Kick = RxKick;
  Table table;
  __device__ __forceinline__ bool begin(const float* rows, int,
                                        int64_t rows_per_pair, int pair,
                                        int step, Shared&, RxKick& kick) const {
    const StepRows r = step_rows(rows, rows_per_pair, pair, step, 1);
    if (!r.active) return false;
    const float2 k = table.at(r.pre, step);
    kick = RxKick{k.x, k.y * r.sign};
    return true;
  }
};

}  // namespace
