// The RX(theta) kick shared by the x libraries (floquet_x.cu,
// floquet_x_resident.cu, floquet_x_streamed.cu, floquet_cycle.cu,
// floquet_cycle_hi.cu): the butterfly, one angle for every step
// (ConstKick), and the kick as the rounds of the step passes
// (floquet_echo.cuh) take it (RxKick).
//
// Include after floquet_common.cuh; the definitions sit in an anonymous
// namespace of their own.

#pragma once

#include "floquet_common.cuh"

namespace {

// RX butterfly on (a, b): a' = c a - i s b, b' = -i s a + c b.
__device__ __forceinline__ void rx_pair(float2& a, float2& b, float c,
                                        float s) {
  float2 a2 = make_float2(c * a.x + s * b.y, c * a.y - s * b.x);
  float2 b2 = make_float2(c * b.x + s * a.y, c * b.y - s * a.x);
  a = a2;
  b = b2;
}

// One angle for every step: at(pre, step) gives (cos theta/2, sin
// theta/2), the pre row not read.
struct ConstKick {
  float c, s;
  __device__ __forceinline__ float2 at(const float*, int) const {
    return make_float2(c, s);
  }
};

// RX(theta) on every bit: the butterflies of a swizzled round of the echo
// passes (floquet_echo.cuh); no X follows them (flip word 0).
struct RxRound {
  static constexpr int flip = 0;
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

}  // namespace
