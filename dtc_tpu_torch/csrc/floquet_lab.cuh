// The lab-frame pieces shared by floquet_general.cu (K4/K5) and
// floquet_general_streamed.cu (the large-L lab-frame family): the flag lanes
// of a step row and the step's kick B = X_m U^{(x)L} as the rounds of the
// step passes (floquet_echo.cuh) take it (LabKick): the complex 2x2 U and
// the X-mask as one 32-bit word, both in registers, nothing in shared
// memory. The diagonal's coefficients come folded (ops/echo_fold.py).
//
// Row layout (ops/params_general.py), 128 lanes: noise-Z bits n [0, L),
// X-mask bits m [L, 2L), h [2L, 3L), phi [3L, 4L-1), then the flag lanes
// from FO = 4L-1: MPOS (FO), the slot's 2x2 U (FO+2..9), COUNT (FO+10).
//
// Include after floquet_common.cuh; the definitions sit in an anonymous
// namespace of their own.

#pragma once

#include "floquet_common.cuh"

namespace {

constexpr int kLaneMpos = 0;   // flag lanes, offset from FO = 4L-1
constexpr int kLaneU8 = 2;
constexpr int kLaneCount = 10;

struct Mat2 {
  float2 a00, a01, a10, a11;
};

// One output of U's butterfly, x a + y b (x, y a row of U): each component
// one product and three fused multiply-adds, 16 operations a butterfly.
__device__ __forceinline__ float2 row_dot(float2 x, float2 y, float2 a,
                                          float2 b) {
  return make_float2(
      fmaf(y.x, b.x, fmaf(-y.y, b.y, fmaf(x.x, a.x, -x.y * a.y))),
      fmaf(y.x, b.y, fmaf(y.y, b.x, fmaf(x.x, a.y, x.y * a.x))));
}

// The kick's butterflies of a swizzled round of the step passes: U on each
// bit of the round. The X that follows U on a bit whose X-mask bit is set
// is the round's flip word, which places the round's results
// (floquet_echo.cuh, swz_round) and costs no operation.
struct LabRound {
  Mat2 u;
  int flip;
  __device__ __forceinline__ void operator()(int, float2& a,
                                             float2& b) const {
    const float2 top = row_dot(u.a00, u.a01, a, b);
    b = row_dot(u.a10, u.a11, a, b);
    a = top;
  }
};

// The step passes' kick: U, and bit j of m the X-mask bit of qubit j of the
// kick's range.
struct LabKick {
  Mat2 u;
  uint32_t m;
  __device__ __forceinline__ LabKick from(int q) const { return {u, m >> q}; }
  template <int NB>
  __device__ __forceinline__ LabRound round(int off) const {
    return {u, (int)((m >> off) & ((1u << NB) - 1))};
  }
};

// The kick of one row: U from lanes FO+2..9, the X-mask lanes [L, 2L)
// packed by one ballot a warp (lane j reads m_j; L <= kMaxEchoL = 32).
// Every thread of each warp calls it (the passes' blocks are whole warps).
__device__ __forceinline__ LabKick load_kick(const float* __restrict__ row,
                                             int L) {
  const float* u = row + 4 * L - 1 + kLaneU8;
  const int lane = threadIdx.x & 31;
  const uint32_t m =
      __ballot_sync(0xffffffffu, lane < L && row[L + lane] > 0.5f);
  return {{make_float2(u[0], u[1]), make_float2(u[2], u[3]),
           make_float2(u[4], u[5]), make_float2(u[6], u[7])},
          m};
}

}  // namespace
