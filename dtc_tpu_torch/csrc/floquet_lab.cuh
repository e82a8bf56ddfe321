// The lab-frame pieces shared by floquet_general.cu (K4/K5) and
// floquet_general_streamed.cu (the large-L lab-frame family): the flag lanes
// of a step row, the per-qubit kick matrices B = X_m U of one row, and the
// general 2x2 kick as the rounds of the step passes (floquet_echo.cuh)
// take it (MatKick). The diagonal's coefficients come folded
// (ops/echo_fold.py).
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

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// (a, b) <- (m00 a + m01 b, m10 a + m11 b)
__device__ __forceinline__ void mat_pair(float2& a, float2& b,
                                         const Mat2& m) {
  const float2 p = cmul(m.a00, a), r = cmul(m.a01, b);
  const float2 u = cmul(m.a10, a), v = cmul(m.a11, b);
  a = make_float2(p.x + r.x, p.y + r.y);
  b = make_float2(u.x + v.x, u.y + v.y);
}

// Per-qubit kick matrices of one row: U, rows swapped where m_j = 1.
__device__ void load_mats(const float* __restrict__ row, int L, Mat2* mats) {
  const float* u = row + 4 * L - 1 + kLaneU8;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const float2 u00 = make_float2(u[0], u[1]), u01 = make_float2(u[2], u[3]);
    const float2 u10 = make_float2(u[4], u[5]), u11 = make_float2(u[6], u[7]);
    mats[j] = row[L + j] > 0.5f ? Mat2{u10, u11, u00, u01}
                                : Mat2{u00, u01, u10, u11};
  }
}

// The per-qubit 2x2 kicks of a swizzled round of the echo passes
// (floquet_echo.cuh), in registers.
template <int NB>
struct MatRound {
  Mat2 m[NB];
  __device__ __forceinline__ void operator()(int k, float2& a,
                                             float2& b) const {
    mat_pair(a, b, m[k]);
  }
};

// The echo passes' kick: mats[j] acts on qubit j of the kick's range.
struct MatKick {
  const Mat2* mats;
  __device__ __forceinline__ MatKick from(int q) const { return {mats + q}; }
  template <int NB>
  __device__ __forceinline__ MatRound<NB> round(int off) const {
    MatRound<NB> r;
#pragma unroll
    for (int k = 0; k < NB; ++k) r.m[k] = mats[off + k];
    return r;
  }
};

}  // namespace
