// K4's echo on the folded rows: the passes of floquet_echo.cuh with the
// step's per-qubit 2x2 kicks (X-mask and U of the echo step's pre row),
// held in shared memory; at most 85 registers a thread (three blocks of
// 256 threads an SM), which the 2x2 butterflies would exceed unbounded.
//
// Include after floquet_common.cuh, floquet_lab.cuh and
// floquet_general_pass.cuh; the definitions sit in an anonymous namespace
// of their own.

#pragma once

#include "floquet_common.cuh"
#include "floquet_echo.cuh"
#include "floquet_general_pass.cuh"
#include "floquet_lab.cuh"

namespace {

// The per-qubit 2x2 kicks of a swizzled round, in registers.
template <int NB>
struct MatRound {
  Mat2 m[NB];
  __device__ __forceinline__ void operator()(int k, float2& a,
                                             float2& b) const {
    mat_pair(a, b, m[k]);
  }
};

// mats[j] acts on qubit j of the kick's range.
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

// The lab-frame echo policy (floquet_echo.cuh).
struct GeneralEcho {
  static constexpr int kMinBlocks = 3;
  struct Shared {
    Mat2 mats[kMaxL];
  };
  using Kick = MatKick;
  __device__ __forceinline__ bool begin(const float* rows, int L,
                                        int64_t rows_per_pair, int pair,
                                        int step, Shared& sh,
                                        MatKick& kick) const {
    const StepRows r = step_rows(rows, L, rows_per_pair, pair, step, 1);
    if (!r.active) return false;
    load_mats(r.kick, L, sh.mats);
    kick = MatKick{sh.mats};
    return true;
  }
};

}  // namespace
