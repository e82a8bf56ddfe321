// The lab-frame pieces shared by floquet_general.cu (K4/K5) and
// floquet_general_streamed.cu (the large-L lab-frame family): the flag lanes
// of a step row and the step's kick B = X_m U^{(x)L} as the rounds of the
// step passes (floquet_echo.cuh) take it (LabKick): the complex 2x2 U, its
// kind and the X-mask as one 32-bit word, all in registers, nothing in
// shared memory. The diagonal's coefficients come folded (ops/echo_fold.py).
//
// Row layout (ops/params_general.py), 128 lanes: noise-Z bits n [0, L),
// X-mask bits m [L, 2L), h [2L, 3L), phi [3L, 4L-1), then the flag lanes
// from FO = 4L-1: MPOS (FO), the slot's 2x2 U (FO+2..9), COUNT (FO+10).
//
// Kick kinds: load_kick reads the kind of the step's U from its 8 lanes, and
// the rounds of a pass run the butterfly of that kind (LabKick::visit, one
// kick type a kind, so that no round holds registers or branches for a kind
// it does not run; a step is one row, so the kind is uniform over a block):
//   RX: re a01 = re a10 = im a00 = im a11 = 0, a00 = a11, a01 = a10:
//       U = [[c, -i s], [-i s, c]], c = re a00, s = -im a01 (RxLabRound);
//   RY: every imaginary part 0, a00 = a11, a01 = -a10:
//       U = [[c, -s], [s, c]], c = re a00, s = re a10 (RyLabRound);
//   general: any other U, the complex 2x2 (LabRound).
// Every slot of every drive (models/drives.py) is a pure RX or RY with exact
// f32 zeros (ops/params_general.py::kick_kind states the same rule on the
// host, where the sweeps count the steps of each kind); the general 2x2
// stays for any other row. RX and RY cost 8 operations a butterfly, the
// general 2x2 16, and the RX and RY butterflies keep row_dot's fused
// operations on U's non-zero entries (its products by U's exact zeros
// dropped), so they give row_dot's results up to the sign of an exact zero.
//
// Include after floquet_common.cuh; the definitions sit in an anonymous
// namespace of their own.

#pragma once

#include "floquet_common.cuh"

namespace {

constexpr int kLaneMpos = 0;   // flag lanes, offset from FO = 4L-1
constexpr int kLaneU8 = 2;
constexpr int kLaneCount = 10;

constexpr int kKickRx = 0;     // kick kinds (LabKick::kind)
constexpr int kKickRy = 1;
constexpr int kKickGeneral = 2;

struct Mat2 {
  float2 a00, a01, a10, a11;
};

// One output of U's butterfly, x a + y b (x, y a row of U): each component
// one product and three fused multiply-adds, 16 operations a butterfly (the
// general kind).
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

// RX's butterfly, a' = c a - i s b, b' = -i s a + c b: row_dot's operations
// on the non-zero entries, one product and one fused multiply-add a
// component, 8 operations.
struct RxLabRound {
  float c, s;
  int flip;
  __device__ __forceinline__ void operator()(int, float2& a,
                                             float2& b) const {
    const float2 top =
        make_float2(fmaf(s, b.y, c * a.x), fmaf(-s, b.x, c * a.y));
    b = make_float2(fmaf(c, b.x, s * a.y), fmaf(c, b.y, -s * a.x));
    a = top;
  }
};

// RY's butterfly, a' = c a - s b, b' = s a + c b: the same, 8 operations.
struct RyLabRound {
  float c, s;
  int flip;
  __device__ __forceinline__ void operator()(int, float2& a,
                                             float2& b) const {
    const float2 top =
        make_float2(fmaf(-s, b.x, c * a.x), fmaf(-s, b.y, c * a.y));
    b = make_float2(fmaf(c, b.x, s * a.x), fmaf(c, b.y, s * a.y));
    a = top;
  }
};

// The general kind's kick: U, and bit j of m the X-mask bit of qubit j of
// the kick's range.
struct GeneralKick {
  Mat2 u;
  uint32_t m;
  template <int NB>
  __device__ __forceinline__ LabRound round(int off) const {
    return {u, (int)((m >> off) & ((1u << NB) - 1))};
  }
};

// An RX or RY kind's kick: (c, s) and the X-mask word, its rounds Round.
template <class Round>
struct AxisKick {
  float c, s;
  uint32_t m;
  template <int NB>
  __device__ __forceinline__ Round round(int off) const {
    return {c, s, (int)((m >> off) & ((1u << NB) - 1))};
  }
};

// The step passes' kick: U, its kind and the X-mask word. The rounds take
// it through visit (kKinds, floquet_echo.cuh's swz_kick): f gets the kick
// of the step's kind.
struct LabKick {
  static constexpr bool kKinds = true;
  Mat2 u;
  uint32_t m;
  int kind;
  __device__ __forceinline__ LabKick from(int q) const {
    return {u, m >> q, kind};
  }
  template <class F>
  __device__ __forceinline__ void visit(const F& f) const {
    if (kind == kKickRx) {
      f(AxisKick<RxLabRound>{u.a00.x, -u.a01.y, m});
    } else if (kind == kKickRy) {
      f(AxisKick<RyLabRound>{u.a00.x, u.a10.x, m});
    } else {
      f(GeneralKick{u, m});
    }
  }
};

// The kind of U (the rule above).
__device__ __forceinline__ int kick_kind(const Mat2& u) {
  const bool diag = u.a00.x == u.a11.x;
  if (u.a01.x == 0.0f && u.a10.x == 0.0f && u.a00.y == 0.0f &&
      u.a11.y == 0.0f && diag && u.a01.y == u.a10.y) {
    return kKickRx;
  }
  if (u.a00.y == 0.0f && u.a01.y == 0.0f && u.a10.y == 0.0f &&
      u.a11.y == 0.0f && diag && u.a01.x == -u.a10.x) {
    return kKickRy;
  }
  return kKickGeneral;
}

// The kick of one row: U from lanes FO+2..9 and its kind, the X-mask lanes
// [L, 2L) packed by one ballot a warp (lane j reads m_j; L <= kMaxEchoL =
// 32). Every thread of each warp calls it (the passes' blocks are whole
// warps).
__device__ __forceinline__ LabKick load_kick(const float* __restrict__ row,
                                             int L) {
  const float* u = row + 4 * L - 1 + kLaneU8;
  const int lane = threadIdx.x & 31;
  const uint32_t m =
      __ballot_sync(0xffffffffu, lane < L && row[L + lane] > 0.5f);
  const Mat2 mat{make_float2(u[0], u[1]), make_float2(u[2], u[3]),
                 make_float2(u[4], u[5]), make_float2(u[6], u[7])};
  return {mat, m, kick_kind(mat)};
}

}  // namespace
