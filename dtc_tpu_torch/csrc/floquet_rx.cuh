// The constant x-drive pieces shared by floquet_x.cu (K1/K2) and
// floquet_x_streamed.cu (the large-L family): the diagonal's coefficients of
// one compact row and the RX(theta) kick on shared-memory tiles, three bits
// per round with 2^3 amplitudes in registers, one angle for every step
// (ConstKick), and the kick as the echo passes' rounds take it (RxKick).
//
// Include after floquet_common.cuh; the definitions sit in an anonymous
// namespace of their own.

#pragma once

#include "floquet_common.cuh"

namespace {

// cz_q, cb_j and c0 of one compact row, into shared memory.
__device__ void load_coeffs(const float* __restrict__ row, int L,
                            float* cz, float* cb, float* c0) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    cz[i] = row[3 * L - 1 + i] * (row[L + i] - 0.5f) - kHalfPi * row[i];
  }
  for (int i = threadIdx.x; i < L - 1; i += blockDim.x) {
    cb[i] = row[4 * L - 1 + i] * (row[2 * L + i] - 0.5f);
  }
  if (threadIdx.x == 0) {
    float n = 0.0f;
    for (int i = 0; i < L; ++i) n += row[i];
    *c0 = kHalfPi * n;
  }
}

// RX butterfly on (a, b): a' = c a - i s b, b' = -i s a + c b.
__device__ __forceinline__ void rx_pair(float2& a, float2& b, float c,
                                        float s) {
  float2 a2 = make_float2(c * a.x + s * b.y, c * a.y - s * b.x);
  float2 b2 = make_float2(c * b.x + s * a.y, c * b.y - s * a.x);
  a = a2;
  b = b2;
}

// RX on NB consecutive tile-index bits [b, b + NB) of a 2^tbits tile, one
// shared-memory round: each thread holds 2^NB amplitudes in registers.
template <int NB>
__device__ void kick_round(float2* tile, int tbits, int b, float c, float s) {
  constexpr int M = 1 << NB;
  const int ntup = 1 << (tbits - NB);
  const int lowmask = (1 << b) - 1;
  for (int p = threadIdx.x; p < ntup; p += blockDim.x) {
    const int base = ((p >> b) << (b + NB)) | (p & lowmask);
    float2 v[M];
#pragma unroll
    for (int j = 0; j < M; ++j) v[j] = tile[base + (j << b)];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        if (!(j & (1 << k))) rx_pair(v[j], v[j | (1 << k)], c, s);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) tile[base + (j << b)] = v[j];
  }
  __syncthreads();
}

// RX on tile-index bits [b0, b0 + n) of a 2^tbits tile.
__device__ void kick_bits(float2* tile, int tbits, int b0, int n, float c,
                          float s) {
  int b = b0;
  const int end = b0 + n;
  while (end - b >= 3) {
    kick_round<3>(tile, tbits, b, c, s);
    b += 3;
  }
  if (end - b == 2) kick_round<2>(tile, tbits, b, c, s);
  if (end - b == 1) kick_round<1>(tile, tbits, b, c, s);
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
// passes (floquet_echo.cuh).
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

}  // namespace
