// Per-cycle noise factor of the planar engine for Hopper (sm_90a): K11.
//
// Replaces
//   K11 dtc_tpu/ops/pallas_noise.py::_make_kernel (entry apply_noise_factor)
//
// For each global index s of a state's (re, im) f32 planes, in place:
//   factor(s) = (-1)^popcount(s & zm) * exp(i A(s)),
//   A(s) = sum_q sigma_q h_q z_q(s) + sum_b flip_b phi_b z_b(s) z_{b+1}(s),
// z_q(s) = 1 - 2 bit_q(s). The cycle's inputs are one (8, 128) f32 tile per
// state: rows [zm bits, sigma bits, bond flips, h, phi, 0, 0, 0]
// (ops/noise_factor.py::pack_cycle_params). The angle is accumulated in q
// order, as the reference does, then one precise sincosf (A reaches about
// L pi, beyond where __sincosf is accurate), then the complex multiply.
//
// What is ported is the function, not the TPU design: the reference maps
// one state per call over (rows, 128) VMEM blocks; here one launch covers a
// batch of states (B, 2, 2^L), grid.y = state, and a grid-stride loop over
// the amplitudes of each plane pair. A block loads its state's tile into
// shared memory once (the per-qubit products sigma_q h_q and flip_b phi_b,
// and the Z mask as an integer, so the sign is one popcount).
//
// What bounds it on this card: bytes. Each amplitude is read and written
// once (16 B per amplitude: two f32 planes in and out), against about 6L
// f32 operations and one sincos; at L=20 that is ~130 operations per 16 B,
// below the card's ~20 f32 operations per byte of device memory rate.
// Loads and stores are coalesced (consecutive threads, consecutive
// amplitudes of one plane). Offsets are 64-bit: at L=30 two planes hold
// 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;

__global__ void noise_factor_kernel(float* __restrict__ state,
                                    const float* __restrict__ params, int L,
                                    int64_t N) {
  __shared__ float cz[32];  // sigma_q * h_q
  __shared__ float cb[32];  // flip_b * phi_b
  __shared__ unsigned int zmask;
  const int b = blockIdx.y;
  const float* par = params + (int64_t)b * 8 * kLanes;
  if (threadIdx.x < 32) {
    const int q = threadIdx.x;
    cz[q] = par[kLanes + q] * par[3 * kLanes + q];
    cb[q] = par[2 * kLanes + q] * par[4 * kLanes + q];
    const unsigned int bit = (q < L && par[q] != 0.0f) ? 1u << q : 0u;
    const unsigned int word = __reduce_or_sync(0xffffffffu, bit);
    if (q == 0) zmask = word;
  }
  __syncthreads();
  float* re = state + (int64_t)b * 2 * N;
  float* im = re + N;
  const unsigned int zm = zmask;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (int64_t)gridDim.x * blockDim.x) {
    float ang = 0.0f;
    float zp = 0.0f;
    for (int q = 0; q < L; ++q) {
      const float z = 1.0f - 2.0f * (float)((i >> q) & 1);
      ang += cz[q] * z;
      if (q > 0) ang += cb[q - 1] * (zp * z);
      zp = z;
    }
    const float sign = (__popc((unsigned int)i & zm) & 1) ? -1.0f : 1.0f;
    float s, c;
    sincosf(ang, &s, &c);
    const float fr = sign * c;
    const float fi = sign * s;
    const float r = re[i];
    const float m = im[i];
    re[i] = r * fr - m * fi;
    im[i] = r * fi + m * fr;
  }
}

}  // namespace

extern "C" {

// K11. state: n_states x 2 x 2^L f32 (re plane, then im plane), updated in
// place; params: n_states x 8 x 128 f32. Returns the launch's cudaError.
int noise_factor_apply(void* state, const void* params, int n_states, int L,
                       void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int64_t N = (int64_t)1 << L;
  int64_t blocks = (N + kThreads - 1) / kThreads;
  // a few amplitudes per thread at large L; enough blocks to fill the card
  // when the batch is small
  const int64_t cap = n_states >= 64 ? 256 : 4096;
  if (blocks > cap) blocks = cap;
  noise_factor_kernel<<<dim3((unsigned)blocks, n_states), kThreads, 0,
                        stream>>>((float*)state, (const float*)params, L, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
