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
// (ops/noise_factor.py::pack_cycle_params).
//
// What is ported is the function, not the TPU design: the reference maps
// one state per call over (rows, 128) VMEM blocks and sums the angle of
// every amplitude (an L-step loop, then one sincos); here one launch covers
// a batch of states (B, 2, 2^L), grid.y = state, and the factor is split
// into per-block phase tables, as the step passes split a diagonal
// (floquet_echo.cuh). The terms of A and the sign bits of qubits [0, a),
// a = min(kLoBits, L), and the bond (a-1, a) that straddles the split, go
// into a table of 2^(a+1) unit phases indexed by the amplitude's bits
// [0, a] (2^a where a = L), built once per block; the terms of qubits
// [a, L), their bonds and sign bits into one unit phase per row of 2^a
// amplitudes, for up to kSegRows rows of the block's contiguous run at a
// time, all threads building them and then streaming those rows without a
// barrier (a first form, 16 rows a barrier built by 16 threads while the
// others waited, took 0.235 ms against 0.207 at L=20 with 32 states;
// PERF.md section 6). An amplitude then costs one complex product of two
// table values and the state multiply (about 12 flops), no sincos and no
// loop over L. Each entry's angle (up to about a pi, or
// (L - a) pi) is summed in double and reduced to [-pi, pi] before one
// precise sincosf, so a table's error stays near one f32 rounding whatever
// L (the reference sums the angle in f32).
//
// What bounds it on this card: bytes. Each amplitude is read and written
// once (16 B per amplitude: two f32 planes in and out). The old form's
// per-amplitude L-step loop, popcount and sincosf came to well over 100
// instructions per 16 B; here a thread moves four consecutive amplitudes
// of each plane with 16-byte loads and stores, kUnroll of those in flight,
// and the lower table is laid out so that a warp's lookups fall on
// consecutive 8-byte slots (entry u at (u % 4) * (n / 4) + u / 4). The
// grid holds one wave of blocks over the card's SMs, each block a
// contiguous run of its state's rows. Offsets are 64-bit: at L=30 two
// planes hold 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kLoBits = 8;     // qubits of the lower table (at most)
constexpr int kSegRows = 1024; // row phases a block holds at once
constexpr int kUnroll = 4;     // 16-byte chunks of each plane in flight
constexpr double kTwoPi = 6.283185307179586;

// The unit phase of qubits [q0, q1) at index s (their bits at their own
// places): (-1)^popcount of their bits in zm times exp(i angle), angle =
// their z terms, the bonds among them and, with `next`, the bond
// (q1 - 1, q1); summed in double and reduced to [-pi, pi] before one
// precise sincosf.
__device__ float2 unit_phase(const float* cz, const float* cb,
                             unsigned int zm, int64_t s, int q0, int q1,
                             bool next) {
  double ang = 0.0, zp = 0.0;
  for (int q = q0; q < (next ? q1 + 1 : q1); ++q) {
    const double z = 1.0 - 2.0 * (double)((s >> q) & 1);
    if (q < q1) ang += (double)cz[q] * z;
    if (q > q0) ang += (double)cb[q - 1] * zp * z;
    zp = z;
  }
  ang -= kTwoPi * rint(ang / kTwoPi);
  float sn, cs;
  sincosf((float)ang, &sn, &cs);
  const unsigned int bits = ((q1 < 32 ? (1u << q1) : 0u) - (1u << q0)) & zm;
  const float sign = (__popc((unsigned int)s & bits) & 1) ? -1.0f : 1.0f;
  return make_float2(sign * cs, sign * sn);
}

// V consecutive f32 of a plane (16 bytes at V = 4).
template <int V>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// K11 on state blockIdx.y: the lower table once, then the block's
// contiguous rows (rows_per_block of them from blockIdx.x on) in segments
// of at most kSegRows, each segment's row phases computed by all threads
// at once, then streamed without a barrier: a thread moves chunks of V
// consecutive amplitudes of both planes (V = 4, or 1 where a state has
// fewer than 4), kUnroll chunks loaded before any is stored.
template <int V>
__global__ void __launch_bounds__(kThreads)
    noise_factor_kernel(float* __restrict__ state,
                        const float* __restrict__ params, int L, int64_t N,
                        int64_t rows_per_block) {
  __shared__ float cz[32];  // sigma_q * h_q
  __shared__ float cb[32];  // flip_b * phi_b
  __shared__ unsigned int zmask;
  __shared__ float2 lo[2 << kLoBits];
  __shared__ float2 hi[kSegRows];
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
  const unsigned int zm = zmask;
  const int a = L < kLoBits ? L : kLoBits;
  const int n_lo = a < L ? 2 << a : 1 << a;  // indexed by bits [0, a]
  const int plane = n_lo / V;
  for (int u = threadIdx.x; u < n_lo; u += blockDim.x) {
    // bits [0, a), and the bond to bit a; bit a's own terms are the row's
    lo[(u % V) * plane + u / V] = unit_phase(cz, cb, zm, u, 0, a, a < L);
  }
  const int64_t r0 = blockIdx.x * rows_per_block;
  const int64_t r_end = r0 + rows_per_block < (N >> a)
                            ? r0 + rows_per_block : (N >> a);
  float* re = state + (int64_t)b * 2 * N;
  float* im = re + N;
  for (int64_t s0 = r0; s0 < r_end; s0 += kSegRows) {
    const int rows = (int)(r_end - s0 < kSegRows ? r_end - s0 : kSegRows);
    if (s0 > r0) __syncthreads();  // the last segment's phases are read
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      hi[r] = unit_phase(cz, cb, zm, (s0 + r) << a, a, L, false);
    }
    __syncthreads();  // and the lower table, on the first segment
    const int64_t base = s0 << a;
    const int chunks = (rows << a) / V;
    for (int c0 = threadIdx.x; c0 < chunks; c0 += kUnroll * blockDim.x) {
      float xr[kUnroll][V], xi[kUnroll][V];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int c = c0 + k * blockDim.x;
        if (c < chunks) {
          load<V>(re + base + c * V, xr[k]);
          load<V>(im + base + c * V, xi[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int c = c0 + k * blockDim.x;
        if (c >= chunks) break;
        const float2 h = hi[(c * V) >> a];
        const int u0 = (int)((base + c * V) & (n_lo - 1)) / V;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float2 l = lo[j * plane + u0];
          const float fr = l.x * h.x - l.y * h.y;
          const float fi = l.x * h.y + l.y * h.x;
          const float r = xr[k][j], m = xi[k][j];
          xr[k][j] = r * fr - m * fi;
          xi[k][j] = r * fi + m * fr;
        }
        store<V>(re + base + c * V, xr[k]);
        store<V>(im + base + c * V, xi[k]);
      }
    }
  }
}

template <int V>
cudaError_t launch(float* state, const float* params, int n_states, int L,
                   cudaStream_t stream) {
  const int64_t N = (int64_t)1 << L;
  const int64_t n_rows = N >> (L < kLoBits ? L : kLoBits);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, noise_factor_kernel<V>, kThreads, 0);
  }
  if (e != cudaSuccess) return e;
  // one wave over the SMs, shared out among the states; each block a
  // contiguous run of rows, at least one
  const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  int64_t nx = (wave + n_states - 1) / n_states;
  if (nx > n_rows) nx = n_rows;
  const int64_t per_block = (n_rows + nx - 1) / nx;
  nx = (n_rows + per_block - 1) / per_block;
  noise_factor_kernel<V><<<dim3((unsigned)nx, n_states), kThreads, 0,
                           stream>>>(state, params, L, N, per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K11. state: n_states x 2 x 2^L f32 (re plane, then im plane), updated in
// place, 16-byte aligned; params: n_states x 8 x 128 f32. Returns the
// launch's cudaError, or cudaErrorInvalidValue without a launch outside
// 1 <= L <= 30, 1 <= n_states <= 65535 or for a misaligned state.
int noise_factor_apply(void* state, const void* params, int n_states, int L,
                       void* stream_ptr) {
  if (L < 1 || L > 30 || n_states < 1 || n_states > 65535 ||
      ((uintptr_t)state & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return (int)(L >= 2 ? launch<4>((float*)state, (const float*)params,
                                  n_states, L, stream)
                      : launch<1>((float*)state, (const float*)params,
                                  n_states, L, stream));
}

}  // extern "C"
