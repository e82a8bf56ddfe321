// The step passes shared by floquet_x.cu (K1, K2), floquet_x_resident.cu
// (K3a, K3b), floquet_general.cu (K4, and K5), floquet_x_streamed.cu
// (K6b/K7b, and K6a/K7a's forward), floquet_general_streamed.cu (K10b, K10a's
// forward, and the per-shard lab-frame cycles K8c/K8d and K10's shard-local
// forms: one cycle on a shard's local bits), floquet_cycle.cu (K8a/K8b, one step on a shard's local bits) and
// floquet_cycle_hi.cu (K9a/K9b, the same from L_loc = 22): the folded
// diagonal rows, the phase tables, the swizzled butterfly rounds and the
// passes of a step, templated on the family's kick and step rows. Each
// redesign below was timed on its own on an H100 (PERF.md section 6).
//
// Pass plan: a step cuts the 2^L state into the tiles of
//   pass lo:  bits [0, a), 2^a consecutive amplitudes;
//   pass mid: bits [a, a + b) (b = 0: no mid pass), 2^b rows x CW
//             consecutive columns, the kick only;
//   pass hi:  bits [a + b, L), 2^c rows x CW columns, c = L - a - b.
// The resident x kernels (K1/K2, K3a/K3b), K4 and K5 (L <= 23) and
// K8a-d take a = L - L/2, b = 0 and CW = kW = 4; the streamed ones and
// the streamed forwards (L = 22..30) the plan of floquet_plan.cuh (two passes
// at L <= 24, CW = 4; three above, CW = 16: 128-byte column runs), tiles
// of 16-64 KiB.
//
// Folded rows (ops/echo_fold.py): an echo step k applies D_pre(k), the kick,
// then D_post(k); D_post(k) D_pre(k+1) is one diagonal whose coefficients
// are the sums, so a pair carries S+1 rows of (cz [0, L), cb [L, 2L-1), c0
// at 2L-1): step 0's pass lo applies row 0 before its kick, step k's pass hi
// row k+1 after it. One diagonal per step instead of two. A forward step k
// is the kick, then its diagonal: row k+1 (forward_fold), and no row 0
// (Fold::pre0 false: pass lo of step 0 only kicks).
//
// Phase tables: a pass that applies a diagonal builds, once per block, the
// unit phases of the bits that vary in its tile as two tables of at most
// 2^7 entries each (the upper one also indexed by the boundary bit, so
// that it carries the bond across the split, and with the block's constant
// angle folded in): at most 256 sincosf a block instead of one per
// amplitude, and an amplitude then costs two or three complex multiplies.
//
// Rounds (swz_kick): a pass's kick runs in rounds of 2 or 3 bits, 8
// amplitudes in registers; the first round reads its amplitudes from device
// memory and the last writes them there (the diagonal on the way, and the
// forward's measure), so a pass makes one read and one write of the state
// and the tile in shared memory, swizzled so that no round has bank
// conflicts, holds it between rounds only.
//
// Measures: an echo pair is measured once, after its last step
// (measure_and_reduce); the forward measures a step whose row names a time
// t in pass hi's store, one partial of |psi|^2 z_q a block into a
// (pairs, T, blocks) buffer, summed once at the end in a fixed order
// (Times); K5 measures the state a step loads, on a step that opens a
// cycle, before the butterflies (Obs): pass lo's diagonal sums in its load
// round, each round's x pairs in that round, a pass-lo block over a walk
// of several tiles with its sums in registers and one reduce; one partial
// a lane and block, summed once a chunk of cycles.
//
// Every pair steps in lockstep: a step is two or three launches over all
// pairs. (A schedule that ran groups of pairs small enough to stay in the
// L2 was measured and taken out: with these passes it gained nothing on
// K4's echo and about 6 % on K3b at L=20, PERF.md section 6.) Tile offsets
// are 64-bit: a pair's state reaches 2^30 amplitudes.
//
// Include after floquet_common.cuh; the definitions sit in an anonymous
// namespace of their own.

#pragma once

#include <type_traits>

#include "floquet_common.cuh"

namespace {

constexpr int kTabBits = 6;              // tile bits per phase-table group
constexpr int kTabLo = 1 << kTabBits;    // lower table entries
constexpr int kTabHi = 2 << kTabBits;    // upper table: one more bit
// Pass lo's tile reaches 13 bits (the streamed plan at L = 23, 24): its
// lower table has 2^7 entries, so that step 0's diagonal takes the tables
// at every L (1 KiB of shared memory more, against 2^13 sincosf a block).
constexpr int kLoTabLo = 2 << kTabBits;
constexpr int kMaxEchoL = 32;

// A pair's folded rows: pair p's row j at rows + p * stride + j * 2L.
// pre0: row 0 is a diagonal before step 0's kick (the echoes); the forward
// has none.
struct Fold {
  const float* __restrict__ rows;
  int64_t stride;
  bool pre0 = true;
  __device__ __forceinline__ const float* row(int pair, int j, int L) const {
    return rows + (int64_t)pair * stride + (int64_t)j * 2 * L;
  }
};

__device__ __forceinline__ float2 phase_mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 unit(float th) {
  float s, c;
  sincosf(th, &s, &c);
  return make_float2(c, s);
}

// A folded row into shared memory: coef[0, 2L).
__device__ __forceinline__ void load_fold(const float* __restrict__ row,
                                          int L, float* coef) {
  for (int i = threadIdx.x; i < 2 * L; i += blockDim.x) coef[i] = row[i];
}

// The unit phases of nb tile bits, tile bit j on qubit q0 + j, the other
// qubits fixed: exp(i theta) = lo[i & (2^a - 1)] * hi[i >> (a - 1)] with
// a = (nb + 1) / 2: 2^a entries in lo, 2^(nb - a + 1) in hi (at most 2^7
// each for nb <= 13). lo: the z terms of tile bits [0, a), their bonds,
// and the bond to the fixed qubit q0 - 1 of sign zb (0: none). hi,
// indexed from tile bit a - 1: the z terms of bits [a, nb), the bonds
// (a-1, a) .. (nb-2, nb-1), the bond to the fixed qubit q0 + nb of sign za
// (0: none) and the fixed angle th. table_angles hands each entry's angle
// to emit(e, angle), e < 2^a for lo[e], else hi[e - 2^a]; phase_tables
// stores its unit phase. Both end in __syncthreads.
template <class Emit>
__device__ void table_angles(const float* cz, const float* cb, int q0, int nb,
                             float zb, float za, float th, const Emit& emit) {
  const int a = (nb + 1) / 2;
  const int n_lo = 1 << a;
  for (int e = threadIdx.x; e < n_lo + (2 << (nb - a)); e += blockDim.x) {
    if (e < n_lo) {
      float ang = angle_bits(cz, cb, e, q0, a);
      if (zb != 0.0f) ang += cb[q0 - 1] * zb * zsign(e, 0);
      emit(e, ang);
    } else {
      const int u = e - n_lo;  // bit 0: tile bit a - 1, bit m: a - 1 + m
      float ang = th;
      float zp = zsign(u, 0);
      for (int j = a; j < nb; ++j) {
        const float z = zsign(u, j - a + 1);
        ang += cz[q0 + j] * z + cb[q0 + j - 1] * zp * z;
        zp = z;
      }
      if (za != 0.0f) ang += cb[q0 + nb - 1] * zp * za;
      emit(e, ang);
    }
  }
  __syncthreads();
}

__device__ void phase_tables(const float* cz, const float* cb, int q0, int nb,
                             float zb, float za, float th, float2* lo,
                             float2* hi) {
  const int n_lo = 1 << ((nb + 1) / 2);
  table_angles(cz, cb, q0, nb, zb, za, th, [&](int e, float ang) {
    (e < n_lo ? lo[e] : hi[e - n_lo]) = unit(ang);
  });
}

// The phase of tile index i from the two tables of nb bits.
__device__ __forceinline__ float2 table_phase(const float2* lo,
                                              const float2* hi, int nb,
                                              int i) {
  const int a = (nb + 1) / 2;
  return phase_mul(lo[i & ((1 << a) - 1)], hi[i >> (a - 1)]);
}

// The tile layout in shared memory: amplitude x of a tile sits at swz(x),
// its low 4 bits XORed with F(bits 4..7 of x), F linear over XOR (the
// 4-bit table kSwz, one nibble per value of bits 4..7). Every access of the
// butterfly rounds that swz_kick plans (tiles of 2^7 to 2^13 amplitudes,
// rounds of 2 or 3 bits) then falls on distinct 8-byte slots of a 128-byte
// line within each half-warp, where the plain layout had 2- to 8-way bank
// conflicts (F was found by checking every round of every tile, L = 14-23;
// tests/test_torch_streamed_echo.py replays every round of every tile of
// both plans, L = 14-30, from this constant; on tiles of 16 columns a
// half-warp reads one line anyway).
constexpr uint64_t kSwz = 0xfd6431a875ecb920ull;

__device__ __forceinline__ int swz(int x) {
  return x ^ (int)((kSwz >> (((x >> 4) & 15) << 2)) & 15);
}

// Threads of a block whose tile has 2^tbits amplitudes: one per 8-amplitude
// tuple of a butterfly round, 32 to 256.
inline int echo_threads(int tbits) {
  const int t = 1 << (tbits - 3);
  return t < 32 ? 32 : (t > kThreads ? kThreads : t);
}

// One butterfly round on NB consecutive tile bits [b, b + NB) of a swizzled
// 2^tbits tile, 2^NB amplitudes in registers: kick.round<NB>(b - b0) gives
// the butterflies (k, a, b) of bits b + k, and its flip word: amplitude j of
// the round's result goes to place j ^ flip (an X on bit b + k after its
// butterfly where bit k of flip is set; 0 for the x family). The round's
// bits are disjoint from the tuple's base, so amplitude j of a tuple sits at
// swz(base) ^ swz(j << b), and swz is linear over XOR. The tuple comes from
// the tile or, with kIn, from in(base, j << b) for each amplitude
// base | j << b (the first round fused into the load); it goes back to the
// tile (the round then ends in __syncthreads) or, with kOut, to
// out(base, (j ^ flip) << b, v) (the last round fused into the store). The
// functors see the base and the offset apart, so that what depends on the
// base alone is computed once per tuple.
// meas.tuple<NB, kIn>(base, b, v) sees each tuple as loaded, before the
// round's butterflies, and meas.end<NB>(b) runs once the thread's tuples
// are done (every thread of the block; NoMeasure: neither does anything).
struct NoMeasure {
  template <int NB, bool kIn>
  __device__ __forceinline__ void tuple(int, int, const float2*) {}
  template <int NB>
  __device__ __forceinline__ void end(int) {}
};

template <int NB, bool kIn, bool kOut, class Kick, class In, class Out,
          class Meas>
__device__ void swz_round(float2* tile, int tbits, int b, int b0,
                          const Kick& kick, const In& in, const Out& out,
                          Meas& meas) {
  constexpr int M = 1 << NB;
  const auto bf = kick.template round<NB>(b - b0);
  const int flip = bf.flip << b;
  const int sflip = swz(flip);
  int off[M];
#pragma unroll
  for (int j = 0; j < M; ++j) off[j] = swz(j << b);
  const int ntup = 1 << (tbits - NB);
  const int lowmask = (1 << b) - 1;
  for (int p = threadIdx.x; p < ntup; p += blockDim.x) {
    const int base = ((p >> b) << (b + NB)) | (p & lowmask);
    const int sb = swz(base);
    float2 v[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if constexpr (kIn) {
        v[j] = in(base, j << b);
      } else {
        v[j] = tile[sb ^ off[j]];
      }
    }
    meas.template tuple<NB, kIn>(base, b, v);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        if (!(j & (1 << k))) bf(k, v[j], v[j | (1 << k)]);
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if constexpr (kOut) {
        out(base, (j << b) ^ flip, v[j]);
      } else {
        tile[sb ^ sflip ^ off[j]] = v[j];
      }
    }
  }
  meas.template end<NB>(b);
  if constexpr (!kOut) __syncthreads();
}

template <bool kIn, bool kOut, class Kick, class In, class Out, class Meas>
__device__ void swz_round_n(int nb, float2* tile, int tbits, int b, int b0,
                            const Kick& kick, const In& in, const Out& out,
                            Meas& meas) {
  if (nb == 3) {
    swz_round<3, kIn, kOut>(tile, tbits, b, b0, kick, in, out, meas);
  } else if (nb == 2) {
    swz_round<2, kIn, kOut>(tile, tbits, b, b0, kick, in, out, meas);
  } else {
    swz_round<1, kIn, kOut>(tile, tbits, b, b0, kick, in, out, meas);
  }
}

// A kick whose steps come in kinds (LabKick, floquet_lab.cuh: RX, RY or a
// general 2x2, read from the step's row) says so with kKinds, and its
// visit(f) hands f the kick of the block's kind, a type of its own a kind.
// Any other kick (the x family's) is its one kind.
template <class K, class = void>
struct has_kinds : std::false_type {};
template <class K>
struct has_kinds<K, std::void_t<decltype(K::kKinds)>> : std::true_type {};

// The kick on tile bits [b0, b0 + n) (n <= 12) of a 2^tbits tile in
// ceil(n / 3) rounds of 2 or 3 bits, the last on the top bits: the first
// takes its amplitudes from in, the last hands them to out (swz_round), and
// the tile (swizzled shared memory) holds the state between rounds; meas
// sees every round's tuples before its butterflies. A kick with kinds is
// resolved here, once a pass: the rounds run on its kind's kick.
template <class Kick, class In, class Out, class Meas>
__device__ void swz_kick(float2* tile, int tbits, int b0, int n,
                         const Kick& kick, const In& in, const Out& out,
                         Meas& meas) {
  if constexpr (has_kinds<Kick>::value) {
    kick.visit([&](const auto& k) {
      swz_kick(tile, tbits, b0, n, k, in, out, meas);
    });
  } else {
    const int rounds = (n + 2) / 3;
    const int nb0 = n / rounds + (n % rounds > 0 ? 1 : 0);
    if (rounds == 1) {
      swz_round_n<true, true>(n, tile, tbits, b0, b0, kick, in, out, meas);
      return;
    }
    swz_round_n<true, false>(nb0, tile, tbits, b0, b0, kick, in, out, meas);
    int b = b0 + nb0;
    for (int i = 1; i < rounds - 1; ++i) {
      const int nb = n / rounds + (i < n % rounds ? 1 : 0);
      swz_round_n<false, false>(nb, tile, tbits, b, b0, kick, in, out, meas);
      b += nb;
    }
    swz_round_n<false, true>(b0 + n - b, tile, tbits, b, b0, kick, in, out,
                             meas);
  }
}

template <class Kick, class In, class Out>
__device__ void swz_kick(float2* tile, int tbits, int b0, int n,
                         const Kick& kick, const In& in, const Out& out) {
  NoMeasure none;
  swz_kick(tile, tbits, b0, n, kick, in, out, none);
}

// The passes take the step's kick through a policy P of the family
// (XEcho in floquet_x_echo.cuh, GeneralEcho in floquet_general_echo.cuh,
// each on its family's step rows, echo or forward):
//   P::kMinBlocks  blocks an SM, the passes' launch bounds (pass hi's:
//                  hi_min_blocks);
//   P::Shared      what a block keeps of its kick in shared memory;
//   P::Kick        a block's kick: from(q) the kick from qubit q on, and
//                  round<NB>(j) the butterflies of its qubits [j, j + NB)
//                  and their flip word (swz_round); or, with kKinds, the
//                  kick of one of several kinds, which swz_kick resolves
//                  once a pass through visit (has_kinds);
//   begin(rows, L, rows_per_pair, pair, step, sh, kick): false once the
//                  pair has run its COUNT steps, else sets kick (its shared
//                  part in sh, read after the next __syncthreads);
//   time(rows, L, rows_per_pair, pair, step): with Times and Obs only, the
//                  time t the step's end is measured into, or the cycle t
//                  whose start it measures (t < 0: none).

// What the passes measure (M): NoTimes, nothing (the echoes); Times, the
// forward's A(t) as pass hi stores: on a step whose time is 0 <= t < T,
// each block writes its partial of |psi|^2 z_q, any 0 <= q < L, to
// partials[(pair * T + t) * blocks + block]; Obs, K5's observables of the
// state a step loads (below). kOn: pass hi's store measures (Times);
// kObs: both passes' rounds measure (Obs).
struct NoTimes {
  static constexpr bool kOn = false;
  static constexpr bool kObs = false;
};

struct Times {
  static constexpr bool kOn = true;
  static constexpr bool kObs = false;
  float* __restrict__ partials;
  int q, T;
};

// K5's per-cycle observables (floquet_general.cu), on the two-pass plan
// (b = 0: pass lo on bits [0, a), pass hi on [a, L)). A pass-lo block walks
// 2^tb consecutive tiles of its pair, hi0 .. hi0 + 2^tb - 1 with hi0 =
// blockIdx.x << tb, on every step (obs_lo; the host picks tb). On a step
// whose time() opens cycle t, t0 <= t < t0 + chunk, each pass measures the
// state it loads, before its butterflies: pass lo's block writes 3 + a + tb
// lanes, lane j of pass-lo block b at cycle(pair, t)[j * blocks + b]:
//   0: sum |psi|^2 E(s), E(s) = sum_q th_q z_q + sum_j tph_j z_j z_{j+1}
//      (erow, one 128-lane row a pair: th [0, L), tph [L, 2L-1));
//   1: its bits' x pairs, sum Re conj(psi_s) psi_{s ^ 2^q} over bit q = 0;
//   2: sum |psi|^2 (a qubit above the walk, q >= a + tb, has one sign a
//      block: the reduce expands it into z_q);
//   3 + q: sum |psi|^2 z_q for q < a + tb (the tile's bits, then the
//      bits of a tile's place in the walk);
// pass hi's block b its bits' x pairs at cycle(pair, t)[slots - blocks +
// b] (with_x; without, pass hi measures nothing and lane 1 is 0). Step
// `last` (the last cycle's first) is measured only: neither pass stores.
struct Obs {
  static constexpr bool kOn = false;
  static constexpr bool kObs = true;
  const float* __restrict__ erow;
  float* __restrict__ part;  // (pairs, chunk, slots)
  int t0, chunk, slots, last, with_x, tb;
  // The pair's slots of cycle t; nullptr outside the chunk.
  __device__ __forceinline__ float* cycle(int pair, int t) const {
    return 0 <= t - t0 && t - t0 < chunk
               ? part + ((int64_t)pair * chunk + t - t0) * slots
               : nullptr;
  }
};

constexpr int kMaxObsBits = 12;  // pass lo's tile bits under Obs (L <= 23)
constexpr int kMaxObsWalk = 4;   // a pass-lo block walks <= 2^4 tiles (Obs)

// Log2 of the tiles a pass-lo block walks: Obs's tb, else one tile.
template <class M>
__host__ __device__ __forceinline__ int lo_walk_bits(const M& m) {
  if constexpr (M::kObs) {
    return m.tb;
  } else {
    return 0;
  }
}

// Sum over a warp in a fixed order (shuffles): lane 0 holds it. Every lane
// of the warp calls it.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// A tuple's x pairs on its round bits k: sum over j with bit k = 0 of
// Re conj(v_j) v_{j + 2^k}.
template <int NB>
__device__ __forceinline__ float x_pairs(const float2* v) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
#pragma unroll
    for (int j = 0; j < (1 << NB); ++j) {
      if (!(j & (1 << k))) {
        const float2 w = v[j | (1 << k)];
        x += v[j].x * w.x + v[j].y * w.y;
      }
    }
  }
  return x;
}

// Obs in pass lo's rounds (swz_round's meas) over the tiles of a block's
// walk, the sums of a thread in registers until the walk ends. The load
// round (the first, on tile bits [0, nb0), nb0 = 3 at every a of K5's
// range) takes every diagonal sum from the amplitudes it loads: tuple
// base | j (the round's bits by j, the other tile bits by the base, the
// high bits by the tile) adds each |psi_j|^2 into s[k] signed by bit k of
// j (z_k, k < nb0) and into e weighted by E_lo(base | j), E's terms on
// bits [0, a) (elo[i & (2^h - 1)] + ehi[i >> (h - 1)]; i >> (h - 1) is the
// base's alone, nb0 <= h - 1); the tuple's sum pt goes into e times the
// tile's constant c0 (the z terms of its high bits and their bonds) plus
// c1 z_{a-1}(base) (c1 = tph_{a-1} z_a(tile), the bond across the tile's
// edge), into p (a base bit's z is p signed by that bit of the thread's
// tuple index: obs_lo's reduce forms it), into pit signed by base bit itb
// (a thread's second tuple, a = 12), and into zt[k] signed by bit k of the
// tile's place in the walk (z_{a+k}). Every round adds the x pairs of its
// bits before its butterflies (a pair is in registers only there; the
// butterflies of earlier rounds act on other qubits, whose gates commute
// with X_q, so they are the cycle's); no later round sums anything else.
struct LoObs {
  const float* elo;
  const float* ehi;
  int h, a, itb, tb;
  bool with_x;
  int tile = 0;
  float c0 = 0.0f, c1 = 0.0f;
  float e = 0.0f, x = 0.0f, p = 0.0f, pit = 0.0f;
  float s[3] = {0.0f, 0.0f, 0.0f};
  float zt[kMaxObsWalk] = {0.0f, 0.0f, 0.0f, 0.0f};
  template <int NB, bool kIn>
  __device__ __forceinline__ void tuple(int base, int b, const float2* v) {
    if constexpr (kIn) {
      float pt = 0.0f, et = 0.0f;
#pragma unroll
      for (int j = 0; j < (1 << NB); ++j) {
        const float pj = v[j].x * v[j].x + v[j].y * v[j].y;
        pt += pj;
#pragma unroll
        for (int k = 0; k < NB; ++k) s[k] += (j & (1 << k)) ? -pj : pj;
        et += pj * elo[(base | (j << b)) & ((1 << h) - 1)];
      }
      e += et + pt * (ehi[base >> (h - 1)] + c0 + c1 * zsign(base, a - 1));
      p += pt;
      pit += zsign(base, itb) * pt;
#pragma unroll
      for (int k = 0; k < kMaxObsWalk; ++k) {
        if (k < tb) zt[k] += (tile & (1 << k)) ? -pt : pt;
      }
    }
    if (with_x) x += x_pairs<NB>(v);
  }
  template <int NB>
  __device__ __forceinline__ void end(int) {}
};

// Obs in pass hi's rounds: the x pairs of its bits.
struct XObs {
  float x = 0.0f;
  template <int NB, bool kIn>
  __device__ __forceinline__ void tuple(int, int, const float2* v) {
    x += x_pairs<NB>(v);
  }
  template <int NB>
  __device__ __forceinline__ void end(int) {}
};

// f(kick), f taking the kick of the step's kind where the kick has kinds
// (has_kinds): resolved once for a whole walk of tiles.
template <class Kick, class F>
__device__ __forceinline__ void visit_kind(const Kick& kick, const F& f) {
  if constexpr (has_kinds<Kick>::value) {
    kick.visit(f);
  } else {
    f(kick);
  }
}

// Pass lo under Obs: the block walks the 2^tb tiles hi0 + i of its pair's
// state sp, the kick on each tile's bits [0, k1) (stored unless `store` is
// false), the tiles in turn with a barrier between (a tile's last round
// reads the shared tile that the next one's load round writes). On a step
// that opens a cycle (slot not null) LoObs measures in the rounds: the
// energy row's tables of bits [0, k1) and each tile's two constants once a
// block, then one fixed-order reduce of the block into lanes 0 .. 2 + k1 +
// tb, slot[j * blocks]. A warp sums p by an xor butterfly that also forms
// the signs of its lanes' bits (a Walsh-Hadamard transform: lane 2^u
// holds p signed by lane bit u, base bit nb0 + u; lane 0 the sum) and
// every other register by warp_sum; then the warps in order in shared
// memory (a warp bit's z: the warp's p signed by the bit), one store a
// lane.
template <class Kick>
__device__ void obs_lo(float2* tile, float2* sp, int L, int k1, int64_t hi0,
                       int tb, const float* erow, float* slot, bool with_x,
                       bool store, const Kick& kick) {
  float2* g = sp;
  const auto in = [&](int base, int jb) { return g[base + jb]; };
  const auto out = [&](int base, int jb, float2 v) {
    if (store) g[base + jb] = v;
  };
  const int n = 1 << tb;
  if (slot == nullptr) {  // a step that opens no cycle: the plain rounds
    visit_kind(kick, [&](const auto& k) {
      for (int i = 0; i < n; ++i) {
        if (i > 0) __syncthreads();
        g = sp + ((hi0 + i) << k1);
        swz_kick(tile, k1, 0, k1, k, in, out);
      }
    });
    return;
  }
  __shared__ float coef[2 * kMaxEchoL], elo[kLoTabLo], ehi[kTabHi];
  __shared__ float ct[2][1 << kMaxObsWalk];
  __shared__ float red[3 + kMaxObsBits + kMaxObsWalk][kThreads / 32];
  load_fold(erow, L, coef);
  __syncthreads();
  const float* tph = coef + L;
  if (threadIdx.x < n) {
    const int64_t hi = hi0 + threadIdx.x;
    ct[0][threadIdx.x] = angle_bits(coef, tph, hi, k1, L - k1);
    ct[1][threadIdx.x] = tph[k1 - 1] * zsign(hi, 0);
  }
  const int h = (k1 + 1) / 2;
  table_angles(coef, tph, 0, k1, 0.0f, 0.0f, 0.0f, [&](int e, float ang) {
    (e < (1 << h) ? elo[e] : ehi[e - (1 << h)]) = ang;
  });
  // swz_kick's first round holds tile bits [0, nb0); base bit nb0 + u is
  // bit u of a thread's tuple index: its lane (u < 5), its warp, then
  // its tuple (u = tbits: a thread's second tuple)
  const int rounds = (k1 + 2) / 3;
  const int nb0 = k1 / rounds + (k1 % rounds > 0 ? 1 : 0);
  const int tbits = __ffs(blockDim.x) - 1;
  LoObs meas{elo, ehi, h, k1, nb0 + tbits, tb, with_x};
  visit_kind(kick, [&](const auto& k) {
    for (int i = 0; i < n; ++i) {
      if (i > 0) __syncthreads();
      g = sp + ((hi0 + i) << k1);
      meas.tile = i;
      meas.c0 = ct[0][i];
      meas.c1 = ct[1][i];
      swz_kick(tile, k1, 0, k1, k, in, out, meas);
    }
  });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float w = meas.p;
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, w, o);
    w = (lane & o) ? y - w : w + y;
  }
  const float sums[3] = {warp_sum(meas.e), warp_sum(meas.x),
                         warp_sum(meas.pit)};
  float s[3], zt[kMaxObsWalk];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = warp_sum(meas.s[k]);
#pragma unroll
  for (int k = 0; k < kMaxObsWalk; ++k) {
    zt[k] = k < tb ? warp_sum(meas.zt[k]) : 0.0f;
  }
  const int nbase = k1 - nb0;  // the base bits
  if (lane == 0) {
    red[0][warp] = sums[0];
    red[1][warp] = sums[1];
    red[2][warp] = w;
    for (int k = 0; k < nb0; ++k) red[3 + k][warp] = s[k];
    for (int u = 5; u < tbits && u < nbase; ++u) {
      red[3 + nb0 + u][warp] = zsign(warp, u - 5) * w;
    }
    if (tbits < nbase) red[3 + nb0 + tbits][warp] = sums[2];
    for (int k = 0; k < tb; ++k) red[3 + k1 + k][warp] = zt[k];
  } else if ((lane & (lane - 1)) == 0 && __ffs(lane) - 1 < nbase) {
    red[3 + nb0 + __ffs(lane) - 1][warp] = w;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 + k1 + tb; j += blockDim.x) {
    float sum = 0.0f;
    for (int v = 0; v < (int)(blockDim.x >> 5); ++v) sum += red[j][v];
    slot[(int64_t)j * gridDim.x + blockIdx.x] = sum;
  }
}

// Pass hi under Obs on a step that opens a cycle, with x pairs: the kick
// on tile bits [b0, b0 + n) with XObs in its rounds (stored unless `store`
// is false), the block's sum into *slot.
template <class Kick, class In, class Out>
__device__ void obs_hi(float2* tile, int tbits, int b0, int n, float* slot,
                       bool store, const Kick& kick, const In& in,
                       const Out& out) {
  __shared__ float red[kThreads / 32];
  XObs meas;
  swz_kick(
      tile, tbits, b0, n, kick, in,
      [&](int base, int jb, float2 v) {
        if (store) out(base, jb, v);
      },
      meas);
  const float tot = block_sum(meas.x, red);
  if (threadIdx.x == 0) *slot = tot;
}

// Pass lo (pair blockIdx.y): an echo's step 0 applies folded row 0, the
// first pre diagonal (later steps' pre diagonals are folded into the
// previous pass hi), then the kick of the step's row on bits [0, k1). Under
// Obs (K5, forward rows: no row 0) the block walks 2^m.tb tiles and
// measures on a step that opens a cycle (obs_lo).
template <class P, class M>
__global__ void __launch_bounds__(kThreads, P::kMinBlocks)
    echo_lo_kernel(float2* __restrict__ st, int L, int k1,
                   const float* __restrict__ rows, int64_t rows_per_pair,
                   Fold fold, int step, P policy, M m) {
  extern __shared__ float2 tile[];
  __shared__ float coef[2 * kMaxEchoL];
  __shared__ float2 tlo[kLoTabLo], thi[kTabHi];
  __shared__ typename P::Shared sh;
  const int pair = blockIdx.y;
  typename P::Kick kick;
  if (!policy.begin(rows, L, rows_per_pair, pair, step, sh, kick)) return;
  if constexpr (M::kObs) {
    __syncthreads();  // the policy's shared part
    obs_lo(tile, st + ((int64_t)pair << L), L, k1,
           (int64_t)blockIdx.x << m.tb, m.tb,
           m.erow + (int64_t)pair * kRowWidth,
           m.cycle(pair, policy.time(rows, L, rows_per_pair, pair, step)),
           m.with_x, step != m.last, kick);
    return;
  }
  const int64_t hi = blockIdx.x;
  float2* g = st + ((int64_t)pair << L) + (hi << k1);
  const bool first = step == 0 && fold.pre0;
  if (first) load_fold(fold.row(pair, 0, L), L, coef);
  __syncthreads();
  if (first) {
    const float* cb = coef + L;
    phase_tables(coef, cb, 0, k1, 0.0f, zsign(hi, 0),
                 coef[2 * L - 1] + angle_bits(coef, cb, hi, k1, L - k1), tlo,
                 thi);
  }
  const auto in = [&](int base, int jb) {
    const float2 v = g[base + jb];
    return first ? phase_mul(v, table_phase(tlo, thi, k1, base + jb)) : v;
  };
  const auto out = [&](int base, int jb, float2 v) { g[base + jb] = v; };
  swz_kick(tile, k1, 0, k1, kick, in, out);
}

// Columns of the strided tiles (passes mid and hi): kW = 4, 32-byte runs,
// where a tile must stay small (the resident echoes, the streamed plan at
// L <= 24, 2^10-2^11 rows); kWideCols = 16, 128-byte runs (whole L2
// lines), on the streamed three-pass plan (L >= 25, at most 2^9 rows: tiles
// of 16-64 KiB).
constexpr int kWideCols = 16;

__host__ __device__ constexpr int log2_of(int x) {
  return x > 1 ? 1 + log2_of(x / 2) : 0;
}

// Amplitude (row, column) of a strided tile of CW columns whose rows sit
// at bits [k0, k0 + n) and whose columns at bits [0, log2 CW): tile index
// base + jb = row * CW + column (jb holds row bits only).
template <int CW>
__device__ __forceinline__ int64_t strided_at(int base, int jb, int k0) {
  return ((int64_t)(base / CW + jb / CW) << k0) + base % CW;
}

// Pass mid (pair blockIdx.y; only where b > 0): the kick on bits
// [a, a + b) on a tile of 2^b rows x CW consecutive columns, no diagonal.
// Block x = (top << (a - log2 CW)) | column group, top the bits above
// a + b.
template <class P, int CW>
__global__ void __launch_bounds__(kThreads, P::kMinBlocks)
    echo_mid_kernel(float2* __restrict__ st, int L, int a, int b,
                    const float* __restrict__ rows, int64_t rows_per_pair,
                    int step, P policy) {
  constexpr int kc = log2_of(CW);
  extern __shared__ float2 tile[];  // [2^b][CW], swizzled
  __shared__ typename P::Shared sh;
  const int pair = blockIdx.y;
  typename P::Kick kick;
  if (!policy.begin(rows, L, rows_per_pair, pair, step, sh, kick)) return;
  const int64_t cols = ((int64_t)1 << a) / CW;
  const int64_t top = blockIdx.x / cols;
  float2* g = st + ((int64_t)pair << L) + (blockIdx.x % cols) * CW
              + (top << (a + b));
  __syncthreads();  // the policy's shared part
  swz_kick(
      tile, b + kc, kc, b, kick.from(a),
      [&](int base, int jb) { return g[strided_at<CW>(base, jb, a)]; },
      [&](int base, int jb, float2 v) {
        g[strided_at<CW>(base, jb, a)] = v;
      });
}

// Blocks an SM that pass hi's launch bounds ask for: the policy's, but 3
// (at most 85 registers) for a pass hi that measures (Times) on 16-column
// tiles. Unbounded, the x forward's (XEcho, kMinBlocks 1) took 92-93
// registers and ran two blocks an SM, the echoes' pass hi three at 80; at 3
// it takes 80, no spill, and its L=28 pass hi went 476 -> 410 ms in 57
// launches, while on 4-column tiles (L=24) 3 made it slower (31.1 -> 36.9
// ms); H100 SXM, PERF.md section 6.
template <class P, int CW, class M>
constexpr int hi_min_blocks() {
  return M::kOn && CW == kWideCols ? 3 : P::kMinBlocks;
}

// Pass hi (pair blockIdx.y): the kick on bits [k0, L) on a tile of
// 2^(L - k0) rows x CW columns, then folded row step + 1 (an echo's post
// diagonal and the next step's pre; the forward's step diagonal) as the
// tile is stored, and what M measures (Times: in the store; Obs: obs_hi
// on a step that opens a cycle).
template <class P, int CW, class M>
__global__ void __launch_bounds__(kThreads, hi_min_blocks<P, CW, M>())
    echo_hi_kernel(float2* __restrict__ st, int L, int k0,
                   const float* __restrict__ rows, int64_t rows_per_pair,
                   Fold fold, int step, P policy, M m) {
  constexpr int kc = log2_of(CW);
  extern __shared__ float2 tile[];  // [2^n2][CW], swizzled
  __shared__ float coef[2 * kMaxEchoL];
  __shared__ float2 tlo[kTabLo], thi[kTabHi], tw[CW];
  __shared__ typename P::Shared sh;
  const int pair = blockIdx.y;
  typename P::Kick kick;
  if (!policy.begin(rows, L, rows_per_pair, pair, step, sh, kick)) return;
  [[maybe_unused]] float* cyc = nullptr;  // Obs: the cycle's slots
  if constexpr (M::kObs) {
    cyc = m.cycle(pair, policy.time(rows, L, rows_per_pair, pair, step));
    // the measure-only step has nothing for pass hi without x pairs
    if (cyc != nullptr && step == m.last && !m.with_x) return;
  }
  const int n2 = L - k0;
  const int64_t o = (int64_t)blockIdx.x * CW;
  float2* g = st + ((int64_t)pair << L) + o;
  [[maybe_unused]] float* slot = nullptr;  // uniform over the block
  if constexpr (M::kOn) {
    const int t = policy.time(rows, L, rows_per_pair, pair, step);
    if (0 <= t && t < m.T) {
      slot = m.partials + ((int64_t)pair * m.T + t) * gridDim.x;
    }
  }
  load_fold(fold.row(pair, step + 1, L), L, coef);
  __syncthreads();
  const float* cb = coef + L;
  if (threadIdx.x < CW) {
    tw[threadIdx.x] =
        unit(coef[2 * L - 1] + angle_bits(coef, cb, o + threadIdx.x, 0, k0));
  }
  phase_tables(coef, cb, k0, n2, zsign(o, k0 - 1), 0.0f, 0.0f, tlo, thi);
  [[maybe_unused]] float acc = 0.0f;
  // tile index x = h * CW + w: the high bits sit at tile bits
  // [kc, kc + n2)
  const auto in = [&](int base, int jb) {
    return g[strided_at<CW>(base, jb, k0)];
  };
  const auto out = [&](int base, int jb, float2 v) {
    // the last round's bits are the top ones, above the lower table's
    const int a = (n2 + 1) / 2;
    const int h = base / CW;
    const float2 ph =
        phase_mul(phase_mul(tlo[h & ((1 << a) - 1)], tw[base % CW]),
                  thi[(h + jb / CW) >> (a - 1)]);
    const int64_t at = strided_at<CW>(base, jb, k0);
    const float2 w = phase_mul(v, ph);
    g[at] = w;
    if constexpr (M::kOn) {
      if (slot != nullptr) {
        acc += (w.x * w.x + w.y * w.y) * zsign(o + at, m.q);
      }
    }
  };
  if constexpr (M::kObs) {
    if (cyc != nullptr && m.with_x) {
      obs_hi(tile, n2 + kc, kc, n2, cyc + m.slots - gridDim.x + blockIdx.x,
             step != m.last, kick.from(k0), in, out);
      return;
    }
  }
  swz_kick(tile, n2 + kc, kc, n2, kick.from(k0), in, out);
  if constexpr (M::kOn) {
    if (slot != nullptr) {
      __shared__ float red[kThreads / 32];
      const float tot = block_sum(acc, red);
      if (threadIdx.x == 0) slot[blockIdx.x] = tot;
    }
  }
}

// Pass-hi blocks of one state on the plan (a, b) with CW columns: the
// forward's partials per pair and time.
__host__ __device__ constexpr int step_hi_blocks(int a, int b, int cw) {
  return (1 << (a + b)) / cw;
}

// The same on the streamed plan (floquet_plan.cuh), whose strided tiles
// take kW columns on two passes (b = 0) and kWideCols on three.
__host__ __device__ constexpr int streamed_hi_blocks(int a, int b) {
  return step_hi_blocks(a, b, b > 0 ? kWideCols : kW);
}

// Steps [from, to) of n_pairs states in st, on the folded rows and the
// pass plan (a, b), strided tiles of CW columns: two or three passes a
// step, a pair stopping at its COUNT; the passes measure what m says.
template <int CW, class P, class M>
cudaError_t launch_steps(float2* st, int L, int a, int b, const float* rows,
                         int64_t rows_per_pair, Fold fold, int n_pairs,
                         int from, int to, P policy, M m,
                         cudaStream_t stream) {
  constexpr int kc = log2_of(CW);
  const int k0 = a + b;
  const int c = L - k0;
  const size_t smem_lo = sizeof(float2) << a;
  const size_t smem_mid = (sizeof(float2) * CW) << b;
  const size_t smem_hi = (sizeof(float2) * CW) << c;
  const int t_lo = echo_threads(a), t_mid = echo_threads(b + kc),
            t_hi = echo_threads(c + kc);
  cudaError_t e = cudaFuncSetAttribute(
      echo_lo_kernel<P, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_lo);
  if (e == cudaSuccess && b > 0) {
    e = cudaFuncSetAttribute(echo_mid_kernel<P, CW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_mid);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(echo_hi_kernel<P, CW, M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_hi);
  }
  for (int k = from; e == cudaSuccess && k < to; ++k) {
    echo_lo_kernel<P, M><<<dim3((1u << (L - a)) >> lo_walk_bits(m),
                                n_pairs),
                           t_lo, smem_lo, stream>>>(st, L, a, rows,
                                                    rows_per_pair, fold, k,
                                                    policy, m);
    if (b > 0) {
      echo_mid_kernel<P, CW><<<dim3((1u << (L - b)) / CW, n_pairs), t_mid,
                               smem_mid, stream>>>(st, L, a, b, rows,
                                                   rows_per_pair, k, policy);
    }
    echo_hi_kernel<P, CW, M><<<dim3(step_hi_blocks(a, b, CW), n_pairs), t_hi,
                               smem_hi, stream>>>(st, L, k0, rows,
                                                  rows_per_pair, fold, k,
                                                  policy, m);
    e = cudaGetLastError();
  }
  return e;
}

// n_steps steps of n_pairs states in st from the basis state b0
// (launch_steps).
template <int CW, class P, class M>
cudaError_t run_steps(float2* st, int L, int a, int b, const float* rows,
                      int64_t rows_per_pair, Fold fold, int n_pairs,
                      int n_steps, P policy, M m, int64_t b0,
                      cudaStream_t stream) {
  init_kernel<<<dim3(256, n_pairs), kThreads, 0, stream>>>(
      st, (int64_t)1 << L, b0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_steps<CW>(st, L, a, b, rows, rows_per_pair, fold, n_pairs, 0,
                          n_steps, policy, m, stream);
}

// The echo of n_pairs states in st on the folded rows and the pass plan
// (a, b), strided tiles of CW columns: the basis state, n_steps echo steps
// (run_steps), the measure and the fixed-order reduce into out (partials:
// n_pairs x measure_blocks(L)).
template <int CW, class P>
cudaError_t run_echo(float2* st, int L, int a, int b, const float* rows,
                     int64_t rows_per_pair, Fold fold, int n_pairs,
                     int n_steps, P policy, int q, int64_t b0,
                     float* partials, float* out, cudaStream_t stream) {
  const cudaError_t e =
      run_steps<CW>(st, L, a, b, rows, rows_per_pair, fold, n_pairs, n_steps,
                    policy, NoTimes{}, b0, stream);
  if (e != cudaSuccess) return e;
  return measure_and_reduce(st, L, q, n_pairs, partials, out, stream);
}

}  // namespace
