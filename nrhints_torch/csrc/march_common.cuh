// Device code of the hierarchical SDF marches, shared by kernels B and C
// (march.cu) and K, L, M and N (march_fused.cu).
//
// * The per-ray round machinery of nrhints_tpu/kernels/march.py on one warp
//   a ray (ray_step): the merge of 16 new (z, sdf) pairs into the sorted
//   128-slot buffer (warp_merge128: the bitonic network of _bitonic_merge,
//   :165, or the stable rank merge of _rank_merge, :200) and the draw of the
//   next 16 samples (warp_draw_new_z, the NeuS up-sample and deterministic
//   inverse CDF of _round_new_z, :263).  Lane l holds slots 32 j + l, j =
//   0..3, in registers: column j does what warp j of a 128-thread ray did,
//   in the same order on the same operands, so every float is that design's
//   bit for bit.  Prefix sums are shuffles in each column, then the column
//   totals in order; the bitonic stages across columns are register swaps,
//   those within one are xor shuffles; the inverse-CDF counts are ballots.
//   The warp joins its lanes by __syncwarp and its 3 x 128-float shared row;
//   no block barrier.  Kernel B runs it for 4 rays on a 128-thread block,
//   the march template on its warps 0-3.
// * march_kernel, one template for the fused marches: <SWEEP, ROUNDS, FINAL,
//   RANK> selects the initial 64-sample sweep, the 4 refinement rounds (each
//   drawing 16 samples, sweeping them but the last, and merging them), the
//   final dual sweep with the transmittance, and the merge.  Kernel C (final
//   sweep of a refined buffer), K (sweep), L (rounds), M (sweep + rounds)
//   and N (sweep + rounds + final) are its instances.  Every sweep runs on
//   the row engine, mma_rows.cuh::sdf_rows: the 8x256 SDF MLP, bf16 weights
//   and activations, f32 biases and nonlinearities, as _mlp_sdf_3d (:87)
//   computes the value, with the forward-mode tangent of
//   _mlp_sdf_dirderiv_3d (:117) for the final sweep.  So L is B's steps
//   between K's sweeps, M's z is L(K(.)) and N's tau C(M(.)), bit for bit.
// * The march weights' dtype picks the engine (the Engine parameter of
//   march_body): Bf16Rows, the kernels march_kernel<...>, or F32Rows, the
//   f32 instances march_kernel_f32<...> (march_dtype="float32"), whose
//   sweeps run sdf_rows_f32 with wdt = float32.  The rounds and merges are
//   the same code, so the identities above hold in f32 too.
//
// Layout: a march block holds kMarchRays = 4 rays on 512 threads; thread t
// loads and stores slot t & 127 of ray t >> 7, and warp w < 4 runs ray w's
// machinery.  A block's sweeps are, with bf16 weights, 2 value passes of 128
// rows (its 4 rays' 64 stratified samples), one value pass of 64 rows per
// swept round (4 rays x 16 new samples), and 8 dual passes of 64 sections
// and their 64 tangent rows; with f32 weights, 4 value passes of 64 rows,
// the same round passes and 16 dual passes of 32 sections.
#pragma once

#include <type_traits>

#include "mma_rows.cuh"

namespace nrh {

constexpr int NBUF = 128;  // slots of the z / sdf buffer
constexpr int NNEW = 16;   // samples drawn per round
constexpr int NOLD = NBUF - NNEW;
constexpr int kRounds = 4;
constexpr int N0 = NBUF - kRounds * NNEW;  // 64 stratified samples
constexpr float BIG_Z = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMarchRays = kRowsThreads / NBUF;  // rays of a march block
static_assert(kMarchRays * NNEW == 64, "a round's sweep is one 64-row pass");

// ---------------------------------------------------------------------------
// Machinery: one warp a ray; lane l holds slot 32 j + l in column j of its
// registers.

// Exclusive prefix sum over the ray's 128 slots: in each column the 32-lane
// Hillis-Steele scan, then the totals of the columns before it, summed in
// order from 0.
__device__ __forceinline__ void warp_exclusive_scan128(float (&v)[4]) {
  const int lane = threadIdx.x & 31;
  float inc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) inc[q] = v[q];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float t = __shfl_up_sync(kFull, inc[q], o);
      if (lane >= o) inc[q] += t;
    }
  }
  float base = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float tot = __shfl_sync(kFull, inc[q], 31);
    float exc = __shfl_up_sync(kFull, inc[q], 1);
    if (lane == 0) exc = 0.0f;
    v[q] = exc + base;
    base += tot;
  }
}

// Sum over the ray's 128 slots: xor butterflies in each column, then
// (t0 + t1) + (t2 + t3) of lane 0's column sums.
__device__ __forceinline__ float warp_sum128(const float (&x)[4]) {
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = x[q];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] += __shfl_xor_sync(kFull, v[q], o);
  float t[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) t[q] = __shfl_sync(kFull, v[q], 0);
  return (t[0] + t[1]) + (t[2] + t[3]);
}

// Sort the ray's [old ascending (BIG_Z pad included) | new descending] row
// ascending, moving the payload s with z.  sz and ss are the warp's 128-slot
// scratch.
//   Bitonic: the 7-stage network (partner k ^ dd; the upper slot of a pair
//   keeps the larger value; ties stay put): dd = 64 and 32 pair columns
//   j ^ 2 and j ^ 1, dd <= 16 lanes l ^ dd.
//   Rank: each element goes straight to its rank in a stable old-before-new
//   merge: old i to i + #{new < old_i}, new j (descending; column 3, lane
//   16 + j) to 15 - j + #{old <= new_j}, as _rank_merge's shift network
//   places them.  The z row equals the bitonic one; the payload differs only
//   among tied z.
template <bool RANK>
__device__ void warp_merge128(float (&z)[4], float (&s)[4], float* sz, float* ss) {
  const int lane = threadIdx.x & 31;
  if (RANK) {
    int up[4] = {0, 0, 0, 0}, cnew = 0;
    for (int j = 0; j < NNEW; ++j) {
      const float nv = __shfl_sync(kFull, z[3], NNEW + j);
      int c = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        up[q] += nv < z[q];
        c += __popc(__ballot_sync(kFull, z[q] <= nv && (q < 3 || lane < NNEW)));
      }
      if (lane == NNEW + j) cnew = c;
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dest = q < 3 || lane < NNEW ? 32 * q + lane + up[q] : NNEW - 1 - (lane - NNEW) + cnew;
      sz[dest] = z[q];
      ss[dest] = s[q];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      z[q] = sz[32 * q + lane];
      s[q] = ss[32 * q + lane];
    }
    __syncwarp();
    return;
  }
#pragma unroll
  for (int cx = 2; cx >= 1; cx >>= 1) {
    float nz[4], ns[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = q ^ cx;
      const bool take = (q & cx) ? z[p] > z[q] : z[p] < z[q];
      nz[q] = take ? z[p] : z[q];
      ns[q] = take ? s[p] : s[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      z[q] = nz[q];
      s[q] = ns[q];
    }
  }
#pragma unroll
  for (int dd = 16; dd >= 1; dd >>= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float pz = __shfl_xor_sync(kFull, z[q], dd), ps = __shfl_xor_sync(kFull, s[q], dd);
      const bool take = (lane & dd) ? pz > z[q] : pz < z[q];
      if (take) {
        z[q] = pz;
        s[q] = ps;
      }
    }
  }
}

// One up-sample round's draw: from the sorted buffer (z, s), vn valid slots,
// at inv_s -> the 16 new samples in descending order, sample l in lane l <
// 16.  oo = |o|^2, od = o . d.  sz and sc are the warp's 128-slot scratch.
__device__ float warp_draw_new_z(const float (&z)[4], const float (&s)[4], int vn, float inv_s, float oo, float od,
                                 float* sz, float* sc) {
  const int lane = threadIdx.x & 31;
  // Slot k's neighbour k + 1 (slot 127's is slot 0, as (k + 1) % 128).
  float nz[4], ns[4], cosv[4], inside[4], mid[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float dz = __shfl_down_sync(kFull, z[q], 1), ds = __shfl_down_sync(kFull, s[q], 1);
    const float fz = __shfl_sync(kFull, z[(q + 1) & 3], 0), fs = __shfl_sync(kFull, s[(q + 1) & 3], 0);
    nz[q] = lane == 31 ? fz : dz;
    ns[q] = lane == 31 ? fs : ds;
    const float r2 = oo + 2.0f * od * z[q] + z[q] * z[q];
    const float r2n = oo + 2.0f * od * nz[q] + nz[q] * nz[q];
    inside[q] = (r2 < 1.0f || r2n < 1.0f) ? 1.0f : 0.0f;
    mid[q] = (s[q] + ns[q]) * 0.5f;
    cosv[q] = (ns[q] - s[q]) / (nz[q] - z[q] + 1e-5f);
  }
  float alpha[4], lg[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // Slot k's neighbour k - 1 (none for slot 0).
    const float up = __shfl_up_sync(kFull, cosv[q], 1), last = __shfl_sync(kFull, cosv[(q + 3) & 3], 31);
    const float prev = lane > 0 ? up : (q > 0 ? last : 0.0f);
    float c = fminf(prev, cosv[q]);
    c = fminf(fmaxf(c, -1e3f), 0.0f) * inside[q];
    const float dist = nz[q] - z[q];
    const float pc = sigmoidf((mid[q] - c * dist * 0.5f) * inv_s);
    const float nc = sigmoidf((mid[q] + c * dist * 0.5f) * inv_s);
    alpha[q] = 32 * q + lane < vn - 1 ? fminf((pc - nc + 1e-5f) / (pc + 1e-5f), 1.0f) : 0.0f;
    lg[q] = logf(1.0f - alpha[q] + 1e-7f);
  }
  warp_exclusive_scan128(lg);
  float cdf[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float w = alpha[q] * expf(lg[q]);
    cdf[q] = 32 * q + lane < vn - 1 ? w + 1e-5f : 0.0f;
  }
  const float tot = warp_sum128(cdf);
#pragma unroll
  for (int q = 0; q < 4; ++q) cdf[q] = cdf[q] / tot;
  warp_exclusive_scan128(cdf);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sz[32 * q + lane] = z[q];
    sc[32 * q + lane] = cdf[q];
  }
  // inds of sample j: the slots whose cdf (2 past the valid ones) <= u_j.
  int inds = 0;
  for (int j = 0; j < NNEW; ++j) {
    const float u = 1.0f - (float)j / (float)(NNEW - 1);
    int c = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) c += __popc(__ballot_sync(kFull, (32 * q + lane < vn ? cdf[q] : 2.0f) <= u));
    if (lane == j) inds = c;
  }
  __syncwarp();
  float out = 0.0f;
  if (lane < NNEW) {
    const float u = 1.0f - (float)lane / (float)(NNEW - 1);
    const int below = max(inds - 1, 0), above = min(inds, vn - 1);
    const float cb = sc[below], zb = sz[below], ca = sc[above], za = sz[above];
    float den = ca - cb;
    if (den < 1e-5f) den = 1.0f;
    const float t = (u - cb) / den;
    out = zb + t * (za - zb);
  }
  __syncwarp();
  return out;
}

// Merge 16 new samples into the ray's buffer: lane 16 + j brings new sample
// j (descending) in (pz, ps); slots vn..111 become BIG_Z padding.
template <bool RANK>
__device__ __forceinline__ void merge_new(float (&z)[4], float (&s)[4], int vn, float pz, float ps, float* sz,
                                          float* ss) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (32 * q + lane >= vn) z[q] = BIG_Z;
  if (lane >= NNEW) {
    z[3] = pz;
    s[3] = ps;
  } else if (96 + lane >= vn) {
    z[3] = BIG_Z;
  }
  warp_merge128<RANK>(z, s, sz, ss);
}

// One machinery step of one ray on one warp, as one _round_machinery_kernel
// step: merge_vn >= 0 merges the previous round's samples in first (pz, ps
// as merge_new); draw_vn >= 0 then draws the next 16 samples from draw_vn
// valid slots at inv_s and returns them (lanes 0-15, descending); `last`
// then merges those in with a zero sdf, as _rounds_xla's tail step does
// after the last round, whose samples are never swept.  sz, ss, sc: the
// warp's 128-slot scratch.  Ends with __syncwarp.
template <bool RANK>
__device__ float ray_step(float (&z)[4], float (&s)[4], int merge_vn, float pz, float ps, int draw_vn, float inv_s,
                          float oo, float od, bool last, float* sz, float* ss, float* sc) {
  if (merge_vn >= 0) merge_new<RANK>(z, s, merge_vn, pz, ps, sz, ss);
  if (draw_vn < 0) return 0.0f;
  const float nz = warp_draw_new_z(z, s, draw_vn, inv_s, oo, od, sz, sc);
  if (last) {
    const float mz = __shfl_sync(kFull, nz, threadIdx.x & (NNEW - 1));
    merge_new<RANK>(z, s, draw_vn, mz, 0.0f, sz, ss);
  }
  return nz;
}

// log(1 - alpha + 1e-7) of one final-sweep section (0 for the last one, which
// tau excludes): the cos-annealed NeuS alpha of _shadow_final_math (:542).
__device__ __forceinline__ float shadow_log_factor(float sdf_v, float dcos, float dist, float inv_s,
                                                   float anneal, bool last) {
  const float iter_cos =
      -(fmaxf(-dcos * 0.5f + 0.5f, 0.0f) * (1.0f - anneal) + fmaxf(-dcos, 0.0f) * anneal);
  const float pc = sigmoidf((sdf_v - iter_cos * dist * 0.5f) * inv_s);
  const float nc = sigmoidf((sdf_v + iter_cos * dist * 0.5f) * inv_s);
  const float alpha = fminf(fmaxf((pc - nc + 1e-5f) / (pc + 1e-5f), 0.0f), 1.0f);
  return last ? 0.0f : logf(1.0f - alpha + 1e-7f);
}

// ---------------------------------------------------------------------------
// The fused march kernel

// The sweeps' engines: shared memory, weight type, the rows of an initial-
// sweep pass and the sections of a dual pass.
struct Bf16Rows {
  using Smem = RowsSmem;
  using W = bf16;
  static constexpr int kValueRows = kRowsMax;
  static constexpr int kSections = 64;
  template <int ROWS>
  static __device__ __forceinline__ void values(Smem& S, const W* wpack, const float* bpack, const float* w_sdf,
                                                const SdfMeta& m, float scale) {
    sdf_rows<false, ROWS / 64>(S, nullptr, wpack, bpack, w_sdf, m, scale);
  }
  static __device__ __forceinline__ void dual(Smem& S, const float* dir, const W* wpack, const float* bpack,
                                              const float* w_sdf, const SdfMeta& m, float scale) {
    sdf_rows<true, 2>(S, dir, wpack, bpack, w_sdf, m, scale);
  }
};

struct F32Rows {
  using Smem = RowsSmemF32;
  using W = float;
  static constexpr int kValueRows = kRowsF32;
  static constexpr int kSections = kRowsF32 / 2;
  template <int ROWS>
  static __device__ __forceinline__ void values(Smem& S, const W* wpack, const float* bpack, const float* w_sdf,
                                                const SdfMeta& m, float scale) {
    static_assert(ROWS == kRowsF32, "the f32 engine runs 64-row passes");
    sdf_rows_f32<false>(S, nullptr, wpack, bpack, w_sdf, m, scale);
  }
  static __device__ __forceinline__ void dual(Smem& S, const float* dir, const W* wpack, const float* bpack,
                                              const float* w_sdf, const SdfMeta& m, float scale) {
    sdf_rows_f32<true>(S, dir, wpack, bpack, w_sdf, m, scale);
  }
};

template <class Engine>
struct MarchSmem {
  static constexpr int R = kMarchRays;
  typename Engine::Smem t;
  float sz[R][NBUF], ss[R][NBUF];  // each ray's buffer (z, sdf), and its machinery's scratch with sc
  float sc[R][NBUF];
  float dists[R][NBUF], logs[R][NBUF];
  float sweep0[R][N0];
  float new_z[R][NNEW];
  float wt[kRowsThreads / 32];
  float ro[R][3], rd[R][3];
};

// Kernel arguments: z_in is z0 [b, 64] (SWEEP or ROUNDS) or the refined
// buffer [b, 128] (kernel C); sdf0_in [b, 64] (ROUNDS without SWEEP); sdist
// [b, 1], inv_s and anneal (device scalars) with FINAL.  out: sdf0 [b, 64]
// (SWEEP alone), z [b, 128] (ROUNDS without FINAL) or tau [b, 1] (FINAL).
template <class Engine, bool SWEEP, bool ROUNDS, bool FINAL, bool RANK>
__device__ __forceinline__ void march_body(const float* __restrict__ z_in, const float* __restrict__ sdf0_in,
                                           const float* __restrict__ o, const float* __restrict__ d,
                                           const float* __restrict__ sdist,
                                           const typename Engine::W* __restrict__ wpack,
                                           const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                                           const float* __restrict__ inv_s_ptr, const float* __restrict__ anneal_ptr,
                                           float* __restrict__ out, int b, const SdfMeta& m, float scale,
                                           float base_inv_s) {
  constexpr int RPB = kMarchRays, kVal = Engine::kValueRows, kSec = Engine::kSections;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MarchSmem<Engine>& S = *reinterpret_cast<MarchSmem<Engine>*>(smem_raw);
  const int tid = threadIdx.x, h = tid >> 7, k = tid & (NBUF - 1), warp = tid >> 5, lane = tid & 31;
  const int ray = blockIdx.x * RPB + h;
  const bool live = ray < b;
  const int rl = live ? ray : b - 1;  // the last block's spare rays repeat the last ray
  if (k < 3) {
    S.ro[h][k] = o[rl * 3 + k];
    S.rd[h][k] = d[rl * 3 + k];
  }
  float zk, sk = 0.0f;
  if (SWEEP || ROUNDS)
    zk = k < N0 ? z_in[(size_t)rl * N0 + k] : BIG_Z;
  else
    zk = z_in[(size_t)rl * NBUF + k];
  S.sz[h][k] = zk;
  __syncthreads();

  if constexpr (SWEEP) {
    // Initial sweep: pass p holds the 64 stratified samples of kVal / 64
    // rays from ray (kVal / 64) p, one row each.
    constexpr int kRaysPass = kVal / N0;
    for (int p = 0; p < RPB * N0 / kVal; ++p) {
      if (tid < kVal * 3) {
        const int r = tid / 3, j = tid % 3, hr = kRaysPass * p + r / N0;
        S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * S.sz[hr][r % N0];
      }
      __syncthreads();
      Engine::template values<kVal>(S.t, wpack, bpack, w_sdf, m, scale);
      if (tid < kVal) S.sweep0[kRaysPass * p + tid / N0][tid % N0] = S.t.sdf[tid];
      __syncthreads();
    }
    if (k < N0) sk = S.sweep0[h][k];
    if (!ROUNDS) {
      if (live && k < N0) out[(size_t)ray * N0 + k] = sk;
      return;
    }
  } else if (ROUNDS) {
    if (k < N0) sk = sdf0_in[(size_t)rl * N0 + k];
  }

  if (ROUNDS) {
    // _refine_rounds: round i draws 16 samples at inv_s = base * 2^i from
    // vn = 64 + 16 i valid slots, sweeps them (not in the last round: that
    // sdf is a payload no one reads) and merges them in.  Warp w < RPB runs
    // ray w's machinery, kernel B's ray_step (a round's merge and the next
    // draw; the last round's samples merged with it), on the buffer it keeps
    // in S.sz[w], S.ss[w] between rounds; the other warps wait at the barrier
    // that follows.  A round's sweep rows are the block's rays' new samples,
    // ray by ray, so sample j of ray w is row 16 w + j of S.t.sdf.
    S.ss[h][k] = sk;
    __syncthreads();
    for (int i = 0; i < kRounds; ++i) {
      const int vn = N0 + i * NNEW;
      const bool last = i + 1 == kRounds;
      if (warp < RPB) {
        float zr[4], sr[4], pz = 0.0f, ps = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          zr[q] = S.sz[warp][32 * q + lane];
          sr[q] = S.ss[warp][32 * q + lane];
        }
        if (i > 0 && lane >= NNEW) {
          pz = S.new_z[warp][lane - NNEW];
          ps = S.t.sdf[warp * NNEW + lane - NNEW];
        }
        const float* ro = S.ro[warp];
        const float* rd = S.rd[warp];
        const float oo = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2];
        const float od = ro[0] * rd[0] + ro[1] * rd[1] + ro[2] * rd[2];
        __syncwarp();
        const float nz = ray_step<RANK>(zr, sr, i == 0 ? -1 : vn - NNEW, pz, ps, vn, base_inv_s * (float)(1 << i),
                                        oo, od, last, S.sz[warp], S.ss[warp], S.sc[warp]);
        if (lane < NNEW) S.new_z[warp][lane] = nz;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          S.sz[warp][32 * q + lane] = zr[q];
          S.ss[warp][32 * q + lane] = sr[q];
        }
      }
      __syncthreads();
      if (last) break;
      if (tid < RPB * NNEW * 3) {
        const int r = tid / 3, j = tid % 3, hr = r / NNEW;
        S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * S.new_z[hr][r % NNEW];
      }
      __syncthreads();
      Engine::template values<64>(S.t, wpack, bpack, w_sdf, m, scale);
    }
    if (!FINAL) {
      if (live) out[(size_t)ray * NBUF + k] = S.sz[h][k];
      return;
    }
  }

  if constexpr (FINAL) {
    // Final sweep of the refined buffer S.sz: section midpoints (the last
    // section is the ray's sample_dist long), sdf and d . grad sdf, then
    // tau = exp(sum of the 127 log factors).  Pass t holds kSec sections of
    // ray t / (128 / kSec) and their tangent rows.
    const float inv_s = *inv_s_ptr, anneal = *anneal_ptr;
    S.dists[h][k] = k == NBUF - 1 ? sdist[rl] : S.sz[h][k + 1] - S.sz[h][k];
    __syncthreads();
    for (int t = 0; t < RPB * NBUF / kSec; ++t) {
      const int hr = t / (NBUF / kSec), s0 = (t % (NBUF / kSec)) * kSec;
      if (tid < kSec * 3) {
        const int r = tid / 3, j = tid % 3, kk = s0 + r;
        const float mid = S.sz[hr][kk] + S.dists[hr][kk] * 0.5f;
        S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * mid;
      }
      __syncthreads();
      Engine::dual(S.t, S.rd[hr], wpack, bpack, w_sdf, m, scale);
      if (tid < kSec) {
        const int kk = s0 + tid;
        S.logs[hr][kk] =
            shadow_log_factor(S.t.sdf[tid], S.t.sdf[kSec + tid], S.dists[hr][kk], inv_s, anneal, kk == NBUF - 1);
      }
      __syncthreads();
    }
    float v = S.logs[h][k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) S.wt[warp] = v;
    __syncthreads();
    if (live && k == 0) {
      float s = 0.0f;
      for (int w = 0; w < 4; ++w) s += S.wt[4 * h + w];
      out[ray] = expf(s);
    }
  }
}

#define NRH_MARCH_PARAMS(WT)                                                                                 \
  const float *__restrict__ z_in, const float *__restrict__ sdf0_in, const float *__restrict__ o,              \
      const float *__restrict__ d, const float *__restrict__ sdist, const WT *__restrict__ wpack,              \
      const float *__restrict__ bpack, const float *__restrict__ w_sdf, const float *__restrict__ inv_s_ptr,   \
      const float *__restrict__ anneal_ptr, float *__restrict__ out, int b, const SdfMeta m, float scale,       \
      float base_inv_s
#define NRH_MARCH_ARGS z_in, sdf0_in, o, d, sdist, wpack, bpack, w_sdf, inv_s_ptr, anneal_ptr, out, b, m, scale, base_inv_s

// The bf16 instances (kernels C, K, L, M and N) and the f32 ones.
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK>
__global__ void __launch_bounds__(kRowsThreads) march_kernel(NRH_MARCH_PARAMS(bf16)) {
  march_body<Bf16Rows, SWEEP, ROUNDS, FINAL, RANK>(NRH_MARCH_ARGS);
}
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK>
__global__ void __launch_bounds__(kRowsThreads) march_kernel_f32(NRH_MARCH_PARAMS(float)) {
  march_body<F32Rows, SWEEP, ROUNDS, FINAL, RANK>(NRH_MARCH_ARGS);
}
#undef NRH_MARCH_PARAMS
#undef NRH_MARCH_ARGS

// One launch on `stream` of the bf16 instance, or with F32 the f32 one
// (wpack then holds f32 weights); returns its launch error.
template <bool F32, bool SWEEP, bool ROUNDS, bool FINAL, bool RANK>
inline int launch_march(const float* z_in, const float* sdf0_in, const float* o, const float* d,
                        const float* sdist, const void* wpack, const float* bpack, const float* w_sdf,
                        const float* inv_s, const float* anneal, float* out, int b, const int* meta,
                        float scale, float base_inv_s, void* stream) {
  using Engine = typename std::conditional<F32, F32Rows, Bf16Rows>::type;
  using W = typename Engine::W;
  SdfMeta m;
  int rc = parse_meta(meta, &m);
  if (rc) return rc;
  if (b <= 0) return 0;
  const int smem = (int)sizeof(MarchSmem<Engine>);
  void (*kernel)(const float*, const float*, const float*, const float*, const float*, const W*, const float*,
                 const float*, const float*, const float*, float*, int, const SdfMeta, float, float);
  if constexpr (F32)
    kernel = march_kernel_f32<SWEEP, ROUNDS, FINAL, RANK>;
  else
    kernel = march_kernel<SWEEP, ROUNDS, FINAL, RANK>;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc) return rc;
  kernel<<<(b + kMarchRays - 1) / kMarchRays, kRowsThreads, smem, (cudaStream_t)stream>>>(
      z_in, sdf0_in, o, d, sdist, (const W*)wpack, bpack, w_sdf, inv_s, anneal, out, b, m, scale, base_inv_s);
  return (int)cudaGetLastError();
}

}  // namespace nrh
