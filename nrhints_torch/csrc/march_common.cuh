// Device code of the hierarchical SDF marches, shared by kernels B and C
// (march.cu) and K, L, M and N (march_fused.cu, and march_geom.cu at any
// march geometry).
//
// A march's geometry: n0 stratified samples, then `rounds` rounds, each
// drawing n_new samples, n0 + rounds * n_new = 128 (MarchGeom).  The
// presets' 64 + 4 x 16 runs the compile-time instances (NN = kFixedNew:
// the geometry constants); every other geometry with rounds >= 1, n_new >= 2
// and n0 >= 2 runs the run-time instances (NN = 0), the same code.
//
// * The per-ray round machinery of nrhints_tpu/kernels/march.py on one warp
//   a ray (ray_step): the merge of n_new new (z, sdf) pairs into the sorted
//   128-slot buffer (warp_merge128: the bitonic network of _bitonic_merge,
//   :165, or the stable rank merge of _rank_merge, :200) and the draw of the
//   next n_new samples (warp_draw_new_z, the NeuS up-sample and
//   deterministic inverse CDF of _round_new_z, :263).  Lane l holds slots
//   32 j + l, j = 0..3, in registers: column j does what warp j of a
//   128-thread ray did, in the same order on the same operands, so every
//   float is that design's bit for bit.  Prefix sums are shuffles in each
//   column, then the column totals in order; the bitonic stages across
//   columns are register swaps, those within one are xor shuffles; the
//   inverse-CDF counts are ballots.  The new samples fill slots 128 - n_new
//   .. 127; a draw returns sample j in lane j & 31 of column j >> 5.  The
//   warp joins its lanes by __syncwarp and its 3 x 128-float shared row; no
//   block barrier.  Kernel B runs it for 4 rays on a 128-thread block, the
//   march template on its warps 0-3.
// * march_kernel, one template for the fused marches: <SWEEP, ROUNDS, FINAL,
//   RANK, NN> selects the initial sweep of the n0 stratified samples, the
//   refinement rounds (each drawing n_new samples, sweeping them but the
//   last, and merging them), the final dual sweep with the transmittance,
//   the merge, and the instance's n_new.  Kernel C (final sweep of a
//   refined buffer), K (sweep), L (rounds), M (sweep + rounds) and N (sweep
//   + rounds + final) are its instances.  Every sweep runs on the row
//   engine, mma_rows.cuh::sdf_rows: the 8x256 SDF MLP, bf16 weights and
//   activations, f32 biases and nonlinearities, as _mlp_sdf_3d (:87)
//   computes the value, with the forward-mode tangent of
//   _mlp_sdf_dirderiv_3d (:117) for the final sweep.  So L is B's steps
//   between K's sweeps, M's z is L(K(.)) and N's tau C(M(.)), bit for bit.
// * The march weights' dtype picks the engine (the Engine parameter of
//   march_body): Bf16Rows, the kernels march_kernel<...>, or F32Rows, the
//   f32 instances march_kernel_f32<...> (march_dtype="float32"), whose
//   sweeps run sdf_rows_f32 with wdt = float32.  The rounds and merges are
//   the same code, so the identities above hold in f32 too.
// * The SDF's widths pick the engine's class (mma_rows.cuh): the presets'
//   widths run the engines above, padded widths up to kWideWMax and
//   encodings up to kWideEncMax their wide class, Bf16RowsWide (the kernels
//   march_kernel_wide<...>) and F32RowsWide (march_kernel_f32_wide<...>),
//   on half the rows a pass; any wider SDF the huge class, Bf16RowsHuge
//   (march_kernel_huge<...>, bf16 weights only), whose 64 rows a pass lie
//   in a device-memory scratch (mma_rows.cuh::sdf_rows_huge).  march_body
//   is the same, so the identities hold at every width.
//
// Layout: a march block holds kMarchRays = 4 rays on 512 threads; thread t
// loads and stores slot t & 127 of ray t >> 7, and warp w < 4 runs ray w's
// machinery.  A sweep lays its rows out ray by ray (sweep_rows: 4 n0 rows
// for the initial sweep, 4 n_new for a round's) in passes of the engine's
// value rows, the last pass partial.  At 64 + 4 x 16 a block's sweeps are,
// with bf16 weights, 2 value passes of 128 rows (its 4 rays' 64 stratified
// samples), one value pass of 64 rows per swept round (4 rays x 16 new
// samples), and 8 dual passes of 64 sections and their 64 tangent rows;
// with f32 weights, 4 value passes of 64 rows, the same round passes and 16
// dual passes of 32 sections.  The wide class halves the rows: bf16, 4
// value passes of 64 rows, the same round passes and 16 dual passes of 32
// sections; f32, value passes of 64 rows each run as two of its 32-row
// tile, and 32 dual passes of 16 sections.  The huge class runs the wide
// bf16 class's passes.
#pragma once

#include <type_traits>

#include "mma_rows.cuh"

namespace nrh {

constexpr int NBUF = 128;  // slots of the z / sdf buffer
constexpr int kFixedNew = 16, kFixedRounds = 4;  // the compile-time instances' geometry: 64 + 4 x 16
constexpr float BIG_Z = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMarchRays = kRowsThreads / NBUF;  // rays of a march block

// A march's geometry: n0 stratified samples, then `rounds` rounds of n_new
// samples, n0 + rounds * n_new = NBUF.  Kernel K reads n0 alone, C none;
// the compile-time instances (NN = kFixedNew) read none of it.
struct MarchGeom {
  int n0, rounds, n_new;
};

// The samples a round draws: NN > 0 fixes their count at compile time (the
// kFixedNew instances), NN = 0 reads it at run time.
template <int NN>
struct NewCount {
  int n_rt;
  __host__ __device__ __forceinline__ int n() const { return NN > 0 ? NN : n_rt; }
};

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

// Whether slot 32 q + lane holds an old sample: the first nold = 128 -
// n_new slots (the new samples fill the rest).
__device__ __forceinline__ bool old_slot(int q, int lane, int nold) {
  return q < (nold >> 5) || (q == (nold >> 5) && lane < (nold & 31));
}

// Sort the ray's [old ascending (BIG_Z pad included) | new descending] row
// ascending, moving the payload s with z.  sz and ss are the warp's 128-slot
// scratch.
//   Bitonic: the 7-stage network (partner k ^ dd; the upper slot of a pair
//   keeps the larger value; ties stay put): dd = 64 and 32 pair columns
//   j ^ 2 and j ^ 1, dd <= 16 lanes l ^ dd.  [ascending | descending] is
//   bitonic wherever the split lies, so it sorts any n_new.
//   Rank: each element goes straight to its rank in a stable old-before-new
//   merge: old i to i + #{new < old_i}, new j (descending; slot 128 - n_new
//   + j) to n_new - 1 - j + #{old <= new_j}, as _rank_merge's shift network
//   places them.  The z row equals the bitonic one; the payload differs only
//   among tied z.
template <bool RANK, int NN>
__device__ void warp_merge128(float (&z)[4], float (&s)[4], float* sz, float* ss, NewCount<NN> nn) {
  const int lane = threadIdx.x & 31;
  if (RANK) {
    const int n_new = nn.n(), nold = NBUF - n_new, qn = nold >> 5;
    int up[4] = {0, 0, 0, 0}, cnew[4] = {0, 0, 0, 0};
#pragma unroll
    for (int qc = 0; qc < 4; ++qc) {
      if (qc < qn) continue;  // column qc holds no new sample
      for (int l = qc == qn ? nold & 31 : 0; l < 32; ++l) {
        const float nv = __shfl_sync(kFull, z[qc], l);  // new sample 32 qc + l - nold
        int c = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          up[q] += nv < z[q];
          c += __popc(__ballot_sync(kFull, z[q] <= nv && old_slot(q, lane, nold)));
        }
        if (lane == l) cnew[qc] = c;
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 32 * q + lane;
      const int dest = old_slot(q, lane, nold) ? k + up[q] : n_new - 1 - (k - nold) + cnew[q];
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
// at inv_s -> the n_new new samples in descending order, sample j in out[j
// >> 5] of lane j & 31 (0 elsewhere).  oo = |o|^2, od = o . d.  sz and sc
// are the warp's 128-slot scratch.
template <int NN>
__device__ void warp_draw_new_z(const float (&z)[4], const float (&s)[4], int vn, float inv_s, float oo, float od,
                                float* sz, float* sc, NewCount<NN> nn, float (&out)[4]) {
  const int lane = threadIdx.x & 31, n_new = nn.n();
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
  // inds of sample j (column j >> 5, lane j & 31): the slots whose cdf (2
  // past the valid ones) <= u_j.
  int inds[4] = {0, 0, 0, 0};
#pragma unroll
  for (int qc = 0; qc < 4; ++qc) {
    if (32 * qc >= n_new) break;
    for (int l = 0; l < min(n_new - 32 * qc, 32); ++l) {
      const float u = 1.0f - (float)(32 * qc + l) / (float)(n_new - 1);
      int c = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) c += __popc(__ballot_sync(kFull, (32 * q + lane < vn ? cdf[q] : 2.0f) <= u));
      if (lane == l) inds[qc] = c;
    }
  }
  __syncwarp();
#pragma unroll
  for (int qc = 0; qc < 4; ++qc) {
    const int j = 32 * qc + lane;
    out[qc] = 0.0f;
    if (32 * qc < n_new && j < n_new) {
      const float u = 1.0f - (float)j / (float)(n_new - 1);
      const int below = max(inds[qc] - 1, 0), above = min(inds[qc], vn - 1);
      const float cb = sc[below], zb = sz[below], ca = sc[above], za = sz[above];
      float den = ca - cb;
      if (den < 1e-5f) den = 1.0f;
      const float t = (u - cb) / den;
      out[qc] = zb + t * (za - zb);
    }
  }
  __syncwarp();
}

// The drawn samples (sample j in column j >> 5, lane j & 31) moved to the
// slots they merge into, 128 - n_new + j: pz[q] is slot 32 q + lane's (0 in
// the old slots).  Where n_new divides 32 they all lie in column 3 and one
// shuffle moves them (lane & (n_new - 1) = j there); otherwise they go
// through the warp's 128-slot scratch sc.
template <int NN>
__device__ __forceinline__ void samples_to_slots(const float (&nz)[4], float (&pz)[4], NewCount<NN> nn, float* sc) {
  const int lane = threadIdx.x & 31, n_new = nn.n(), nold = NBUF - n_new;
#pragma unroll
  for (int q = 0; q < 4; ++q) pz[q] = 0.0f;
  if (32 % n_new == 0) {
    pz[3] = __shfl_sync(kFull, nz[0], lane & (n_new - 1));
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (32 * q + lane < n_new) sc[32 * q + lane] = nz[q];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (!old_slot(q, lane, nold)) pz[q] = sc[32 * q + lane - nold];
  __syncwarp();
}

// Merge n_new new samples into the ray's buffer: slot 128 - n_new + j
// brings new sample j (descending) in (pz, ps as samples_to_slots lays them
// out); old slots vn.. become BIG_Z padding.
template <bool RANK, int NN>
__device__ __forceinline__ void merge_new(float (&z)[4], float (&s)[4], int vn, const float (&pz)[4],
                                          const float (&ps)[4], float* sz, float* ss, NewCount<NN> nn) {
  const int lane = threadIdx.x & 31, nold = NBUF - nn.n();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!old_slot(q, lane, nold)) {
      z[q] = pz[q];
      s[q] = ps[q];
    } else if (32 * q + lane >= vn) {
      z[q] = BIG_Z;
    }
  }
  warp_merge128<RANK>(z, s, sz, ss, nn);
}

// One machinery step of one ray on one warp, as one _round_machinery_kernel
// step: merge_vn >= 0 merges the previous round's samples in first (pz, ps
// as merge_new); draw_vn >= 0 then draws the next n_new samples from
// draw_vn valid slots at inv_s into nz (as warp_draw_new_z; 0 without a
// draw); `last` then merges those in with a zero sdf, as _rounds_xla's tail
// step does after the last round, whose samples are never swept.  sz, ss,
// sc: the warp's 128-slot scratch.  Ends with __syncwarp.
template <bool RANK, int NN>
__device__ void ray_step(float (&z)[4], float (&s)[4], int merge_vn, const float (&pz)[4], const float (&ps)[4],
                         int draw_vn, float inv_s, float oo, float od, bool last, float* sz, float* ss, float* sc,
                         NewCount<NN> nn, float (&nz)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) nz[q] = 0.0f;
  if (merge_vn >= 0) merge_new<RANK>(z, s, merge_vn, pz, ps, sz, ss, nn);
  if (draw_vn < 0) return;
  warp_draw_new_z(z, s, draw_vn, inv_s, oo, od, sz, sc, nn, nz);
  if (last) {
    float mz[4];
    const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    samples_to_slots(nz, mz, nn, sc);
    merge_new<RANK>(z, s, draw_vn, mz, zero, sz, ss, nn);
  }
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

// The wide class of each (mma_rows.cuh::RowsWide): padded widths up to
// kWideWMax, encodings up to kWideEncMax.  bf16: 64-row value passes and 32
// sections a dual pass.  f32: a value sweep of 64 rows runs as two passes
// of the 32-row tile (the points and outputs keep 64 rows), 16 sections a
// dual pass.
struct Bf16RowsWide {
  using Smem = RowsTile<RowsWide>;
  using W = bf16;
  static constexpr int kValueRows = RowsWide::kRows;
  static constexpr int kSections = RowsWide::kRows / 2;
  template <int ROWS>
  static __device__ __forceinline__ void values(Smem& S, const W* wpack, const float* bpack, const float* w_sdf,
                                                const SdfMeta& m, float scale) {
    static_assert(ROWS == kValueRows, "the wide bf16 engine runs 64-row passes");
    sdf_rows<false, 2>(S, nullptr, wpack, bpack, w_sdf, m, scale);
  }
  static __device__ __forceinline__ void dual(Smem& S, const float* dir, const W* wpack, const float* bpack,
                                              const float* w_sdf, const SdfMeta& m, float scale) {
    sdf_rows<true, 2>(S, dir, wpack, bpack, w_sdf, m, scale);
  }
};

struct F32RowsWide {
  using Smem = RowsTileF32<RowsWide>;
  using W = float;
  static constexpr int kValueRows = kRowsF32;
  static constexpr int kSections = RowsWide::kRowsF / 2;
  template <int ROWS>
  static __device__ __forceinline__ void values(Smem& S, const W* wpack, const float* bpack, const float* w_sdf,
                                                const SdfMeta& m, float scale) {
    static_assert(ROWS == kValueRows, "a value sweep of the wide f32 engine takes 64 rows");
    for (int row0 = 0; row0 < ROWS; row0 += RowsWide::kRowsF)
      sdf_rows_f32<false>(S, nullptr, wpack, bpack, w_sdf, m, scale, row0);
  }
  static __device__ __forceinline__ void dual(Smem& S, const float* dir, const W* wpack, const float* bpack,
                                              const float* w_sdf, const SdfMeta& m, float scale) {
    sdf_rows_f32<true>(S, dir, wpack, bpack, w_sdf, m, scale);
  }
};

// The huge class (mma_rows.cuh::RowsHuge): any padded width and encoding,
// bf16 weights; 64-row value passes and 32 sections a dual pass, as the wide
// bf16 class, the rows in the block's part of a device-memory scratch
// (Smem::rows, set by march_kernel_huge).
struct Bf16RowsHuge {
  using Smem = RowsHugeTile;
  using W = bf16;
  static constexpr int kValueRows = RowsHuge::kRows;
  static constexpr int kSections = RowsHuge::kRows / 2;
  template <int ROWS>
  static __device__ __forceinline__ void values(Smem& S, const W* wpack, const float* bpack, const float* w_sdf,
                                                const SdfMeta& m, float scale) {
    static_assert(ROWS == kValueRows, "the huge engine runs 64-row passes");
    sdf_rows_huge<false>(S, nullptr, wpack, bpack, w_sdf, m, scale);
  }
  static __device__ __forceinline__ void dual(Smem& S, const float* dir, const W* wpack, const float* bpack,
                                              const float* w_sdf, const SdfMeta& m, float scale) {
    sdf_rows_huge<true>(S, dir, wpack, bpack, w_sdf, m, scale);
  }
};

template <class Engine>
struct MarchSmem {
  static constexpr int R = kMarchRays;
  typename Engine::Smem t;
  float sz[R][NBUF], ss[R][NBUF];  // each ray's buffer (z, sdf), and its machinery's scratch with sc
  float sc[R][NBUF];
  float dists[R][NBUF], logs[R][NBUF];
  float new_z[R][NBUF], new_s[R][NBUF];  // a round's samples and their sdf, sample j at [ray][j]
  float wt[kRowsThreads / 32];
  float ro[R][3], rd[R][3];
};

// The SDF of the block's rays at per depths a ray, zs[ray][j] for j < per ->
// out[ray][j]: row r of the sweep is depth r % per of ray r / per, in passes
// of the engine's kValueRows rows, a pass of 64 where at most 64 remain (the
// bf16 engine's passes hold 128); a last pass's spare rows repeat the last
// point.  A row's floats do not depend on its pass or its place in one.
// PER > 0 is per at compile time (the 64 + 4 x 16 instances): where it
// fills whole passes, only those are compiled.
template <int PER, class Engine>
__device__ __forceinline__ void sweep_rows(MarchSmem<Engine>& S, const float (*zs)[NBUF], int per,
                                           float (*out)[NBUF], const typename Engine::W* __restrict__ wpack,
                                           const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                                           const SdfMeta& m, float scale) {
  constexpr int kVal = Engine::kValueRows;
  constexpr bool kWholePasses = PER > 0 && kMarchRays * PER % kVal == 0;
  const int tid = threadIdx.x, rows = kMarchRays * per;
  for (int r0 = 0; r0 < rows; r0 += kVal) {
    const bool full = kWholePasses || (kVal > 64 && rows - r0 > 64);
    if (tid < (full ? kVal : 64) * 3) {
      const int r = tid / 3, j = tid % 3, g = min(r0 + r, rows - 1), hr = g / per;
      S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * zs[hr][g % per];
    }
    __syncthreads();
    if (full)
      Engine::template values<kVal>(S.t, wpack, bpack, w_sdf, m, scale);
    else
      Engine::template values<64>(S.t, wpack, bpack, w_sdf, m, scale);
    if (tid < min(rows - r0, kVal)) out[(r0 + tid) / per][(r0 + tid) % per] = S.t.sdf[tid];
    __syncthreads();
  }
}

// Kernel arguments: z_in is z0 [b, n0] (SWEEP or ROUNDS) or the refined
// buffer [b, 128] (kernel C); sdf0_in [b, n0] (ROUNDS without SWEEP); sdist
// [b, 1], inv_s and anneal (device scalars) with FINAL.  out: sdf0 [b, n0]
// (SWEEP alone), z [b, 128] (ROUNDS without FINAL) or tau [b, 1] (FINAL).
// g: the march's geometry, its n_new nn.n() (NN > 0: the constant NN).
template <class Engine, bool SWEEP, bool ROUNDS, bool FINAL, bool RANK, int NN>
__device__ __forceinline__ void march_body(const float* __restrict__ z_in, const float* __restrict__ sdf0_in,
                                           const float* __restrict__ o, const float* __restrict__ d,
                                           const float* __restrict__ sdist,
                                           const typename Engine::W* __restrict__ wpack,
                                           const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                                           const float* __restrict__ inv_s_ptr, const float* __restrict__ anneal_ptr,
                                           float* __restrict__ out, int b, const SdfMeta& m, float scale,
                                           float base_inv_s, const MarchGeom& g) {
  constexpr int RPB = kMarchRays, kSec = Engine::kSections;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MarchSmem<Engine>& S = *reinterpret_cast<MarchSmem<Engine>*>(smem_raw);
  const int tid = threadIdx.x, h = tid >> 7, k = tid & (NBUF - 1), warp = tid >> 5, lane = tid & 31;
  const int ray = blockIdx.x * RPB + h;
  const bool live = ray < b;
  const int rl = live ? ray : b - 1;  // the last block's spare rays repeat the last ray
  // The geometry: the constant 64 + 4 x 16 where NN > 0, else g's.
  const int n0 = NN > 0 ? NBUF - kFixedRounds * NN : g.n0, n_rounds = NN > 0 ? kFixedRounds : g.rounds;
  const NewCount<NN> nn{g.n_new};
  if (k < 3) {
    S.ro[h][k] = o[rl * 3 + k];
    S.rd[h][k] = d[rl * 3 + k];
  }
  float zk, sk = 0.0f;
  if (SWEEP || ROUNDS)
    zk = k < n0 ? z_in[(size_t)rl * n0 + k] : BIG_Z;
  else
    zk = z_in[(size_t)rl * NBUF + k];
  S.sz[h][k] = zk;
  __syncthreads();

  if constexpr (SWEEP) {
    // Initial sweep: the block's 4 n0 stratified samples, ray by ray, into
    // the sdf buffer S.ss.
    sweep_rows<(NN > 0 ? NBUF - kFixedRounds * NN : 0)>(S, S.sz, n0, S.ss, wpack, bpack, w_sdf, m, scale);
    if (k < n0) sk = S.ss[h][k];
    if (!ROUNDS) {
      if (live && k < n0) out[(size_t)ray * n0 + k] = sk;
      return;
    }
  } else if (ROUNDS) {
    if (k < n0) sk = sdf0_in[(size_t)rl * n0 + k];
  }

  if (ROUNDS) {
    // _refine_rounds: round i draws n_new samples at inv_s = base * 2^i
    // from vn = n0 + n_new i valid slots, sweeps them (not in the last
    // round: that sdf is a payload no one reads) and merges them in.  Warp
    // w < RPB runs ray w's machinery, kernel B's ray_step (a round's merge
    // and the next draw; the last round's samples merged with it), on the
    // buffer it keeps in S.sz[w], S.ss[w] between rounds; the other warps
    // wait at the barrier that follows.  A round's sweep rows are the
    // block's rays' new samples, ray by ray (sweep_rows), its sdf S.new_s.
    S.ss[h][k] = sk;
    __syncthreads();
    const int n_new = nn.n(), nold = NBUF - n_new;
    for (int i = 0; i < n_rounds; ++i) {
      const int vn = n0 + i * n_new;
      const bool last = i + 1 == n_rounds;
      if (warp < RPB) {
        float zr[4], sr[4], pz[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ps[4] = {0.0f, 0.0f, 0.0f, 0.0f}, nz[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          zr[q] = S.sz[warp][32 * q + lane];
          sr[q] = S.ss[warp][32 * q + lane];
          if (i > 0 && !old_slot(q, lane, nold)) {
            pz[q] = S.new_z[warp][32 * q + lane - nold];
            ps[q] = S.new_s[warp][32 * q + lane - nold];
          }
        }
        const float* ro = S.ro[warp];
        const float* rd = S.rd[warp];
        const float oo = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2];
        const float od = ro[0] * rd[0] + ro[1] * rd[1] + ro[2] * rd[2];
        __syncwarp();
        ray_step<RANK>(zr, sr, i == 0 ? -1 : vn - n_new, pz, ps, vn, base_inv_s * ldexpf(1.0f, i), oo, od, last,
                       S.sz[warp], S.ss[warp], S.sc[warp], nn, nz);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (32 * q + lane < n_new) S.new_z[warp][32 * q + lane] = nz[q];
          S.sz[warp][32 * q + lane] = zr[q];
          S.ss[warp][32 * q + lane] = sr[q];
        }
      }
      __syncthreads();
      if (last) break;
      sweep_rows<NN>(S, S.new_z, n_new, S.new_s, wpack, bpack, w_sdf, m, scale);
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
      float base_inv_s, const MarchGeom g
#define NRH_MARCH_ARGS \
  z_in, sdf0_in, o, d, sdist, wpack, bpack, w_sdf, inv_s_ptr, anneal_ptr, out, b, m, scale, base_inv_s, g

// The bf16 instances (kernels C, K, L, M and N) and the f32 ones, the wide
// class's of each, and the huge class's bf16 ones; NN = kFixedNew for the
// compile-time geometry, 0 for the run-time one.
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK, int NN>
__global__ void __launch_bounds__(kRowsThreads) march_kernel(NRH_MARCH_PARAMS(bf16)) {
  march_body<Bf16Rows, SWEEP, ROUNDS, FINAL, RANK, NN>(NRH_MARCH_ARGS);
}
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK, int NN>
__global__ void __launch_bounds__(kRowsThreads) march_kernel_f32(NRH_MARCH_PARAMS(float)) {
  march_body<F32Rows, SWEEP, ROUNDS, FINAL, RANK, NN>(NRH_MARCH_ARGS);
}
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK, int NN>
__global__ void __launch_bounds__(kRowsThreads) march_kernel_wide(NRH_MARCH_PARAMS(bf16)) {
  march_body<Bf16RowsWide, SWEEP, ROUNDS, FINAL, RANK, NN>(NRH_MARCH_ARGS);
}
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK, int NN>
__global__ void __launch_bounds__(kRowsThreads) march_kernel_f32_wide(NRH_MARCH_PARAMS(float)) {
  march_body<F32RowsWide, SWEEP, ROUNDS, FINAL, RANK, NN>(NRH_MARCH_ARGS);
}
// The huge class's: rows is the scratch of every block's kRows rows,
// huge_row(m) floats each (core_mlp.march_layout).
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK, int NN>
__global__ void __launch_bounds__(kRowsThreads) march_kernel_huge(NRH_MARCH_PARAMS(bf16), float* __restrict__ rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if (threadIdx.x == 0)  // read after march_body's first barrier
    reinterpret_cast<MarchSmem<Bf16RowsHuge>*>(smem_raw)->t.rows =
        rows + (size_t)blockIdx.x * RowsHuge::kRows * huge_row(m);
  march_body<Bf16RowsHuge, SWEEP, ROUNDS, FINAL, RANK, NN>(NRH_MARCH_ARGS);
}
#undef NRH_MARCH_PARAMS
#undef NRH_MARCH_ARGS

// Whether an instance takes geometry g: the compile-time instances (NN > 0)
// 64 + 4 x 16 alone; the run-time ones K any n0 of the range (2 to 126),
// the rounds rounds >= 1, n_new >= 2, n0 >= 2 and n0 + rounds n_new = NBUF.
template <bool SWEEP, bool ROUNDS, int NN>
__host__ __device__ inline bool takes_geometry(const MarchGeom& g) {
  const int n0_fixed = NBUF - kFixedRounds * NN;
  if (ROUNDS)
    return NN > 0 ? g.n0 == n0_fixed && g.rounds == kFixedRounds && g.n_new == NN
                  : g.rounds >= 1 && g.n_new >= 2 && g.n0 >= 2 && g.n0 + g.rounds * g.n_new == NBUF;
  return !SWEEP || (NN > 0 ? g.n0 == n0_fixed : g.n0 >= 2 && g.n0 <= NBUF - 2);
}

// The engine of each weight type (F32) and width class (Cls: RowsNarrow,
// RowsWide, RowsHuge; the huge class is bf16 only).
template <bool F32, class Cls>
struct MarchEngine;
template <>
struct MarchEngine<false, RowsNarrow> {
  using type = Bf16Rows;
};
template <>
struct MarchEngine<true, RowsNarrow> {
  using type = F32Rows;
};
template <>
struct MarchEngine<false, RowsWide> {
  using type = Bf16RowsWide;
};
template <>
struct MarchEngine<true, RowsWide> {
  using type = F32RowsWide;
};
template <>
struct MarchEngine<false, RowsHuge> {
  using type = Bf16RowsHuge;
};

// One launch on `stream` of the bf16 instance, or with F32 the f32 one
// (wpack then holds f32 weights), of width class Cls (RowsNarrow, RowsWide
// or RowsHuge; meta checked against its limits; meta_dev its copy on the
// card, null up to kMaxLayers layers), at geometry g (checked,
// takes_geometry); returns its launch error.  The huge class also takes
// rows, its device-memory scratch (march_kernel_huge; null is refused).
// Each instantiation compiles one class's kernel only, so the classes'
// sources build apart.
template <bool F32, bool SWEEP, bool ROUNDS, bool FINAL, bool RANK, int NN = kFixedNew, class Cls = RowsNarrow>
inline int launch_march(const float* z_in, const float* sdf0_in, const float* o, const float* d,
                        const float* sdist, const void* wpack, const float* bpack, const float* w_sdf,
                        const float* inv_s, const float* anneal, float* out, int b, const int* meta,
                        const int* meta_dev, float scale, float base_inv_s, const MarchGeom& g, void* stream,
                        float* rows = nullptr) {
  using Engine = typename MarchEngine<F32, Cls>::type;
  using W = typename Engine::W;
  constexpr bool kIsWide = std::is_same<Cls, RowsWide>::value, kIsHuge = std::is_same<Cls, RowsHuge>::value;
  SdfMeta m;
  int rc = parse_meta(meta, meta_dev, &m, kIsWide, kIsHuge);
  if (rc) return rc;
  if (!takes_geometry<SWEEP, ROUNDS, NN>(g)) return (int)cudaErrorInvalidValue;
  if (b <= 0) return 0;
  if (kIsHuge && !rows) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(MarchSmem<Engine>);
  if constexpr (kIsHuge) {
    const auto kernel = march_kernel_huge<SWEEP, ROUNDS, FINAL, RANK, NN>;
    rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
    kernel<<<(b + kMarchRays - 1) / kMarchRays, kRowsThreads, smem, (cudaStream_t)stream>>>(
        z_in, sdf0_in, o, d, sdist, (const W*)wpack, bpack, w_sdf, inv_s, anneal, out, b, m, scale, base_inv_s, g,
        rows);
  } else {
    void (*kernel)(const float*, const float*, const float*, const float*, const float*, const W*, const float*,
                   const float*, const float*, const float*, float*, int, const SdfMeta, float, float,
                   const MarchGeom);
    if constexpr (F32 && kIsWide)
      kernel = march_kernel_f32_wide<SWEEP, ROUNDS, FINAL, RANK, NN>;
    else if constexpr (F32)
      kernel = march_kernel_f32<SWEEP, ROUNDS, FINAL, RANK, NN>;
    else if constexpr (kIsWide)
      kernel = march_kernel_wide<SWEEP, ROUNDS, FINAL, RANK, NN>;
    else
      kernel = march_kernel<SWEEP, ROUNDS, FINAL, RANK, NN>;
    rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
    kernel<<<(b + kMarchRays - 1) / kMarchRays, kRowsThreads, smem, (cudaStream_t)stream>>>(
        z_in, sdf0_in, o, d, sdist, (const W*)wpack, bpack, w_sdf, inv_s, anneal, out, b, m, scale, base_inv_s, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace nrh
