// Device code of the hierarchical SDF marches, shared by kernels B and C
// (march.cu) and K, L, M and N (march_fused.cu).
//
// * The per-ray round machinery of nrhints_tpu/kernels/march.py: the merge
//   of 16 new (z, sdf) pairs into the sorted 128-slot buffer (merge128: the
//   bitonic network of _bitonic_merge, :165, or the stable rank merge of
//   _rank_merge, :200) and the draw of the next 16 samples (draw_new_z, the
//   NeuS up-sample and deterministic inverse CDF of _round_new_z, :263).
//   Both run on 128 threads per ray, one slot per thread; the prefix sums
//   are warp shuffles, the inverse-CDF counts warp ballots.
// * The tile loop of the march sweeps (sdf_tile): the 8x256 SDF MLP on 32
//   points, bf16 weights and activations, f32 biases and nonlinearities, as
//   _mlp_sdf_3d (:87) computes the value, and with DUAL also the forward-mode
//   tangent of _mlp_sdf_dirderiv_3d (:117).
// * march_kernel, one template for the fused marches: <SWEEP, ROUNDS, FINAL,
//   RANK> selects the initial 64-sample sweep, the 4 refinement rounds (each
//   drawing 16 samples, sweeping them but the last, and merging them), and
//   the final dual sweep with the transmittance.  Kernel C (final sweep of a
//   refined buffer), K (sweep), L (rounds), M (sweep + rounds) and N (sweep +
//   rounds + final) are its instances, so M's z is L(K(.)) bit for bit and
//   N's tau is C(M(.)) bit for bit.
//
// Layout: a march block holds two rays on 256 threads; thread t works slot
// t & 127 of ray t >> 7 in the machinery, so every __syncthreads is reached
// by both rays' threads together.  A sweep tile is 32 rows: 32 samples of
// one ray (initial and final sweeps) or the 16 new samples of both rays (a
// round).  Its bf16 activations ping-pong in shared memory; each warp owns
// 16-column output tiles of both 16-row halves, so every weight fragment it
// loads from global memory (L2) feeds two WMMA products (four with DUAL).
#pragma once

#include "sdf_mlp.cuh"

namespace nrh {

constexpr int NBUF = 128;  // slots of the z / sdf buffer
constexpr int NNEW = 16;   // samples drawn per round
constexpr int NOLD = NBUF - NNEW;
constexpr int kRounds = 4;
constexpr int N0 = NBUF - kRounds * NNEW;  // 64 stratified samples
constexpr float BIG_Z = 1e9f;

constexpr int TPC = 32;  // rows of a sweep tile
constexpr int MTHREADS = 256;
constexpr int MWARPS = MTHREADS / 32;
constexpr int RPB = MTHREADS / NBUF;  // rays per march block
static_assert(RPB * NNEW == TPC, "a round's sweep tile holds both rays' new samples");

// ---------------------------------------------------------------------------
// Machinery: 128 threads per ray.  wt is the ray's 4 warp totals.

__device__ __forceinline__ int slot_id() { return threadIdx.x & (NBUF - 1); }

// Exclusive prefix sum over the ray's 128 slots (4 warps).
__device__ float block_exclusive_scan128(float v, float* wt) {
  const int lane = threadIdx.x & 31, w4 = slot_id() >> 5;
  float inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  float exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = 0.0f;
  if (lane == 31) wt[w4] = inc;
  __syncthreads();
  float base = 0.0f;
  for (int w = 0; w < w4; ++w) base += wt[w];
  __syncthreads();
  return exc + base;
}

// Sum over the ray's 128 slots: xor butterflies in each warp, then
// (w0 + w1) + (w2 + w3).
__device__ float block_sum128(float v, float* wt) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) wt[slot_id() >> 5] = v;
  __syncthreads();
  const float s = (wt[0] + wt[1]) + (wt[2] + wt[3]);
  __syncthreads();
  return s;
}

// Sort the ray's [old ascending (BIG_Z pad included) | new descending] row
// ascending, moving the payload with z; (zk, sk) is this thread's slot, in
// and out.  sz and ss are the ray's 128-slot scratch.
//   Bitonic: the 7-stage network (partner k ^ dd; the upper lane of a pair
//   keeps the larger value; ties stay put).
//   Rank: each element goes straight to its rank in a stable old-before-new
//   merge: old i to i + #{new < old_i}, new j (descending) to 15 - j +
//   #{old <= new_j}, as _rank_merge's shift network places them.  The z row
//   equals the bitonic one; the payload differs only among tied z.
template <bool RANK>
__device__ void merge128(float& zk, float& sk, float* sz, float* ss) {
  const int k = slot_id();
  if (RANK) {
    sz[k] = zk;
    __syncthreads();
    int dest;
    if (k < NOLD) {
      int c = 0;
      for (int j = 0; j < NNEW; ++j) c += sz[NOLD + j] < zk;
      dest = k + c;
    } else {
      int c = 0;
      for (int i = 0; i < NOLD; ++i) c += sz[i] <= zk;
      dest = NNEW - 1 - (k - NOLD) + c;
    }
    __syncthreads();
    sz[dest] = zk;
    ss[dest] = sk;
    __syncthreads();
    zk = sz[k];
    sk = ss[k];
    __syncthreads();
    return;
  }
  for (int dd = NBUF / 2; dd >= 1; dd >>= 1) {
    sz[k] = zk;
    ss[k] = sk;
    __syncthreads();
    const float pz = sz[k ^ dd], ps = ss[k ^ dd];
    const bool take = (k & dd) ? pz > zk : pz < zk;
    if (take) {
      zk = pz;
      sk = ps;
    }
    __syncthreads();
  }
}

// One up-sample round's draw: from the sorted buffer ((zk, sk) per slot,
// vn valid slots) at inv_s, the 16 new samples in descending order into
// new_z[0..15] (written by slots 0-15).  oo = |o|^2, od = o . d.  sz, ss, sc
// are the ray's 128-slot scratch, wt its 4 warp totals, cnt its ballot counts.
__device__ void draw_new_z(float zk, float sk, int vn, float inv_s, float oo, float od, float* sz,
                           float* ss, float* sc, float* wt, int (*cnt)[NNEW], float* new_z) {
  const int k = slot_id(), lane = k & 31, w4 = k >> 5;
  sz[k] = zk;
  ss[k] = sk;
  __syncthreads();
  const float nz = sz[(k + 1) % NBUF], ns = ss[(k + 1) % NBUF];
  const float r2 = oo + 2.0f * od * zk + zk * zk;
  const float r2n = oo + 2.0f * od * nz + nz * nz;
  const float inside = (r2 < 1.0f || r2n < 1.0f) ? 1.0f : 0.0f;
  const float mid = (sk + ns) * 0.5f;
  float cosv = (ns - sk) / (nz - zk + 1e-5f);
  sc[k] = cosv;
  __syncthreads();
  const float prev = k == 0 ? 0.0f : sc[k - 1];
  cosv = fminf(prev, cosv);
  cosv = fminf(fmaxf(cosv, -1e3f), 0.0f) * inside;
  const float dist = nz - zk;
  const float pc = sigmoidf((mid - cosv * dist * 0.5f) * inv_s);
  const float nc = sigmoidf((mid + cosv * dist * 0.5f) * inv_s);
  const bool ivalid = k < vn - 1;
  const float alpha = ivalid ? fminf((pc - nc + 1e-5f) / (pc + 1e-5f), 1.0f) : 0.0f;
  const float w = alpha * expf(block_exclusive_scan128(logf(1.0f - alpha + 1e-7f), wt));
  float pdf = ivalid ? w + 1e-5f : 0.0f;
  pdf = pdf / block_sum128(pdf, wt);
  const float cdf = block_exclusive_scan128(pdf, wt);
  const float cdf_cnt = k < vn ? cdf : 2.0f;
  sc[k] = cdf;
  for (int j = 0; j < NNEW; ++j) {
    const float u = 1.0f - (float)j / (float)(NNEW - 1);
    const unsigned ball = __ballot_sync(0xffffffffu, cdf_cnt <= u);
    if (lane == 0) cnt[w4][j] = __popc(ball);
  }
  __syncthreads();
  if (k < NNEW) {
    const int inds = cnt[0][k] + cnt[1][k] + cnt[2][k] + cnt[3][k];
    const float u = 1.0f - (float)k / (float)(NNEW - 1);
    const int below = max(inds - 1, 0), above = min(inds, vn - 1);
    const float cb = sc[below], zb = sz[below], ca = sc[above], za = sz[above];
    float den = ca - cb;
    if (den < 1e-5f) den = 1.0f;
    const float t = (u - cb) / den;
    new_z[k] = zb + t * (za - zb);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Sweep tiles

struct TileSmem {
  float enc[TPC][kEncMax];
  float tenc[TPC][kEncMax];
  bf16 h[2][TPC][kLdA];
  bf16 th[2][TPC][kLdA];
  float scratch[MWARPS][2][16 * 16];
  float pts[TPC][3];  // the rows' raw points
  float dir[TPC][3];  // the rows' directions (DUAL)
  float sdf[TPC];     // out: sdf per row
  float dsdf[TPC];    // out: dir . grad sdf per row (DUAL)
};

// The SDF MLP on the tile's 32 points (S.pts): S.sdf, and with DUAL the
// directional derivative along S.dir by one forward-mode tangent (the
// tangent multiplied by the f32 gate before its bf16 rounding).  Every
// thread of the block calls it; it ends with __syncthreads.
template <bool DUAL>
__device__ void sdf_tile(TileSmem& S, const bf16* __restrict__ wpack, const float* __restrict__ bpack,
                         const float* __restrict__ w_sdf, const SdfMeta& m, float scale) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;
  for (int idx = tid; idx < TPC * kEncMax; idx += MTHREADS) {
    const int r = idx / kEncMax, c = idx % kEncMax;
    float xs[3], ts[3];
    for (int j = 0; j < 3; ++j) {
      xs[j] = S.pts[r][j] * scale;
      ts[j] = DUAL ? S.dir[r][j] * scale : 0.0f;
    }
    float t = 0.0f, v = 0.0f;
    if (c < d0) v = freq_channel(xs, ts, c, F, DUAL ? &t : nullptr);
    S.enc[r][c] = v;
    if (DUAL) S.tenc[r][c] = t;
  }
  __syncthreads();
  for (int idx = tid; idx < TPC * m.kp[0]; idx += MTHREADS) {
    const int r = idx / m.kp[0], c = idx % m.kp[0];
    S.h[0][r][c] = to_bf16(S.enc[r][c]);
    if (DUAL) S.th[0][r][c] = to_bf16(S.tenc[r][c]);
  }
  __syncthreads();

  int cur = 0;
  for (int i = 0; i < L; ++i) {
    const int kp = m.kp[i], np = m.np_[i], out = m.out_dim[i];
    const bf16* W = wpack + m.w_off[i];
    const float* b = bpack + m.b_off[i];
    const bool next_skip = i + 1 < L && m.skip[i + 1];
    const int kp_next = i + 1 < L ? m.kp[i + 1] : ((m.d_last + 15) / 16) * 16;
    const int nxt = cur ^ 1;
    for (int nt = warp; nt < np / 16; nt += MWARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> ah[2], at[2];
      for (int r = 0; r < 2; ++r) {
        wmma::fill_fragment(ah[r], 0.0f);
        if (DUAL) wmma::fill_fragment(at[r], 0.0f);
      }
      for (int kt = 0; kt < kp / 16; ++kt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, W + (size_t)kt * 16 * np + nt * 16, np);
        for (int r = 0; r < 2; ++r) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, &S.h[cur][r * 16][kt * 16], kLdA);
          wmma::mma_sync(ah[r], a, bw, ah[r]);
          if (DUAL) {
            wmma::load_matrix_sync(a, &S.th[cur][r * 16][kt * 16], kLdA);
            wmma::mma_sync(at[r], a, bw, at[r]);
          }
        }
      }
      for (int r = 0; r < 2; ++r) {
        float* sh = S.scratch[warp][0];
        float* st = S.scratch[warp][1];
        wmma::store_matrix_sync(sh, ah[r], 16, wmma::mem_row_major);
        if (DUAL) wmma::store_matrix_sync(st, at[r], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = r * 16 + e / 16, c = nt * 16 + e % 16;
          if (c >= out) continue;
          float sp, gate;
          softplus100_gate(sh[e] + b[c], &sp, &gate);
          bf16 hv = to_bf16(sp);
          if (next_skip) hv = to_bf16(bf(hv) * kInvSqrt2);
          S.h[nxt][row][c] = hv;
          if (DUAL) {
            bf16 tv = to_bf16(st[e] * gate);
            if (next_skip) tv = to_bf16(bf(tv) * kInvSqrt2);
            S.th[nxt][row][c] = tv;
          }
        }
        __syncwarp();
      }
    }
    // Columns past this layer's output: the skip layer's encoding half
    // (x 1/sqrt2), then zeros up to the next padded width.
    const int tail = kp_next - out;
    for (int idx = tid; idx < TPC * tail; idx += MTHREADS) {
      const int r = idx / tail, c = idx % tail;
      const bool e = next_skip && c < d0;
      S.h[nxt][r][out + c] = to_bf16(e ? S.enc[r][c] * kInvSqrt2 : 0.0f);
      if (DUAL) S.th[nxt][r][out + c] = to_bf16(e ? S.tenc[r][c] * kInvSqrt2 : 0.0f);
    }
    __syncthreads();
    cur = nxt;
  }

  // The bf16 sdf head, one warp per row: sdf = (h . w_sdf + b_sdf) / scale,
  // dsdf = (th . w_sdf) / scale.
  const float b_sdf = bpack[m.bf_off + m.npf];
  for (int r = warp; r < TPC; r += MWARPS) {
    float s = 0.0f, ds = 0.0f;
    for (int c = lane; c < m.d_last; c += 32) {
      const float wv = bf(to_bf16(w_sdf[c]));
      s += bf(S.h[cur][r][c]) * wv;
      if (DUAL) ds += bf(S.th[cur][r][c]) * wv;
    }
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      if (DUAL) ds += __shfl_xor_sync(0xffffffffu, ds, off);
    }
    if (lane == 0) {
      S.sdf[r] = (s + b_sdf) / scale;
      if (DUAL) S.dsdf[r] = ds / scale;
    }
  }
  __syncthreads();
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

struct MarchSmem {
  TileSmem t;
  float sz[RPB][NBUF], ss[RPB][NBUF], sc[RPB][NBUF];  // machinery scratch
  float dists[RPB][NBUF], logs[RPB][NBUF];
  float sweep0[RPB][N0];
  float new_z[RPB][NNEW], new_sdf[RPB][NNEW];
  float wt[MWARPS];
  int cnt[RPB][4][NNEW];
  float ro[RPB][3], rd[RPB][3];
};

// Kernel arguments: z_in is z0 [b, 64] (SWEEP or ROUNDS) or the refined
// buffer [b, 128] (kernel C); sdf0_in [b, 64] (ROUNDS without SWEEP); sdist
// [b, 1], inv_s and anneal (device scalars) with FINAL.  out: sdf0 [b, 64]
// (SWEEP alone), z [b, 128] (ROUNDS without FINAL) or tau [b, 1] (FINAL).
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK>
__global__ void __launch_bounds__(MTHREADS)
    march_kernel(const float* __restrict__ z_in, const float* __restrict__ sdf0_in,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ sdist, const bf16* __restrict__ wpack,
                 const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                 const float* __restrict__ inv_s_ptr, const float* __restrict__ anneal_ptr,
                 float* __restrict__ out, int b, const SdfMeta m, float scale, float base_inv_s) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MarchSmem& S = *reinterpret_cast<MarchSmem*>(smem_raw);
  const int tid = threadIdx.x, h = tid >> 7, k = slot_id();
  const int ray = blockIdx.x * RPB + h;
  const bool live = ray < b;
  const int rl = live ? ray : b - 1;  // the last block's spare ray repeats the last ray
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

  if (SWEEP) {
    // Initial sweep: tile t holds 32 stratified samples of ray t / 2.
    for (int t = 0; t < RPB * N0 / TPC; ++t) {
      const int hr = t / (N0 / TPC), s0 = (t % (N0 / TPC)) * TPC;
      if (tid < TPC * 3) {
        const int r = tid / 3, j = tid % 3;
        S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * S.sz[hr][s0 + r];
      }
      __syncthreads();
      sdf_tile<false>(S.t, wpack, bpack, w_sdf, m, scale);
      if (tid < TPC) S.sweep0[hr][s0 + tid] = S.t.sdf[tid];
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
    // sdf is a payload no one reads) and merges them in.
    const float* ro = S.ro[h];
    const float* rd = S.rd[h];
    const float oo = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2];
    const float od = ro[0] * rd[0] + ro[1] * rd[1] + ro[2] * rd[2];
    for (int i = 0; i < kRounds; ++i) {
      const int vn = N0 + i * NNEW;
      const float inv_s = base_inv_s * (float)(1 << i);
      draw_new_z(zk, sk, vn, inv_s, oo, od, S.sz[h], S.ss[h], S.sc[h], S.wt + 4 * h, S.cnt[h],
                 S.new_z[h]);
      if (i + 1 < kRounds) {
        if (tid < TPC * 3) {
          const int r = tid / 3, j = tid % 3, hr = r / NNEW;
          S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * S.new_z[hr][r % NNEW];
        }
        __syncthreads();
        sdf_tile<false>(S.t, wpack, bpack, w_sdf, m, scale);
        if (tid < TPC) S.new_sdf[tid / NNEW][tid % NNEW] = S.t.sdf[tid];
      } else if (k < NNEW) {
        S.new_sdf[h][k] = 0.0f;
      }
      __syncthreads();
      if (k >= NOLD) {
        zk = S.new_z[h][k - NOLD];
        sk = S.new_sdf[h][k - NOLD];
      } else if (k >= vn) {
        zk = BIG_Z;
      }
      merge128<RANK>(zk, sk, S.sz[h], S.ss[h]);
    }
    if (!FINAL) {
      if (live) out[(size_t)ray * NBUF + k] = zk;
      return;
    }
    S.sz[h][k] = zk;
    __syncthreads();
  }

  if (FINAL) {
    // Final sweep of the refined buffer: section midpoints (the last section
    // is the ray's sample_dist long), sdf and d . grad sdf, then
    // tau = exp(sum of the 127 log factors).  Tile t holds 32 sections of ray t / 4.
    const float inv_s = *inv_s_ptr, anneal = *anneal_ptr;
    S.dists[h][k] = k == NBUF - 1 ? sdist[rl] : S.sz[h][k + 1] - S.sz[h][k];
    __syncthreads();
    for (int t = 0; t < RPB * NBUF / TPC; ++t) {
      const int hr = t / (NBUF / TPC), s0 = (t % (NBUF / TPC)) * TPC;
      if (tid < TPC * 3) {
        const int r = tid / 3, j = tid % 3, kk = s0 + r;
        const float mid = S.sz[hr][kk] + S.dists[hr][kk] * 0.5f;
        S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * mid;
        S.t.dir[r][j] = S.rd[hr][j];
      }
      __syncthreads();
      sdf_tile<true>(S.t, wpack, bpack, w_sdf, m, scale);
      if (tid < TPC) {
        const int kk = s0 + tid;
        S.logs[hr][kk] =
            shadow_log_factor(S.t.sdf[tid], S.t.dsdf[tid], S.dists[hr][kk], inv_s, anneal, kk == NBUF - 1);
      }
      __syncthreads();
    }
    float v = S.logs[h][k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) S.wt[tid >> 5] = v;
    __syncthreads();
    if (live && k == 0) {
      float s = 0.0f;
      for (int w = 0; w < 4; ++w) s += S.wt[4 * h + w];
      out[ray] = expf(s);
    }
  }
}

// One launch on `stream`; returns its launch error.
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK>
inline int launch_march(const float* z_in, const float* sdf0_in, const float* o, const float* d,
                        const float* sdist, const void* wpack, const float* bpack, const float* w_sdf,
                        const float* inv_s, const float* anneal, float* out, int b, const int* meta,
                        float scale, float base_inv_s, void* stream) {
  SdfMeta m;
  int rc = parse_meta(meta, &m);
  if (rc) return rc;
  if (b <= 0) return 0;
  const int smem = (int)sizeof(MarchSmem);
  auto kernel = march_kernel<SWEEP, ROUNDS, FINAL, RANK>;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc) return rc;
  kernel<<<(b + RPB - 1) / RPB, MTHREADS, smem, (cudaStream_t)stream>>>(
      z_in, sdf0_in, o, d, sdist, (const bf16*)wpack, bpack, w_sdf, inv_s, anneal, out, b, m, scale,
      base_inv_s);
  return (int)cudaGetLastError();
}

}  // namespace nrh
