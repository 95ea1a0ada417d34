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
// * Two sweep paths for the 8x256 SDF MLP, bf16 weights and activations,
//   f32 biases and nonlinearities, as _mlp_sdf_3d (:87) computes the value.
//   Both give every row the same floats bit for bit.
//   - mma_rows.cuh::sdf_rows (C, K, M, N): up to 128 rows on 4-ray blocks
//     of 512 threads, the weights staged through a cp.async ring of 64-row
//     slabs, fragments by ldmatrix into mma.sync, the epilogue in
//     registers; in dual mode also the forward-mode tangent of
//     _mlp_sdf_dirderiv_3d (:117) that the final sweep needs.
//   - sdf_tile (L alone): the value on 32-row tiles on 2-ray blocks of 256
//     threads; its bf16 activations ping-pong in shared memory, and each
//     warp loads every WMMA weight fragment it needs from global memory.
//     It and TileSmem go when L moves to the row engine.
// * march_kernel, one template for the fused marches: <SWEEP, ROUNDS, FINAL,
//   RANK, WIDE> selects the initial 64-sample sweep, the 4 refinement rounds
//   (each drawing 16 samples, sweeping them but the last, and merging them),
//   the final dual sweep with the transmittance (WIDE only), the merge, and
//   the sweep path (WIDE: sdf_rows).  Kernel C (final sweep of a refined
//   buffer), K (sweep), L (rounds), M (sweep + rounds) and N (sweep + rounds
//   + final) are its instances, all WIDE but L, so M's z is L(K(.)) bit for
//   bit and N's tau is C(M(.)) bit for bit.
//
// Layout: a march block holds RPB rays (4 when WIDE, 2 for L) on 128 RPB
// threads; thread t works slot t & 127 of ray t >> 7 in the machinery, so
// every __syncthreads is reached by all rays' threads together.  A WIDE
// block's sweeps are 2 value passes of 128 rows (its 4 rays' 64 stratified
// samples), one value pass of 64 rows per swept round (4 rays x 16 new
// samples), and 8 dual passes of 64 sections and their 64 tangent rows.
// L's sdf_tile sweep is 32 rows: the 16 new samples of both its rays.
#pragma once

#include "mma_rows.cuh"

namespace nrh {

constexpr int NBUF = 128;  // slots of the z / sdf buffer
constexpr int NNEW = 16;   // samples drawn per round
constexpr int NOLD = NBUF - NNEW;
constexpr int kRounds = 4;
constexpr int N0 = NBUF - kRounds * NNEW;  // 64 stratified samples
constexpr float BIG_Z = 1e9f;

constexpr int TPC = 32;  // rows of an sdf_tile sweep tile
constexpr int MTHREADS = 256;  // threads of a 2-ray block (sdf_tile)
constexpr int MWARPS = MTHREADS / 32;
static_assert(2 * NNEW == TPC, "a round's sweep tile holds both rays' new samples");
// Rays per march block: 2 on sdf_tile, 4 on sdf_rows (512 threads).
template <bool WIDE>
__host__ __device__ constexpr int march_rpb() { return WIDE ? kRowsThreads / NBUF : MTHREADS / NBUF; }
static_assert(march_rpb<true>() * NNEW == 64, "a WIDE round's sweep is one 64-row pass");

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
  bf16 h[2][TPC][kLdA];
  float scratch[MWARPS][16 * 16];
  float pts[TPC][3];  // the rows' raw points
  float sdf[TPC];     // out: sdf per row
};

// The SDF MLP's value on the tile's 32 points (S.pts): S.sdf.  Every thread
// of the block calls it; it ends with __syncthreads.
__device__ void sdf_tile(TileSmem& S, const bf16* __restrict__ wpack, const float* __restrict__ bpack,
                         const float* __restrict__ w_sdf, const SdfMeta& m, float scale) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;
  for (int idx = tid; idx < TPC * kEncMax; idx += MTHREADS) {
    const int r = idx / kEncMax, c = idx % kEncMax;
    float xs[3];
    for (int j = 0; j < 3; ++j) xs[j] = S.pts[r][j] * scale;
    S.enc[r][c] = c < d0 ? freq_channel(xs, nullptr, c, F, nullptr) : 0.0f;
  }
  __syncthreads();
  for (int idx = tid; idx < TPC * m.kp[0]; idx += MTHREADS) {
    const int r = idx / m.kp[0], c = idx % m.kp[0];
    S.h[0][r][c] = to_bf16(S.enc[r][c]);
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
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> ah[2];
      for (int r = 0; r < 2; ++r) wmma::fill_fragment(ah[r], 0.0f);
      for (int kt = 0; kt < kp / 16; ++kt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, W + (size_t)kt * 16 * np + nt * 16, np);
        for (int r = 0; r < 2; ++r) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, &S.h[cur][r * 16][kt * 16], kLdA);
          wmma::mma_sync(ah[r], a, bw, ah[r]);
        }
      }
      for (int r = 0; r < 2; ++r) {
        float* sh = S.scratch[warp];
        wmma::store_matrix_sync(sh, ah[r], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = r * 16 + e / 16, c = nt * 16 + e % 16;
          if (c >= out) continue;
          float sp, gate;
          softplus100_gate(sh[e] + b[c], &sp, &gate);
          bf16 hv = to_bf16(sp);
          if (next_skip) hv = to_bf16(bf(hv) * kInvSqrt2);
          S.h[nxt][row][c] = hv;
        }
        __syncwarp();
      }
    }
    // Columns past this layer's output: the skip layer's encoding half
    // (x 1/sqrt2), then zeros up to the next padded width.
    const int tail = kp_next - out;
    for (int idx = tid; idx < TPC * tail; idx += MTHREADS) {
      const int r = idx / tail, c = idx % tail;
      S.h[nxt][r][out + c] = to_bf16(next_skip && c < d0 ? S.enc[r][c] * kInvSqrt2 : 0.0f);
    }
    __syncthreads();
    cur = nxt;
  }

  // The bf16 sdf head, one warp per row: sdf = (h . w_sdf + b_sdf) / scale.
  const float b_sdf = bpack[m.bf_off + m.npf];
  for (int r = warp; r < TPC; r += MWARPS) {
    float s = 0.0f;
    for (int c = lane; c < m.d_last; c += 32) s += bf(S.h[cur][r][c]) * bf(to_bf16(w_sdf[c]));
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) S.sdf[r] = (s + b_sdf) / scale;
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

template <bool WIDE>
struct MarchSmem {
  static constexpr int R = march_rpb<WIDE>();
  typename std::conditional<WIDE, RowsSmem, TileSmem>::type t;
  float sz[R][NBUF], ss[R][NBUF], sc[R][NBUF];  // machinery scratch
  float dists[R][NBUF], logs[R][NBUF];
  float sweep0[R][N0];
  float new_z[R][NNEW], new_sdf[R][NNEW];
  float wt[4 * R];
  int cnt[R][4][NNEW];
  float ro[R][3], rd[R][3];
};

// Kernel arguments: z_in is z0 [b, 64] (SWEEP or ROUNDS) or the refined
// buffer [b, 128] (kernel C); sdf0_in [b, 64] (ROUNDS without SWEEP); sdist
// [b, 1], inv_s and anneal (device scalars) with FINAL.  out: sdf0 [b, 64]
// (SWEEP alone), z [b, 128] (ROUNDS without FINAL) or tau [b, 1] (FINAL).
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK, bool WIDE>
__global__ void __launch_bounds__(march_rpb<WIDE>() * NBUF)
    march_kernel(const float* __restrict__ z_in, const float* __restrict__ sdf0_in,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ sdist, const bf16* __restrict__ wpack,
                 const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                 const float* __restrict__ inv_s_ptr, const float* __restrict__ anneal_ptr,
                 float* __restrict__ out, int b, const SdfMeta m, float scale, float base_inv_s) {
  constexpr int RPB = march_rpb<WIDE>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MarchSmem<WIDE>& S = *reinterpret_cast<MarchSmem<WIDE>*>(smem_raw);
  const int tid = threadIdx.x, h = tid >> 7, k = slot_id();
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
    // Initial sweep: pass p holds the 64 stratified samples of rays 2p and
    // 2p + 1, one row each.
    static_assert(WIDE, "the initial sweep runs on sdf_rows");
    for (int p = 0; p < RPB * N0 / kRowsMax; ++p) {
      if (tid < kRowsMax * 3) {
        const int r = tid / 3, j = tid % 3, hr = 2 * p + r / N0;
        S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * S.sz[hr][r % N0];
      }
      __syncthreads();
      sdf_rows<false, 2>(S.t, nullptr, wpack, bpack, w_sdf, m, scale);
      if (tid < kRowsMax) S.sweep0[2 * p + tid / N0][tid % N0] = S.t.sdf[tid];
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
    // sdf is a payload no one reads) and merges them in.  The sweep's rows
    // are the block's rays' new samples, ray by ray.
    constexpr int kNewRows = RPB * NNEW;
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
        if (tid < kNewRows * 3) {
          const int r = tid / 3, j = tid % 3, hr = r / NNEW;
          S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * S.new_z[hr][r % NNEW];
        }
        __syncthreads();
        if constexpr (WIDE)
          sdf_rows<false, 1>(S.t, nullptr, wpack, bpack, w_sdf, m, scale);
        else
          sdf_tile(S.t, wpack, bpack, w_sdf, m, scale);
        if (tid < kNewRows) S.new_sdf[tid / NNEW][tid % NNEW] = S.t.sdf[tid];
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

  if constexpr (FINAL) {
    // Final sweep of the refined buffer: section midpoints (the last section
    // is the ray's sample_dist long), sdf and d . grad sdf, then
    // tau = exp(sum of the 127 log factors).  Pass t holds 64 sections of
    // ray t / 2 and their tangent rows.
    static_assert(WIDE, "the final dual sweep runs on sdf_rows");
    const float inv_s = *inv_s_ptr, anneal = *anneal_ptr;
    S.dists[h][k] = k == NBUF - 1 ? sdist[rl] : S.sz[h][k + 1] - S.sz[h][k];
    __syncthreads();
    for (int t = 0; t < RPB * NBUF / 64; ++t) {
      const int hr = t / (NBUF / 64), s0 = (t % (NBUF / 64)) * 64;
      if (tid < 64 * 3) {
        const int r = tid / 3, j = tid % 3, kk = s0 + r;
        const float mid = S.sz[hr][kk] + S.dists[hr][kk] * 0.5f;
        S.t.pts[r][j] = S.ro[hr][j] + S.rd[hr][j] * mid;
      }
      __syncthreads();
      sdf_rows<true, 2>(S.t, S.rd[hr], wpack, bpack, w_sdf, m, scale);
      if (tid < 64) {
        const int kk = s0 + tid;
        S.logs[hr][kk] =
            shadow_log_factor(S.t.sdf[tid], S.t.sdf[64 + tid], S.dists[hr][kk], inv_s, anneal, kk == NBUF - 1);
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
template <bool SWEEP, bool ROUNDS, bool FINAL, bool RANK, bool WIDE>
inline int launch_march(const float* z_in, const float* sdf0_in, const float* o, const float* d,
                        const float* sdist, const void* wpack, const float* bpack, const float* w_sdf,
                        const float* inv_s, const float* anneal, float* out, int b, const int* meta,
                        float scale, float base_inv_s, void* stream) {
  SdfMeta m;
  int rc = parse_meta(meta, &m);
  if (rc) return rc;
  if (b <= 0) return 0;
  constexpr int rpb = march_rpb<WIDE>();
  const int smem = (int)sizeof(MarchSmem<WIDE>);
  auto kernel = march_kernel<SWEEP, ROUNDS, FINAL, RANK, WIDE>;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc) return rc;
  kernel<<<(b + rpb - 1) / rpb, rpb * NBUF, smem, (cudaStream_t)stream>>>(
      z_in, sdf0_in, o, d, sdist, (const bf16*)wpack, bpack, w_sdf, inv_s, anneal, out, b, m, scale,
      base_inv_s);
  return (int)cudaGetLastError();
}

}  // namespace nrh
