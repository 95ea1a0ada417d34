// The per-point chain of the SDF core's backward, shared by kernel E
// (sdf_stash.cu, gates recovered from the stashed bf16 h_i), E's stash_all
// variant (US: u_i and g_enc read from the stash, stage 1's reverse sweep
// skipped) and kernel H (sdf_core_bwd.cu, the f32 gates sigmoid(100 z_i)
// of its own forward pass).  Its stages and design are described in
// sdf_stash.cu.
//
// T is the dot operands' type, S the stash's, as in sdf_fwd.cuh: at
// compute_dtype="float32" the activation tile, the ring, the weights and
// the dW operands in the scratch are f32 (every product on mma_rows.cuh's
// gemm_rows_f32, the dW passes on dw_sum.cuh's f32 tiles) and nothing is
// rounded but what the stash's type S rounds.  H's f32 instance reads its
// own f32 h_i (S = T).  Every T-dependent step reduces to the bf16
// expressions at T = S = bf16, so the bf16 instance gives the shipping
// gradients bit for bit (scripts/compare_sdf_fwd.py).
//
// Cls is the width class, as in sdf_fwd.cuh: CoreNarrow, the 64-point
// instances sdf_bwd_chain_kernel<T, S, GATES, US>; or CoreWide,
// sdf_bwd_chain_wide_kernel<T, S, GATES, US>: 32-point blocks, padded
// widths up to 512 and encodings up to 128, every bf16 product in
// gemm_rows32's column passes, every f32 one on gemm_rows_f32<RowsWide>;
// or CoreHuge, sdf_bwd_chain_huge_kernel<bf16, bf16, GATES, US>: 64-point
// blocks at any width, the activations, carry and encoding rows of device
// memory after the chain scratch's (cscr, then core_mlp.row_layout's rows),
// every product gemm_rows_huge.
#pragma once

#include "dw_sum.cuh"
#include "mma_rows.cuh"

namespace nrh {

// Shared memory of the chain: the activation tile of T, the f32 carry tile
// (every product writes its output there in place), the encoding, the
// weight ring and d sdf / scale per point: 227,584 bytes in bf16, 215,296
// in f32 (two 32-row f32 stages), 226,432 and 214,144 in the wide class
// (32 points), one block per SM.
template <class Cls, typename T>
constexpr size_t chain_smem() {
  return Cls::kPts * kCoreLdAct<Cls, T> * sizeof(T) + Cls::kPts * Cls::kLdC * sizeof(float) +
         Cls::kPts * Cls::kEnc * sizeof(float) + CoreTile<T>::kRing * sizeof(T) + Cls::kPts * sizeof(float);
}
static_assert(chain_smem<CoreNarrow, bf16>() == 227584 && chain_smem<CoreNarrow, float>() == 215296 &&
                  chain_smem<CoreWide, bf16>() == 226432 && chain_smem<CoreWide, float>() == 214144,
              "the chain's shared-memory budget");
// The huge class: the weight ring, the row ring and d sdf / scale.
template <>
constexpr size_t chain_smem<CoreHuge, bf16>() {
  return huge_smem(CoreHuge::kPts * sizeof(float));
}
static_assert(chain_smem<CoreHuge, bf16>() == 138496, "the huge chain's shared-memory budget");

// f32 per point of the chain's device-memory scratch: u_i then dL/dh_i of
// every layer (gates_total), then g_enc, its cotangent, the Tail's direct
// cotangents and the cotangent of enc from the two sweeps (Cls::kEnc each;
// the huge class's padded encoding, huge_enc).
template <class Cls>
__host__ __device__ inline int chain_row(const SdfMeta& m) {
  return m.gates_total + 4 * (Cls::kHuge ? huge_enc(m) : Cls::kEnc);
}

__device__ __forceinline__ float gate_from_h(float h) { return 1.0f - expf(-100.0f * h); }

// The chain of one block of Cls::kPts points.  Its elementwise passes take
// four consecutive columns of one point per item (16-byte accesses to the
// device-memory scratch, 8-byte ones to the stash), so each thread has a
// few items, not dozens, of dependent global-memory round trips per pass.
// The stash's rows are stash_row(m, US) wide.  The transposed products read
// wpack through column-major fragments in bf16 and wtpack's transposed
// blocks in f32 (null in bf16), as in sdf_fwd.cuh.
template <class Cls, typename T, typename S, bool GATES, bool US>
__device__ __forceinline__ void sdf_bwd_chain_block(
    unsigned char* smem, const float* __restrict__ x, const S* __restrict__ stash, const float* __restrict__ gsc,
    const float* __restrict__ ds, const float* __restrict__ df, const float* __restrict__ dgx,
    const T* __restrict__ wpack, const T* __restrict__ wtpack, const float* __restrict__ w_sdf,
    float* __restrict__ dx, T* __restrict__ scratch, float* __restrict__ cscr, float* __restrict__ partial, int n,
    const SdfMeta& m, const DwJobs& jobs, float scale) {
  constexpr int kPts = Cls::kPts;
  const size_t npad = (size_t)gridDim.x * kPts;
  const int CW = chain_row<Cls>(m);
  // The huge class's rows follow the chain scratch's padded rows.
  float* rows = Cls::kHuge ? cscr + npad * CW + (size_t)blockIdx.x * kPts * huge_row(m) : nullptr;
  const CoreTiles<T> tl = core_tiles<Cls, T>(smem, rows, m);
  const int kLdAct = tl.ld_act, kLdC = tl.ld_c, kEnc = tl.ld_enc;
  T* act = tl.act;
  float* G = tl.carry;
  float* enc = tl.enc;
  T* ring = tl.ring;
  float* dss = reinterpret_cast<float*>(tl.tail);  // d sdf / scale per point
  const T* wt = std::is_same<T, float>::value ? wtpack : wpack;  // the transposed products' weights

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPts;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0, GT = m.gates_total, ST = stash_row(m, US);
  const int DL = m.d_last, DF = m.d_feat, kpf = m.kpf, npf = m.npf;
  // The block's rows of the device-memory scratch: U (u_i, then dL/dh_i),
  // genc (the recomputed g_enc), dgenc (its cotangent, the Tail VJP), tail
  // (the Tail's direct sin / cos cotangents), denc (cotangent of enc from
  // the two sweeps).
  float* crow = cscr + (size_t)p0 * CW;
  auto U = [&](int p, int col) -> float* { return crow + (size_t)p * CW + col; };
  auto genc = [&](int p, int c) -> float& { return crow[(size_t)p * CW + GT + c]; };
  auto dgenc = [&](int p, int c) -> float& { return crow[(size_t)p * CW + GT + kEnc + c]; };
  auto tail = [&](int p, int c) -> float& { return crow[(size_t)p * CW + GT + 2 * kEnc + c]; };
  auto denc = [&](int p, int c) -> float& { return crow[(size_t)p * CW + GT + 3 * kEnc + c]; };
  const int pw = GT + npf + 1 + 2 * kpf;
  float* prow = partial + (size_t)blockIdx.x * pw;
  auto hval = [&](int p, int col) -> float {
    return p0 + p < n ? to_f(stash[(size_t)(p0 + p) * ST + col]) : 0.0f;
  };
  // Four columns of h_i (col a multiple of 4).
  auto hval4 = [&](int p, int col, float* v) {
    if (p0 + p < n)
      ld4(stash + (size_t)(p0 + p) * ST + col, v);
    else
      v[0] = v[1] = v[2] = v[3] = 0.0f;
  };
  // Layer gates, four columns: E recovers them from the stashed h; H reads
  // the f32 sigmoid(100 z) of its forward pass.
  auto gval4 = [&](int p, int col, float* g) {
    if (GATES) {
      if (p0 + p < n)
        ld_f4(gsc + (size_t)(p0 + p) * GT + col, g);
      else
        g[0] = g[1] = g[2] = g[3] = 0.0f;
    } else {
      hval4(p, col, g);
#pragma unroll
      for (int k = 0; k < 4; ++k) g[k] = gate_from_h(g[k]);
    }
  };

  // 0. Encoding of 3x; the cotangents.
  if (!US) core_stage<Cls, true>(wt + m.w_off(L - 1), m.np(L - 1), m.np(L - 1), m.kp(L - 1), ring);
  for (int idx = tid; idx < kPts * kEnc; idx += kChainThreads) {
    const int p = idx / kEnc, c = idx % kEnc, gp = p0 + p;
    float xs[3];
    for (int d = 0; d < 3; ++d) xs[d] = gp < n ? x[gp * 3 + d] * scale : 0.0f;
    enc[idx] = c < d0 ? freq_channel(xs, nullptr, c, F, nullptr) : 0.0f;
    genc(p, c) = 0.0f;
    denc(p, c) = 0.0f;
  }
  if (tid < kPts) dss[tid] = (p0 + tid < n ? ds[p0 + tid] : 0.0f) / scale;
  for (int idx = tid; idx < kPts * DL; idx += kChainThreads) {
    const int p = idx / DL, c = idx % DL;
    G[p * kLdC + c] = w_sdf[c] / scale;
  }
  __syncthreads();

  // 1. The reverse sweep at the stashed h: U_i = g before layer i's gate.
  // US: U_i and g_enc are read from the stash, its rounding to S kept.
  if (US) {
    for (int idx = tid; idx < kPts * (GT / 4); idx += kChainThreads) {
      const int p = idx / (GT / 4), c = (idx % (GT / 4)) * 4;
      float u[4];
      hval4(p, GT + c, u);
      st_f4(U(p, c), u);
    }
    for (int idx = tid; idx < kPts * d0; idx += kChainThreads) {
      const int p = idx / d0, c = idx % d0;
      genc(p, c) = hval(p, 2 * GT + c);
    }
  }
  for (int i = L - 1; i >= 0 && !US; --i) {
    const int np = m.np(i), out = m.out(i), in = m.in(i), kp = m.kp(i), goff = m.b_off(i);
    if (i < L - 1) core_stage<Cls, true>(wt + m.w_off(i), np, np, kp, ring);
    for (int idx = tid; idx < kPts * (np / 4); idx += kChainThreads) {
      const int p = idx / (np / 4), c = (idx % (np / 4)) * 4;
      float u[4], gate[4], t[4];
      ld_f4(G + p * kLdC + c, u);
      gval4(p, goff + c, gate);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c + k >= out) u[k] = gate[k] = 0.0f;
        t[k] = u[k] * gate[k];
      }
      st_f4(U(p, goff + c), u);
      st4(act + p * kLdAct + c, t);
    }
    core_gemm<Cls, true>(act, kLdAct, wt + m.w_off(i), np, np, kp, G, kLdC, ring);
    __syncthreads();
    if (m.skip(i)) {  // elsewhere the product is already the carry
      const int split = in - d0;
      for (int idx = tid; idx < kPts * in; idx += kChainThreads) {
        const int p = idx / in, c = idx % in;
        const float v = G[p * kLdC + c] * kInvSqrt2;
        if (c < split)
          G[p * kLdC + c] = v;
        else
          genc(p, c - split) += v;
      }
      __syncthreads();
    }
  }
  for (int idx = tid; idx < kPts * d0 && !US; idx += kChainThreads) {
    const int p = idx / d0, c = idx % d0;
    genc(p, c) += G[p * kLdC + c];
  }
  __syncthreads();

  // 2. The Tail VJP: gx = (g_enc[:3] + sum_f dS_f 2^f) * scale with
  // dS = g_sin cos_b - g_cos sin_b.
  core_stage<Cls, false>(wpack + m.w_off(0), m.np(0), m.kp(0), m.np(0), ring);
  for (int idx = tid; idx < kPts * d0; idx += kChainThreads) {
    const int p = idx / d0, c = idx % d0, gp = p0 + p;
    const float* e = enc + p * kEnc;
    const float* ge = &genc(p, 0);
    float dg = 0.0f, tv = 0.0f;
    if (c < 3) {
      dg = (gp < n ? dgx[gp * 3 + c] : 0.0f) * scale;
    } else {
      const int j = c - 3, jj = j % (3 * F), d = jj / F, f = jj % F;
      const float cdS = (gp < n ? dgx[gp * 3 + d] : 0.0f) * scale * (float)(1 << f);
      if (j < 3 * F) {  // a sine channel
        dg = cdS * e[3 + 3 * F + jj];
        tv = -cdS * ge[3 + 3 * F + jj];
      } else {  // a cosine channel
        dg = -cdS * e[3 + jj];
        tv = cdS * ge[3 + jj];
      }
    }
    dgenc(p, c) = dg;
    tail(p, c) = tv;
    G[p * kLdC + c] = dg;  // the ascending pass's carry starts at d g_enc
  }
  __syncthreads();

  // 3. The VJP of the reverse sweep, ascending: v_i (cotangent of layer i's
  // sweep output), t_i = u_i gate_i; dt = v_i W_i; dL/dh_i = dt u_i 100
  // (1 - gate_i) (into U), carry = dt gate_i.
  for (int i = 0; i < L; ++i) {
    const int np = m.np(i), out = m.out(i), in = m.in(i), kp = m.kp(i), goff = m.b_off(i);
    const int split = m.skip(i) ? in - d0 : in;
    T* Aop = scratch + jobs.a(i);
    T* Bop = scratch + jobs.b(i);
    if (i > 0) core_stage<Cls, false>(wpack + m.w_off(i), np, kp, np, ring);
    for (int idx = tid; idx < kPts * (kp / 4); idx += kChainThreads) {
      const int p = idx / (kp / 4), c = (idx % (kp / 4)) * 4;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ck = c + k;
        v[k] = 0.0f;
        if (ck < in && p0 + p < n) {
          if (m.skip(i))
            v[k] = (ck < split ? G[p * kLdC + ck] : dgenc(p, ck - split)) * kInvSqrt2;
          else
            v[k] = G[p * kLdC + ck];
        }
      }
      st4(act + p * kLdAct + c, v);
      st4(Aop + (size_t)(p0 + p) * kp + c, v);
    }
    core_gemm<Cls, false>(act, kLdAct, wpack + m.w_off(i), np, kp, np, G, kLdC, ring);
    __syncthreads();
    // t_i (dW_i's first B operand) from the same u_i and gates.
    for (int idx = tid; idx < kPts * (np / 4); idx += kChainThreads) {
      const int p = idx / (np / 4), c = (idx % (np / 4)) * 4;
      float dt[4], u[4], gate[4], t[4], dh[4], carry[4];
      ld_f4(G + p * kLdC + c, dt);
      ld_f4(U(p, goff + c), u);
      gval4(p, goff + c, gate);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        t[k] = dh[k] = carry[k] = 0.0f;
        if (c + k < out) {
          if (p0 + p < n) t[k] = u[k] * gate[k];
          dh[k] = dt[k] * u[k] * (100.0f * (1.0f - gate[k]));
          carry[k] = dt[k] * gate[k];
        }
      }
      st4(Bop + (size_t)(p0 + p) * np + c, t);
      st_f4(U(p, goff + c), dh);
      st_f4(G + p * kLdC + c, carry);
    }
    __syncthreads();
  }

  // 3b. The heads.  Column sums: the final carry (the sdf head's column,
  // / scale by the caller), h_L . rnd<T>(ds / scale), d b_sdf, d b_feat.
  const int o_bf = GT, o_bs = GT + npf, o_hds = GT + npf + 1, o_carry = o_hds + kpf;
  const int lgoff = m.b_off(L - 1);
  core_stage<Cls, true>(wt + m.wf_off, npf, npf, kpf, ring);
  for (int c = tid; c < kpf; c += kChainThreads) {
    float sc = 0.0f, sh = 0.0f;
    if (c < DL) {
#pragma unroll 8
      for (int p = 0; p < kPts; ++p) {
        sc += G[p * kLdC + c];
        sh += rnd<T>(hval(p, lgoff + c)) * rnd<T>(dss[p]);
      }
    }
    prow[o_carry + c] = sc;
    prow[o_hds + c] = sh;
  }
  for (int c = tid; c < npf; c += kChainThreads) {
    float s = 0.0f;
    if (c < DF) {
#pragma unroll 8
      for (int p = 0; p < kPts; ++p) s += p0 + p < n ? df[(size_t)(p0 + p) * DF + c] : 0.0f;
    }
    prow[o_bf + c] = s;
  }
  if (tid == 0) {
    float s = 0.0f;
    for (int p = 0; p < kPts; ++p) s += dss[p];
    prow[o_bs] = s;
  }
  {
    T* Aop = scratch + jobs.a(L);
    T* Bop = scratch + jobs.b(L);
    for (int idx = tid; idx < kPts * (kpf / 4); idx += kChainThreads) {
      const int p = idx / (kpf / 4), c = (idx % (kpf / 4)) * 4;
      float h[4];
      hval4(p, lgoff + c, h);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k >= DL) h[k] = 0.0f;
      st4(Aop + (size_t)(p0 + p) * kpf + c, h);
    }
    for (int idx = tid; idx < kPts * (npf / 4); idx += kChainThreads) {
      const int p = idx / (npf / 4), c = (idx % (npf / 4)) * 4;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = c + k < DF && p0 + p < n ? df[(size_t)(p0 + p) * DF + c + k] : 0.0f;
      st4(Bop + (size_t)(p0 + p) * npf + c, v);
      st4(act + p * kLdAct + c, v);
    }
  }
  // dh_L = rnd<T>(ds/scale) rnd<T>(w_sdf) + df W_feat^T, then + dL/dh_{L-1}.
  // The carry's column sums above read G before the product overwrites it.
  core_gemm<Cls, true>(act, kLdAct, wt + m.wf_off, npf, npf, kpf, G, kLdC, ring);
  __syncthreads();
  core_stage<Cls, true>(wt + m.w_off(L - 1), m.np(L - 1), m.np(L - 1), m.kp(L - 1), ring);
  for (int idx = tid; idx < kPts * (m.np(L - 1) / 4); idx += kChainThreads) {
    const int p = idx / (m.np(L - 1) / 4), c = (idx % (m.np(L - 1) / 4)) * 4;
    float z[4], u[4], g[4];
    ld_f4(G + p * kLdC + c, z);
    ld_f4(U(p, lgoff + c), u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      g[k] = c + k < DL ? rnd<T>(dss[p]) * rnd<T>(w_sdf[c + k]) + z[k] + u[k] : 0.0f;
    st_f4(G + p * kLdC + c, g);
  }
  __syncthreads();

  // 4. The forward z-chain, descending: Gz_i = G gate_i; dW_i's second half
  // is inp_i^T Gz_i; G_{i-1} = (Gz_i W_i^T)[:split] + dL/dh_{i-1}.
  for (int i = L - 1; i >= 0; --i) {
    const int np = m.np(i), out = m.out(i), in = m.in(i), kp = m.kp(i), goff = m.b_off(i);
    const int split = m.skip(i) ? in - d0 : in;
    const int poff = i > 0 ? m.b_off(i - 1) : 0;
    T* Aop = scratch + jobs.a(i) + npad * kp;
    T* Bop = scratch + jobs.b(i) + npad * np;
    for (int idx = tid; idx < kPts * (np / 4); idx += kChainThreads) {
      const int p = idx / (np / 4), c = (idx % (np / 4)) * 4;
      float g[4], gate[4], gz[4];
      ld_f4(G + p * kLdC + c, g);
      gval4(p, goff + c, gate);
#pragma unroll
      for (int k = 0; k < 4; ++k) gz[k] = c + k < out ? g[k] * gate[k] : 0.0f;
      st_f4(G + p * kLdC + c, gz);
      st4(act + p * kLdAct + c, gz);
      st4(Bop + (size_t)(p0 + p) * np + c, gz);
    }
    for (int idx = tid; idx < kPts * (kp / 4); idx += kChainThreads) {
      const int p = idx / (kp / 4), c = (idx % (kp / 4)) * 4;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (p0 + p < n) {
        if (i > 0 && !m.skip(i) && c + 4 <= in) {
          hval4(p, poff + c, v);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int ck = c + k;
            if (i == 0)
              v[k] = ck < d0 ? enc[p * kEnc + ck] : 0.0f;
            else if (m.skip(i))
              v[k] = (ck < split ? hval(p, poff + ck) : (ck < in ? enc[p * kEnc + ck - split] : 0.0f)) * kInvSqrt2;
            else
              v[k] = ck < in ? hval(p, poff + ck) : 0.0f;
          }
        }
      }
      st4(Aop + (size_t)(p0 + p) * kp + c, v);
    }
    __syncthreads();
    for (int c = tid; c < np; c += kChainThreads) {
      float s = 0.0f;
#pragma unroll 8
      for (int p = 0; p < kPts; ++p) s += G[p * kLdC + c];
      prow[goff + c] = s;
    }
    core_gemm<Cls, true>(act, kLdAct, wt + m.w_off(i), np, np, kp, G, kLdC, ring);
    __syncthreads();
    // The next layer's first slabs (the head's product staged layer L - 1's).
    if (i > 0) core_stage<Cls, true>(wt + m.w_off(i - 1), m.np(i - 1), m.np(i - 1), m.kp(i - 1), ring);
    if (i > 0 && !m.skip(i)) {
      for (int idx = tid; idx < kPts * (kp / 4); idx += kChainThreads) {
        const int p = idx / (kp / 4), c = (idx % (kp / 4)) * 4;
        float z[4], u[4];
        ld_f4(G + p * kLdC + c, z);
        ld_f4(U(p, poff + c), u);
#pragma unroll
        for (int k = 0; k < 4; ++k) z[k] = c + k < in ? z[k] + u[k] : z[k];
        st_f4(G + p * kLdC + c, z);
      }
    } else {
      for (int idx = tid; idx < kPts * in; idx += kChainThreads) {
        const int p = idx / in, c = idx % in;
        float v = G[p * kLdC + c];
        if (m.skip(i)) v *= kInvSqrt2;
        if (i == 0)
          denc(p, c) += v;
        else if (c < split)
          G[p * kLdC + c] = v + *U(p, poff + c);
        else
          denc(p, c - split) += v;
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // 5. The encoding chain -> dx.
  for (int idx = tid; idx < kPts * 3; idx += kChainThreads) {
    const int p = idx / 3, d = idx % 3;
    if (p0 + p >= n) continue;
    const float* e = enc + p * kEnc;
    const float* de = &denc(p, 0);
    const float* tv = &tail(p, 0);
    float acc = 0.0f;
    for (int f = 0; f < F; ++f) {
      const int j = 3 + d * F + f;
      const float e_sin = de[j] + tv[j];
      const float e_cos = de[j + 3 * F] + tv[j + 3 * F];
      const float dS = e_sin * e[j + 3 * F] - e_cos * e[j];
      acc = f == 0 ? dS : acc + dS * (float)(1 << f);
    }
    dx[(size_t)(p0 + p) * 3 + d] = (de[d] + acc) * scale;
  }
}

template <typename T, typename S, bool GATES, bool US>
__global__ void __launch_bounds__(kChainThreads)
    sdf_bwd_chain_kernel(const float* __restrict__ x, const S* __restrict__ stash,
                         const float* __restrict__ gsc, const float* __restrict__ ds, const float* __restrict__ df,
                         const float* __restrict__ dgx, const T* __restrict__ wpack, const T* __restrict__ wtpack,
                         const float* __restrict__ w_sdf, float* __restrict__ dx,
                         T* __restrict__ scratch, float* __restrict__ cscr, float* __restrict__ partial, int n,
                         const SdfMeta m, const DwJobs jobs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  sdf_bwd_chain_block<CoreNarrow, T, S, GATES, US>(smem, x, stash, gsc, ds, df, dgx, wpack, wtpack, w_sdf, dx,
                                                   scratch, cscr, partial, n, m, jobs, scale);
}

template <typename T, typename S, bool GATES, bool US>
__global__ void __launch_bounds__(kChainThreads)
    sdf_bwd_chain_wide_kernel(const float* __restrict__ x, const S* __restrict__ stash,
                              const float* __restrict__ gsc, const float* __restrict__ ds,
                              const float* __restrict__ df, const float* __restrict__ dgx,
                              const T* __restrict__ wpack, const T* __restrict__ wtpack,
                              const float* __restrict__ w_sdf, float* __restrict__ dx, T* __restrict__ scratch,
                              float* __restrict__ cscr, float* __restrict__ partial, int n, const SdfMeta m,
                              const DwJobs jobs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  sdf_bwd_chain_block<CoreWide, T, S, GATES, US>(smem, x, stash, gsc, ds, df, dgx, wpack, wtpack, w_sdf, dx, scratch,
                                                 cscr, partial, n, m, jobs, scale);
}

template <typename T, typename S, bool GATES, bool US>
__global__ void __launch_bounds__(kChainThreads)
    sdf_bwd_chain_huge_kernel(const float* __restrict__ x, const S* __restrict__ stash,
                              const float* __restrict__ gsc, const float* __restrict__ ds,
                              const float* __restrict__ df, const float* __restrict__ dgx,
                              const T* __restrict__ wpack, const T* __restrict__ wtpack,
                              const float* __restrict__ w_sdf, float* __restrict__ dx, T* __restrict__ scratch,
                              float* __restrict__ cscr, float* __restrict__ partial, int n, const SdfMeta m,
                              const DwJobs jobs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  sdf_bwd_chain_block<CoreHuge, T, S, GATES, US>(smem, x, stash, gsc, ds, df, dgx, wpack, wtpack, w_sdf, dx, scratch,
                                                 cscr, partial, n, m, jobs, scale);
}

// The class's chain kernel of each template.
template <class Cls, typename T, typename S, bool GATES, bool US>
auto chain_kernel() {
  if constexpr (std::is_same<Cls, CoreWide>::value)
    return sdf_bwd_chain_wide_kernel<T, S, GATES, US>;
  else if constexpr (std::is_same<Cls, CoreHuge>::value)
    return sdf_bwd_chain_huge_kernel<T, S, GATES, US>;
  else
    return sdf_bwd_chain_kernel<T, S, GATES, US>;
}

// The chain of class Cls (blocks of Cls::kPts points), then dw_sum.cuh's
// passes, on `stream`; returns the first launch error.
template <class Cls, typename T, typename S, bool GATES, bool US>
inline int launch_sdf_bwd(const float* x, const void* stash, const float* gsc, const float* ds, const float* df,
                          const float* dgx, const void* wpack, const void* wtpack, const float* w_sdf, float* dx,
                          void* scratch, float* cscr, float* partial, float* colsum, float* part_dw, float* dw,
                          const SdfMeta& m, const DwJobs& jobs, int split, int n, float scale, cudaStream_t stream) {
  const size_t smem = chain_smem<Cls, T>();
  const auto kernel = chain_kernel<Cls, T, S, GATES, US>();
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc) return rc;
  const int nblk = (n + Cls::kPts - 1) / Cls::kPts;
  kernel<<<nblk, kChainThreads, smem, stream>>>(x, (const S*)stash, gsc, ds, df, dgx, (const T*)wpack,
                                                (const T*)wtpack, w_sdf, dx, (T*)scratch, cscr, partial, n, m, jobs,
                                                scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int pw = m.gates_total + m.npf + 1 + 2 * m.kpf;
  return launch_dw_sums((const T*)scratch, part_dw, dw, jobs, split, partial, nblk, pw, colsum, stream);
}

// launch_sdf_bwd at the instance the dtypes select: kF32Compute and
// kF32Stash the (operand, stash) pair, kWideClass the class; H's chain
// (GATES) reads its own h_i, S = T.
template <bool GATES, bool US, class Cls, typename... A>
inline int launch_sdf_bwd_pair(int dtypes, A... a) {
  if constexpr (GATES) {
    return dtypes & kF32Compute ? launch_sdf_bwd<Cls, float, float, GATES, US>(a...)
                                : launch_sdf_bwd<Cls, bf16, bf16, GATES, US>(a...);
  } else {
    switch (dtypes) {
      case 0:
        return launch_sdf_bwd<Cls, bf16, bf16, GATES, US>(a...);
      case kF32Compute:
        return launch_sdf_bwd<Cls, float, bf16, GATES, US>(a...);
      case kF32Stash:
        return launch_sdf_bwd<Cls, bf16, float, GATES, US>(a...);
      case kF32Compute | kF32Stash:
        return launch_sdf_bwd<Cls, float, float, GATES, US>(a...);
    }
    return (int)cudaErrorInvalidValue;
  }
}
template <bool GATES, bool US, typename... A>
inline int launch_sdf_bwd_dtypes(int dtypes, A... a) {
  if (dtypes & kHugeClass)
    return dtypes == kHugeClass ? launch_sdf_bwd<CoreHuge, bf16, bf16, GATES, US>(a...) : (int)cudaErrorInvalidValue;
  if (dtypes & kWideClass) return launch_sdf_bwd_pair<GATES, US, CoreWide>(dtypes ^ kWideClass, a...);
  return launch_sdf_bwd_pair<GATES, US, CoreNarrow>(dtypes, a...);
}

// The checks both launchers make on their tables (the meta at the limits
// of the width class the dtypes select, the jobs at its padded points).
inline int parse_sdf_bwd(const int* meta, const int* meta_dev, const long long* jobs, const long long* jobs_dev,
                         int n_jobs, int n, int dtypes, SdfMeta* m, DwJobs* J) {
  int rc = parse_meta(meta, meta_dev, m, dtypes & kWideClass, dtypes & kHugeClass);
  if (rc) return rc;
  const int pts = dtypes & kHugeClass ? CoreHuge::kPts : dtypes & kWideClass ? CoreWide::kPts : CoreNarrow::kPts;
  rc = parse_jobs(jobs, jobs_dev, n_jobs, (long long)((n + pts - 1) / pts) * pts, J);
  if (rc) return rc;
  return n_jobs != m->n_layers + 1 || m->d_feat < 1 ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace nrh
