// The per-point chain of the SDF core's backward, shared by kernel E
// (sdf_stash.cu, gates recovered from the stashed bf16 h_i) and kernel H
// (sdf_core_bwd.cu, the f32 gates sigmoid(100 z_i) of its own forward
// pass).  Its stages and design are described in sdf_stash.cu.
#pragma once

#include "dw_sum.cuh"

namespace nrh {

inline size_t sdf_bwd_smem_bytes(const SdfMeta& m) {
  return kTP * kLdA * sizeof(bf16) + 2 * kTP * kLdZ * sizeof(float) + 5 * kTP * kEncMax * sizeof(float) +
         (size_t)kTP * m.gates_total * sizeof(float) + kTP * sizeof(float);
}

__device__ __forceinline__ float gate_from_h(float h) { return 1.0f - expf(-100.0f * h); }

template <bool GATES>
__global__ void __launch_bounds__(kThreads)
    sdf_bwd_chain_kernel(const float* __restrict__ x, const bf16* __restrict__ stash,
                         const float* __restrict__ gsc, const float* __restrict__ ds, const float* __restrict__ df,
                         const float* __restrict__ dgx, const bf16* __restrict__ wpack,
                         const float* __restrict__ w_sdf, float* __restrict__ dx,
                         bf16* __restrict__ scratch, float* __restrict__ partial, int n,
                         const SdfMeta m, const DwJobs jobs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  float* Z = reinterpret_cast<float*>(act + kTP * kLdA);
  float* G = Z + kTP * kLdZ;
  float* enc = G + kTP * kLdZ;
  float* genc = enc + kTP * kEncMax;   // the recomputed g_enc
  float* dgenc = genc + kTP * kEncMax;  // its cotangent (the Tail VJP)
  float* tail = dgenc + kTP * kEncMax;  // the Tail's direct sin / cos cotangents
  float* denc = tail + kTP * kEncMax;   // cotangent of enc from the two sweeps
  float* U = denc + kTP * kEncMax;      // [kTP][GT]: u_i, then dL/dh_i
  float* dss = U + (size_t)kTP * m.gates_total;  // d sdf / scale per point

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kTP;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0, GT = m.gates_total;
  const int DL = m.d_last, DF = m.d_feat, kpf = m.kpf, npf = m.npf;
  const size_t npad = (size_t)gridDim.x * kTP;
  const int pw = GT + npf + 1 + 2 * kpf;
  float* prow = partial + (size_t)blockIdx.x * pw;
  auto hval = [&](int p, int col) -> float {
    return p0 + p < n ? bf(stash[(size_t)(p0 + p) * GT + col]) : 0.0f;
  };
  // Layer gates: E recovers them from the stashed h; H reads the f32
  // sigmoid(100 z) of its forward pass.
  auto gval = [&](int p, int col) -> float {
    if (GATES) return p0 + p < n ? gsc[(size_t)(p0 + p) * GT + col] : 0.0f;
    return gate_from_h(hval(p, col));
  };

  // 0. Encoding of 3x; the cotangents.
  for (int idx = tid; idx < kTP * kEncMax; idx += kThreads) {
    const int p = idx / kEncMax, c = idx % kEncMax, gp = p0 + p;
    float xs[3];
    for (int d = 0; d < 3; ++d) xs[d] = gp < n ? x[gp * 3 + d] * scale : 0.0f;
    enc[idx] = c < d0 ? freq_channel(xs, nullptr, c, F, nullptr) : 0.0f;
    genc[idx] = 0.0f;
    denc[idx] = 0.0f;
  }
  if (tid < kTP) dss[tid] = (p0 + tid < n ? ds[p0 + tid] : 0.0f) / scale;
  for (int idx = tid; idx < kTP * DL; idx += kThreads) {
    const int p = idx / DL, c = idx % DL;
    G[p * kLdZ + c] = w_sdf[c] / scale;
  }
  __syncthreads();

  // 1. The reverse sweep at the stashed h: U_i = g before layer i's gate.
  for (int i = L - 1; i >= 0; --i) {
    const int np = m.np_[i], out = m.out_dim[i], in = m.in_dim[i], kp = m.kp[i], goff = m.b_off[i];
    for (int idx = tid; idx < kTP * np; idx += kThreads) {
      const int p = idx / np, c = idx % np;
      const float u = c < out ? G[p * kLdZ + c] : 0.0f;
      const float gate = c < out ? gval(p, goff + c) : 0.0f;
      U[p * GT + goff + c] = u;
      act[p * kLdA + c] = to_bf16(u * gate);
    }
    __syncthreads();
    gemm_rows16<true, kWarps>(act, kLdA, wpack + m.w_off[i], np, np, kp, Z, kLdZ);
    __syncthreads();
    const int split = m.skip[i] ? in - d0 : in;
    for (int idx = tid; idx < kTP * in; idx += kThreads) {
      const int p = idx / in, c = idx % in;
      float v = Z[p * kLdZ + c];
      if (m.skip[i]) v *= kInvSqrt2;
      if (c < split)
        G[p * kLdZ + c] = v;
      else
        genc[p * kEncMax + c - split] += v;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < kTP * d0; idx += kThreads) {
    const int p = idx / d0, c = idx % d0;
    genc[p * kEncMax + c] += G[p * kLdZ + c];
  }
  __syncthreads();

  // 2. The Tail VJP: gx = (g_enc[:3] + sum_f dS_f 2^f) * scale with
  // dS = g_sin cos_b - g_cos sin_b.
  for (int idx = tid; idx < kTP * d0; idx += kThreads) {
    const int p = idx / d0, c = idx % d0, gp = p0 + p;
    const float* e = enc + p * kEncMax;
    const float* ge = genc + p * kEncMax;
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
    dgenc[p * kEncMax + c] = dg;
    tail[p * kEncMax + c] = tv;
    G[p * kLdZ + c] = dg;  // the ascending pass's carry starts at d g_enc
  }
  __syncthreads();

  // 3. The VJP of the reverse sweep, ascending: v_i (cotangent of layer i's
  // sweep output), t_i = u_i gate_i; dt = v_i W_i; dL/dh_i = dt u_i 100
  // (1 - gate_i) (into U), carry = dt gate_i.
  for (int i = 0; i < L; ++i) {
    const int np = m.np_[i], out = m.out_dim[i], in = m.in_dim[i], kp = m.kp[i], goff = m.b_off[i];
    const int split = m.skip[i] ? in - d0 : in;
    bf16* Aop = scratch + jobs.a_off[i];
    bf16* Bop = scratch + jobs.b_off[i];
    for (int idx = tid; idx < kTP * kp; idx += kThreads) {
      const int p = idx / kp, c = idx % kp;
      float v = 0.0f;
      if (c < in) {
        if (m.skip[i])
          v = (c < split ? G[p * kLdZ + c] : dgenc[p * kEncMax + c - split]) * kInvSqrt2;
        else
          v = G[p * kLdZ + c];
      }
      const bf16 vb = to_bf16(p0 + p < n ? v : 0.0f);
      act[p * kLdA + c] = vb;
      Aop[(size_t)(p0 + p) * kp + c] = vb;
    }
    for (int idx = tid; idx < kTP * np; idx += kThreads) {
      const int p = idx / np, c = idx % np;
      const float t = c < out ? U[p * GT + goff + c] * gval(p, goff + c) : 0.0f;
      Bop[(size_t)(p0 + p) * np + c] = to_bf16(p0 + p < n ? t : 0.0f);
    }
    __syncthreads();
    gemm_rows16<false, kWarps>(act, kLdA, wpack + m.w_off[i], np, kp, np, Z, kLdZ);
    __syncthreads();
    for (int idx = tid; idx < kTP * np; idx += kThreads) {
      const int p = idx / np, c = idx % np;
      float dh = 0.0f, carry = 0.0f;
      if (c < out) {
        const float dt = Z[p * kLdZ + c];
        const float gate = gval(p, goff + c);
        dh = dt * U[p * GT + goff + c] * (100.0f * (1.0f - gate));
        carry = dt * gate;
      }
      U[p * GT + goff + c] = dh;
      G[p * kLdZ + c] = carry;
    }
    __syncthreads();
  }

  // 3b. The heads.  Column sums: the final carry (the sdf head's column,
  // / scale by the caller), h_L . bf16(ds / scale), d b_sdf, d b_feat.
  const int o_bf = GT, o_bs = GT + npf, o_hds = GT + npf + 1, o_carry = o_hds + kpf;
  const int lgoff = m.b_off[L - 1];
  for (int c = tid; c < kpf; c += kThreads) {
    float sc = 0.0f, sh = 0.0f;
    if (c < DL)
      for (int p = 0; p < kTP; ++p) {
        sc += G[p * kLdZ + c];
        sh += bf(to_bf16(hval(p, lgoff + c))) * bf(to_bf16(dss[p]));
      }
    prow[o_carry + c] = sc;
    prow[o_hds + c] = sh;
  }
  for (int c = tid; c < npf; c += kThreads) {
    float s = 0.0f;
    if (c < DF)
      for (int p = 0; p < kTP; ++p) s += p0 + p < n ? df[(size_t)(p0 + p) * DF + c] : 0.0f;
    prow[o_bf + c] = s;
  }
  if (tid == 0) {
    float s = 0.0f;
    for (int p = 0; p < kTP; ++p) s += dss[p];
    prow[o_bs] = s;
  }
  {
    bf16* Aop = scratch + jobs.a_off[L];
    bf16* Bop = scratch + jobs.b_off[L];
    for (int idx = tid; idx < kTP * kpf; idx += kThreads) {
      const int p = idx / kpf, c = idx % kpf;
      Aop[(size_t)(p0 + p) * kpf + c] = to_bf16(c < DL ? hval(p, lgoff + c) : 0.0f);
    }
    for (int idx = tid; idx < kTP * npf; idx += kThreads) {
      const int p = idx / npf, c = idx % npf;
      const bf16 v = to_bf16(c < DF && p0 + p < n ? df[(size_t)(p0 + p) * DF + c] : 0.0f);
      Bop[(size_t)(p0 + p) * npf + c] = v;
      act[p * kLdA + c] = v;
    }
  }
  __syncthreads();
  // dh_L = bf16(ds/scale) bf16(w_sdf) + df W_feat^T, then + dL/dh_{L-1}.
  gemm_rows16<true, kWarps>(act, kLdA, wpack + m.wf_off, npf, npf, kpf, Z, kLdZ);
  __syncthreads();
  for (int idx = tid; idx < kTP * m.np_[L - 1]; idx += kThreads) {
    const int p = idx / m.np_[L - 1], c = idx % m.np_[L - 1];
    G[p * kLdZ + c] = c < DL ? bf(to_bf16(dss[p])) * bf(to_bf16(w_sdf[c])) + Z[p * kLdZ + c] + U[p * GT + lgoff + c]
                             : 0.0f;
  }
  __syncthreads();

  // 4. The forward z-chain, descending: Gz_i = G gate_i; dW_i's second half
  // is inp_i^T Gz_i; G_{i-1} = (Gz_i W_i^T)[:split] + dL/dh_{i-1}.
  for (int i = L - 1; i >= 0; --i) {
    const int np = m.np_[i], out = m.out_dim[i], in = m.in_dim[i], kp = m.kp[i], goff = m.b_off[i];
    const int split = m.skip[i] ? in - d0 : in;
    const int poff = i > 0 ? m.b_off[i - 1] : 0;
    bf16* Aop = scratch + jobs.a_off[i] + npad * kp;
    bf16* Bop = scratch + jobs.b_off[i] + npad * np;
    for (int idx = tid; idx < kTP * np; idx += kThreads) {
      const int p = idx / np, c = idx % np;
      const float gz = c < out ? G[p * kLdZ + c] * gval(p, goff + c) : 0.0f;
      Z[p * kLdZ + c] = gz;
      const bf16 gb = to_bf16(gz);
      act[p * kLdA + c] = gb;
      Bop[(size_t)(p0 + p) * np + c] = gb;
    }
    for (int idx = tid; idx < kTP * kp; idx += kThreads) {
      const int p = idx / kp, c = idx % kp;
      float v = 0.0f;
      if (p0 + p < n) {
        if (i == 0)
          v = c < d0 ? enc[p * kEncMax + c] : 0.0f;
        else if (m.skip[i])
          v = (c < split ? hval(p, poff + c) : (c < in ? enc[p * kEncMax + c - split] : 0.0f)) * kInvSqrt2;
        else
          v = c < in ? hval(p, poff + c) : 0.0f;
      }
      Aop[(size_t)(p0 + p) * kp + c] = to_bf16(v);
    }
    __syncthreads();
    for (int c = tid; c < np; c += kThreads) {
      float s = 0.0f;
      for (int p = 0; p < kTP; ++p) s += Z[p * kLdZ + c];
      prow[goff + c] = s;
    }
    __syncthreads();
    gemm_rows16<true, kWarps>(act, kLdA, wpack + m.w_off[i], np, np, kp, Z, kLdZ);
    __syncthreads();
    for (int idx = tid; idx < kTP * in; idx += kThreads) {
      const int p = idx / in, c = idx % in;
      float v = Z[p * kLdZ + c];
      if (m.skip[i]) v *= kInvSqrt2;
      if (i == 0)
        denc[p * kEncMax + c] += v;
      else if (c < split)
        G[p * kLdZ + c] = v + U[p * GT + poff + c];
      else
        denc[p * kEncMax + c - split] += v;
    }
    __syncthreads();
  }

  // 5. The encoding chain -> dx.
  for (int idx = tid; idx < kTP * 3; idx += kThreads) {
    const int p = idx / 3, d = idx % 3;
    if (p0 + p >= n) continue;
    const float* e = enc + p * kEncMax;
    const float* de = denc + p * kEncMax;
    const float* tv = tail + p * kEncMax;
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

// The chain, then dw_sum.cuh's passes, on `stream`; returns the first
// launch error.
template <bool GATES>
inline int launch_sdf_bwd(const float* x, const bf16* stash, const float* gsc, const float* ds, const float* df,
                          const float* dgx, const bf16* wpack, const float* w_sdf, float* dx, bf16* scratch,
                          float* partial, float* colsum, float* part_dw, float* dw, const SdfMeta& m,
                          const DwJobs& jobs, int split, int n, float scale, cudaStream_t stream) {
  const size_t smem = sdf_bwd_smem_bytes(m);
  int rc = (int)cudaFuncSetAttribute(sdf_bwd_chain_kernel<GATES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc) return rc;
  const int nblk = (n + kTP - 1) / kTP;
  sdf_bwd_chain_kernel<GATES><<<nblk, kThreads, smem, stream>>>(x, stash, gsc, ds, df, dgx, wpack, w_sdf, dx,
                                                                 scratch, partial, n, m, jobs, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int pw = m.gates_total + m.npf + 1 + 2 * m.kpf;
  return launch_dw_sums(scratch, part_dw, dw, jobs, split, partial, nblk, pw, colsum, stream);
}

// The checks both launchers make on their tables.
inline int parse_sdf_bwd(const int* meta, const long long* jobs, int n_jobs, SdfMeta* m, DwJobs* J) {
  int rc = parse_meta(meta, m);
  if (rc) return rc;
  rc = parse_jobs(jobs, n_jobs, J);
  if (rc) return rc;
  return n_jobs != m->n_layers + 1 || m->d_feat < 1 ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace nrh
