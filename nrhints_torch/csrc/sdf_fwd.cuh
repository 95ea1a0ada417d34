// The forward kernel of the SDF core, shared by kernels A and D
// (sdf_core.cu) and by the first pass of kernel H (sdf_core_bwd.cu).  Its
// design is described in sdf_core.cu.  MODE says what it writes:
//   kFwdPlain      sdf, feat and grad_x sdf (kernel A);
//   kFwdStash      those, and every layer's activation h_i rounded to bf16
//                  into a packed stash [N, sum of the 16-padded widths]
//                  (kernel D);
//   kFwdRecompute  the same bf16 stash and every layer's gate
//                  sigmoid(100 z_i) in f32 into a scratch of the same layout,
//                  and nothing else: no heads, no reverse sweep (kernel H's
//                  forward pass).  The gates then live in device memory, not
//                  in shared memory, so a block needs 58 KB instead of 187.
#pragma once

#include "sdf_mlp.cuh"

namespace nrh {

constexpr int kFwdPlain = 0, kFwdStash = 1, kFwdRecompute = 2;

template <int MODE>
inline size_t sdf_fwd_smem_bytes(const SdfMeta& m) {
  const size_t tiles = 2 * kTP * kLdA * sizeof(bf16) + 2 * kTP * kLdZ * sizeof(float) +
                       2 * kTP * kEncMax * sizeof(float);
  return MODE == kFwdRecompute ? tiles : tiles + (size_t)kTP * m.gates_total * sizeof(float);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    sdf_core_fwd_kernel(const float* __restrict__ x, const bf16* __restrict__ wpack,
                        const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                        float* __restrict__ sdf_out, float* __restrict__ feat_out,
                        float* __restrict__ gx_out, bf16* __restrict__ stash, float* __restrict__ gsc,
                        int n, const SdfMeta m, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act0 = reinterpret_cast<bf16*>(smem);
  bf16* act1 = act0 + kTP * kLdA;
  float* Z = reinterpret_cast<float*>(act1 + kTP * kLdA);
  float* G = Z + kTP * kLdZ;
  float* enc = G + kTP * kLdZ;
  float* genc = enc + kTP * kEncMax;
  float* gates = genc + kTP * kEncMax;  // [kTP][gates_total]; not in kFwdRecompute

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kTP;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;
  const int GT = m.gates_total;

  // Encoding of 3x, and the first layer's bf16 input.
  for (int idx = tid; idx < kTP * kEncMax; idx += kThreads) {
    const int p = idx / kEncMax, c = idx % kEncMax, gp = p0 + p;
    float xs[3];
    for (int d = 0; d < 3; ++d) xs[d] = gp < n ? x[gp * 3 + d] * scale : 0.0f;
    const float v = c < d0 ? freq_channel(xs, nullptr, c, F, nullptr) : 0.0f;
    enc[idx] = v;
    genc[idx] = 0.0f;
  }
  __syncthreads();
  for (int idx = tid; idx < kTP * m.kp[0]; idx += kThreads) {
    const int p = idx / m.kp[0], c = idx % m.kp[0];
    act0[p * kLdA + c] = to_bf16(c < d0 ? enc[p * kEncMax + c] : 0.0f);
  }
  __syncthreads();

  // Forward: z_i = h_{i-1} W_i + b_i; h_i = softplus(100 z_i)/100, gate_i.
  bf16* a_in = act0;
  bf16* a_out = act1;
  int goff = 0;
  for (int i = 0; i < L; ++i) {
    const int np = m.np_[i], out = m.out_dim[i];
    gemm_rows16<false, kWarps>(a_in, kLdA, wpack + m.w_off[i], np, m.kp[i], np, Z, kLdZ);
    __syncthreads();
    const bool next_skip = i + 1 < L && m.skip[i + 1];
    const int kp_next = i + 1 < L ? m.kp[i + 1] : m.kpf;
    const float* b = bpack + m.b_off[i];
    for (int idx = tid; idx < kTP * np; idx += kThreads) {
      const int p = idx / np, c = idx % np;
      float gate = 0.0f, sp = 0.0f;
      if (c < out) {
        softplus100_gate(Z[p * kLdZ + c] + b[c], &sp, &gate);
        a_out[p * kLdA + c] = to_bf16(next_skip ? sp * kInvSqrt2 : sp);
      }
      const size_t row = (size_t)(p0 + p) * GT + goff + c;
      if (MODE != kFwdRecompute) gates[p * GT + goff + c] = gate;
      if (MODE != kFwdPlain && p0 + p < n) stash[row] = to_bf16(sp);
      if (MODE == kFwdRecompute && p0 + p < n) gsc[row] = gate;
    }
    // Columns past this layer's output: the skip layer's encoding half
    // (x 1/sqrt2), then zeros up to the next padded width.
    const int tail = kp_next - out;
    for (int idx = tid; idx < kTP * tail; idx += kThreads) {
      const int p = idx / tail, c = idx % tail;
      const float v = next_skip && c < d0 ? enc[p * kEncMax + c] * kInvSqrt2 : 0.0f;
      a_out[p * kLdA + out + c] = to_bf16(v);
    }
    __syncthreads();
    bf16* t = a_in;
    a_in = a_out;
    a_out = t;
    goff += np;
  }
  if (MODE == kFwdRecompute) return;

  // Heads: feat = h W_feat + b_feat (WMMA); sdf = (h . w_sdf + b_sdf)/scale
  // with both operands rounded to bf16, one warp per point.
  gemm_rows16<false, kWarps>(a_in, kLdA, wpack + m.wf_off, m.npf, m.kpf, m.npf, Z, kLdZ);
  {
    const int warp = tid >> 5, lane = tid & 31;
    const float b_sdf = bpack[m.bf_off + m.npf];
    for (int p = warp; p < kTP; p += kWarps) {
      float s = 0.0f;
      for (int k = lane; k < m.d_last; k += 32) s += bf(a_in[p * kLdA + k]) * bf(to_bf16(w_sdf[k]));
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0 && p0 + p < n) sdf_out[p0 + p] = (s + b_sdf) / scale;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kTP * m.d_feat; idx += kThreads) {
    const int p = idx / m.d_feat, c = idx % m.d_feat;
    if (p0 + p < n) feat_out[(size_t)(p0 + p) * m.d_feat + c] = Z[p * kLdZ + c] + bpack[m.bf_off + c];
  }
  // Reverse sweep: g starts as w_sdf / scale (f32, unrounded).
  for (int idx = tid; idx < kTP * m.d_last; idx += kThreads) {
    const int p = idx / m.d_last, c = idx % m.d_last;
    G[p * kLdZ + c] = w_sdf[c] / scale;
  }
  __syncthreads();
  for (int i = L - 1; i >= 0; --i) {
    const int np = m.np_[i], out = m.out_dim[i], in = m.in_dim[i], kp = m.kp[i];
    goff -= np;
    bf16* gb = act0;
    for (int idx = tid; idx < kTP * np; idx += kThreads) {
      const int p = idx / np, c = idx % np;
      gb[p * kLdA + c] = to_bf16(c < out ? G[p * kLdZ + c] * gates[p * GT + goff + c] : 0.0f);
    }
    __syncthreads();
    gemm_rows16<true, kWarps>(gb, kLdA, wpack + m.w_off[i], np, np, kp, Z, kLdZ);
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

  // Through the encoding: enc = [xs, sin(S), cos(S)], S_{d,f} = xs_d 2^f.
  for (int idx = tid; idx < kTP * 3; idx += kThreads) {
    const int p = idx / 3, d = idx % 3;
    if (p0 + p >= n) continue;
    const float* e = enc + p * kEncMax;
    const float* ge = genc + p * kEncMax;
    float acc = 0.0f;
    for (int f = 0; f < F; ++f) {
      const int j = 3 + d * F + f;
      const float dS = ge[j] * e[j + 3 * F] - ge[j + 3 * F] * e[j];
      acc = f == 0 ? dS : acc + dS * (float)(1 << f);
    }
    gx_out[(size_t)(p0 + p) * 3 + d] = (ge[d] + acc) * scale;
  }
}

// One launch of the forward on `stream`; returns its launch error.
template <int MODE>
inline int launch_sdf_fwd(const float* x, const bf16* wpack, const float* bpack, const float* w_sdf, float* sdf,
                          float* feat, float* gx, bf16* stash, float* gsc, int n, const SdfMeta& m, float scale,
                          cudaStream_t stream) {
  const size_t smem = sdf_fwd_smem_bytes<MODE>(m);
  int rc = (int)cudaFuncSetAttribute(sdf_core_fwd_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc) return rc;
  sdf_core_fwd_kernel<MODE><<<(n + kTP - 1) / kTP, kThreads, smem, stream>>>(x, wpack, bpack, w_sdf, sdf, feat, gx,
                                                                              stash, gsc, n, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace nrh
