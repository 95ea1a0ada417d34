// The forward kernel of the SDF core, shared by kernels A and D
// (sdf_core.cu) and by the first pass of kernel H (sdf_core_bwd.cu).  Its
// design is described in sdf_core.cu.  MODE says what it writes:
//   kFwdPlain      sdf, feat and grad_x sdf (kernel A);
//   kFwdStash      those, and every layer's activation h_i rounded to bf16
//                  into a packed stash [N, sum of the 16-padded widths]
//                  (kernel D);
//   kFwdStashAll   those, and also every layer's reverse-sweep value u_i
//                  (the g that reaches the layer's gate) and the encoding
//                  cotangent g_enc, rounded to bf16, in the stash_all
//                  layout of stash_row (D's variant for
//                  core_backward="stash_all"); sdf, feat, grad and the h_i
//                  columns are kFwdStash's bit for bit;
//   kFwdRecompute  the same bf16 stash and nothing else: no heads, no
//                  reverse sweep (kernel H's forward pass).
// Every mode writes every layer's gate sigmoid(100 z_i) in f32 to a
// device-memory scratch gsc [padded N, gates_total] of the same column
// layout (core_mlp.gate_layout); A and D read it back in their reverse
// sweep, H in its chain (sdf_bwd.cuh).
//
// T is the dot operands' type: bf16 (the shipping compute_dtype) or f32
// (compute_dtype="float32": the activation tile, the ring and the weights
// in f32, every product on mma_rows.cuh's gemm_rows_f32, the sdf head
// unrounded).  S is the stash's type (stash_dtype; "bf16" above reads S):
// the h_i, u_i and g_enc are rounded to S, nothing else is.  Every
// T-dependent step reduces to the bf16 expressions at T = S = bf16, so the
// bf16 instance gives the shipping outputs bit for bit
// (scripts/compare_sdf_fwd.py holds it against a parent tree).
//
// Cls is the width class (staged_mma.cuh): CoreNarrow, the 64-point
// instances sdf_core_fwd_kernel<T, S, MODE> at the presets' widths; or
// CoreWide, sdf_core_fwd_wide_kernel<T, S, MODE>, the same code on 32-point
// blocks with padded widths up to 512 and encodings up to 128, every bf16
// product in gemm_rows32's column passes of at most 256, every f32 one on
// mma_rows.cuh's gemm_rows_f32<RowsWide> (sdf_core.cu says why); or
// CoreHuge, sdf_core_fwd_huge_kernel<bf16, bf16, MODE>, the same code on
// 64-point blocks at any width: the block's activations, carry and
// encoding are rows of device memory after the gate scratch's (gsc, then
// core_mlp.row_layout's rows), every product gemm_rows_huge.
#pragma once

#include "mma_rows.cuh"

namespace nrh {

constexpr int kFwdPlain = 0, kFwdStash = 1, kFwdRecompute = 2, kFwdStashAll = 3;

// Shared memory of the forward: the activation tile of T (each layer's
// output written in place once the product that read it has returned), the
// f32 carry tile (Z in the forward, G in the reverse sweep; every product
// writes there), the encoding (the encoding's cotangent g_enc once the
// forward has read it for the last time) and the weight ring: 227,328
// bytes in bf16, 215,040 in f32 (two 32-row f32 stages), 226,304 in the wide
// class (32 points: activations 33,280, carry 66,048, encoding 16,384, the
// same ring) and 214,016 in its f32 instances (activations 66,048, the f32
// ring of 65,536), one block per SM.
template <class Cls, typename T>
constexpr size_t fwd_smem() {
  return Cls::kPts * kCoreLdAct<Cls, T> * sizeof(T) + Cls::kPts * Cls::kLdC * sizeof(float) +
         Cls::kPts * Cls::kEnc * sizeof(float) + CoreTile<T>::kRing * sizeof(T);
}
static_assert(fwd_smem<CoreNarrow, bf16>() == 227328 && fwd_smem<CoreNarrow, float>() == 215040 &&
                  fwd_smem<CoreWide, bf16>() == 226304 && fwd_smem<CoreWide, float>() == 214016,
              "the forward's shared-memory budget");
// The huge class keeps only the weight ring and the row ring there.
template <>
constexpr size_t fwd_smem<CoreHuge, bf16>() {
  return huge_smem(0);
}
static_assert(fwd_smem<CoreHuge, bf16>() == 138240, "the huge forward's shared-memory budget");

// The forward of one block of Cls::kPts points: every product through
// core_gemm, each product's first slabs requested before the elementwise
// pass in front of it, the elementwise passes four columns of one point per
// item.  The reverse sweep multiplies by each weight's transpose: the bf16
// instances read wpack through column-major fragments; the f32 instance
// reads the transposed blocks of wtpack (the same offsets; null in bf16).
template <class Cls, typename T, typename S, int MODE>
__device__ __forceinline__ void sdf_fwd_block(unsigned char* smem, const float* __restrict__ x,
                                              const T* __restrict__ wpack, const T* __restrict__ wtpack,
                                              const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                                              float* __restrict__ sdf_out, float* __restrict__ feat_out,
                                              float* __restrict__ gx_out, S* __restrict__ stash,
                                              float* __restrict__ gsc, int n, const SdfMeta& m, float scale) {
  constexpr int kPts = Cls::kPts;
  const int GT = m.gates_total;
  // The huge class's rows follow the gate scratch's padded rows.
  float* rows = Cls::kHuge ? gsc + (size_t)gridDim.x * kPts * GT + (size_t)blockIdx.x * kPts * huge_row(m) : nullptr;
  const CoreTiles<T> tl = core_tiles<Cls, T>(smem, rows, m);
  const int kLdAct = tl.ld_act, kLdC = tl.ld_c, kEnc = tl.ld_enc;
  T* act = tl.act;
  float* Z = tl.carry;
  float* enc = tl.enc;
  T* ring = tl.ring;
  const T* wt = std::is_same<T, float>::value ? wtpack : wpack;  // the reverse products' weights

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPts;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;
  const int ST = stash_row(m, MODE == kFwdStashAll);  // the stash's row stride
  float* grow = gsc + (size_t)p0 * GT;  // the block's rows of the gate scratch

  // Encoding of 3x, and the first layer's input (of T).
  core_stage<Cls, false>(wpack + m.w_off(0), m.np(0), m.kp(0), m.np(0), ring);
  for (int idx = tid; idx < kPts * kEnc; idx += kChainThreads) {
    const int p = idx / kEnc, c = idx % kEnc, gp = p0 + p;
    float xs[3];
    for (int d = 0; d < 3; ++d) xs[d] = gp < n ? x[gp * 3 + d] * scale : 0.0f;
    const float v = c < d0 ? freq_channel(xs, nullptr, c, F, nullptr) : 0.0f;
    enc[idx] = v;
    if (c < m.kp(0)) act[p * kLdAct + c] = from_f<T>(v);
  }

  // Forward: z_i = h_{i-1} W_i + b_i; h_i = softplus(100 z_i)/100, gate_i.
  for (int i = 0; i < L; ++i) {
    const int np = m.np(i), out = m.out(i), goff = m.b_off(i);
    core_gemm<Cls, false>(act, kLdAct, wpack + m.w_off(i), np, m.kp(i), np, Z, kLdC, ring);
    __syncthreads();
    const bool last = i + 1 == L;
    if (!last)
      core_stage<Cls, false>(wpack + m.w_off(i + 1), m.np(i + 1), m.kp(i + 1), m.np(i + 1), ring);
    else if (MODE != kFwdRecompute)
      core_stage<Cls, false>(wpack + m.wf_off, m.npf, m.kpf, m.npf, ring);
    // The next product's input, written over this one's: h_i (x 1/sqrt2
    // before the skip layer), then the skip layer's encoding half (x
    // 1/sqrt2), then zeros up to the next padded width (>= np).
    const bool next_skip = !last && m.skip(i + 1);
    const int w4 = (last ? m.kpf : m.kp(i + 1)) / 4;
    const float* b = bpack + goff;
    for (int idx = tid; idx < kPts * w4; idx += kChainThreads) {
      const int p = idx / w4, c = (idx % w4) * 4;
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bb[4] = {0.0f, 0.0f, 0.0f, 0.0f}, a[4], h[4], g[4];
      if (c < np) {
        ld_f4(Z + p * kLdC + c, z);
        ld_f4(b + c, bb);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ck = c + k;
        h[k] = g[k] = 0.0f;
        if (ck < out) {
          softplus100_gate(z[k] + bb[k], &h[k], &g[k]);
          a[k] = next_skip ? h[k] * kInvSqrt2 : h[k];
        } else {
          a[k] = next_skip && ck - out < d0 ? enc[p * kEnc + ck - out] * kInvSqrt2 : 0.0f;
        }
      }
      st4(act + p * kLdAct + c, a);
      if (c < np) {
        st_f4(grow + (size_t)p * GT + goff + c, g);
        if (MODE != kFwdPlain && p0 + p < n) st4(stash + (size_t)(p0 + p) * ST + goff + c, h);
      }
    }
  }
  if (MODE == kFwdRecompute) return;

  // Heads: feat = h W_feat + b_feat (core_gemm); sdf = (h . w_sdf +
  // b_sdf)/scale with both operands of type T, one warp per point.  The
  // product began with a barrier, so h is complete in act.
  core_gemm<Cls, false>(act, kLdAct, wpack + m.wf_off, m.npf, m.kpf, m.npf, Z, kLdC, ring);
  {
    const int warp = tid >> 5, lane = tid & 31;
    const float b_sdf = bpack[m.bf_off + m.npf];
    for (int p = warp; p < kPts; p += kChainThreads / 32) {
      float s = 0.0f;
      for (int k = lane; k < m.d_last; k += 32) s += to_f(act[p * kLdAct + k]) * rnd<T>(w_sdf[k]);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0 && p0 + p < n) sdf_out[p0 + p] = (s + b_sdf) / scale;
    }
  }
  __syncthreads();

  // The reverse sweep's first slabs; feat; g_enc = 0 in the enc tile; and
  // layer L - 1's gated cotangent, with g = w_sdf / scale (f32, unrounded).
  core_stage<Cls, true>(wt + m.w_off(L - 1), m.np(L - 1), m.np(L - 1), m.kp(L - 1), ring);
  for (int idx = tid; idx < kPts * m.d_feat; idx += kChainThreads) {
    const int p = idx / m.d_feat, c = idx % m.d_feat;
    if (p0 + p < n) feat_out[(size_t)(p0 + p) * m.d_feat + c] = Z[p * kLdC + c] + bpack[m.bf_off + c];
  }
  float* genc = enc;
  for (int idx = tid; idx < kPts * kEnc; idx += kChainThreads) genc[idx] = 0.0f;

  // Reverse sweep: g <- (g gate_i) W_i^T, the product written in place into
  // the carry tile G; at the skip layer x 1/sqrt2, split into the carry and
  // g_enc.
  float* G = Z;
  for (int i = L - 1; i >= 0; --i) {
    const int np = m.np(i), out = m.out(i), in = m.in(i), kp = m.kp(i), goff = m.b_off(i);
    if (i < L - 1) core_stage<Cls, true>(wt + m.w_off(i), np, np, kp, ring);
    for (int idx = tid; idx < kPts * (np / 4); idx += kChainThreads) {
      const int p = idx / (np / 4), c = (idx % (np / 4)) * 4;
      float u[4], gate[4], t[4];
      if (i == L - 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) u[k] = c + k < out ? w_sdf[c + k] / scale : 0.0f;
      } else {
        ld_f4(G + p * kLdC + c, u);
      }
      ld_f4(grow + (size_t)p * GT + goff + c, gate);
#pragma unroll
      for (int k = 0; k < 4; ++k) t[k] = c + k < out ? u[k] * gate[k] : 0.0f;
      st4(act + p * kLdAct + c, t);
      if (MODE == kFwdStashAll && p0 + p < n) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c + k >= out) u[k] = 0.0f;
        st4(stash + (size_t)(p0 + p) * ST + GT + goff + c, u);
      }
    }
    core_gemm<Cls, true>(act, kLdAct, wt + m.w_off(i), np, np, kp, G, kLdC, ring);
    __syncthreads();
    if (m.skip(i)) {  // elsewhere the product is already the carry
      const int split = in - d0;
      for (int idx = tid; idx < kPts * (kp / 4); idx += kChainThreads) {
        const int p = idx / (kp / 4), c = (idx % (kp / 4)) * 4;
        float v[4];
        ld_f4(G + p * kLdC + c, v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ck = c + k;
          if (ck < in) {
            v[k] *= kInvSqrt2;
            if (ck >= split) genc[p * kEnc + ck - split] += v[k];
          }
        }
        st_f4(G + p * kLdC + c, v);
      }
      __syncthreads();
    }
  }

  // Through the encoding: enc = [xs, sin(S), cos(S)], S_{d,f} = xs_d 2^f,
  // with sin and cos recomputed from x as the encoding pass computed them;
  // d sdf / d enc = g_enc + the last carry.
  for (int idx = tid; idx < kPts * 3; idx += kChainThreads) {
    const int p = idx / 3, d = idx % 3, gp = p0 + p;
    if (gp >= n) continue;
    const float* ge = genc + p * kEnc;
    const float* g = G + p * kLdC;
    const float xs = x[gp * 3 + d] * scale;
    float acc = 0.0f;
    for (int f = 0; f < F; ++f) {
      const int j = 3 + d * F + f;
      const float s = xs * (float)(1 << f);
      const float sin_b = sinf(s), cos_b = sinf(s + kHalfPi);
      const float dS = (ge[j] + g[j]) * cos_b - (ge[j + 3 * F] + g[j + 3 * F]) * sin_b;
      acc = f == 0 ? dS : acc + dS * (float)(1 << f);
    }
    gx_out[(size_t)gp * 3 + d] = (ge[d] + g[d] + acc) * scale;
  }
  if (MODE == kFwdStashAll) {  // g_enc = the skip's share + the last carry, zero-padded
    const int ew = ST - 2 * GT;
    for (int idx = tid; idx < kPts * ew; idx += kChainThreads) {
      const int p = idx / ew, c = idx % ew;
      if (p0 + p < n)
        stash[(size_t)(p0 + p) * ST + 2 * GT + c] =
            from_f<S>(c < d0 ? genc[p * kEnc + c] + G[p * kLdC + c] : 0.0f);
    }
  }
}

template <typename T, typename S, int MODE>
__global__ void __launch_bounds__(kChainThreads)
    sdf_core_fwd_kernel(const float* __restrict__ x, const T* __restrict__ wpack, const T* __restrict__ wtpack,
                        const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                        float* __restrict__ sdf_out, float* __restrict__ feat_out,
                        float* __restrict__ gx_out, S* __restrict__ stash, float* __restrict__ gsc,
                        int n, const SdfMeta m, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  sdf_fwd_block<CoreNarrow, T, S, MODE>(smem, x, wpack, wtpack, bpack, w_sdf, sdf_out, feat_out, gx_out, stash, gsc,
                                        n, m, scale);
}

template <typename T, typename S, int MODE>
__global__ void __launch_bounds__(kChainThreads)
    sdf_core_fwd_wide_kernel(const float* __restrict__ x, const T* __restrict__ wpack, const T* __restrict__ wtpack,
                             const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                             float* __restrict__ sdf_out, float* __restrict__ feat_out, float* __restrict__ gx_out,
                             S* __restrict__ stash, float* __restrict__ gsc, int n, const SdfMeta m, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  sdf_fwd_block<CoreWide, T, S, MODE>(smem, x, wpack, wtpack, bpack, w_sdf, sdf_out, feat_out, gx_out, stash, gsc, n,
                                      m, scale);
}

template <typename T, typename S, int MODE>
__global__ void __launch_bounds__(kChainThreads)
    sdf_core_fwd_huge_kernel(const float* __restrict__ x, const T* __restrict__ wpack, const T* __restrict__ wtpack,
                             const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                             float* __restrict__ sdf_out, float* __restrict__ feat_out, float* __restrict__ gx_out,
                             S* __restrict__ stash, float* __restrict__ gsc, int n, const SdfMeta m, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  sdf_fwd_block<CoreHuge, T, S, MODE>(smem, x, wpack, wtpack, bpack, w_sdf, sdf_out, feat_out, gx_out, stash, gsc, n,
                                      m, scale);
}

// The class's forward kernel of each template.
template <class Cls, typename T, typename S, int MODE>
auto fwd_kernel() {
  if constexpr (std::is_same<Cls, CoreWide>::value)
    return sdf_core_fwd_wide_kernel<T, S, MODE>;
  else if constexpr (std::is_same<Cls, CoreHuge>::value)
    return sdf_core_fwd_huge_kernel<T, S, MODE>;
  else
    return sdf_core_fwd_kernel<T, S, MODE>;
}

// One launch of the forward of class Cls on `stream`; returns its launch
// error.  gsc is the gate scratch of (n + Cls::kPts - 1) / Cls::kPts *
// Cls::kPts rows (core_mlp.gate_layout), in the huge class followed by as
// many rows of huge_row floats (core_mlp.row_layout).
template <class Cls, typename T, typename S, int MODE>
inline int launch_sdf_fwd(const float* x, const void* wpack, const void* wtpack, const float* bpack,
                          const float* w_sdf, float* sdf, float* feat, float* gx, void* stash, float* gsc, int n,
                          const SdfMeta& m, float scale, cudaStream_t stream) {
  constexpr size_t kFwdSmem = fwd_smem<Cls, T>();
  const auto kernel = fwd_kernel<Cls, T, S, MODE>();
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (rc) return rc;
  kernel<<<(n + Cls::kPts - 1) / Cls::kPts, kChainThreads, kFwdSmem, stream>>>(
      x, (const T*)wpack, (const T*)wtpack, bpack, w_sdf, sdf, feat, gx, (S*)stash, gsc, n, m, scale);
  return (int)cudaGetLastError();
}

// launch_sdf_fwd at the instance the dtypes select: kF32Compute and
// kF32Stash the (operand, stash) pair, kWideClass the class; the modes that
// keep no stash of their own choosing take S = T (H's first pass stashes
// its h_i in the operand type).
template <int MODE, class Cls, typename... A>
inline int launch_sdf_fwd_pair(int dtypes, A... a) {
  if constexpr (MODE == kFwdPlain || MODE == kFwdRecompute) {
    return dtypes & kF32Compute ? launch_sdf_fwd<Cls, float, float, MODE>(a...)
                                : launch_sdf_fwd<Cls, bf16, bf16, MODE>(a...);
  } else {
    switch (dtypes) {
      case 0:
        return launch_sdf_fwd<Cls, bf16, bf16, MODE>(a...);
      case kF32Compute:
        return launch_sdf_fwd<Cls, float, bf16, MODE>(a...);
      case kF32Stash:
        return launch_sdf_fwd<Cls, bf16, float, MODE>(a...);
      case kF32Compute | kF32Stash:
        return launch_sdf_fwd<Cls, float, float, MODE>(a...);
    }
    return (int)cudaErrorInvalidValue;
  }
}
template <int MODE, typename... A>
inline int launch_sdf_fwd_dtypes(int dtypes, A... a) {
  if (dtypes & kHugeClass)
    return dtypes == kHugeClass ? launch_sdf_fwd<CoreHuge, bf16, bf16, MODE>(a...) : (int)cudaErrorInvalidValue;
  if (dtypes & kWideClass) return launch_sdf_fwd_pair<MODE, CoreWide>(dtypes ^ kWideClass, a...);
  return launch_sdf_fwd_pair<MODE, CoreNarrow>(dtypes, a...);
}

}  // namespace nrh
