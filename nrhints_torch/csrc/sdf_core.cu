// Kernels A and D: the fused SDF core, sdf_core_fwd (no gradient) and
// sdf_stash_fwd (the forward of the with-gradient stash op).
//
// A replaces: nrhints_tpu/kernels/core_mlp.py::_sdf_core_fwd_pallas (the
// pallas_call at :241), whose body is sdf_core_ref (:71) with
// compute_dtype="bfloat16".  For N points: frequency encoding of 3x (L=6,
// 39 channels), an 8x256 softplus(100) MLP with a skip concat x 1/sqrt(2)
// at layer 4, the sdf head (/3) and the 256-wide feature head, and the
// input gradient of the sdf by a reverse sweep with gates sigmoid(100 z).
// Only the dot operands are bf16; activations, gates and accumulation are
// f32, as in the reference.
//
// D replaces: nrhints_tpu/kernels/core_stash.py::_sdf_stash_fwd_pallas (the
// pallas_call at :399): A's outputs, bit for bit, plus every layer's
// activation h_i rounded to bf16 into a packed stash [N, sum of the
// 16-padded layer widths] that kernel E (sdf_stash.cu) reads.  It is A's
// code with one more store per layer (STASH = true).
//
// Bound on an H100: about 0.98 M multiply-adds per point (524,544 forward,
// 458,752 reverse) = 1.97 MFLOP, so 129 GFLOP per 512-ray chunk of 65,536
// points: 0.130 ms at 989 TFLOP/s bf16.  Its outputs (sdf, 256 feature
// floats, 3 gradient floats per point) are 68 MB, 0.020 ms at 3.35 TB/s;
// D adds 264 MB of stash, 0.079 ms.  Both are bound by operations.
//
// Design.  The reverse sweep needs every layer's gate for every point:
// 2,016 f32 per point at full width.  On the TPU they sat in VMEM for a
// 256-point block; here a block takes TP = 16 points and keeps all their
// gates in shared memory (129 KB), beside two bf16 activation tiles, two
// f32 accumulator tiles and the encoding (185 KB in all, one block per
// SM).  Eight warps compute each 16-row layer product with bf16 WMMA
// (m16n16k16), one 16-column tile at a time, reading the weight fragments
// straight from global memory (they stay in L2).  The reverse sweep
// multiplies by the transposed weight through a column-major fragment, so
// no transpose is stored.  This first version is simple, not fast: every
// block streams all weights through L2 for only 16 points; wgmma on larger
// point tiles, with the gates spilled to a scratch tensor, is later work.
// The ragged edge is masked: rows past N read x = 0 and store nothing.
#include "sdf_mlp.cuh"

using namespace nrh;

namespace {

constexpr int TP = 16;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

size_t smem_bytes(const SdfMeta& m) {
  return 2 * TP * kLdA * sizeof(bf16) + 2 * TP * kLdZ * sizeof(float) +
         2 * TP * kEncMax * sizeof(float) + (size_t)TP * m.gates_total * sizeof(float);
}

template <bool STASH>
__global__ void __launch_bounds__(NTHREADS)
    sdf_core_fwd_kernel(const float* __restrict__ x, const bf16* __restrict__ wpack,
                        const float* __restrict__ bpack, const float* __restrict__ w_sdf,
                        float* __restrict__ sdf_out, float* __restrict__ feat_out,
                        float* __restrict__ gx_out, bf16* __restrict__ stash, int n, const SdfMeta m,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act0 = reinterpret_cast<bf16*>(smem);
  bf16* act1 = act0 + TP * kLdA;
  float* Z = reinterpret_cast<float*>(act1 + TP * kLdA);
  float* G = Z + TP * kLdZ;
  float* enc = G + TP * kLdZ;
  float* genc = enc + TP * kEncMax;
  float* gates = genc + TP * kEncMax;  // [TP][gates_total]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;
  const int GT = m.gates_total;

  // Encoding of 3x, and the first layer's bf16 input.
  for (int idx = tid; idx < TP * kEncMax; idx += NTHREADS) {
    const int p = idx / kEncMax, c = idx % kEncMax, gp = p0 + p;
    float xs[3];
    for (int d = 0; d < 3; ++d) xs[d] = gp < n ? x[gp * 3 + d] * scale : 0.0f;
    const float v = c < d0 ? freq_channel(xs, nullptr, c, F, nullptr) : 0.0f;
    enc[idx] = v;
    genc[idx] = 0.0f;
  }
  __syncthreads();
  for (int idx = tid; idx < TP * m.kp[0]; idx += NTHREADS) {
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
    gemm_rows16<false, NWARPS>(a_in, kLdA, wpack + m.w_off[i], np, m.kp[i], np, Z, kLdZ);
    __syncthreads();
    const bool next_skip = i + 1 < L && m.skip[i + 1];
    const int kp_next = i + 1 < L ? m.kp[i + 1] : m.kpf;
    const float* b = bpack + m.b_off[i];
    for (int idx = tid; idx < TP * np; idx += NTHREADS) {
      const int p = idx / np, c = idx % np;
      float gate = 0.0f, sp = 0.0f;
      if (c < out) {
        softplus100_gate(Z[p * kLdZ + c] + b[c], &sp, &gate);
        a_out[p * kLdA + c] = to_bf16(next_skip ? sp * kInvSqrt2 : sp);
      }
      gates[p * GT + goff + c] = gate;
      if (STASH && p0 + p < n) stash[(size_t)(p0 + p) * GT + goff + c] = to_bf16(sp);
    }
    // Columns past this layer's output: the skip layer's encoding half
    // (x 1/sqrt2), then zeros up to the next padded width.
    const int tail = kp_next - out;
    for (int idx = tid; idx < TP * tail; idx += NTHREADS) {
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

  // Heads: feat = h W_feat + b_feat (WMMA); sdf = (h . w_sdf + b_sdf)/scale
  // with both operands rounded to bf16, one warp per point.
  gemm_rows16<false, NWARPS>(a_in, kLdA, wpack + m.wf_off, m.npf, m.kpf, m.npf, Z, kLdZ);
  {
    const int warp = tid >> 5, lane = tid & 31;
    const float b_sdf = bpack[m.bf_off + m.npf];
    for (int p = warp; p < TP; p += NWARPS) {
      float s = 0.0f;
      for (int k = lane; k < m.d_last; k += 32) s += bf(a_in[p * kLdA + k]) * bf(to_bf16(w_sdf[k]));
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0 && p0 + p < n) sdf_out[p0 + p] = (s + b_sdf) / scale;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < TP * m.d_feat; idx += NTHREADS) {
    const int p = idx / m.d_feat, c = idx % m.d_feat;
    if (p0 + p < n) feat_out[(size_t)(p0 + p) * m.d_feat + c] = Z[p * kLdZ + c] + bpack[m.bf_off + c];
  }
  // Reverse sweep: g starts as w_sdf / scale (f32, unrounded).
  for (int idx = tid; idx < TP * m.d_last; idx += NTHREADS) {
    const int p = idx / m.d_last, c = idx % m.d_last;
    G[p * kLdZ + c] = w_sdf[c] / scale;
  }
  __syncthreads();
  for (int i = L - 1; i >= 0; --i) {
    const int np = m.np_[i], out = m.out_dim[i], in = m.in_dim[i], kp = m.kp[i];
    goff -= np;
    bf16* gb = act0;
    for (int idx = tid; idx < TP * np; idx += NTHREADS) {
      const int p = idx / np, c = idx % np;
      gb[p * kLdA + c] = to_bf16(c < out ? G[p * kLdZ + c] * gates[p * GT + goff + c] : 0.0f);
    }
    __syncthreads();
    gemm_rows16<true, NWARPS>(gb, kLdA, wpack + m.w_off[i], np, np, kp, Z, kLdZ);
    __syncthreads();
    const int split = m.skip[i] ? in - d0 : in;
    for (int idx = tid; idx < TP * in; idx += NTHREADS) {
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
  for (int idx = tid; idx < TP * d0; idx += NTHREADS) {
    const int p = idx / d0, c = idx % d0;
    genc[p * kEncMax + c] += G[p * kLdZ + c];
  }
  __syncthreads();

  // Through the encoding: enc = [xs, sin(S), cos(S)], S_{d,f} = xs_d 2^f.
  for (int idx = tid; idx < TP * 3; idx += NTHREADS) {
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

template <bool STASH>
int launch_fwd(const float* x, const void* wpack, const float* bpack, const float* w_sdf, float* sdf,
               float* feat, float* gx, void* stash, int n, const int* meta, float scale, void* stream) {
  SdfMeta m;
  int rc = parse_meta(meta, &m);
  if (rc) return rc;
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(m);
  rc = (int)cudaFuncSetAttribute(sdf_core_fwd_kernel<STASH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc) return rc;
  const int grid = (n + TP - 1) / TP;
  sdf_core_fwd_kernel<STASH><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      x, (const bf16*)wpack, bpack, w_sdf, sdf, feat, gx, (bf16*)stash, n, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdf_core_fwd(const float* x, const void* wpack, const float* bpack,
                            const float* w_sdf, float* sdf, float* feat, float* gx, int n,
                            const int* meta, float scale, void* stream) {
  return launch_fwd<false>(x, wpack, bpack, w_sdf, sdf, feat, gx, nullptr, n, meta, scale, stream);
}

extern "C" int sdf_stash_fwd(const float* x, const void* wpack, const float* bpack,
                             const float* w_sdf, float* sdf, float* feat, float* gx, void* stash,
                             int n, const int* meta, float scale, void* stream) {
  return launch_fwd<true>(x, wpack, bpack, w_sdf, sdf, feat, gx, stash, n, meta, scale, stream);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
