// Shared pieces of the kernels that evaluate the SDF MLP on the card
// (sdf_fwd.cuh: kernels A, D and H's forward pass; march_common.cuh: the
// march sweeps of kernels C, K, L, M and N) and of the trunk kernels
// (mlp_stash.cu): the packed-weight layout, the widths and tile strides,
// the frequency encoding and the one-exp softplus(100) gate.
//
// Packed weights (built by nrhints_torch/kernels/core_mlp.py::pack_sdf_mlp):
//   wpack  bf16, per hidden layer i a zero-padded [kp_i, np_i] row-major
//          block (w stored [in, out]), then (kernel A only) the feature head
//          [kpf, npf].  kp/np are the in/out widths rounded up to 16.
//   bpack  f32, per layer a zero-padded [np_i] bias, then the feature bias
//          [npf], then b_sdf.
//   w_sdf  f32 [d_last]: the sdf head column, unrounded (the reverse sweep
//          starts from it in f32; the forward head rounds it to bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace nrh {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Layers whose rows ride in the kernels' parameters (SdfMeta's tables, and
// MlpMeta's in mlp_stash.cu); a deeper network's rows are read from its
// meta vector's copy on the card, so the kernels take any depth.
constexpr int kMaxLayers = 16;
constexpr int kMetaHead = 10;  // ints of the SDF meta vector before its per-layer rows
constexpr int kWMax = 256;        // widest padded layer output, and input but the trunk's first (mlp_stash.cu)
constexpr int kEncMax = 64;       // widest padded frequency encoding
constexpr int kLdA = kWMax + 8;   // bf16 row stride of activation tiles
constexpr int kLdZ = kWMax + 4;   // f32 row stride of accumulator tiles
// The SDF core's wide instances (sdf_fwd.cuh, sdf_bwd.cuh: kernels A, D, E
// and H above the presets' widths) take twice both limits.
constexpr int kWideWMax = 2 * kWMax;
constexpr int kWideEncMax = 2 * kEncMax;
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kHalfPi = 1.57079632679489661923f;

struct SdfMeta {
  int n_layers, multi_res, d0, d_feat, d_last, kpf, npf, wf_off, bf_off, gates_total;
  int in_[kMaxLayers], out_[kMaxLayers], kp_[kMaxLayers], np_[kMaxLayers];
  int skip_[kMaxLayers], w_off_[kMaxLayers], b_off_[kMaxLayers];
  // The meta vector on the card where n_layers > kMaxLayers (its rows are
  // then read from there), else null.
  const int* dev;

  // Field k of layer i's row: the parameter table's, or the device copy's.
  __device__ __forceinline__ int field(const int (&t)[kMaxLayers], int i, int k) const {
    return dev ? dev[kMetaHead + 7 * i + k] : t[i];
  }
  __device__ __forceinline__ int in(int i) const { return field(in_, i, 0); }
  __device__ __forceinline__ int out(int i) const { return field(out_, i, 1); }
  __device__ __forceinline__ int kp(int i) const { return field(kp_, i, 2); }
  __device__ __forceinline__ int np(int i) const { return field(np_, i, 3); }
  __device__ __forceinline__ int skip(int i) const { return field(skip_, i, 4); }
  __device__ __forceinline__ int w_off(int i) const { return field(w_off_, i, 5); }
  __device__ __forceinline__ int b_off(int i) const { return field(b_off_, i, 6); }
};

// meta = [L, multi_res, d0, d_feat, d_last, kpf, npf, wf_off, bf_off,
//         gates_total, then per layer: in, out, kp, np, skip, w_off, b_off]
// in host memory, checked against the 64-point instances' limits, or with
// wide the wide instances' (kWideWMax, kWideEncMax), or with huge none (the
// huge instances take any width; pack_sdf_mlp pads every one to 16).  Up
// to kMaxLayers layers the rows ride in SdfMeta's tables; a deeper
// network's are read from meta_dev, the same vector on the card (null for a
// shallower one).
inline int parse_meta(const int* meta, const int* meta_dev, SdfMeta* m, bool wide = false, bool huge = false) {
  const int w_max = huge ? 1 << 30 : wide ? kWideWMax : kWMax, enc_max = huge ? 1 << 30 : wide ? kWideEncMax : kEncMax;
  m->n_layers = meta[0];
  m->multi_res = meta[1];
  m->d0 = meta[2];
  m->d_feat = meta[3];
  m->d_last = meta[4];
  m->kpf = meta[5];
  m->npf = meta[6];
  m->wf_off = meta[7];
  m->bf_off = meta[8];
  m->gates_total = meta[9];
  if (m->n_layers < 1 || (m->n_layers > kMaxLayers && !meta_dev)) return (int)cudaErrorInvalidValue;
  m->dev = m->n_layers > kMaxLayers ? meta_dev : nullptr;
  if (m->d0 > enc_max || 3 + 6 * m->multi_res != m->d0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < m->n_layers; ++i) {
    const int* l = meta + kMetaHead + 7 * i;
    if (l[2] > w_max || l[3] > w_max) return (int)cudaErrorInvalidValue;
    if (i >= kMaxLayers) continue;
    m->in_[i] = l[0];
    m->out_[i] = l[1];
    m->kp_[i] = l[2];
    m->np_[i] = l[3];
    m->skip_[i] = l[4];
    m->w_off_[i] = l[5];
    m->b_off_[i] = l[6];
  }
  if (m->kpf > w_max || m->npf > w_max) return (int)cudaErrorInvalidValue;
  return 0;
}

// Columns of kernel D's packed bf16 stash (core_stash.py::sdf_stash_width):
// every layer's h_i on 16-column boundaries (gates_total columns); with us
// (core_backward="stash_all") then every layer's u_i at the same offsets
// plus gates_total, and g_enc at 2 gates_total, d0 columns padded to 16.
__host__ __device__ inline int stash_row(const SdfMeta& m, bool us) {
  return us ? 2 * m.gates_total + (m.d0 + 15) / 16 * 16 : m.gates_total;
}

// softplus(100 z) * 0.01 and sigmoid(100 z) from one exponential, exactly
// as kernels/common.py::softplus100_gate writes them.
__device__ __forceinline__ void softplus100_gate(float z, float* sp, float* gate) {
  const float t = 100.0f * z;
  const float e = expf(-fabsf(t));
  const float inv = 1.0f / (1.0f + e);
  *gate = t >= 0.0f ? inv : e * inv;
  *sp = (fmaxf(t, 0.0f) + log1pf(e)) * 0.01f;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ bf16 to_bf16(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// Channel c of the frequency encoding of xs (already scaled), in the
// layout [xs, sin(xs_d * 2^f) dim-major, cos(...) same order]; the cosine
// is sin(s + pi/2) as in the JAX package.  With a tangent ts, *tan gets the
// matching forward-mode tangent channel.
__device__ __forceinline__ float freq_channel(const float* xs, const float* ts, int c, int F,
                                              float* tan) {
  if (c < 3) {
    if (tan) *tan = ts[c];
    return xs[c];
  }
  int j = c - 3;
  const bool is_cos = j >= 3 * F;
  if (is_cos) j -= 3 * F;
  const int d = j / F;
  const float p = (float)(1 << (j % F));
  const float s = xs[d] * p;
  const float sin_b = sinf(s);
  const float cos_b = sinf(s + kHalfPi);
  if (tan) {
    const float tsc = ts[d] * p;
    *tan = is_cos ? -tsc * sin_b : tsc * cos_b;
  }
  return is_cos ? cos_b : sin_b;
}

}  // namespace nrh
