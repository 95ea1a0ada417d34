// Kernels F and G: the reflectance trunk's stash op, mlp_stash_fwd and
// mlp_stash_bwd.
//
// F replaces: nrhints_tpu/kernels/core_stash.py::_mlp_stash_fwd_pallas (the
// pallas_call at :605), whose body is mlp_relu_fwd_zs_ref (:528): n ReLU
// layers then a linear layer, at the shipping 361 -> 4 x 256 -> 3, with
// bf16 dot operands and f32 accumulation; it stores each hidden
// pre-activation z_i rounded to bf16 into a packed stash [N, sum of the
// 16-padded widths].
// G replaces: _mlp_stash_bwd_pallas (:655), whose body is
// mlp_relu_bwd_stash_ref (:541): G <- (G [z_i > 0]) W_i^T down the layers,
// dx, and dW_i = relu(z_{i-1})^T G_i, db_i = sum G_i.
//
// Bound on an H100 at 65,536 points: F does 38 GFLOP (0.038 ms at 989
// TFLOP/s bf16) and moves 95 MB in, 134 MB of stash and 0.8 MB out (0.069
// ms at 3.35 TB/s); G does about 76 GFLOP (0.077 ms) and moves about 324 MB
// (0.097 ms).  Both are bound by bytes.
//
// Design.  A block takes TP = 16 points; 8 warps compute each layer's
// 16-row product with bf16 WMMA (sdf_mlp.cuh::gemm_rows16), the weights
// read from L2 as in kernel A; the activations stay in shared memory (42 KB
// for F, 75 KB for G, so several blocks share an SM).  G's per-point chain
// writes dx and, per layer, the operands of dW_i in bf16 (the reference
// rounds exactly these to bf16) and per-block f32 sums of G_i; the products
// and the sums over blocks are dw_sum.cuh's split-K passes, in a fixed
// order.  The ragged edge is masked: rows past N read zeros and store
// nothing.  This first version is simple, not fast: 16 points per block
// stream all 0.6 MB of bf16 weights through L2.
#include "dw_sum.cuh"

using namespace nrh;

namespace {

constexpr int TP = 16;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int kInMax = 512;          // widest padded trunk input
constexpr int kLdX = kInMax + 8;     // row stride of input-wide tiles

struct MlpMeta {
  int n_lin, d0, d_out, zt;
  int in_dim[kMaxLayers], out_dim[kMaxLayers], kp[kMaxLayers], np_[kMaxLayers];
  int w_off[kMaxLayers], b_off[kMaxLayers], z_off[kMaxLayers];
};

// meta = [n_lin, d0, d_out, ZT, then per layer: in, out, kp, np, w_off,
// b_off, z_off] (core_stash.py::pack_mlp).
int parse_mlp_meta(const int* meta, MlpMeta* m) {
  m->n_lin = meta[0];
  m->d0 = meta[1];
  m->d_out = meta[2];
  m->zt = meta[3];
  if (m->n_lin < 1 || m->n_lin > kMaxLayers) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < m->n_lin; ++i) {
    const int* l = meta + 4 + 7 * i;
    m->in_dim[i] = l[0];
    m->out_dim[i] = l[1];
    m->kp[i] = l[2];
    m->np_[i] = l[3];
    m->w_off[i] = l[4];
    m->b_off[i] = l[5];
    m->z_off[i] = l[6];
    if (m->kp[i] > (i == 0 ? kInMax : kWMax) || m->np_[i] > kWMax) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

__global__ void __launch_bounds__(NTHREADS)
    mlp_stash_fwd_kernel(const float* __restrict__ x, const bf16* __restrict__ wpack,
                         const float* __restrict__ bpack, float* __restrict__ out,
                         bf16* __restrict__ zs, int n, const MlpMeta m) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xin = reinterpret_cast<bf16*>(smem);
  bf16* act = xin + TP * kLdX;
  float* Z = reinterpret_cast<float*>(act + TP * kLdA);
  const int tid = threadIdx.x, p0 = blockIdx.x * TP;

  for (int idx = tid; idx < TP * m.kp[0]; idx += NTHREADS) {
    const int p = idx / m.kp[0], c = idx % m.kp[0];
    xin[p * kLdX + c] = to_bf16(c < m.d0 && p0 + p < n ? x[(size_t)(p0 + p) * m.d0 + c] : 0.0f);
  }
  __syncthreads();
  for (int i = 0; i < m.n_lin; ++i) {
    const int np = m.np_[i], o = m.out_dim[i];
    const float* b = bpack + m.b_off[i];
    gemm_rows16<false, NWARPS>(i == 0 ? xin : act, i == 0 ? kLdX : kLdA, wpack + m.w_off[i], np, m.kp[i], np, Z,
                               kLdZ);
    __syncthreads();
    if (i + 1 < m.n_lin) {
      for (int idx = tid; idx < TP * np; idx += NTHREADS) {
        const int p = idx / np, c = idx % np;
        const float z = c < o ? Z[p * kLdZ + c] + b[c] : 0.0f;
        act[p * kLdA + c] = to_bf16(fmaxf(z, 0.0f));
        if (p0 + p < n) zs[(size_t)(p0 + p) * m.zt + m.z_off[i] + c] = to_bf16(z);
      }
    } else {
      for (int idx = tid; idx < TP * o; idx += NTHREADS) {
        const int p = idx / o, c = idx % o;
        if (p0 + p < n) out[(size_t)(p0 + p) * m.d_out + c] = Z[p * kLdZ + c] + b[c];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NTHREADS)
    mlp_stash_bwd_kernel(const float* __restrict__ x, const bf16* __restrict__ zs,
                         const float* __restrict__ g, const bf16* __restrict__ wpack,
                         float* __restrict__ dx, bf16* __restrict__ scratch, float* __restrict__ partial,
                         int n, const MlpMeta m, const DwJobs jobs, int bt) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Gf = reinterpret_cast<float*>(smem);  // [TP][kLdX] the running cotangent
  float* Z = Gf + TP * kLdX;                   // [TP][kLdX] product output
  bf16* act = reinterpret_cast<bf16*>(Z + TP * kLdX);
  const int tid = threadIdx.x, p0 = blockIdx.x * TP;
  const int last = m.n_lin - 1;
  float* prow = partial + (size_t)blockIdx.x * bt;
  auto zval = [&](int p, int col) -> float {
    return p0 + p < n ? bf(zs[(size_t)(p0 + p) * m.zt + col]) : 0.0f;
  };

  for (int idx = tid; idx < TP * m.np_[last]; idx += NTHREADS) {
    const int p = idx / m.np_[last], c = idx % m.np_[last];
    Gf[p * kLdX + c] = c < m.d_out && p0 + p < n ? g[(size_t)(p0 + p) * m.d_out + c] : 0.0f;
  }
  __syncthreads();
  for (int i = last; i >= 0; --i) {
    const int np = m.np_[i], o = m.out_dim[i], kp = m.kp[i], in = m.in_dim[i];
    bf16* Aop = scratch + jobs.a_off[i];
    bf16* Bop = scratch + jobs.b_off[i];
    for (int idx = tid; idx < TP * np; idx += NTHREADS) {
      const int p = idx / np, c = idx % np;
      float v = c < o ? Gf[p * kLdX + c] : 0.0f;
      if (i < last) v = v * (zval(p, m.z_off[i] + c) > 0.0f ? 1.0f : 0.0f);
      Gf[p * kLdX + c] = v;
      const bf16 vb = to_bf16(v);
      act[p * kLdA + c] = vb;
      Bop[(size_t)(p0 + p) * np + c] = vb;
    }
    for (int idx = tid; idx < TP * kp; idx += NTHREADS) {
      const int p = idx / kp, c = idx % kp;
      float v = 0.0f;
      if (c < in && p0 + p < n)
        v = i == 0 ? x[(size_t)(p0 + p) * m.d0 + c] : fmaxf(zval(p, m.z_off[i - 1] + c), 0.0f);
      Aop[(size_t)(p0 + p) * kp + c] = to_bf16(v);
    }
    __syncthreads();
    for (int c = tid; c < np; c += NTHREADS) {
      float s = 0.0f;
      for (int p = 0; p < TP; ++p) s += Gf[p * kLdX + c];
      prow[m.b_off[i] + c] = s;
    }
    gemm_rows16<true, NWARPS>(act, kLdA, wpack + m.w_off[i], np, np, kp, Z, kLdX);
    __syncthreads();
    for (int idx = tid; idx < TP * kp; idx += NTHREADS) {
      const int p = idx / kp, c = idx % kp;
      Gf[p * kLdX + c] = c < in ? Z[p * kLdX + c] : 0.0f;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < TP * m.d0; idx += NTHREADS) {
    const int p = idx / m.d0, c = idx % m.d0;
    if (p0 + p < n) dx[(size_t)(p0 + p) * m.d0 + c] = Gf[p * kLdX + c];
  }
}

size_t fwd_smem() { return TP * kLdX * sizeof(bf16) + TP * kLdA * sizeof(bf16) + TP * kLdZ * sizeof(float); }
size_t bwd_smem() { return 2 * TP * kLdX * sizeof(float) + TP * kLdA * sizeof(bf16); }

}  // namespace

extern "C" int mlp_stash_fwd(const float* x, const void* wpack, const float* bpack, float* out, void* zs, int n,
                             const int* meta, void* stream) {
  MlpMeta m;
  int rc = parse_mlp_meta(meta, &m);
  if (rc) return rc;
  if (n <= 0) return 0;
  rc = (int)cudaFuncSetAttribute(mlp_stash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)fwd_smem());
  if (rc) return rc;
  mlp_stash_fwd_kernel<<<(n + TP - 1) / TP, NTHREADS, fwd_smem(), (cudaStream_t)stream>>>(
      x, (const bf16*)wpack, bpack, out, (bf16*)zs, n, m);
  return (int)cudaGetLastError();
}

extern "C" int mlp_stash_bwd(const float* x, const void* zs, const float* g, const void* wpack, float* dx,
                             void* scratch, float* partial, float* colsum, float* part_dw, float* dw,
                             const long long* jobs, int n_jobs, int split, int n, const int* meta, void* stream) {
  MlpMeta m;
  int rc = parse_mlp_meta(meta, &m);
  if (rc) return rc;
  DwJobs J;
  rc = parse_jobs(jobs, n_jobs, &J);
  if (rc) return rc;
  if (n_jobs != m.n_lin) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  rc = (int)cudaFuncSetAttribute(mlp_stash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bwd_smem());
  if (rc) return rc;
  int bt = 0;
  for (int i = 0; i < m.n_lin; ++i) bt += m.np_[i];
  const int nblk = (n + TP - 1) / TP;
  cudaStream_t s = (cudaStream_t)stream;
  mlp_stash_bwd_kernel<<<nblk, NTHREADS, bwd_smem(), s>>>(x, (const bf16*)zs, g, (const bf16*)wpack, dx,
                                                         (bf16*)scratch, partial, n, m, J, bt);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_dw_sums((const bf16*)scratch, part_dw, dw, J, split, partial, nblk, bt, colsum, s);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
