// The reflectance trunk's kernels: F mlp_stash_fwd and G mlp_stash_bwd (the
// stash op), I mlp_fwd and J mlp_bwd (the recompute op).
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
// I replaces: nrhints_tpu/kernels/core_mlp.py::_mlp_fwd_pallas (the
// pallas_call at :409), mlp_relu_ref (:152): F without the stash store
// (STASH = false), so its output is F's bit for bit.  It serves the eval
// trunk (eval_reflectance_impl="pallas") and the forward of the recompute
// op.
// J replaces: core_mlp.py::_mlp_bwd_pallas (:453), jax.vjp of mlp_relu_ref
// per block: G's chain after each block reruns the hidden layers and keeps
// its z_i in f32 in shared memory (RECOMPUTE = true), so nothing is kept
// between the forward and the backward call.
//
// Bound on an H100 at 65,536 points: F and I do 38 GFLOP (0.038 ms at 989
// TFLOP/s bf16); F moves 95 MB in, 134 MB of stash and 0.8 MB out (0.069 ms
// at 3.35 TB/s), I only the 95 MB in (0.028 ms).  G does about 76 GFLOP
// (0.077 ms) and moves about 324 MB (0.097 ms); J does the forward's 38
// GFLOP more (114 GFLOP, 0.115 ms) and moves 190 MB (x in, dx out; 0.057
// ms).  F and G are bound by bytes, I and J by operations.
//
// Design.  A block takes kTP = 16 points; 8 warps compute each layer's
// 16-row product with bf16 WMMA (sdf_mlp.cuh::gemm_rows16), the weights
// read from L2 as in kernel A; the activations stay in shared memory (42 KB
// for F and I, 75 KB for G, 141 KB for J with its 66 KB of z_i, so one or
// more blocks share an SM).  G's and J's per-point chain writes dx and, per
// layer, the operands of dW_i in bf16 (the reference rounds exactly these
// to bf16) and per-block f32 sums of G_i; the products and the sums over
// blocks are dw_sum.cuh's split-K passes, in a fixed order.  The ragged
// edge is masked: rows past N read zeros and store nothing.  This first
// version is simple, not fast: 16 points per block stream all 0.6 MB of
// bf16 weights through L2.
#include "dw_sum.cuh"

using namespace nrh;

namespace {

constexpr int kInMax = 512;          // widest padded trunk input
constexpr int kLdX = kInMax + 8;     // row stride of input-wide tiles

struct MlpMeta {
  int n_lin, d0, d_out, zt;
  int in_dim[kMaxLayers], out_dim[kMaxLayers], kp[kMaxLayers], np_[kMaxLayers];
  int w_off[kMaxLayers], b_off[kMaxLayers], z_off[kMaxLayers];
};

// meta = [n_lin, d0, d_out, ZT, then per layer: in, out, kp, np, w_off,
// b_off, z_off] (core_mlp.py::pack_mlp).
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

// The hidden layers of a 16-point block: z_i = h_{i-1} W_i + b_i, h_i =
// relu(z_i) into act (bf16), from the bf16 input tile xin; emit(p, col, z)
// sees every z_i at its packed column (0 past the layer's width).  Returns
// with the last hidden activation in act, after a barrier.
template <typename Emit>
__device__ void mlp_hidden_layers(const bf16* xin, bf16* act, float* Z, const bf16* __restrict__ wpack,
                                  const float* __restrict__ bpack, const MlpMeta& m, Emit emit) {
  const int tid = threadIdx.x;
  for (int i = 0; i + 1 < m.n_lin; ++i) {
    const int np = m.np_[i], o = m.out_dim[i];
    const float* b = bpack + m.b_off[i];
    gemm_rows16<false, kWarps>(i == 0 ? xin : act, i == 0 ? kLdX : kLdA, wpack + m.w_off[i], np, m.kp[i], np, Z,
                               kLdZ);
    __syncthreads();
    for (int idx = tid; idx < kTP * np; idx += kThreads) {
      const int p = idx / np, c = idx % np;
      const float z = c < o ? Z[p * kLdZ + c] + b[c] : 0.0f;
      act[p * kLdA + c] = to_bf16(fmaxf(z, 0.0f));
      emit(p, m.z_off[i] + c, z);
    }
    __syncthreads();
  }
}

// The block's inputs as a bf16 tile [kTP][kLdX], zero past N and past d0.
__device__ __forceinline__ void load_input_tile(const float* __restrict__ x, bf16* xin, int p0, int n,
                                                const MlpMeta& m) {
  for (int idx = threadIdx.x; idx < kTP * m.kp[0]; idx += kThreads) {
    const int p = idx / m.kp[0], c = idx % m.kp[0];
    xin[p * kLdX + c] = to_bf16(c < m.d0 && p0 + p < n ? x[(size_t)(p0 + p) * m.d0 + c] : 0.0f);
  }
  __syncthreads();
}

// F (STASH = true) and I (STASH = false).
template <bool STASH>
__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(const float* __restrict__ x, const bf16* __restrict__ wpack, const float* __restrict__ bpack,
                   float* __restrict__ out, bf16* __restrict__ zs, int n, const MlpMeta m) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xin = reinterpret_cast<bf16*>(smem);
  bf16* act = xin + kTP * kLdX;
  float* Z = reinterpret_cast<float*>(act + kTP * kLdA);
  const int tid = threadIdx.x, p0 = blockIdx.x * kTP;

  load_input_tile(x, xin, p0, n, m);
  mlp_hidden_layers(xin, act, Z, wpack, bpack, m, [&](int p, int col, float z) {
    if (STASH && p0 + p < n) zs[(size_t)(p0 + p) * m.zt + col] = to_bf16(z);
  });
  const int last = m.n_lin - 1, np = m.np_[last], o = m.out_dim[last];
  const float* b = bpack + m.b_off[last];
  gemm_rows16<false, kWarps>(last == 0 ? xin : act, last == 0 ? kLdX : kLdA, wpack + m.w_off[last], np, m.kp[last],
                             np, Z, kLdZ);
  __syncthreads();
  for (int idx = tid; idx < kTP * o; idx += kThreads) {
    const int p = idx / o, c = idx % o;
    if (p0 + p < n) out[(size_t)(p0 + p) * m.d_out + c] = Z[p * kLdZ + c] + b[c];
  }
}

// G (RECOMPUTE = false: z_i from F's bf16 stash) and J (RECOMPUTE = true:
// the block first reruns the hidden layers and keeps its z_i in f32 in
// shared memory).  The two give the same gradients: the ReLU backward reads
// only the sign of z_i and bf16(relu(z_i)), which a bf16 z_i keeps.
template <bool RECOMPUTE>
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_kernel(const float* __restrict__ x, const bf16* __restrict__ zs, const float* __restrict__ g,
                   const bf16* __restrict__ wpack, const float* __restrict__ bpack, float* __restrict__ dx,
                   bf16* __restrict__ scratch, float* __restrict__ partial, int n, const MlpMeta m,
                   const DwJobs jobs, int bt) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Gf = reinterpret_cast<float*>(smem);  // [kTP][kLdX] the running cotangent
  float* Z = Gf + kTP * kLdX;                  // [kTP][kLdX] product output
  bf16* act = reinterpret_cast<bf16*>(Z + kTP * kLdX);
  float* zsm = reinterpret_cast<float*>(act + kTP * kLdA);  // RECOMPUTE: [kTP][zt] f32
  const int tid = threadIdx.x, p0 = blockIdx.x * kTP;
  const int last = m.n_lin - 1;
  float* prow = partial + (size_t)blockIdx.x * bt;
  if (RECOMPUTE) {
    bf16* xin = reinterpret_cast<bf16*>(Gf);  // Gf is free until the chain starts
    load_input_tile(x, xin, p0, n, m);
    mlp_hidden_layers(xin, act, Z, wpack, bpack, m, [&](int p, int col, float z) { zsm[p * m.zt + col] = z; });
  }
  auto zval = [&](int p, int col) -> float {
    if (p0 + p >= n) return 0.0f;
    return RECOMPUTE ? zsm[p * m.zt + col] : bf(zs[(size_t)(p0 + p) * m.zt + col]);
  };

  for (int idx = tid; idx < kTP * m.np_[last]; idx += kThreads) {
    const int p = idx / m.np_[last], c = idx % m.np_[last];
    Gf[p * kLdX + c] = c < m.d_out && p0 + p < n ? g[(size_t)(p0 + p) * m.d_out + c] : 0.0f;
  }
  __syncthreads();
  for (int i = last; i >= 0; --i) {
    const int np = m.np_[i], o = m.out_dim[i], kp = m.kp[i], in = m.in_dim[i];
    bf16* Aop = scratch + jobs.a_off[i];
    bf16* Bop = scratch + jobs.b_off[i];
    for (int idx = tid; idx < kTP * np; idx += kThreads) {
      const int p = idx / np, c = idx % np;
      float v = c < o ? Gf[p * kLdX + c] : 0.0f;
      if (i < last) v = v * (zval(p, m.z_off[i] + c) > 0.0f ? 1.0f : 0.0f);
      Gf[p * kLdX + c] = v;
      const bf16 vb = to_bf16(v);
      act[p * kLdA + c] = vb;
      Bop[(size_t)(p0 + p) * np + c] = vb;
    }
    for (int idx = tid; idx < kTP * kp; idx += kThreads) {
      const int p = idx / kp, c = idx % kp;
      float v = 0.0f;
      if (c < in && p0 + p < n)
        v = i == 0 ? x[(size_t)(p0 + p) * m.d0 + c] : fmaxf(zval(p, m.z_off[i - 1] + c), 0.0f);
      Aop[(size_t)(p0 + p) * kp + c] = to_bf16(v);
    }
    __syncthreads();
    for (int c = tid; c < np; c += kThreads) {
      float s = 0.0f;
      for (int p = 0; p < kTP; ++p) s += Gf[p * kLdX + c];
      prow[m.b_off[i] + c] = s;
    }
    gemm_rows16<true, kWarps>(act, kLdA, wpack + m.w_off[i], np, np, kp, Z, kLdX);
    __syncthreads();
    for (int idx = tid; idx < kTP * kp; idx += kThreads) {
      const int p = idx / kp, c = idx % kp;
      Gf[p * kLdX + c] = c < in ? Z[p * kLdX + c] : 0.0f;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < kTP * m.d0; idx += kThreads) {
    const int p = idx / m.d0, c = idx % m.d0;
    if (p0 + p < n) dx[(size_t)(p0 + p) * m.d0 + c] = Gf[p * kLdX + c];
  }
}

size_t fwd_smem() { return kTP * kLdX * sizeof(bf16) + kTP * kLdA * sizeof(bf16) + kTP * kLdZ * sizeof(float); }
size_t bwd_smem(const MlpMeta& m, bool recompute) {
  return 2 * kTP * kLdX * sizeof(float) + kTP * kLdA * sizeof(bf16) + (recompute ? kTP * m.zt * sizeof(float) : 0);
}

template <bool STASH>
int launch_fwd(const float* x, const void* wpack, const float* bpack, float* out, void* zs, int n, const int* meta,
               void* stream) {
  MlpMeta m;
  int rc = parse_mlp_meta(meta, &m);
  if (rc || n <= 0) return rc;
  rc = (int)cudaFuncSetAttribute(mlp_fwd_kernel<STASH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)fwd_smem());
  if (rc) return rc;
  mlp_fwd_kernel<STASH><<<(n + kTP - 1) / kTP, kThreads, fwd_smem(), (cudaStream_t)stream>>>(
      x, (const bf16*)wpack, bpack, out, (bf16*)zs, n, m);
  return (int)cudaGetLastError();
}

template <bool RECOMPUTE>
int launch_bwd(const float* x, const void* zs, const float* g, const void* wpack, const float* bpack, float* dx,
               void* scratch, float* partial, float* colsum, float* part_dw, float* dw, const long long* jobs,
               int n_jobs, int split, int n, const int* meta, void* stream) {
  MlpMeta m;
  int rc = parse_mlp_meta(meta, &m);
  if (rc) return rc;
  DwJobs J;
  rc = parse_jobs(jobs, n_jobs, &J);
  if (rc) return rc;
  if (n_jobs != m.n_lin) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const size_t smem = bwd_smem(m, RECOMPUTE);
  rc = (int)cudaFuncSetAttribute(mlp_bwd_kernel<RECOMPUTE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc) return rc;
  int bt = 0;
  for (int i = 0; i < m.n_lin; ++i) bt += m.np_[i];
  const int nblk = (n + kTP - 1) / kTP;
  cudaStream_t s = (cudaStream_t)stream;
  mlp_bwd_kernel<RECOMPUTE><<<nblk, kThreads, smem, s>>>(x, (const bf16*)zs, g, (const bf16*)wpack, bpack, dx,
                                                         (bf16*)scratch, partial, n, m, J, bt);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_dw_sums((const bf16*)scratch, part_dw, dw, J, split, partial, nblk, bt, colsum, s);
}

}  // namespace

extern "C" int mlp_stash_fwd(const float* x, const void* wpack, const float* bpack, float* out, void* zs, int n,
                             const int* meta, void* stream) {
  return launch_fwd<true>(x, wpack, bpack, out, zs, n, meta, stream);
}

extern "C" int mlp_fwd(const float* x, const void* wpack, const float* bpack, float* out, int n, const int* meta,
                       void* stream) {
  return launch_fwd<false>(x, wpack, bpack, out, nullptr, n, meta, stream);
}

extern "C" int mlp_stash_bwd(const float* x, const void* zs, const float* g, const void* wpack, float* dx,
                             void* scratch, float* partial, float* colsum, float* part_dw, float* dw,
                             const long long* jobs, int n_jobs, int split, int n, const int* meta, void* stream) {
  return launch_bwd<false>(x, zs, g, wpack, nullptr, dx, scratch, partial, colsum, part_dw, dw, jobs, n_jobs, split,
                           n, meta, stream);
}

extern "C" int mlp_bwd(const float* x, const float* g, const void* wpack, const float* bpack, float* dx,
                       void* scratch, float* partial, float* colsum, float* part_dw, float* dw, const long long* jobs,
                       int n_jobs, int split, int n, const int* meta, void* stream) {
  return launch_bwd<true>(x, nullptr, g, wpack, bpack, dx, scratch, partial, colsum, part_dw, dw, jobs, n_jobs, split,
                          n, meta, stream);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
