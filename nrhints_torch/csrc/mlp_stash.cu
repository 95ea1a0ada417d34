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
// (kMlpPlain), so its output is F's bit for bit.  It serves the eval
// trunk (eval_reflectance_impl="pallas") and the forward of the recompute
// op.
// J replaces: core_mlp.py::_mlp_bwd_pallas (:453), jax.vjp of mlp_relu_ref
// per block: two launches, a recompute pass J1 (F's kernel without the
// output layer) that writes the z_i into a transient bf16 stash of F's
// layout, then G's chain on it (J2).  The wrapper allocates the stash per
// call, so nothing is kept between the forward and the backward call, and
// J's gradients are G's at F's stash bit for bit: the ReLU backward reads
// only the sign of z_i and bf16(relu(z_i)), which a bf16 z_i keeps.
//
// Bound on an H100 at 65,536 points: F and I do 38 GFLOP (0.038 ms at 989
// TFLOP/s bf16); F moves 95 MB in, 134 MB of stash and 0.8 MB out (0.069 ms
// at 3.35 TB/s), I only the 95 MB in (0.028 ms).  G does about 76 GFLOP
// (0.077 ms) and moves about 324 MB (0.097 ms); J does the forward's 38
// GFLOP more (114 GFLOP, 0.115 ms) and moves 190 MB (x in, dx out; 0.057
// ms).  F and G are bound by bytes, I and J by operations.
//
// Design.  A block takes kChainTP = 64 points on kChainThreads = 512
// threads (16 warps), as the SDF core's kernels do: every product goes
// through staged_mma.cuh::gemm_rows64, the weights streamed through a
// 3-stage cp.async ring in shared memory, so a weight byte fetched from L2
// serves 64 points; each product's first slabs are requested before the
// elementwise pass in front of it; the elementwise passes take four
// columns of one point per item.  The first layer's 368-deep product walks
// six k-slabs, the last one partial; dx = G_0 W_0^T, 368 columns wide, runs
// as column passes of at most 256 (the warps' tiling and a transposed ring
// slab), each stored to dx.  Shared memory (one block per SM):
//   forward  the bf16 input tile [64][kLdX] (each hidden layer's
//            relu(z + b) written in place into it once the product that
//            read it has returned: x is dead after layer 0), the f32
//            product tile [64][kLdZ] and the ring: 50,176 + 66,560 +
//            110,592 = 227,328 B;
//   chain    the f32 running cotangent [64][kLdZ] (each product written in
//            place), the bf16 operand tile [64][kLdA] and the ring: 66,560
//            + 33,792 + 110,592 = 210,944 B.
// The chain writes dx and, per layer, the operands of dW_i in bf16 (the
// reference rounds exactly these to bf16) and f32 column sums of G_i, one
// row per kSumRows = 16 points; the products and the sums over the rows are
// dw_sum.cuh's passes, in a fixed order.  Each output tile walks its
// k-tiles in order, 16 deep at a time, and db_i's rows are sums of 16
// points, as in the earlier 16-point blocks of these kernels, so F's output
// and stash, I's output and G's and J's gradients equal those of that
// design bit for bit (scripts/compare_trunk.py holds two checkouts to it).
// The ragged edge is masked: rows past N read zeros and store nothing but
// the dW operands' zero rows.
//
// The f32 instances replace the same pallas_calls at compute_dtype="float32"
// (mlp_relu_ref and its twins with cdt=None: exact f32 dots) and, for F and
// G, at stash_dtype="float32" (an f32 stash): the dtypes argument selects
// mlp_fwd_kernel<T, S, MODE> and mlp_bwd_chain_kernel<T, S>, T the dot
// operands' type and S the stash's (F and G at every pair; I at T = S; J
// at T = S, so J's f32 instance keeps its transient stash in f32, as JAX's
// f32 vjp reads relu(z_i) unrounded, and J's gradients are G's at F's stash
// bit for bit at f32 too).  Every T- and S-dependent step goes through
// staged_mma.cuh's ld4, st4 and mma_rows.cuh's CoreTile, which reduce to
// the bf16 expressions at T = S = bf16, so the bf16 instances give the
// shipping outputs bit for bit.  Bound on an H100 at 65,536 points and the
// 67 TFLOP/s f32 peak: F and I 0.57 ms, G 1.13 ms, J 1.70 ms (operations).
// Design: every product on mma_rows.cuh's f32 gemm_rows64_f32 (one fmaf a
// multiply-add in k order, a 2-stage ring of 32-row f32 slabs; layer 0's
// 368-deep product walks 11.5 slabs), the dW operands in an f32 scratch and
// their products on dw_sum.cuh's dw_partial_f32_kernel over the same row
// chunks, summed by the same in-order passes, so the f32 gradients repeat
// bit for bit.  The chain's transposed products read the f32 pack's
// transposed blocks (core_mlp.pack_mlp's wtpack): dx = G_0 W_0^T reads
// columns 0-255 and 256-367 of W_0^T [256][368].  Shared memory (one block
// per SM):
//   forward  the f32 input tile [64][kInMax + 4] (each hidden layer's
//            relu(z + b) written in place, as in bf16), the f32 product
//            tile and the ring: 99,328 + 66,560 + 65,536 = 231,424 B;
//   chain    the f32 running cotangent, the f32 operand tile and the ring:
//            66,560 + 66,560 + 65,536 = 198,656 B.
#include "dw_sum.cuh"
#include "mma_rows.cuh"

using namespace nrh;

namespace {

constexpr int kInMax = 384;         // widest padded trunk input (core_mlp.IN_MAX)
constexpr int kSumRows = 16;        // points per row of the bias sums (core_mlp.SUM_ROWS)
constexpr int kMlpPlain = 0, kMlpStash = 1, kMlpRecompute = 2;

// The row stride of the forward's input tile, in elements of T.
template <typename T>
__host__ __device__ constexpr int ld_x() {
  return std::is_same<T, float>::value ? kInMax + 4 : kInMax + 8;
}

// Shared memory by operand type T: the forward's input tile, f32 product
// tile and ring; the chain's f32 running cotangent, operand tile and ring.
template <typename T>
constexpr size_t mlp_fwd_smem() {
  return kChainTP * ld_x<T>() * sizeof(T) + kChainTP * kLdZ * sizeof(float) + CoreTile<T>::kRing * sizeof(T);
}
template <typename T>
constexpr size_t mlp_chain_smem() {
  return kChainTP * kLdZ * sizeof(float) + kChainTP * CoreTile<T>::kLdAct * sizeof(T) +
         CoreTile<T>::kRing * sizeof(T);
}
static_assert(mlp_fwd_smem<bf16>() == 227328 && mlp_fwd_smem<float>() == 231424 &&
                  mlp_chain_smem<bf16>() == 210944 && mlp_chain_smem<float>() == 198656,
              "the trunk's shared-memory budget (a block may have 227 KB)");

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

// The chain's transposed product G_i W_i^T at the layer's input columns
// c0 .. c0 + nc (at most kWMax): its first slabs, and the product into C.
// bf16 reads rows c0.. of W_i [kp, np] (wpack) through column-major
// fragments; f32 reads columns c0.. of the transposed block W_i^T [np, kp]
// (wtpack; row stride kp).
__device__ __forceinline__ void stage_wt(const bf16* w, int np, int kp, int c0, int nc, bf16* ring) {
  stage_first_slabs<true>(w + (size_t)c0 * np, np, np, nc, ring);
}
__device__ __forceinline__ void stage_wt(const float* wt, int np, int kp, int c0, int nc, float* ring) {
  stage_first_slabs_f32<kChainStagesF32>(wt + c0, kp, np, nc, ring);
}
__device__ __forceinline__ void product_wt(const bf16* A, const bf16* w, int np, int kp, int c0, int nc, float* C,
                                           bf16* ring) {
  gemm_rows64<true>(A, kLdA, w + (size_t)c0 * np, np, np, nc, C, kLdZ, ring);
}
__device__ __forceinline__ void product_wt(const float* A, const float* wt, int np, int kp, int c0, int nc, float* C,
                                           float* ring) {
  gemm_rows64_f32(A, kLdZ, wt + c0, kp, np, nc, C, kLdZ, ring);
}

// The forward of one 64-point block, dot operands of T.  MODE says what it
// writes:
//   kMlpPlain      the output (kernel I);
//   kMlpStash      the output and every hidden z_i rounded to S into the
//                  packed stash [N, ZT] (kernel F);
//   kMlpRecompute  the stash and nothing else: no output layer (J1).
template <typename T, typename S, int MODE>
__global__ void __launch_bounds__(kChainThreads)
    mlp_fwd_kernel(const float* __restrict__ x, const T* __restrict__ wpack, const float* __restrict__ bpack,
                   float* __restrict__ out, S* __restrict__ zs, int n, const MlpMeta m) {
  constexpr int kLdX = ld_x<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);                         // [kChainTP][kLdX]
  float* Z = reinterpret_cast<float*>(act + kChainTP * kLdX);  // [kChainTP][kLdZ]
  T* ring = reinterpret_cast<T*>(Z + kChainTP * kLdZ);
  const int tid = threadIdx.x, p0 = blockIdx.x * kChainTP;
  const int last = m.n_lin - 1, n_run = MODE == kMlpRecompute ? last : m.n_lin;

  // The input tile: x as a dot operand of T, zero past d0 and past N (x's
  // rows are d0 = 361 floats, so not 16-byte aligned: four scalar loads).
  stage_first_slabs<false>(wpack + m.w_off[0], m.np_[0], m.kp[0], m.np_[0], ring);
  const int w4 = m.kp[0] / 4;
  for (int idx = tid; idx < kChainTP * w4; idx += kChainThreads) {
    const int p = idx / w4, c = (idx % w4) * 4;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = c + k < m.d0 && p0 + p < n ? x[(size_t)(p0 + p) * m.d0 + c + k] : 0.0f;
    st4(act + p * kLdX + c, v);
  }

  // z_i = h_{i-1} W_i + b_i; h_i = relu(z_i) in T, over h_{i-1} in act.
  for (int i = 0; i < n_run; ++i) {
    const int np = m.np_[i], o = m.out_dim[i];
    const float* b = bpack + m.b_off[i];
    gemm_rows64<false>(act, kLdX, wpack + m.w_off[i], np, m.kp[i], np, Z, kLdZ, ring);
    __syncthreads();
    if (i == last) {  // the linear output layer
      for (int idx = tid; idx < kChainTP * o; idx += kChainThreads) {
        const int p = idx / o, c = idx % o;
        if (p0 + p < n) out[(size_t)(p0 + p) * m.d_out + c] = Z[p * kLdZ + c] + b[c];
      }
      return;
    }
    if (i + 1 < n_run)
      stage_first_slabs<false>(wpack + m.w_off[i + 1], m.np_[i + 1], m.kp[i + 1], m.np_[i + 1], ring);
    for (int idx = tid; idx < kChainTP * (np / 4); idx += kChainThreads) {
      const int p = idx / (np / 4), c = (idx % (np / 4)) * 4;
      float z[4], bb[4], h[4];
      ld_f4(Z + p * kLdZ + c, z);
      ld_f4(b + c, bb);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        z[k] = c + k < o ? z[k] + bb[k] : 0.0f;
        h[k] = fmaxf(z[k], 0.0f);
      }
      st4(act + p * kLdX + c, h);
      if (MODE != kMlpPlain && p0 + p < n) st4(zs + (size_t)(p0 + p) * m.zt + m.z_off[i] + c, z);
    }
  }
}

// The backward chain of one 64-point block at the stash zs of S, dot
// operands of T: G1, and J2 on J1's transient stash.  G_i = G [z_i > 0]
// (the cotangent g at the output layer), then G <- G_i W_i^T, down to dx.
// The transposed products read wpack in bf16 and wtpack in f32 (null in
// bf16; stage_wt).
template <typename T, typename S>
__global__ void __launch_bounds__(kChainThreads)
    mlp_bwd_chain_kernel(const float* __restrict__ x, const S* __restrict__ zs, const float* __restrict__ g,
                         const T* __restrict__ wpack, const T* __restrict__ wtpack, float* __restrict__ dx,
                         T* __restrict__ scratch, float* __restrict__ partial, int n, const MlpMeta m,
                         const DwJobs jobs, int bt) {
  constexpr int kLdAct = CoreTile<T>::kLdAct;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Gf = reinterpret_cast<float*>(smem);             // [kChainTP][kLdZ] the running cotangent
  T* act = reinterpret_cast<T*>(Gf + kChainTP * kLdZ);    // [kChainTP][kLdAct] the product's operand
  T* ring = act + kChainTP * kLdAct;
  const T* wt = std::is_same<T, float>::value ? wtpack : wpack;
  const int tid = threadIdx.x, p0 = blockIdx.x * kChainTP;
  const int last = m.n_lin - 1, d0 = m.d0;
  // Four columns of the stash (zero past N).
  auto z4 = [&](int p, int col, float* v) {
    if (p0 + p < n)
      ld4(zs + (size_t)(p0 + p) * m.zt + col, v);
    else
      v[0] = v[1] = v[2] = v[3] = 0.0f;
  };

  stage_wt(wt + m.w_off[last], m.np_[last], m.kp[last], 0, min(m.kp[last], kWMax), ring);
  for (int i = last; i >= 0; --i) {
    const int np = m.np_[i], o = m.out_dim[i], kp = m.kp[i], in = m.in_dim[i];
    T* Aop = scratch + jobs.a_off[i];
    T* Bop = scratch + jobs.b_off[i];
    if (i < last) stage_wt(wt + m.w_off[i], np, kp, 0, min(kp, kWMax), ring);
    // G_i in f32 (for the bias sums), and in T as the product's operand
    // and dW_i's B operand.
    for (int idx = tid; idx < kChainTP * (np / 4); idx += kChainThreads) {
      const int p = idx / (np / 4), c = (idx % (np / 4)) * 4;
      float v[4], z[4];
      if (i == last) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = c + k < o && p0 + p < n ? g[(size_t)(p0 + p) * m.d_out + c + k] : 0.0f;
      } else {
        ld_f4(Gf + p * kLdZ + c, v);
        z4(p, m.z_off[i] + c, z);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = c + k < o ? v[k] * (z[k] > 0.0f ? 1.0f : 0.0f) : 0.0f;
      }
      st_f4(Gf + p * kLdZ + c, v);
      st4(act + p * kLdAct + c, v);
      st4(Bop + (size_t)(p0 + p) * np + c, v);
    }
    // dW_i's A operand: the layer's input in T (x, or relu(z_{i-1})).
    for (int idx = tid; idx < kChainTP * (kp / 4); idx += kChainThreads) {
      const int p = idx / (kp / 4), c = (idx % (kp / 4)) * 4;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (p0 + p < n) {
        if (i == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c + k < in) v[k] = x[(size_t)(p0 + p) * d0 + c + k];
        } else {
          z4(p, m.z_off[i - 1] + c, v);
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = c + k < in ? fmaxf(v[k], 0.0f) : 0.0f;
        }
      }
      st4(Aop + (size_t)(p0 + p) * kp + c, v);
    }
    __syncthreads();
    // db_i's partial sums: one row per kSumRows points, summed in point
    // order.  The product below begins with a barrier, so these reads of
    // Gf finish before it overwrites Gf.
    for (int idx = tid; idx < (kChainTP / kSumRows) * np; idx += kChainThreads) {
      const int q = idx / np, c = idx % np;
      float s = 0.0f;
      for (int p = q * kSumRows; p < (q + 1) * kSumRows; ++p) s += Gf[p * kLdZ + c];
      partial[((size_t)blockIdx.x * (kChainTP / kSumRows) + q) * bt + m.b_off[i] + c] = s;
    }
    if (i > 0) {
      product_wt(act, wt + m.w_off[i], np, kp, 0, kp, Gf, ring);
      __syncthreads();
      continue;
    }
    // dx = G_0 W_0^T, in column passes of at most kWMax, each stored to dx.
    for (int c0 = 0; c0 < kp; c0 += kWMax) {
      const int nc = min(kp - c0, kWMax);
      if (c0 > 0) stage_wt(wt + m.w_off[0], np, kp, c0, nc, ring);
      product_wt(act, wt + m.w_off[0], np, kp, c0, nc, Gf, ring);
      __syncthreads();
      for (int idx = tid; idx < kChainTP * nc; idx += kChainThreads) {
        const int p = idx / nc, c = idx % nc;
        if (p0 + p < n && c0 + c < d0) dx[(size_t)(p0 + p) * d0 + c0 + c] = Gf[p * kLdZ + c];
      }
    }
  }
}

int nblocks(int n) { return (n + kChainTP - 1) / kChainTP; }

template <typename T, typename S, int MODE>
int launch_fwd(const float* x, const void* wpack, const float* bpack, float* out, void* zs, int n, const MlpMeta& m,
               cudaStream_t stream) {
  constexpr size_t kMlpFwdSmem = mlp_fwd_smem<T>();
  int rc = (int)cudaFuncSetAttribute(mlp_fwd_kernel<T, S, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)kMlpFwdSmem);
  if (rc) return rc;
  mlp_fwd_kernel<T, S, MODE><<<nblocks(n), kChainThreads, kMlpFwdSmem, stream>>>(x, (const T*)wpack, bpack, out,
                                                                                  (S*)zs, n, m);
  return (int)cudaGetLastError();
}

// The chain, then dw_sum.cuh's passes over its nblk * kChainTP / kSumRows
// rows of bias sums (the scratch's type T picks the partial products'
// kernel).
template <typename T, typename S>
int launch_chain(const float* x, const void* zs, const float* g, const void* wpack, const void* wtpack, float* dx,
                 void* scratch, float* partial, float* colsum, float* part_dw, float* dw, const DwJobs& J, int split,
                 int n, const MlpMeta& m, cudaStream_t stream) {
  constexpr size_t kMlpChainSmem = mlp_chain_smem<T>();
  int rc = (int)cudaFuncSetAttribute(mlp_bwd_chain_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)kMlpChainSmem);
  if (rc) return rc;
  int bt = 0;
  for (int i = 0; i < m.n_lin; ++i) bt += m.np_[i];
  const int nblk = nblocks(n);
  mlp_bwd_chain_kernel<T, S><<<nblk, kChainThreads, kMlpChainSmem, stream>>>(
      x, (const S*)zs, g, (const T*)wpack, (const T*)wtpack, dx, (T*)scratch, partial, n, m, J, bt);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_dw_sums((const T*)scratch, part_dw, dw, J, split, partial, nblk * (kChainTP / kSumRows), bt, colsum,
                        stream);
}

// J at operand type T: the recompute pass J1 into the transient stash zsc
// [N, ZT] of T, then the chain on it.
template <typename T>
int launch_recompute_bwd(const float* x, const float* g, const void* wpack, const void* wtpack, const float* bpack,
                         void* zsc, float* dx, void* scratch, float* partial, float* colsum, float* part_dw, float* dw,
                         const DwJobs& J, int split, int n, const MlpMeta& m, cudaStream_t stream) {
  if (m.n_lin > 1) {
    const int rc = launch_fwd<T, T, kMlpRecompute>(x, wpack, bpack, nullptr, zsc, n, m, stream);
    if (rc) return rc;
  }
  return launch_chain<T, T>(x, zsc, g, wpack, wtpack, dx, scratch, partial, colsum, part_dw, dw, J, split, n, m,
                            stream);
}

// The instance the dtypes select: F and G at each (T, S) pair; I at T = S.
template <int MODE, typename... A>
int launch_fwd_dtypes(int dtypes, A... a) {
  if constexpr (MODE == kMlpPlain) {
    return dtypes & kF32Compute ? launch_fwd<float, float, MODE>(a...) : launch_fwd<bf16, bf16, MODE>(a...);
  } else {
    switch (dtypes) {
      case 0:
        return launch_fwd<bf16, bf16, MODE>(a...);
      case kF32Compute:
        return launch_fwd<float, bf16, MODE>(a...);
      case kF32Stash:
        return launch_fwd<bf16, float, MODE>(a...);
      case kF32Compute | kF32Stash:
        return launch_fwd<float, float, MODE>(a...);
    }
    return (int)cudaErrorInvalidValue;
  }
}

template <typename... A>
int launch_chain_dtypes(int dtypes, A... a) {
  switch (dtypes) {
    case 0:
      return launch_chain<bf16, bf16>(a...);
    case kF32Compute:
      return launch_chain<float, bf16>(a...);
    case kF32Stash:
      return launch_chain<bf16, float>(a...);
    case kF32Compute | kF32Stash:
      return launch_chain<float, float>(a...);
  }
  return (int)cudaErrorInvalidValue;
}

int parse_bwd(const int* meta, const long long* jobs, int n_jobs, MlpMeta* m, DwJobs* J) {
  int rc = parse_mlp_meta(meta, m);
  if (rc) return rc;
  rc = parse_jobs(jobs, n_jobs, J);
  if (rc) return rc;
  return n_jobs != m->n_lin ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// dtypes: kF32Compute and kF32Stash select F's instance (its dot operands'
// and its stash's types; wpack holds the operands' type).
extern "C" int mlp_stash_fwd(const float* x, const void* wpack, const float* bpack, float* out, void* zs, int n,
                             const int* meta, int dtypes, void* stream) {
  MlpMeta m;
  const int rc = parse_mlp_meta(meta, &m);
  if (rc || n <= 0) return rc;
  return launch_fwd_dtypes<kMlpStash>(dtypes, x, wpack, bpack, out, zs, n, m, (cudaStream_t)stream);
}

// dtypes: kF32Compute selects I's f32 instance.
extern "C" int mlp_fwd(const float* x, const void* wpack, const float* bpack, float* out, int n, const int* meta,
                       int dtypes, void* stream) {
  MlpMeta m;
  const int rc = parse_mlp_meta(meta, &m);
  if (rc || n <= 0) return rc;
  return launch_fwd_dtypes<kMlpPlain>(dtypes, x, wpack, bpack, out, nullptr, n, m, (cudaStream_t)stream);
}

// dtypes: kF32Compute and kF32Stash select G's instance (its dot operands',
// and so its scratch's, and its stash's types); wtpack is the f32 pack's
// transposed blocks (null in bf16).
extern "C" int mlp_stash_bwd(const float* x, const void* zs, const float* g, const void* wpack, const void* wtpack,
                             float* dx, void* scratch, float* partial, float* colsum, float* part_dw, float* dw,
                             const long long* jobs, int n_jobs, int split, int n, const int* meta, int dtypes,
                             void* stream) {
  MlpMeta m;
  DwJobs J;
  const int rc = parse_bwd(meta, jobs, n_jobs, &m, &J);
  if (rc || n <= 0) return rc;
  return launch_chain_dtypes(dtypes, x, zs, g, wpack, wtpack, dx, scratch, partial, colsum, part_dw, dw, J, split, n,
                             m, (cudaStream_t)stream);
}

// J: the recompute pass J1 into the transient stash zsc [N, ZT], then the
// chain on it; dtypes: kF32Compute selects J's f32 instance, whose zsc is
// f32.
extern "C" int mlp_bwd(const float* x, const float* g, const void* wpack, const void* wtpack, const float* bpack,
                       void* zsc, float* dx, void* scratch, float* partial, float* colsum, float* part_dw, float* dw,
                       const long long* jobs, int n_jobs, int split, int n, const int* meta, int dtypes,
                       void* stream) {
  MlpMeta m;
  DwJobs J;
  const int rc = parse_bwd(meta, jobs, n_jobs, &m, &J);
  if (rc || n <= 0) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtypes & kF32Compute)
    return launch_recompute_bwd<float>(x, g, wpack, wtpack, bpack, zsc, dx, scratch, partial, colsum, part_dw, dw, J,
                                       split, n, m, s);
  return launch_recompute_bwd<bf16>(x, g, wpack, wtpack, bpack, zsc, dx, scratch, partial, colsum, part_dw, dw, J,
                                    split, n, m, s);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
