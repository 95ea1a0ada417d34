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
// Design: every product on mma_rows.cuh's gemm_rows_f32<RowsNarrow> (one fmaf a
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
//
// The wide instances replace the same pallas_calls above the presets'
// widths (JAX's kernels take any width): padded hidden widths up to 512 and
// a padded input up to kInWide = 640, which takes sdf_network.d_out_feat =
// 512 under both hints (617 inputs at multi_res 4).  Bound on an H100 at
// 65,536 points and 617 -> 4 x 512 -> 3 (1.104 M multiply-adds a point,
// 3.81x the presets'): F and I 145 GFLOP (0.146 ms at 989 TFLOP/s bf16; F
// moves 162 MB in and 268 MB of stash, 0.128 ms at 3.35 TB/s), G 289
// GFLOP (0.293 ms), J 434 GFLOP (0.439 ms), all bound by operations; at the
// 67 TFLOP/s f32 peak 2.16, 4.32 and 6.48 ms.  Design: the class TrunkWide
// is the template argument Cls of the same two block bodies (the 64-point
// instances are Cls = TrunkNarrow, so their code, floats and kernel names
// are the parent's).  A 64-point block cannot hold the wide tiles (the
// bf16 input tile alone would be 82,944 B and an f32 product tile 132,096
// B), so a wide block takes kWidePts = 32 points on the same 512 threads,
// as the SDF core's wide instances do: every bf16 product on
// staged_mma.cuh::gemm_rows32 (column passes of at most 256 on the same
// ring) into a [32][516] f32 tile, every f32 product on mma_rows.cuh's
// gemm_rows_f32<RowsWide> (32 rows, 512 columns a pass, two stages of 16
// k-rows).  dx = G_0 W_0^T (up to 624 columns) runs as column passes of at
// most 512.  Each output keeps its k order, 16 deep, and db's rows are sums
// of kSumRows = 16 points, so F = I, J = G at F's stash, and G and J repeat,
// bit for bit, as in the 64-point instances.  Shared memory (one block per
// SM):
//   forward  bf16 input tile [32][648], f32 product tile [32][516], ring:
//            41,472 + 66,048 + 110,592 = 218,112 B; f32: input tile
//            [32][644], 82,432 + 66,048 + 65,536 = 214,016 B;
//   chain    f32 running cotangent [32][516], operand tile [32][520] bf16
//            or [32][516] f32, ring: 209,920 B bf16, 197,632 B f32.
// Bit 2 of the dtypes argument (kWideClass) selects them.
#include "dw_sum.cuh"
#include "mma_rows.cuh"

using namespace nrh;

namespace {

constexpr int kInMax = 384;         // widest padded trunk input (core_mlp.IN_MAX)
constexpr int kInWide = 640;        // widest padded trunk input of the wide class (core_mlp.TRUNK_WIDE)
constexpr int kSumRows = 16;        // points per row of the bias sums (core_mlp.SUM_ROWS)
constexpr int kMlpPlain = 0, kMlpStash = 1, kMlpRecompute = 2;
constexpr int kMlpMetaHead = 4;     // ints of the trunk's meta vector before its per-layer rows

// The trunk's width classes (core_mlp.TRUNK_NARROW, TRUNK_WIDE): kPts points
// a block, kIn the widest padded input, kW the widest padded hidden layer
// (and the widest column pass of dx), kLdC the f32 row stride of the product
// tile and the running cotangent; Core the SDF core's class whose bf16
// products they run (core_stage, core_gemm), Rows the f32 engine's class.
struct TrunkNarrow {
  static constexpr int kPts = kChainTP, kIn = kInMax, kW = kWMax, kLdC = kLdZ;
  using Core = CoreNarrow;
  using Rows = RowsNarrow;
};
struct TrunkWide {
  static constexpr int kPts = kWidePts, kIn = kInWide, kW = kWideWMax, kLdC = CoreWide::kLdC;
  using Core = CoreWide;
  using Rows = RowsWide;
};

// The row strides, in elements of T, of the forward's input tile and of the
// chain's operand tile.
template <class Cls, typename T>
__host__ __device__ constexpr int ld_x() {
  return std::is_same<T, float>::value ? Cls::kIn + 4 : Cls::kIn + 8;
}
template <class Cls, typename T>
__host__ __device__ constexpr int ld_act() {
  return std::is_same<T, float>::value ? Cls::kW + 4 : Cls::kW + 8;
}

// Shared memory by class and operand type T: the forward's input tile, f32
// product tile and ring; the chain's f32 running cotangent, operand tile and
// ring (the ring's bytes are the same in both classes).
template <class Cls, typename T>
constexpr size_t mlp_fwd_smem() {
  return Cls::kPts * ld_x<Cls, T>() * sizeof(T) + Cls::kPts * Cls::kLdC * sizeof(float) +
         CoreTile<T>::kRing * sizeof(T);
}
template <class Cls, typename T>
constexpr size_t mlp_chain_smem() {
  return Cls::kPts * Cls::kLdC * sizeof(float) + Cls::kPts * ld_act<Cls, T>() * sizeof(T) +
         CoreTile<T>::kRing * sizeof(T);
}
static_assert(mlp_fwd_smem<TrunkNarrow, bf16>() == 227328 && mlp_fwd_smem<TrunkNarrow, float>() == 231424 &&
                  mlp_chain_smem<TrunkNarrow, bf16>() == 210944 && mlp_chain_smem<TrunkNarrow, float>() == 198656,
              "the trunk's shared-memory budget (a block may have 227 KB)");
static_assert(mlp_fwd_smem<TrunkWide, bf16>() == 218112 && mlp_fwd_smem<TrunkWide, float>() == 214016 &&
                  mlp_chain_smem<TrunkWide, bf16>() == 209920 && mlp_chain_smem<TrunkWide, float>() == 197632,
              "the wide trunk's shared-memory budget");
static_assert(TrunkWide::kPts % kSumRows == 0 && TrunkWide::kLdC == TrunkWide::kW + 4,
              "a wide block holds whole rows of bias sums and a 512-wide product");

struct MlpMeta {
  int n_lin, d0, d_out, zt, bt;  // bt: the sum of the padded output widths (the bias sums' columns)
  int in_[kMaxLayers], out_[kMaxLayers], kp_[kMaxLayers], np_[kMaxLayers];
  int w_off_[kMaxLayers], b_off_[kMaxLayers], z_off_[kMaxLayers];
  // The meta vector on the card where n_lin > kMaxLayers (its rows are
  // then read from there), else null.
  const int* dev;

  // Field k of layer i's row: the parameter table's, or the device copy's.
  __device__ __forceinline__ int field(const int (&t)[kMaxLayers], int i, int k) const {
    return dev ? dev[kMlpMetaHead + 7 * i + k] : t[i];
  }
  __device__ __forceinline__ int in(int i) const { return field(in_, i, 0); }
  __device__ __forceinline__ int out(int i) const { return field(out_, i, 1); }
  __device__ __forceinline__ int kp(int i) const { return field(kp_, i, 2); }
  __device__ __forceinline__ int np(int i) const { return field(np_, i, 3); }
  __device__ __forceinline__ int w_off(int i) const { return field(w_off_, i, 4); }
  __device__ __forceinline__ int b_off(int i) const { return field(b_off_, i, 5); }
  __device__ __forceinline__ int z_off(int i) const { return field(z_off_, i, 6); }
};

// meta = [n_lin, d0, d_out, ZT, then per layer: in, out, kp, np, w_off,
// b_off, z_off] (core_mlp.py::pack_mlp) in host memory, checked against the
// limits of the class Cls.  Up to kMaxLayers linears the rows ride in
// MlpMeta's tables; a deeper trunk's are read from meta_dev, the same vector
// on the card (null for a shallower one).
template <class Cls>
int parse_mlp_meta(const int* meta, const int* meta_dev, MlpMeta* m, Cls) {
  m->n_lin = meta[0];
  m->d0 = meta[1];
  m->d_out = meta[2];
  m->zt = meta[3];
  if (m->n_lin < 1 || (m->n_lin > kMaxLayers && !meta_dev)) return (int)cudaErrorInvalidValue;
  m->dev = m->n_lin > kMaxLayers ? meta_dev : nullptr;
  m->bt = 0;
  for (int i = 0; i < m->n_lin; ++i) {
    const int* l = meta + kMlpMetaHead + 7 * i;
    if (l[2] > (i == 0 ? Cls::kIn : Cls::kW) || l[3] > Cls::kW) return (int)cudaErrorInvalidValue;
    m->bt += l[3];
    if (i >= kMaxLayers) continue;
    m->in_[i] = l[0];
    m->out_[i] = l[1];
    m->kp_[i] = l[2];
    m->np_[i] = l[3];
    m->w_off_[i] = l[4];
    m->b_off_[i] = l[5];
    m->z_off_[i] = l[6];
  }
  return 0;
}

// The products of a Cls block with dot operands of T, and their first
// slabs (requested before the elementwise pass in front of the product):
// the forward's h W_i, W_i the row-major [kp, np] block of wpack; the
// chain's transposed G_i W_i^T at the layer's input columns c0 .. c0 + nc
// (at most Cls::kW).  bf16: the SDF core's products of Cls::Core
// (gemm_rows64, or gemm_rows32's column passes of at most kWMax), the
// transposed ones reading rows c0.. of W_i through column-major fragments.
// f32: gemm_rows_f32 of Cls::Rows, the transposed ones reading columns c0..
// of the transposed block W_i^T [np, kp] (wtpack; row stride kp).  C is the
// f32 tile of row stride Cls::kLdC.
template <class Cls>
__device__ __forceinline__ void stage_w(const bf16* w, int np, int kp, bf16* ring) {
  core_stage<typename Cls::Core, false>(w, np, kp, np, ring);
}
template <class Cls>
__device__ __forceinline__ void stage_w(const float* w, int np, int kp, float* ring) {
  stage_first_slabs_f32<kChainStagesF32, typename Cls::Rows>(w, np, kp, np, ring);
}
template <class Cls>
__device__ __forceinline__ void product_w(const bf16* A, int lda, const bf16* w, int np, int kp, float* C,
                                          bf16* ring) {
  core_gemm<typename Cls::Core, false>(A, lda, w, np, kp, np, C, Cls::kLdC, ring);
}
template <class Cls>
__device__ __forceinline__ void product_w(const float* A, int lda, const float* w, int np, int kp, float* C,
                                          float* ring) {
  gemm_rows_f32<typename Cls::Rows>(A, lda, w, np, kp, np, C, Cls::kLdC, ring);
}
template <class Cls>
__device__ __forceinline__ void stage_wt(const bf16* w, int np, int kp, int c0, int nc, bf16* ring) {
  core_stage<typename Cls::Core, true>(w + (size_t)c0 * np, np, np, nc, ring);
}
template <class Cls>
__device__ __forceinline__ void stage_wt(const float* wt, int np, int kp, int c0, int nc, float* ring) {
  stage_first_slabs_f32<kChainStagesF32, typename Cls::Rows>(wt + c0, kp, np, nc, ring);
}
template <class Cls>
__device__ __forceinline__ void product_wt(const bf16* A, const bf16* w, int np, int kp, int c0, int nc, float* C,
                                           bf16* ring) {
  core_gemm<typename Cls::Core, true>(A, ld_act<Cls, bf16>(), w + (size_t)c0 * np, np, np, nc, C, Cls::kLdC, ring);
}
template <class Cls>
__device__ __forceinline__ void product_wt(const float* A, const float* wt, int np, int kp, int c0, int nc, float* C,
                                           float* ring) {
  gemm_rows_f32<typename Cls::Rows>(A, ld_act<Cls, float>(), wt + c0, kp, np, nc, C, Cls::kLdC, ring);
}

// The forward of one block of Cls::kPts points, dot operands of T.  MODE
// says what it writes:
//   kMlpPlain      the output (kernel I);
//   kMlpStash      the output and every hidden z_i rounded to S into the
//                  packed stash [N, ZT] (kernel F);
//   kMlpRecompute  the stash and nothing else: no output layer (J1).
template <class Cls, typename T, typename S, int MODE>
__device__ __forceinline__ void mlp_fwd_block(unsigned char* smem, const float* __restrict__ x,
                                              const T* __restrict__ wpack, const float* __restrict__ bpack,
                                              float* __restrict__ out, S* __restrict__ zs, int n, const MlpMeta& m) {
  constexpr int kPts = Cls::kPts, kLdX = ld_x<Cls, T>(), kLdC = Cls::kLdC;
  T* act = reinterpret_cast<T*>(smem);                     // [kPts][kLdX]
  float* Z = reinterpret_cast<float*>(act + kPts * kLdX);  // [kPts][kLdC]
  T* ring = reinterpret_cast<T*>(Z + kPts * kLdC);
  const int tid = threadIdx.x, p0 = blockIdx.x * kPts;
  const int last = m.n_lin - 1, n_run = MODE == kMlpRecompute ? last : m.n_lin;

  // The input tile: x as a dot operand of T, zero past d0 and past N (x's
  // rows are d0 = 361 floats, so not 16-byte aligned: four scalar loads).
  stage_w<Cls>(wpack + m.w_off(0), m.np(0), m.kp(0), ring);
  const int w4 = m.kp(0) / 4;
  for (int idx = tid; idx < kPts * w4; idx += kChainThreads) {
    const int p = idx / w4, c = (idx % w4) * 4;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = c + k < m.d0 && p0 + p < n ? x[(size_t)(p0 + p) * m.d0 + c + k] : 0.0f;
    st4(act + p * kLdX + c, v);
  }

  // z_i = h_{i-1} W_i + b_i; h_i = relu(z_i) in T, over h_{i-1} in act.
  for (int i = 0; i < n_run; ++i) {
    const int np = m.np(i), o = m.out(i);
    const float* b = bpack + m.b_off(i);
    product_w<Cls>(act, kLdX, wpack + m.w_off(i), np, m.kp(i), Z, ring);
    __syncthreads();
    if (i == last) {  // the linear output layer
      for (int idx = tid; idx < kPts * o; idx += kChainThreads) {
        const int p = idx / o, c = idx % o;
        if (p0 + p < n) out[(size_t)(p0 + p) * m.d_out + c] = Z[p * kLdC + c] + b[c];
      }
      return;
    }
    if (i + 1 < n_run) stage_w<Cls>(wpack + m.w_off(i + 1), m.np(i + 1), m.kp(i + 1), ring);
    for (int idx = tid; idx < kPts * (np / 4); idx += kChainThreads) {
      const int p = idx / (np / 4), c = (idx % (np / 4)) * 4;
      float z[4], bb[4], h[4];
      ld_f4(Z + p * kLdC + c, z);
      ld_f4(b + c, bb);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        z[k] = c + k < o ? z[k] + bb[k] : 0.0f;
        h[k] = fmaxf(z[k], 0.0f);
      }
      st4(act + p * kLdX + c, h);
      if (MODE != kMlpPlain && p0 + p < n) st4(zs + (size_t)(p0 + p) * m.zt + m.z_off(i) + c, z);
    }
  }
}

// The backward chain of one block of Cls::kPts points at the stash zs of S,
// dot operands of T: G1, and J2 on J1's transient stash.  G_i = G [z_i > 0]
// (the cotangent g at the output layer), then G <- G_i W_i^T, down to dx.
// The transposed products read wpack in bf16 and wtpack in f32 (null in
// bf16; stage_wt).
template <class Cls, typename T, typename S>
__device__ __forceinline__ void mlp_bwd_chain_block(unsigned char* smem, const float* __restrict__ x,
                                                    const S* __restrict__ zs, const float* __restrict__ g,
                                                    const T* __restrict__ wpack, const T* __restrict__ wtpack,
                                                    float* __restrict__ dx, T* __restrict__ scratch,
                                                    float* __restrict__ partial, int n, const MlpMeta& m,
                                                    const DwJobs& jobs, int bt) {
  constexpr int kPts = Cls::kPts, kLdC = Cls::kLdC, kLdAct = ld_act<Cls, T>(), kRowsPerBlock = kPts / kSumRows;
  float* Gf = reinterpret_cast<float*>(smem);        // [kPts][kLdC] the running cotangent
  T* act = reinterpret_cast<T*>(Gf + kPts * kLdC);   // [kPts][kLdAct] the product's operand
  T* ring = act + kPts * kLdAct;
  const T* wt = std::is_same<T, float>::value ? wtpack : wpack;
  const int tid = threadIdx.x, p0 = blockIdx.x * kPts;
  const int last = m.n_lin - 1, d0 = m.d0;
  // Four columns of the stash (zero past N).
  auto z4 = [&](int p, int col, float* v) {
    if (p0 + p < n)
      ld4(zs + (size_t)(p0 + p) * m.zt + col, v);
    else
      v[0] = v[1] = v[2] = v[3] = 0.0f;
  };

  stage_wt<Cls>(wt + m.w_off(last), m.np(last), m.kp(last), 0, min(m.kp(last), Cls::kW), ring);
  for (int i = last; i >= 0; --i) {
    const int np = m.np(i), o = m.out(i), kp = m.kp(i), in = m.in(i);
    T* Aop = scratch + jobs.a(i);
    T* Bop = scratch + jobs.b(i);
    if (i < last) stage_wt<Cls>(wt + m.w_off(i), np, kp, 0, min(kp, Cls::kW), ring);
    // G_i in f32 (for the bias sums), and in T as the product's operand
    // and dW_i's B operand.
    for (int idx = tid; idx < kPts * (np / 4); idx += kChainThreads) {
      const int p = idx / (np / 4), c = (idx % (np / 4)) * 4;
      float v[4], z[4];
      if (i == last) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = c + k < o && p0 + p < n ? g[(size_t)(p0 + p) * m.d_out + c + k] : 0.0f;
      } else {
        ld_f4(Gf + p * kLdC + c, v);
        z4(p, m.z_off(i) + c, z);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = c + k < o ? v[k] * (z[k] > 0.0f ? 1.0f : 0.0f) : 0.0f;
      }
      st_f4(Gf + p * kLdC + c, v);
      st4(act + p * kLdAct + c, v);
      st4(Bop + (size_t)(p0 + p) * np + c, v);
    }
    // dW_i's A operand: the layer's input in T (x, or relu(z_{i-1})).
    for (int idx = tid; idx < kPts * (kp / 4); idx += kChainThreads) {
      const int p = idx / (kp / 4), c = (idx % (kp / 4)) * 4;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (p0 + p < n) {
        if (i == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c + k < in) v[k] = x[(size_t)(p0 + p) * d0 + c + k];
        } else {
          z4(p, m.z_off(i - 1) + c, v);
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
    for (int idx = tid; idx < kRowsPerBlock * np; idx += kChainThreads) {
      const int q = idx / np, c = idx % np;
      float s = 0.0f;
      for (int p = q * kSumRows; p < (q + 1) * kSumRows; ++p) s += Gf[p * kLdC + c];
      partial[((size_t)blockIdx.x * kRowsPerBlock + q) * bt + m.b_off(i) + c] = s;
    }
    if (i > 0) {
      product_wt<Cls>(act, wt + m.w_off(i), np, kp, 0, kp, Gf, ring);
      __syncthreads();
      continue;
    }
    // dx = G_0 W_0^T, in column passes of at most Cls::kW, each stored to dx.
    for (int c0 = 0; c0 < kp; c0 += Cls::kW) {
      const int nc = min(kp - c0, Cls::kW);
      if (c0 > 0) stage_wt<Cls>(wt + m.w_off(0), np, kp, c0, nc, ring);
      product_wt<Cls>(act, wt + m.w_off(0), np, kp, c0, nc, Gf, ring);
      __syncthreads();
      for (int idx = tid; idx < kPts * nc; idx += kChainThreads) {
        const int p = idx / nc, c = idx % nc;
        if (p0 + p < n && c0 + c < d0) dx[(size_t)(p0 + p) * d0 + c0 + c] = Gf[p * kLdC + c];
      }
    }
  }
}

// The kernels: the 64-point instances (whose names the profiles read) and
// the wide ones, each one block body.
template <typename T, typename S, int MODE>
__global__ void __launch_bounds__(kChainThreads)
    mlp_fwd_kernel(const float* __restrict__ x, const T* __restrict__ wpack, const float* __restrict__ bpack,
                   float* __restrict__ out, S* __restrict__ zs, int n, const MlpMeta m) {
  extern __shared__ __align__(128) unsigned char smem[];
  mlp_fwd_block<TrunkNarrow, T, S, MODE>(smem, x, wpack, bpack, out, zs, n, m);
}
template <typename T, typename S, int MODE>
__global__ void __launch_bounds__(kChainThreads)
    mlp_fwd_wide_kernel(const float* __restrict__ x, const T* __restrict__ wpack, const float* __restrict__ bpack,
                        float* __restrict__ out, S* __restrict__ zs, int n, const MlpMeta m) {
  extern __shared__ __align__(128) unsigned char smem[];
  mlp_fwd_block<TrunkWide, T, S, MODE>(smem, x, wpack, bpack, out, zs, n, m);
}
template <typename T, typename S>
__global__ void __launch_bounds__(kChainThreads)
    mlp_bwd_chain_kernel(const float* __restrict__ x, const S* __restrict__ zs, const float* __restrict__ g,
                         const T* __restrict__ wpack, const T* __restrict__ wtpack, float* __restrict__ dx,
                         T* __restrict__ scratch, float* __restrict__ partial, int n, const MlpMeta m,
                         const DwJobs jobs, int bt) {
  extern __shared__ __align__(128) unsigned char smem[];
  mlp_bwd_chain_block<TrunkNarrow, T, S>(smem, x, zs, g, wpack, wtpack, dx, scratch, partial, n, m, jobs, bt);
}
template <typename T, typename S>
__global__ void __launch_bounds__(kChainThreads)
    mlp_bwd_chain_wide_kernel(const float* __restrict__ x, const S* __restrict__ zs, const float* __restrict__ g,
                              const T* __restrict__ wpack, const T* __restrict__ wtpack, float* __restrict__ dx,
                              T* __restrict__ scratch, float* __restrict__ partial, int n, const MlpMeta m,
                              const DwJobs jobs, int bt) {
  extern __shared__ __align__(128) unsigned char smem[];
  mlp_bwd_chain_block<TrunkWide, T, S>(smem, x, zs, g, wpack, wtpack, dx, scratch, partial, n, m, jobs, bt);
}

// The class's kernel of each template.
template <class Cls, typename T, typename S, int MODE>
auto fwd_kernel() {
  if constexpr (std::is_same<Cls, TrunkWide>::value)
    return mlp_fwd_wide_kernel<T, S, MODE>;
  else
    return mlp_fwd_kernel<T, S, MODE>;
}
template <class Cls, typename T, typename S>
auto chain_kernel() {
  if constexpr (std::is_same<Cls, TrunkWide>::value)
    return mlp_bwd_chain_wide_kernel<T, S>;
  else
    return mlp_bwd_chain_kernel<T, S>;
}

template <class Cls>
int nblocks(int n) { return (n + Cls::kPts - 1) / Cls::kPts; }

// The launchers take the class as a tag, their first argument.
template <typename T, typename S, int MODE, class Cls>
int launch_fwd(Cls, const float* x, const void* wpack, const float* bpack, float* out, void* zs, int n,
               const MlpMeta& m, cudaStream_t stream) {
  constexpr size_t kMlpFwdSmem = mlp_fwd_smem<Cls, T>();
  const auto kernel = fwd_kernel<Cls, T, S, MODE>();
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMlpFwdSmem);
  if (rc) return rc;
  kernel<<<nblocks<Cls>(n), kChainThreads, kMlpFwdSmem, stream>>>(x, (const T*)wpack, bpack, out, (S*)zs, n, m);
  return (int)cudaGetLastError();
}

// The chain, then dw_sum.cuh's passes over its nblk * Cls::kPts / kSumRows
// rows of bias sums (the scratch's type T picks the partial products'
// kernel).
template <typename T, typename S, class Cls>
int launch_chain(Cls, const float* x, const void* zs, const float* g, const void* wpack, const void* wtpack,
                 float* dx, void* scratch, float* partial, float* colsum, float* part_dw, float* dw, const DwJobs& J,
                 int split, int n, const MlpMeta& m, cudaStream_t stream) {
  constexpr size_t kMlpChainSmem = mlp_chain_smem<Cls, T>();
  const auto kernel = chain_kernel<Cls, T, S>();
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMlpChainSmem);
  if (rc) return rc;
  const int bt = m.bt;
  const int nblk = nblocks<Cls>(n);
  kernel<<<nblk, kChainThreads, kMlpChainSmem, stream>>>(x, (const S*)zs, g, (const T*)wpack, (const T*)wtpack, dx,
                                                         (T*)scratch, partial, n, m, J, bt);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_dw_sums((const T*)scratch, part_dw, dw, J, split, partial, nblk * (Cls::kPts / kSumRows), bt, colsum,
                        stream);
}

// J at operand type T: the recompute pass J1 into the transient stash zsc
// [N, ZT] of T, then the chain on it.
template <typename T, class Cls>
int launch_recompute_bwd(Cls cls, const float* x, const float* g, const void* wpack, const void* wtpack,
                         const float* bpack, void* zsc, float* dx, void* scratch, float* partial, float* colsum,
                         float* part_dw, float* dw, const DwJobs& J, int split, int n, const MlpMeta& m,
                         cudaStream_t stream) {
  if (m.n_lin > 1) {
    const int rc = launch_fwd<T, T, kMlpRecompute>(cls, x, wpack, bpack, nullptr, zsc, n, m, stream);
    if (rc) return rc;
  }
  return launch_chain<T, T>(cls, x, zsc, g, wpack, wtpack, dx, scratch, partial, colsum, part_dw, dw, J, split, n, m,
                            stream);
}

// The instance the dtypes select: F and G at each (T, S) pair; I at T = S.
// a... begins with the class's tag.
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

// f(class tag, the dtypes without the class bit): kWideClass in dtypes
// selects the wide instances.
template <class F>
int by_class(int dtypes, F f) {
  return dtypes & kWideClass ? f(TrunkWide{}, dtypes ^ kWideClass) : f(TrunkNarrow{}, dtypes);
}

template <class Cls>
int parse_bwd(const int* meta, const int* meta_dev, const long long* jobs, const long long* jobs_dev, int n_jobs,
              int n, MlpMeta* m, DwJobs* J, Cls cls) {
  int rc = parse_mlp_meta(meta, meta_dev, m, cls);
  if (rc) return rc;
  rc = parse_jobs(jobs, jobs_dev, n_jobs, (long long)nblocks<Cls>(n) * Cls::kPts, J);
  if (rc) return rc;
  return n_jobs != m->n_lin ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// dtypes: kF32Compute and kF32Stash select F's instance (its dot operands'
// and its stash's types; wpack holds the operands' type), kWideClass the
// wide class's.
extern "C" int mlp_stash_fwd(const float* x, const void* wpack, const float* bpack, float* out, void* zs, int n,
                             const int* meta, const int* meta_dev, int dtypes, void* stream) {
  return by_class(dtypes, [&](auto cls, int dt) {
    MlpMeta m;
    const int rc = parse_mlp_meta(meta, meta_dev, &m, cls);
    if (rc || n <= 0) return rc;
    return launch_fwd_dtypes<kMlpStash>(dt, cls, x, wpack, bpack, out, zs, n, m, (cudaStream_t)stream);
  });
}

// dtypes: kF32Compute selects I's f32 instance, kWideClass the wide class's.
extern "C" int mlp_fwd(const float* x, const void* wpack, const float* bpack, float* out, int n, const int* meta,
                       const int* meta_dev, int dtypes, void* stream) {
  return by_class(dtypes, [&](auto cls, int dt) {
    MlpMeta m;
    const int rc = parse_mlp_meta(meta, meta_dev, &m, cls);
    if (rc || n <= 0) return rc;
    return launch_fwd_dtypes<kMlpPlain>(dt, cls, x, wpack, bpack, out, nullptr, n, m, (cudaStream_t)stream);
  });
}

// dtypes: kF32Compute and kF32Stash select G's instance (its dot operands',
// and so its scratch's, and its stash's types), kWideClass the wide
// class's; wtpack is the f32 pack's transposed blocks (null in bf16).
extern "C" int mlp_stash_bwd(const float* x, const void* zs, const float* g, const void* wpack, const void* wtpack,
                             float* dx, void* scratch, float* partial, float* colsum, float* part_dw, float* dw,
                             const long long* jobs, const long long* jobs_dev, int n_jobs, int split, int n,
                             const int* meta, const int* meta_dev, int dtypes, void* stream) {
  return by_class(dtypes, [&](auto cls, int dt) {
    MlpMeta m;
    DwJobs J;
    const int rc = parse_bwd(meta, meta_dev, jobs, jobs_dev, n_jobs, n, &m, &J, cls);
    if (rc || n <= 0) return rc;
    return launch_chain_dtypes(dt, cls, x, zs, g, wpack, wtpack, dx, scratch, partial, colsum, part_dw, dw, J, split,
                               n, m, (cudaStream_t)stream);
  });
}

// J: the recompute pass J1 into the transient stash zsc [N, ZT], then the
// chain on it; dtypes: kF32Compute selects J's f32 instance, whose zsc is
// f32, kWideClass the wide class's.
extern "C" int mlp_bwd(const float* x, const float* g, const void* wpack, const void* wtpack, const float* bpack,
                       void* zsc, float* dx, void* scratch, float* partial, float* colsum, float* part_dw, float* dw,
                       const long long* jobs, const long long* jobs_dev, int n_jobs, int split, int n,
                       const int* meta, const int* meta_dev, int dtypes, void* stream) {
  return by_class(dtypes, [&](auto cls, int dt) {
    MlpMeta m;
    DwJobs J;
    const int rc = parse_bwd(meta, meta_dev, jobs, jobs_dev, n_jobs, n, &m, &J, cls);
    if (rc || n <= 0) return rc;
    const cudaStream_t s = (cudaStream_t)stream;
    if (dt & kF32Compute)
      return launch_recompute_bwd<float>(cls, x, g, wpack, wtpack, bpack, zsc, dx, scratch, partial, colsum, part_dw,
                                         dw, J, split, n, m, s);
    return launch_recompute_bwd<bf16>(cls, x, g, wpack, wtpack, bpack, zsc, dx, scratch, partial, colsum, part_dw, dw,
                                      J, split, n, m, s);
  });
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
