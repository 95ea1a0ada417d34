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
// code with one more 8-byte store per item of the layer loop (sdf_fwd.cuh,
// MODE = kFwdStash).
//
// D's stash_all variant, sdf_stash_all_fwd, replaces the same pallas_call
// with stash_us=True (core_backward="stash_all"): D's outputs and h_i bit
// for bit, and also each layer's reverse-sweep value u_i (the g that meets
// the layer's gate; u_{L-1} = w_sdf / scale) and g_enc, rounded to bf16,
// in a stash [N, 2 x 2,016 + 48] (535 MB at 65,536 points; MODE =
// kFwdStashAll).  D computes both in its reverse sweep for the gradient
// anyway: the variant adds an 8-byte store per item of that sweep and a
// pass over g_enc.  Its bound adds 271 MB of writes (0.081 ms).
//
// Bound on an H100: about 0.98 M multiply-adds per point (524,544 forward,
// 458,752 reverse) = 1.97 MFLOP, so 129 GFLOP per 512-ray chunk of 65,536
// points: 0.130 ms at 989 TFLOP/s bf16.  Its outputs (sdf, 256 feature
// floats, 3 gradient floats per point) are 68 MB, 0.020 ms at 3.35 TB/s;
// D adds 264 MB of stash, 0.079 ms.  Both are bound by operations.
//
// Design.  The reverse sweep needs every layer's gate for every point:
// 2,016 f32 per point at full width.  A block takes kChainTP = 64 points on
// 512 threads, as kernel E's chain does (staged_mma.cuh).  Every product of
// the 8 forward layers, the feature head and the 8 reverse layers runs
// through gemm_rows64: bf16 WMMA with the weights streamed through a
// three-stage cp.async ring of 64-row slabs in shared memory, so a weight
// byte fetched from L2 serves 64 points and no mma waits on an L2 load; a
// product's first slabs are requested before the elementwise pass in front
// of it.  The reverse sweep multiplies by the transposed weight through
// column-major fragments, so no transpose is stored.  Shared memory holds
// one bf16 activation tile (each layer's output written in place once the
// product that read it has returned), one f32 carry tile that every
// product writes, the encoding and the ring: 227,328 bytes, one block per
// SM.  The gates do not fit beside them: they stay f32, as the reference's,
// in a device-memory scratch [padded N, 2,016] (528 MB at 65,536 points,
// allocated per call by the wrapper, core_mlp.gate_layout), written 16
// bytes at a time in the forward and read back so in the reverse sweep.
// The encoding's cotangent takes the encoding tile once the forward has
// read it for the last time; the final VJP recomputes sin and cos from x.
// The elementwise passes take four consecutive columns of one point per
// item.  This design's own byte floor is the gate scratch written and read
// once, 1.06 GB (0.32 ms), above the operations' 0.130 ms.  The ragged edge
// is masked: rows past N read x = 0 and store only their gates.  The kernel
// itself lives in sdf_fwd.cuh: kernel H (sdf_core_bwd.cu) runs its layers
// as its own first pass.
//
// The f32 instances replace the same pallas_calls at compute_dtype="float32"
// (sdf_core_ref with cdt=None: exact f32 dots) and, for D, at
// stash_dtype="float32" (an f32 stash): the dtypes argument selects
// sdf_core_fwd_kernel<T, S, MODE> (sdf_fwd.cuh).  Bound on an H100: A's and
// D's 128.9 GFLOP at the 67 TFLOP/s f32 peak, 1.92 ms a 65,536-point call.
// Design: every product on mma_rows.cuh's gemm_rows_f32 (the march's f32 row
// engine, one fmaf a multiply-add in k order, on a 2-stage ring of 32-row
// f32 slabs), an f32 activation tile beside the f32 carry tile: 215,040
// bytes of shared memory, one block per SM; the reverse sweep's transposed
// products read the f32 pack's transposed blocks (wtpack).
//
// The wide instances replace the same pallas_calls above the presets'
// widths (JAX's Pallas kernels take any SDFNetConfig): padded hidden and
// feature widths up to 512, encodings up to 128 (multi_res <= 20), at
// every (operand, stash) dtype pair; the dtypes argument's kWideClass bit
// selects sdf_core_fwd_wide_kernel<T, S, MODE> (sdf_fwd.cuh).  Bound on an
// H100 at
// d_hidden = 512 (8 layers, skip at 4, multi_res 6, a 256-wide feature
// head): 3.80 M multiply-adds a point, 498 GFLOP a 65,536-point call, 0.50
// ms at 989 TFLOP/s bf16 (3.9x the 256-wide); D adds 533 MB of bf16 stash
// (0.16 ms).  Bound by operations.
// Design: the 64-point tiles at width 512 would need 66,560 B of bf16
// activations, 132,096 B of f32 carry and 32,768 B of encoding beside the
// 110,592 B ring, more than a block's 232,448 B.  So a block takes 32
// points (kWidePts) on the same 512 threads: activations 33,280, carry
// 66,048, encoding 16,384 and the same three-stage ring, 226,304 bytes,
// one block per SM.  Every product runs as column passes of at most 256
// (staged_mma.cuh::gemm_rows32: the 16 warps over 32 rows x 256 columns, 2
// accumulator tiles a warp); the carry tile holds the whole output, so the
// product's input stays intact until its last pass has read it.  A weight
// byte fetched from L2 serves 32 points, half the 64-point instances'
// reuse, at 4x the products a point.  The gate scratch keeps the same
// column layout on 32-point padded rows (core_mlp.gate_layout at the wide
// class's block): 1.06 GB at 65,536 points at d_hidden 512.
// The wide f32 instances (compute_dtype="float32", and D's f32 stash):
// A's and D's 498 GFLOP at d_hidden 512 at the 67 TFLOP/s f32 peak, 7.43 ms
// a 65,536-point call; D's f32 stash adds 1.07 GB (0.32 ms).  Design: the
// same 32-point blocks with an f32 activation tile [32][516] beside the
// carry, every product on mma_rows.cuh's gemm_rows_f32<RowsWide> (32 rows
// by up to 512 columns a pass, one fmaf a multiply-add in k order, two
// ring stages of 16 f32 k-rows by 512 columns), the reverse sweep's
// products on the f32 pack's transposed blocks (wtpack): 214,016 bytes of
// shared memory, one block per SM.
//
// The huge instances replace the same pallas_calls above the wide class
// (padded widths above 512 or encodings above 128), at bf16 operands and a
// bf16 stash (the kHugeClass bit alone in the dtypes argument:
// sdf_core_fwd_huge_kernel<bf16, bf16, MODE>).  Bound on an H100 at
// d_hidden = 1024 (8 layers, skip at 4, multi_res 6, a 256-wide feature
// head): 14.94 M multiply-adds a point, 1,958.6 GFLOP a 65,536-point call,
// 1.98 ms at 989 TFLOP/s bf16; D adds 1.07 GB of bf16 stash (0.32 ms).
// Bound by operations.  Design: no shared-memory tile holds a 1024-wide
// row, so a block of 64 points keeps its activations (bf16), its f32 carry
// and its encoding as rows of a device-memory scratch after the gate
// scratch's rows (core_mlp.row_layout: 415 MB at 65,536 points at d_hidden
// 1024, beside 2.14 GB of gates), at the meta's widths; shared memory holds
// the weight ring and a ring of the row operand's k-slabs (138,240 bytes).
// Every product is staged_mma.cuh::gemm_rows_huge: column passes of at most
// 256, both operands streamed through cp.async in 64-row k-slabs, the
// output written to the carry rows; the elementwise passes are the same
// code, four columns of a point an item, on those rows.
#include "sdf_fwd.cuh"

using namespace nrh;

// dtypes: kF32Compute selects A's f32 instance (wpack and wtpack the f32
// pack; wtpack is null in bf16), kWideClass the wide class's, kHugeClass
// (alone) the huge class's; gates then also holds the huge rows.
extern "C" int sdf_core_fwd(const float* x, const void* wpack, const void* wtpack, const float* bpack,
                            const float* w_sdf, float* sdf, float* feat, float* gx, float* gates, int n,
                            const int* meta, const int* meta_dev, float scale, int dtypes, void* stream) {
  SdfMeta m;
  const int rc = parse_meta(meta, meta_dev, &m, dtypes & kWideClass, dtypes & kHugeClass);
  if (rc || n <= 0) return rc;
  return launch_sdf_fwd_dtypes<kFwdPlain>(dtypes, x, wpack, wtpack, bpack, w_sdf, sdf, feat, gx, nullptr, gates,
                                          n, m, scale, (cudaStream_t)stream);
}

// dtypes: kF32Compute and kF32Stash select D's instance (its dot operands'
// and its stash's types), kWideClass the wide class's.
extern "C" int sdf_stash_fwd(const float* x, const void* wpack, const void* wtpack, const float* bpack,
                             const float* w_sdf, float* sdf, float* feat, float* gx, void* stash,
                             float* gates, int n, const int* meta, const int* meta_dev,
                             float scale, int dtypes, void* stream) {
  SdfMeta m;
  const int rc = parse_meta(meta, meta_dev, &m, dtypes & kWideClass, dtypes & kHugeClass);
  if (rc || n <= 0) return rc;
  return launch_sdf_fwd_dtypes<kFwdStash>(dtypes, x, wpack, wtpack, bpack, w_sdf, sdf, feat, gx, stash, gates, n,
                                          m, scale, (cudaStream_t)stream);
}

extern "C" int sdf_stash_all_fwd(const float* x, const void* wpack, const void* wtpack, const float* bpack,
                                 const float* w_sdf, float* sdf, float* feat, float* gx, void* stash,
                                 float* gates, int n, const int* meta, const int* meta_dev,
                                 float scale, int dtypes, void* stream) {
  SdfMeta m;
  const int rc = parse_meta(meta, meta_dev, &m, dtypes & kWideClass, dtypes & kHugeClass);
  if (rc || n <= 0) return rc;
  return launch_sdf_fwd_dtypes<kFwdStashAll>(dtypes, x, wpack, wtpack, bpack, w_sdf, sdf, feat, gx, stash, gates,
                                             n, m, scale, (cudaStream_t)stream);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
