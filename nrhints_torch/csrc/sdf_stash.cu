// Kernel E: the backward of the SDF stash op, sdf_stash_bwd.
//
// Replaces: nrhints_tpu/kernels/core_stash.py::_sdf_stash_bwd_pallas (the
// pallas_call at :473): the VJP of (sdf, feat, grad_x sdf) with respect to
// every weight and to x, at the bf16 activations h_i that kernel D stashed,
// with compute_dtype="bfloat16" (bf16 dot operands, f32 everything else).
// It follows sdf_core_bwd_stash_all_ref (:226) with the reverse sweep's
// u_i and g_enc recomputed from the stash, as the stash path's backward
// does (the port of the arithmetic is core_stash.py::
// sdf_core_bwd_stash_plain): the Tail VJP, the VJP of the reverse sweep in
// ascending layer order (it carries the eikonal loss's second-order terms:
// the gates are 1 - exp(-100 h), so dL/dh picks up 100 (1 - gate) u), the
// heads, and the forward z-chain in descending order.
//
// Bound on an H100, per 512-ray step of 65,536 points at full width: five
// 8-layer sweeps of 65,536 x 256 x 256 products (the recomputed reverse
// sweep, the sweep's VJP, the z-chain, and the two halves of the dW
// products) plus the heads, about 340 GFLOP: 0.34 ms at 989 TFLOP/s bf16;
// it reads the 264 MB stash once, 0.08 ms.  Bound by operations.
//
// Design.  Two stages, one launch each (plus the in-order sums of
// dw_sum.cuh):
//   E1 (sdf_bwd.cuh) takes kChainTP = 64 points per 16-warp block.  The
//   activation and carry tiles and the encoding stay in shared memory;
//   each product writes its output into the carry tile in place.  u_i of
//   every layer, overwritten by dL/dh_i once the ascending pass has used
//   it, and the four f32 encoding cotangents live in a per-point f32
//   scratch in device memory (gates_total + 256 floats a point: 596 MB at
//   65,536 points at full width, allocated by the wrapper for the call);
//   the elementwise passes move it four columns per item, 16 bytes at a
//   time.  Each per-layer product is staged_mma.cuh::gemm_rows64: the
//   weights stream through a three-stage shared-memory ring in 64-row
//   slabs filled by cp.async, shared by all 16 warps, so a weight byte
//   fetched from L2 serves 64 points (about 3.2 GB of L2 weight reads per
//   step, where 16-point blocks read 12.6 GB); a product's first two slabs
//   are requested before the elementwise pass that precedes it.  227,584
//   bytes of shared memory: one block per SM.  It writes dx, and for
//   every layer the operands of dW_i = v_i^T t_i + inp_i^T Gz_i as one
//   [2 Npad, kp] x [2 Npad, np] bf16 pair (the reference rounds exactly
//   these operands to bf16, so nothing is lost), and per-block f32 column
//   sums (bias cotangents, the sdf head's column).
//   E2 (dw_sum.cuh) computes the products with K = 2 Npad split into row
//   chunks, on 128 x 128 output tiles staged through shared memory, and
//   sums the chunks and the column sums in a fixed order: no atomics, so
//   the gradients repeat bit for bit.
// The ragged edge is masked: rows past N read zeros, store nothing to dx,
// and contribute zeros to every sum.
//
// E's stash_all variant, sdf_stash_all_bwd, replaces the same pallas_call
// with stash_us=True (core_backward="stash_all"): sdf_core_bwd_stash_all_ref
// at the u_i and g_enc that D's variant stashed in bf16 (the port of the
// arithmetic is core_stash.py::sdf_core_bwd_stash_all_plain).  E1 skips
// its first stage, the reverse sweep's L products, and copies the stashed
// u_i and g_enc into the f32 scratch instead (as f32 of the bf16 values,
// as the reference reads them); no shared memory is added.  Its bound
// drops the recomputed sweep's 458,752 multiply-adds a point (60.1 GFLOP,
// 0.061 ms) and reads the 535 MB stash (0.160 ms).  Every later stage is
// E's.  The chain lives in sdf_bwd.cuh, where
// kernel H (sdf_core_bwd.cu) runs it with its own f32 gates.
//
// The f32 instances replace the same pallas_call at compute_dtype="float32"
// and stash_dtype="float32" (the dtypes argument; each pair is an instance
// of sdf_bwd_chain_kernel<T, S, false, US>).  Bound on an H100: E's 317.9
// GFLOP (the variant's 257.8) at the 67 TFLOP/s f32 peak, 4.75 ms (3.85) a
// 65,536-point call.  Design: E1's stages as above, every product on
// mma_rows.cuh's gemm_rows_f32 (215,296 bytes of shared memory, one
// block per SM), the dW operands in an f32 scratch (2.15 GB at 65,536
// points) and their products on dw_sum.cuh's dw_partial_f32_kernel over the
// same row chunks, summed by the same in-order passes: the f32 gradients
// repeat bit for bit too.
//
// The wide instances (E's and its variant's, at every (operand, stash)
// dtype pair) replace the same pallas_call above the presets' widths:
// padded widths up to 512, encodings up to 128 (kWideClass in the dtypes
// argument: sdf_bwd_chain_wide_kernel<T, S, false, US>).  Bound on an H100 at d_hidden =
// 512 (8 layers, skip at 4, multi_res 6, a 256-wide feature head): 1,237
// GFLOP a 65,536-point call (the variant's 997), 1.25 ms (1.01) at 989
// TFLOP/s bf16, 3.9x the 256-wide; bound by operations.  Design: E1's
// stages on 32-point blocks (226,432 bytes of shared memory), every
// product in staged_mma.cuh::gemm_rows32's column passes of at most 256
// (sdf_core.cu says why), the f32 chain scratch at 4,064 + 4 x 128 floats a
// point (1.2 GB at 65,536 points) and 2.1 GB of bf16 dW operands; the dW
// passes are dw_sum.cuh's, whose 128 x 128 tiles take ka and nb up to 512
// (a 512 x 512 dW is 16 tiles of a row chunk), over the same row chunks.
// The wide f32 instances (f32 operands, or an f32 stash, or both): the same
// stages with an f32 activation tile, every product on mma_rows.cuh's
// gemm_rows_f32<RowsWide> (214,144 bytes of shared memory), the transposed
// products on the f32 pack's wtpack, and with f32 operands the dW operands
// in an f32 scratch (4.3 GB at 65,536 points at d_hidden 512) summed by
// dw_partial_f32_kernel.  Bound at the 67 TFLOP/s f32 peak: 18.5 ms (the
// variant's 14.9) a 65,536-point call at d_hidden 512.
// The huge instances (E's and its variant's, bf16 operands and stash only:
// kHugeClass alone in the dtypes argument, sdf_bwd_chain_huge_kernel<bf16,
// bf16, false, US>) replace the same pallas_call above the wide class.
// Bound on an H100 at d_hidden = 1024 (8 layers, skip at 4, multi_res 6, a
// 256-wide feature head): 4,879 GFLOP a 65,536-point call (the variant's
// 3,917), 4.93 ms (3.96) at 989 TFLOP/s bf16; bound by operations.  Design:
// E1's stages on 64-point blocks whose activations, carry and encoding are
// rows of device memory after the chain scratch's (sdf_core.cu says why;
// 138,496 bytes of shared memory), every product gemm_rows_huge; the dW
// passes are dw_sum.cuh's, whose 128 x 128 tiles take any ka and nb that
// are multiples of 16 (4.2 GB of bf16 dW operands at 65,536 points).
#include "sdf_bwd.cuh"

using namespace nrh;

// dtypes: kF32Compute and kF32Stash select E's instance (its dot operands',
// and so its scratch's, and its stash's types), kWideClass the wide
// class's, kHugeClass (alone) the huge class's (cscr then also holds its
// rows); wtpack is the f32 pack's transposed blocks (null in bf16).
extern "C" int sdf_stash_bwd(const float* x, const void* stash, const float* ds, const float* df,
                             const float* dgx, const void* wpack, const void* wtpack, const float* w_sdf, float* dx,
                             void* scratch, float* cscr, float* partial, float* colsum, float* part_dw, float* dw,
                             const long long* jobs, const long long* jobs_dev, int n_jobs, int split, int n,
                             const int* meta, const int* meta_dev, float scale, int dtypes, void* stream) {
  SdfMeta m;
  DwJobs J;
  const int rc = parse_sdf_bwd(meta, meta_dev, jobs, jobs_dev, n_jobs, n, dtypes, &m, &J);
  if (rc || n <= 0) return rc;
  return launch_sdf_bwd_dtypes<false, false>(dtypes, x, stash, nullptr, ds, df, dgx, wpack, wtpack, w_sdf, dx,
                                             scratch, cscr, partial, colsum, part_dw, dw, m, J, split, n, scale,
                                             (cudaStream_t)stream);
}

// E's stash_all variant: the same arguments, at the stash of D's variant.
extern "C" int sdf_stash_all_bwd(const float* x, const void* stash, const float* ds, const float* df,
                                 const float* dgx, const void* wpack, const void* wtpack, const float* w_sdf,
                                 float* dx, void* scratch, float* cscr, float* partial, float* colsum,
                                 float* part_dw, float* dw, const long long* jobs, const long long* jobs_dev,
                                 int n_jobs, int split, int n, const int* meta, const int* meta_dev,
                                 float scale, int dtypes, void* stream) {
  SdfMeta m;
  DwJobs J;
  const int rc = parse_sdf_bwd(meta, meta_dev, jobs, jobs_dev, n_jobs, n, dtypes, &m, &J);
  if (rc || n <= 0) return rc;
  return launch_sdf_bwd_dtypes<false, true>(dtypes, x, stash, nullptr, ds, df, dgx, wpack, wtpack, w_sdf, dx,
                                            scratch, cscr, partial, colsum, part_dw, dw, m, J, split, n, scale,
                                            (cudaStream_t)stream);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
