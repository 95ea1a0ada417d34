// Kernel H: the recompute backward of the SDF core, sdf_core_bwd.
//
// Replaces: nrhints_tpu/kernels/core_mlp.py::_sdf_core_bwd_pallas (the
// pallas_call at :300), the VJP of kernel A's function (sdf, feat, grad_x
// sdf) with respect to every weight and to x, under
// core_backward="recompute": the TPU kernel re-reads only x and the
// cotangents, recomputes the forward chain block by block and runs jax.vjp
// over sdf_core_ref, which carries the eikonal loss's second-order terms.
// Nothing is kept from the forward call.  Dot operands are bf16 (the
// shipping compute_dtype); everything else is f32.  The gates are
// sigmoid(100 z_i) of the f32 pre-activations, as sdf_core_ref computes
// them, not kernel E's 1 - exp(-100 h) of a bf16 h, so H's gradients are
// close to E's but not equal to them.
//
// Bound on an H100, per 512-ray step of 65,536 points at full width:
// kernel E's operations (the reverse sweep, its VJP, the z-chain, both dW
// halves and the heads, 317.9 GFLOP) plus the recomputed forward layers
// (60.1 GFLOP), about 378 GFLOP: 0.38 ms at 989 TFLOP/s bf16.  It must read
// x and the cotangents (68 MB) and write dx and dW: bound by operations.
//
// Design.  E's per-point chain fills the shared memory of a 64-point block
// (228 KB); holding the recomputed gates beside its tiles would not fit
// the 227 KB a block may use.  So H is two stages in one launcher, with a transient scratch that the wrapper
// allocates for this call only and frees when it returns:
//   H1 (sdf_fwd.cuh, kFwdRecompute): the layer loop of kernels A and D, on
//      the same 64-point blocks of 512 threads, every product through the
//      cp.async-staged gemm_rows64, writing every h_i in bf16 (the value
//      every dot of the backward reads, as kernel D's stash) and every gate
//      in f32 to device memory, where A keeps its own; no heads and no
//      reverse sweep.  227,328 bytes of shared memory per block.
//   H2 (sdf_bwd.cuh with GATES = true, US = false): kernel E's chain and
//      its split-K dW passes (dw_sum.cuh), reading the f32 gates instead
//      of recovering them from h.  The dW sums run in a fixed order: the gradients repeat
//      bit for bit.
// The scratch is 6 bytes per point per padded hidden unit (2,016 at full
// width): 793 MB at 65,536 points (264 MB bf16 h, 528 MB f32 gates on
// core_mlp.gate_layout's padded rows).
//
// H's f32 instance replaces the same pallas_call at compute_dtype="float32"
// (the dtypes argument): H1 and H2 as above with T = f32 (f32 h_i in the
// scratch, 1.06 GB at 65,536 points; f32 dW operands), their products on
// mma_rows.cuh's gemm_rows_f32 and dw_sum.cuh's dw_partial_f32_kernel.
// Bound: 378.0 GFLOP at the 67 TFLOP/s f32 peak, 5.64 ms a 65,536-point
// call.  With an f32 stash, E's gates 1 - exp(-100 h) and H's sigmoid(100 z)
// agree to rounding, so the f32 E and H give the same gradients but for
// rounding (chip_smoke.py phase 16 prints the gap).
//
// H's wide instance replaces the same pallas_call above the presets'
// widths (kWideClass in the dtypes argument): H1 and H2 on the wide
// instances' 32-point blocks (sdf_core_fwd_wide_kernel<T, T, 2>,
// sdf_bwd_chain_wide_kernel<T, T, true, false>), the same dW passes.
// Bound on an H100 at d_hidden = 512 (8 layers, skip at 4, multi_res 6, a
// 256-wide feature head): 1,478 GFLOP a 65,536-point call,
// 1.49 ms at 989 TFLOP/s bf16; bound by operations.  Its scratch: 533 MB of
// bf16 h and 1.06 GB of f32 gates at 65,536 points.  At compute_dtype=
// "float32" (T = f32: f32 h_i, f32 dW operands, every product on
// gemm_rows_f32<RowsWide>): 22.1 ms at the 67 TFLOP/s f32 peak.
//
// H's huge instance (kHugeClass alone in the dtypes argument: bf16 only)
// replaces the same pallas_call above the wide class: H1 and H2 on the huge
// instances' 64-point blocks with their rows in device memory
// (sdf_core_fwd_huge_kernel<bf16, bf16, 2>, sdf_bwd_chain_huge_kernel<bf16,
// bf16, true, false>: sdf_core.cu says why), the same dW passes.  Bound on
// an H100 at d_hidden = 1024 (8 layers, skip at 4, multi_res 6, a 256-wide
// feature head): 5,841 GFLOP a 65,536-point call, 5.91 ms at 989 TFLOP/s
// bf16; bound by operations.  Its scratch at 65,536 points: 1.07 GB of bf16
// h, 2.14 GB of f32 gates and 415 MB of H1's rows, then H2's chain scratch
// (2.19 GB and 415 MB of rows) and 4.2 GB of bf16 dW operands.
#include "sdf_bwd.cuh"
#include "sdf_fwd.cuh"

using namespace nrh;

// dtypes: kF32Compute selects H's f32 instance: H1 and H2 with f32 dot
// operands, its h_i and its dW scratch in f32 (wpack and wtpack the f32
// pack; wtpack is null in bf16); kWideClass the wide class's, kHugeClass
// (alone) the huge class's: gates and cscr then also hold the huge rows.
extern "C" int sdf_core_bwd(const float* x, const float* ds, const float* df, const float* dgx,
                            const void* wpack, const void* wtpack, const float* bpack, const float* w_sdf, void* hs,
                            float* gates, float* dx, void* scratch, float* cscr, float* partial, float* colsum,
                            float* part_dw, float* dw, const long long* jobs, const long long* jobs_dev,
                            int n_jobs, int split, int n, const int* meta, const int* meta_dev,
                            float scale, int dtypes, void* stream) {
  SdfMeta m;
  DwJobs J;
  int rc = parse_sdf_bwd(meta, meta_dev, jobs, jobs_dev, n_jobs, n, dtypes, &m, &J);
  if (rc || n <= 0) return rc;
  if (dtypes & ~(kF32Compute | kWideClass | kHugeClass)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  rc = launch_sdf_fwd_dtypes<kFwdRecompute>(dtypes, x, wpack, wtpack, bpack, w_sdf, nullptr, nullptr, nullptr, hs,
                                            gates, n, m, scale, s);
  if (rc) return rc;
  return launch_sdf_bwd_dtypes<true, false>(dtypes, x, hs, gates, ds, df, dgx, wpack, wtpack, w_sdf, dx, scratch,
                                            cscr, partial, colsum, part_dw, dw, m, J, split, n, scale, s);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
