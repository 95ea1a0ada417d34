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
//   E1 (this file) takes TP = 16 points per block and runs their whole
//   chain in shared memory: u_i of every layer (f32, 129 KB at full width)
//   stays there and is overwritten in place by dL/dh_i once the ascending
//   pass has used it; the per-layer products are bf16 WMMA on 16-row tiles,
//   the weights read from L2 as in kernel A.  It writes dx, and for every
//   layer the operands of dW_i = v_i^T t_i + inp_i^T Gz_i as one
//   [2 Npad, kp] x [2 Npad, np] bf16 pair (the reference rounds exactly
//   these operands to bf16, so nothing is lost), and per-block f32 column
//   sums (bias cotangents, the sdf head's column).
//   E2 (dw_sum.cuh) computes the products with K = 2 Npad split into row
//   chunks and sums the chunks and the column sums in a fixed order: no
//   atomics, so the gradients repeat bit for bit.
// The ragged edge is masked: rows past N read zeros, store nothing to dx,
// and contribute zeros to every sum.  The chain lives in sdf_bwd.cuh, where
// kernel H (sdf_core_bwd.cu) runs it with its own f32 gates.
#include "sdf_bwd.cuh"

using namespace nrh;

extern "C" int sdf_stash_bwd(const float* x, const void* stash, const float* ds, const float* df,
                             const float* dgx, const void* wpack, const float* w_sdf, float* dx,
                             void* scratch, float* partial, float* colsum, float* part_dw, float* dw,
                             const long long* jobs, int n_jobs, int split, int n, const int* meta,
                             float scale, void* stream) {
  SdfMeta m;
  DwJobs J;
  const int rc = parse_sdf_bwd(meta, jobs, n_jobs, &m, &J);
  if (rc || n <= 0) return rc;
  return launch_sdf_bwd<false>(x, (const bf16*)stash, nullptr, ds, df, dgx, (const bf16*)wpack, w_sdf, dx,
                               (bf16*)scratch, partial, colsum, part_dw, dw, m, J, split, n, scale,
                               (cudaStream_t)stream);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
