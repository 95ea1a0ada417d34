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
// code with one more store per layer (sdf_fwd.cuh, MODE = kFwdStash).
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
// The kernel itself lives in sdf_fwd.cuh: kernel H (sdf_core_bwd.cu) runs
// its layers as its own first pass.
#include "sdf_fwd.cuh"

using namespace nrh;

extern "C" int sdf_core_fwd(const float* x, const void* wpack, const float* bpack,
                            const float* w_sdf, float* sdf, float* feat, float* gx, int n,
                            const int* meta, float scale, void* stream) {
  SdfMeta m;
  const int rc = parse_meta(meta, &m);
  if (rc || n <= 0) return rc;
  return launch_sdf_fwd<kFwdPlain>(x, (const bf16*)wpack, bpack, w_sdf, sdf, feat, gx, nullptr, nullptr, n, m,
                                   scale, (cudaStream_t)stream);
}

extern "C" int sdf_stash_fwd(const float* x, const void* wpack, const float* bpack,
                             const float* w_sdf, float* sdf, float* feat, float* gx, void* stash,
                             int n, const int* meta, float scale, void* stream) {
  SdfMeta m;
  const int rc = parse_meta(meta, &m);
  if (rc || n <= 0) return rc;
  return launch_sdf_fwd<kFwdStash>(x, (const bf16*)wpack, bpack, w_sdf, sdf, feat, gx, (bf16*)stash, nullptr, n, m,
                                   scale, (cudaStream_t)stream);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
