// Kernels B and C of the hierarchical SDF marches.  Their device code is in
// march_common.cuh, shared with kernels K, L, M and N (march_fused.cu).
//
// Kernel B, round_machinery.  Replaces
// nrhints_tpu/kernels/march.py::_round_machinery_kernel (:392), launched
// five times per march by _rounds_xla (:424, pallas_call at :443).  Per ray
// it merges the previous round's 16 new (z, sdf) pairs into the sorted
// 128-slot buffer (merge128: the bitonic network of _bitonic_merge, :165, so
// ties resolve identically, or with RANK the stable rank merge of
// _rank_merge, :200), then draws the next 16 samples exactly as
// _round_new_z (:263): NeuS section alpha at inv_s, weights by the
// exclusive log-space prefix, pdf + 1e-5 over the valid intervals, and the
// deterministic inverse CDF at descending u = 1 - k/15.
// Bound on an H100: it moves about 1.1 MB per launch at B = 512 rays, about
// 0.3 us at 3.35 TB/s, so launch latency (a few us) dominates.  Design: one
// 128-thread block per ray, one thread per slot, the buffers in shared
// memory; prefix sums are warp shuffles, the inverse-CDF counts are warp
// ballots.
//
// Kernel C, shadow_final.  Replaces
// nrhints_tpu/kernels/march.py::_shadow_final_kernel (:574, pallas_call at
// :873), whose body is _shadow_final_math (:542).  Per shadow ray: 128
// section midpoints (the last section length is the ray's sample_dist),
// sdf and d . grad sdf by one forward-mode tangent through the 8x256 SDF MLP
// (_mlp_sdf_dirderiv_3d, :117: bf16 weights, f32 biases, both streams
// rounded to bf16 after every layer, the tangent multiplied by the f32 gate
// first), the cos-annealed NeuS alpha, and tau = prod_{j<127}(1 - a_j + 1e-7).
// Bound on an H100: 918,016 multiply-adds per point, 120 GFLOP per 512-ray
// chunk of 65,536 points, 0.122 ms at 989 TFLOP/s bf16: bound by operations.
// Design: the TPU kept 128 points x 256 x 2 streams in VMEM next to a whole
// layer's weights; that is more than a Hopper block's 227 KB.  So a block
// takes four rays on 512 threads (march_kernel's FINAL stage with WIDE: 128
// blocks for 512 rays, one per SM, 225,952 bytes of shared memory) and
// walks their 512 sections in eight dual passes of 64 sections and their 64
// tangent rows (mma_rows.cuh::sdf_rows): each 64-row weight slab, staged by
// cp.async, feeds all 128 rows through ldmatrix and mma.sync, and the gate
// stays in registers.  Every tau equals the 32-row WMMA design's bit for
// bit.  Measured (NVIDIA H100 80GB HBM3, 700 W): 1.04 ms of device time a
// launch against that design's 1.645, 8.5x its bound; the epilogue's
// softplus, the fragment loads with the MMAs, the exposed slab copies and
// the rest (barriers, heads, encoding) take 0.30, 0.36, 0.17 and 0.26 ms
// of it, one after another (scripts/probe_march_parts.py).
#include "march_common.cuh"

using namespace nrh;

namespace {

template <bool RANK>
__global__ void __launch_bounds__(NBUF)
    round_machinery_kernel(const float* __restrict__ z, const float* __restrict__ sdf,
                           const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ new_z_prev,
                           const float* __restrict__ new_sdf_prev, float* __restrict__ out_new_z,
                           float* __restrict__ out_z, float* __restrict__ out_sdf,
                           int merge_valid_n, int next_valid_n, float inv_s) {
  __shared__ float sz[NBUF], ss[NBUF], sc[NBUF], warp_tot[4];
  __shared__ int cnt[4][NNEW];
  const int ray = blockIdx.x, k = threadIdx.x;
  float zk = z[(size_t)ray * NBUF + k];
  float sk = sdf[(size_t)ray * NBUF + k];

  if (merge_valid_n >= 0) {
    // [old ascending | BIG_Z pad | new descending]
    if (k < NOLD) {
      if (k >= merge_valid_n) zk = BIG_Z;
    } else {
      zk = new_z_prev[(size_t)ray * NNEW + k - NOLD];
      sk = new_sdf_prev[(size_t)ray * NNEW + k - NOLD];
    }
    merge128<RANK>(zk, sk, sz, ss);
  }
  out_z[(size_t)ray * NBUF + k] = zk;
  if (out_sdf) out_sdf[(size_t)ray * NBUF + k] = sk;
  if (next_valid_n < 0) return;  // uniform over the block

  const float o0 = o[ray * 3], o1 = o[ray * 3 + 1], o2 = o[ray * 3 + 2];
  const float d0 = d[ray * 3], d1 = d[ray * 3 + 1], d2 = d[ray * 3 + 2];
  const float oo = o0 * o0 + o1 * o1 + o2 * o2;
  const float od = o0 * d0 + o1 * d1 + o2 * d2;
  draw_new_z(zk, sk, next_valid_n, inv_s, oo, od, sz, ss, sc, warp_tot, cnt,
             out_new_z + (size_t)ray * NNEW);
}

}  // namespace

extern "C" int round_machinery(const float* z, const float* sdf, const float* o, const float* d,
                               const float* new_z_prev, const float* new_sdf_prev,
                               float* out_new_z, float* out_z, float* out_sdf, int b,
                               int merge_valid_n, int next_valid_n, float inv_s, int rank,
                               void* stream) {
  if (b <= 0) return 0;
  auto kernel = rank ? round_machinery_kernel<true> : round_machinery_kernel<false>;
  kernel<<<b, NBUF, 0, (cudaStream_t)stream>>>(z, sdf, o, d, new_z_prev, new_sdf_prev, out_new_z,
                                               out_z, out_sdf, merge_valid_n, next_valid_n, inv_s);
  return (int)cudaGetLastError();
}

extern "C" int shadow_final(const float* z, const float* o, const float* d, const float* sdist,
                            const void* wpack, const float* bpack, const float* w_sdf,
                            const float* inv_s, const float* anneal, float* tau, int b,
                            const int* meta, float scale, void* stream) {
  return launch_march<false, false, true, false, true>(z, nullptr, o, d, sdist, wpack, bpack, w_sdf, inv_s,
                                                       anneal, tau, b, meta, scale, 0.0f, stream);
}

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
