// Kernels B and C of the hierarchical SDF marches.  Their device code is in
// march_common.cuh, shared with kernels K, L, M and N (march_fused.cu).
//
// Kernel B, round_machinery.  Replaces
// nrhints_tpu/kernels/march.py::_round_machinery_kernel (:392), launched
// rounds + 1 times per march by _rounds_xla (:424, pallas_call at :443).
// Per ray it merges the previous round's n_new new (z, sdf) pairs into the
// sorted 128-slot buffer (the bitonic network of _bitonic_merge, :165, so
// ties resolve identically, or with RANK the stable rank merge of
// _rank_merge, :200), then draws the next n_new samples exactly as
// _round_new_z (:263): NeuS section alpha at inv_s, weights by the exclusive
// log-space prefix, pdf + 1e-5 over the valid intervals, and the
// deterministic inverse CDF at descending u = 1 - k/(n_new - 1).  With
// `last` it then merges those samples in with a zero sdf and writes z
// alone: the last round's step and JAX's tail step in one launch, so a
// march takes `rounds` launches.  round_machinery draws n_new = 16 (the
// compile-time instance), round_machinery_geom any n_new from 2 to 126.
// Bound on an H100: it moves about 1.1 MB per launch at B = 512 rays, about
// 0.3 us at 3.35 TB/s; its work is a few hundred bytes a ray, in chains of
// dependent shuffles and transcendentals.  Design: one warp a ray
// (march_common.cuh::ray_step), 4 rays on a 128-thread block (128 blocks
// for 512 rays, 6 KB of shared memory): lane l holds slots 32 j + l in
// registers, so each lane interleaves four independent chains, and nothing
// waits at a block barrier.  The march template runs the same ray_step.
// Measured (NVIDIA H100 80GB HBM3, 700 W): 5.3-6.0 us of device time a
// launch against the 128-thread design's 4.1: with one warp on each SM
// sub-partition, nothing hides that warp's chains of shuffles and IEEE
// divisions, which the old design's four warps a sub-partition hid.
// round_machinery_geom (the same code, n_new at run time; phase 20 of
// chip_smoke.py): 5.4 us a launch at n_new = 8, 6.6 at 32, 9.0 at 64 and
// 12.6 at 126, where each lane draws 4 samples.
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
// takes four rays on 512 threads (march_kernel's FINAL stage: 128
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
// shadow_final_f32 is kernel C with f32 march weights, march_kernel_f32 on
// mma_rows.cuh::sdf_rows_f32: the same multiply-adds as f32 FMAs on the CUDA
// cores, 1.80 ms a 512-ray launch at the 67 TFLOP/s f32 peak; 16 dual passes
// of 32 sections and their tangents a block.
// shadow_final_wide and shadow_final_f32_wide are kernel C above the
// presets' widths (padded widths up to 512, encodings up to 128), the
// march_kernel_wide and march_kernel_f32_wide instances on the row engine's
// wide class (mma_rows.cuh::RowsWide): 16 dual passes of 32 sections (bf16)
// or 32 of 16 (f32) a block.  At d_hidden 512 a 512-ray launch is 4.0x the
// 256-wide one's operations: 0.487 ms at the bf16 peak, 7.18 ms at f32's.
// shadow_final_huge is kernel C at any wider SDF (bf16 march weights), the
// march_kernel_huge instance on the row engine's huge class
// (mma_rows.cuh::RowsHuge): the wide bf16 class's 16 dual passes of 32
// sections a block, each row's activations, product output and encoding in
// a device-memory scratch.  At d_hidden 1024 a 512-ray launch is 1.93
// TFLOP: 1.96 ms at the bf16 peak.
#include "march_common.cuh"

using namespace nrh;

namespace {

constexpr MarchGeom kAnyGeom{NBUF, 0, kFixedNew};  // kernel C reads no geometry

constexpr int kMachRays = 4;  // rays of a kernel B block, one warp each

template <bool RANK, int NN>
__global__ void __launch_bounds__(kMachRays * 32)
    round_machinery_kernel(const float* __restrict__ z, const float* __restrict__ sdf,
                           const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ new_z_prev,
                           const float* __restrict__ new_sdf_prev, float* __restrict__ out_new_z,
                           float* __restrict__ out_z, float* __restrict__ out_sdf, int b,
                           int merge_valid_n, int next_valid_n, float inv_s, bool last, NewCount<NN> nn) {
  __shared__ float sz[kMachRays][NBUF], ss[kMachRays][NBUF], sc[kMachRays][NBUF];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kMachRays + warp;
  if (ray >= b) return;  // a warp's own ray; no block barrier follows
  const size_t row = (size_t)ray * NBUF;
  const int n_new = nn.n(), nold = NBUF - n_new;
  float zr[4], sr[4], pz[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ps[4] = {0.0f, 0.0f, 0.0f, 0.0f}, nz[4], oo = 0.0f,
                      od = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    zr[q] = z[row + 32 * q + lane];
    sr[q] = sdf[row + 32 * q + lane];
  }
  if (merge_valid_n >= 0) {
    // new sample j (descending) into slot nold + j
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!old_slot(q, lane, nold)) {
        pz[q] = new_z_prev[(size_t)ray * n_new + 32 * q + lane - nold];
        ps[q] = new_sdf_prev[(size_t)ray * n_new + 32 * q + lane - nold];
      }
    }
  }
  if (next_valid_n >= 0) {
    const float o0 = o[ray * 3], o1 = o[ray * 3 + 1], o2 = o[ray * 3 + 2];
    const float d0 = d[ray * 3], d1 = d[ray * 3 + 1], d2 = d[ray * 3 + 2];
    oo = o0 * o0 + o1 * o1 + o2 * o2;
    od = o0 * d0 + o1 * d1 + o2 * d2;
  }
  ray_step<RANK>(zr, sr, merge_valid_n, pz, ps, next_valid_n, inv_s, oo, od, last, sz[warp], ss[warp], sc[warp], nn,
                 nz);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out_z[row + 32 * q + lane] = zr[q];
    if (out_sdf) out_sdf[row + 32 * q + lane] = sr[q];
    if (out_new_z && 32 * q + lane < n_new) out_new_z[(size_t)ray * n_new + 32 * q + lane] = nz[q];
  }
}

// merge_valid_n < 0: no merge; next_valid_n < 0: no draw (the merge-only
// tail step); last != 0 (with a draw): merge the drawn samples in and write
// out_z alone.  out_new_z and out_sdf may be null where nothing is drawn.
template <int NN>
int launch_machinery(const float* z, const float* sdf, const float* o, const float* d, const float* new_z_prev,
                     const float* new_sdf_prev, float* out_new_z, float* out_z, float* out_sdf, int b,
                     int merge_valid_n, int next_valid_n, float inv_s, int rank, int last, int n_new, void* stream) {
  if (last && next_valid_n < 0) return (int)cudaErrorInvalidValue;
  if (n_new < 2 || n_new > NBUF - 2 || (NN > 0 && n_new != NN)) return (int)cudaErrorInvalidValue;
  if (b <= 0) return 0;
  auto kernel = rank ? round_machinery_kernel<true, NN> : round_machinery_kernel<false, NN>;
  kernel<<<(b + kMachRays - 1) / kMachRays, kMachRays * 32, 0, (cudaStream_t)stream>>>(
      z, sdf, o, d, new_z_prev, new_sdf_prev, out_new_z, out_z, out_sdf, b, merge_valid_n, next_valid_n, inv_s,
      last != 0, NewCount<NN>{n_new});
  return (int)cudaGetLastError();
}

}  // namespace

#define NRH_MACHINERY_ARGS                                                                                    \
  const float *z, const float *sdf, const float *o, const float *d, const float *new_z_prev,                   \
      const float *new_sdf_prev, float *out_new_z, float *out_z, float *out_sdf, int b, int merge_valid_n,     \
      int next_valid_n, float inv_s, int rank, int last

// Kernel B at n_new = 16, and at any n_new from 2 to 126 (its run-time
// instance).
extern "C" int round_machinery(NRH_MACHINERY_ARGS, void* stream) {
  return launch_machinery<kFixedNew>(z, sdf, o, d, new_z_prev, new_sdf_prev, out_new_z, out_z, out_sdf, b,
                                     merge_valid_n, next_valid_n, inv_s, rank, last, kFixedNew, stream);
}
extern "C" int round_machinery_geom(NRH_MACHINERY_ARGS, int n_new, void* stream) {
  return launch_machinery<0>(z, sdf, o, d, new_z_prev, new_sdf_prev, out_new_z, out_z, out_sdf, b, merge_valid_n,
                             next_valid_n, inv_s, rank, last, n_new, stream);
}
#undef NRH_MACHINERY_ARGS

#define NRH_FINAL_ARGS                                                                                       \
  const float *z, const float *o, const float *d, const float *sdist, const void *wpack, const float *bpack,     \
      const float *w_sdf, const float *inv_s, const float *anneal, float *tau, int b, const int *meta,            \
      const int *meta_dev, float scale, void *stream

extern "C" int shadow_final(NRH_FINAL_ARGS) {
  return launch_march<false, false, false, true, false>(z, nullptr, o, d, sdist, wpack, bpack, w_sdf, inv_s, anneal,
                                                        tau, b, meta, meta_dev, scale, 0.0f, kAnyGeom, stream);
}

// Kernel C with f32 march weights (march_dtype="float32"): wpack holds the
// f32 pack of pack_sdf_mlp(..., dtype=float32).
extern "C" int shadow_final_f32(NRH_FINAL_ARGS) {
  return launch_march<true, false, false, true, false>(z, nullptr, o, d, sdist, wpack, bpack, w_sdf, inv_s, anneal,
                                                       tau, b, meta, meta_dev, scale, 0.0f, kAnyGeom, stream);
}

// Kernel C's wide instances (core_mlp.ROWS_WIDE: padded widths up to 512,
// encodings up to 128), bf16 and f32 march weights.
extern "C" int shadow_final_wide(NRH_FINAL_ARGS) {
  return launch_march<false, false, false, true, false, kFixedNew, RowsWide>(
      z, nullptr, o, d, sdist, wpack, bpack, w_sdf, inv_s, anneal, tau, b, meta, meta_dev, scale, 0.0f, kAnyGeom,
      stream);
}
extern "C" int shadow_final_f32_wide(NRH_FINAL_ARGS) {
  return launch_march<true, false, false, true, false, kFixedNew, RowsWide>(
      z, nullptr, o, d, sdist, wpack, bpack, w_sdf, inv_s, anneal, tau, b, meta, meta_dev, scale, 0.0f, kAnyGeom,
      stream);
}

// Kernel C's huge instance (core_mlp.ROWS_HUGE: any wider SDF, bf16 march
// weights), its device-memory rows scratch last (core_mlp.march_layout).
extern "C" int shadow_final_huge(NRH_FINAL_ARGS, float* rows) {
  return launch_march<false, false, false, true, false, kFixedNew, RowsHuge>(
      z, nullptr, o, d, sdist, wpack, bpack, w_sdf, inv_s, anneal, tau, b, meta, meta_dev, scale, 0.0f, kAnyGeom,
      stream, rows);
}
#undef NRH_FINAL_ARGS

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
