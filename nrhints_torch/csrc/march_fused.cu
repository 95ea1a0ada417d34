// Kernels K, L, M and N: the round-4 fused marches, instances of
// march_common.cuh::march_kernel (one template with kernel C), at the
// presets' geometry, 64 stratified samples and 4 rounds of 16, as
// compile-time constants (NN = kFixedNew); march_geom.cu holds the same
// kernels at every other geometry.
//
// K, march_sweep: replaces nrhints_tpu/kernels/march.py::_sweep_kernel
//   (:507, pallas_call at :723), the initial 64-sample SDF value sweep
//   z0 [B, 64] -> sdf0 [B, 64].
// L, march_rounds: replaces _rounds_kernel (:522, pallas_call at :749), the
//   4 refinement rounds of _refine_rounds (:322) from (z0, sdf0): each
//   draws 16 samples, sweeps them in-kernel (not in the last round) and
//   merges them -> z [B, 128].
// M, importance_march: replaces _importance_kernel (:488, pallas_call at
//   :771): K then L in one kernel.
// N, shadow_march: replaces _shadow_kernel (:595, pallas_call at :894): M
//   then kernel C's final dual sweep and transmittance -> tau [B, 1].
//
// Bound on an H100 (bf16 tensor-core peak, 989 TFLOP/s): a value sweep is
// 459,008 multiply-adds per point (the 8x256 MLP and the sdf head), so per
// 512-ray launch K 32,768 points (30.1 GFLOP, 0.030 ms), L 24,576 (0.023
// ms), M 57,344 (0.053 ms) and N those plus 65,536 dual points (0.175 ms):
// all bound by operations; the bytes in and out are a few hundred KB.
// Design: all four hold four rays on 512 threads (128 blocks for 512 rays,
// one per SM) and sweep through mma_rows.cuh::sdf_rows: the initial sweep
// as 2 value passes of 128 rows (the 4 rays' 64 stratified samples; K's
// whole block, 58 staged slabs), each swept round as one value pass of 64
// rows (4 rays x 16 new samples), and N's final sweep as kernel C's 8 dual
// passes.  Each cp.async-staged 64-row weight slab feeds every row of a pass
// through ldmatrix and mma.sync.  Warps 0-3 run the 4 rays' round machinery
// (march_common.cuh::ray_step, kernel B's), one warp a ray, between the
// sweeps.  So L = B's steps between K's sweeps, M = L(K(.)) and N = C(M(.))
// bit for bit.  Measured (NVIDIA H100 80GB HBM3, 700 W, device time a
// 512-ray launch), against the same kernels on 2-ray blocks of 32-row WMMA
// tiles: K 0.28 ms (0.60), L 0.31 (0.47), M 0.59 (1.05), N 1.70 (2.52).
// K runs 9x, L 14x and M 11x their bounds: each layer's product and its
// softplus epilogue run one after the other (scripts/probe_march_parts.py).
// merge selects the network: rank != 0 is the rank merge.
// Each has an f32 instance, *_f32, for march_dtype="float32": the same
// template on mma_rows.cuh::sdf_rows_f32 (f32 weights and activations, f32
// FMAs on the CUDA cores).  At the 67 TFLOP/s f32 peak the bounds are K
// 0.449 ms, L 0.337, M 0.786 and N 2.582 a 512-ray launch.
// Each also has wide instances, *_wide and *_f32_wide, in march_fused_wide.cu,
// for SDFs above the presets' widths.  The launch helpers are in
// march_fused.cuh.
#include "march_fused.cuh"

using namespace nrh::fused;

extern "C" int march_sweep(NRH_SWEEP_ARGS) { return sweep<false>(NRH_SWEEP_CALL); }
extern "C" int march_sweep_f32(NRH_SWEEP_ARGS) { return sweep<true>(NRH_SWEEP_CALL); }
extern "C" int march_rounds(NRH_ROUNDS_ARGS) { return rounds<false>(NRH_ROUNDS_CALL); }
extern "C" int march_rounds_f32(NRH_ROUNDS_ARGS) { return rounds<true>(NRH_ROUNDS_CALL); }
extern "C" int importance_march(NRH_IMPORTANCE_ARGS) { return importance<false>(NRH_IMPORTANCE_CALL); }
extern "C" int importance_march_f32(NRH_IMPORTANCE_ARGS) { return importance<true>(NRH_IMPORTANCE_CALL); }
extern "C" int shadow_march(NRH_SHADOW_ARGS) { return shadow<false>(NRH_SHADOW_CALL); }
extern "C" int shadow_march_f32(NRH_SHADOW_ARGS) { return shadow<true>(NRH_SHADOW_CALL); }

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
