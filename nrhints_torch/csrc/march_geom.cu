// Kernels K, L, M and N at every march geometry that JAX's
// fused_importance_z (nrhints_tpu/kernels/march.py:664) and fused_shadow_tau
// (:797) take: n0 stratified samples and `rounds` rounds of n_new, with
// n0 + rounds * n_new = 128, rounds >= 1, n_new >= 2 and n0 >= 2 (the
// wrappers in kernels/march.py also ask a power-of-two n_new of the rank
// merge, as JAX does).  The instances of march_common.cuh::march_kernel with
// NN = 0, n_new read at run time: the same code as march_fused.cu's
// compile-time 64 + 4 x 16 instances, so L = B's steps between K's sweeps,
// M = L(K(.)) and N = C(M(.)) bit for bit here too.
//
// K, march_sweep_geom: the initial sweep of n0 samples, z0 [B, n0] -> sdf0
//   [B, n0] (_sweep_kernel, :507, pallas_call at :723).
// L, march_rounds_geom: the rounds from (z0, sdf0) -> z [B, 128]
//   (_rounds_kernel, :522, pallas_call at :749).
// M, importance_march_geom: K then L (_importance_kernel, :488, :771).
// N, shadow_march_geom: M then kernel C's final sweep -> tau [B, 1]
//   (_shadow_kernel, :595, :894).
//
// A block's sweeps lay their rows out ray by ray: the initial sweep 4 n0
// rows, a round's 4 n_new, in passes of the engine's value rows (128 with
// bf16 weights, else 64), the last pass partial (march_common.cuh::
// sweep_rows).  Bound on an H100: the value sweeps evaluate n0 + (rounds -
// 1) n_new points a ray (the last round's samples are not swept), each
// 459,008 multiply-adds at the 8x256 MLP; N adds kernel C's 128 sections
// and their tangents.  This source holds the bf16 instances and the wide
// class's (core_mlp.ROWS_WIDE); march_geom_f32.cu the f32 ones.  Time follows the passes, not the rows: measured
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 20, device time a
// 512-ray launch, bf16 at 256 wide), at 5 x 12 K 0.395 ms (the 64 + 4 x 16
// K's 1.40x: 272 rows take a third, 64-row pass), L 0.433 (4 rounds of 48
// rows, each a 64-row pass), M 0.861, N 1.979; at 8 x 8 L 0.738 (2.38x: 7
// half-empty passes).
#include "march_geom.cuh"

NRH_GEOM_ENTRIES(, false, nrh::RowsNarrow, , nullptr)
NRH_GEOM_ENTRIES(_wide, false, nrh::RowsWide, , nullptr)
#undef NRH_GEOM_ENTRIES

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
