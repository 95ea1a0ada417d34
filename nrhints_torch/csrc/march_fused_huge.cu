// Kernels K, L, M and N of march_fused.cu and march_geom.cu in the row
// engine's huge class (core_mlp.ROWS_HUGE: any padded width and encoding
// above the wide class's, bf16 march weights only): the same template on
// mma_rows.cuh::RowsHuge, 64 rows a pass whose activations, product output
// and encoding lie in a device-memory scratch, every product
// staged_mma.cuh::gemm_rows_huge.  Each entry point takes that scratch last
// (core_mlp.march_layout: 64 rows a 4-ray block, huge_row floats a row).
// The 64 + 4 x 16 instances (compile-time NN = kFixedNew) and the run-time
// geometry ones (*_huge_geom, NN = 0) are one source, built beside the
// others.
//
// Bound on an H100 (989 TFLOP/s bf16 dense) at d_hidden 1024 (8 layers, a
// skip at 4, multi_res 6): a value point is 14.8 MFLOP, a section with its
// tangent twice that, so a 512-ray launch of K is 0.48 TFLOP (0.49 ms), L
// 0.36 (0.37 ms), M 0.85 (0.86 ms) and N 2.78 (2.81 ms).
#include "march_fused.cuh"

using namespace nrh;
using namespace nrh::fused;

#define NRH_HUGE(FN, KIND, ARGS, CALL) \
  extern "C" int FN##_huge(ARGS, float* rows) { return KIND<false, RowsHuge>(CALL, rows); }
NRH_HUGE(march_sweep, sweep, NRH_SWEEP_ARGS, NRH_SWEEP_CALL)
NRH_HUGE(march_rounds, rounds, NRH_ROUNDS_ARGS, NRH_ROUNDS_CALL)
NRH_HUGE(importance_march, importance, NRH_IMPORTANCE_ARGS, NRH_IMPORTANCE_CALL)
NRH_HUGE(shadow_march, shadow, NRH_SHADOW_ARGS, NRH_SHADOW_CALL)
#undef NRH_HUGE
// march_geom.cuh's argument lists take the geometry: the fixed ones go.
#undef NRH_SWEEP_ARGS
#undef NRH_ROUNDS_ARGS
#undef NRH_IMPORTANCE_ARGS
#undef NRH_SHADOW_ARGS

#include "march_geom.cuh"

NRH_GEOM_ENTRIES(_huge, false, nrh::RowsHuge, NRH_ROWS_PARAM, rows)
#undef NRH_GEOM_ENTRIES

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
