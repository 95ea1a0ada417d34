// Kernels K, L, M and N of march_fused.cu in the row engine's wide class
// (core_mlp.ROWS_WIDE: padded widths up to 512, encodings up to 128), at
// bf16 and f32 march weights: the same template on mma_rows.cuh::RowsWide,
// whose passes hold half the rows; at d_hidden 512 each sweep is 4.0x the
// 256-wide one's operations.  A source of its own, built beside
// march_fused.cu.
#include "march_fused.cuh"

using namespace nrh;
using namespace nrh::fused;

extern "C" int march_sweep_wide(NRH_SWEEP_ARGS) { return sweep<false, RowsWide>(NRH_SWEEP_CALL); }
extern "C" int march_sweep_f32_wide(NRH_SWEEP_ARGS) { return sweep<true, RowsWide>(NRH_SWEEP_CALL); }
extern "C" int march_rounds_wide(NRH_ROUNDS_ARGS) { return rounds<false, RowsWide>(NRH_ROUNDS_CALL); }
extern "C" int march_rounds_f32_wide(NRH_ROUNDS_ARGS) { return rounds<true, RowsWide>(NRH_ROUNDS_CALL); }
extern "C" int importance_march_wide(NRH_IMPORTANCE_ARGS) { return importance<false, RowsWide>(NRH_IMPORTANCE_CALL); }
extern "C" int importance_march_f32_wide(NRH_IMPORTANCE_ARGS) { return importance<true, RowsWide>(NRH_IMPORTANCE_CALL); }
extern "C" int shadow_march_wide(NRH_SHADOW_ARGS) { return shadow<false, RowsWide>(NRH_SHADOW_CALL); }
extern "C" int shadow_march_f32_wide(NRH_SHADOW_ARGS) { return shadow<true, RowsWide>(NRH_SHADOW_CALL); }

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
