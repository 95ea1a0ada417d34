// Kernels K, L, M and N at every march geometry other than 64 + 4 x 16
// with f32 march weights (march_dtype="float32"): march_geom.cu's f32 and
// wide f32 instances, built beside it (march_geom.cuh).
#include "march_geom.cuh"

NRH_GEOM_ENTRIES(_f32, true, nrh::RowsNarrow, , nullptr)
NRH_GEOM_ENTRIES(_f32_wide, true, nrh::RowsWide, , nullptr)
#undef NRH_GEOM_ENTRIES

extern "C" const char* nrh_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
