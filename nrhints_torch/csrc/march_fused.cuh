// The launch helpers and C-entry argument lists of kernels K, L, M and N
// at the presets' geometry (64 + 4 x 16, compile-time NN = kFixedNew),
// shared by march_fused.cu (the 256-wide class, bf16 and f32 march weights),
// march_fused_wide.cu (the wide class, core_mlp.ROWS_WIDE) and
// march_fused_huge.cu (the huge class, core_mlp.ROWS_HUGE), sources apart so
// that their builds run side by side.
#pragma once

#include "march_common.cuh"

namespace nrh {
namespace fused {

constexpr MarchGeom kGeom{NBUF - kFixedRounds * kFixedNew, kFixedRounds, kFixedNew};  // 64 + 4 x 16

// Each entry point's bf16 instance, or with F32 its f32 one, of width class
// Cls (launch_march's).  meta_dev is the meta vector's copy on the card (null
// up to kMaxLayers layers); rows the huge class's device-memory scratch
// (core_mlp.march_layout; null in the other classes).
template <bool F32, class Cls = RowsNarrow>
int sweep(const float* z0, const float* o, const float* d, const void* wpack, const float* bpack,
          const float* w_sdf, float* sdf0, int b, const int* meta, const int* meta_dev, float scale, void* stream,
          float* rows = nullptr) {
  return launch_march<F32, true, false, false, false, kFixedNew, Cls>(z0, nullptr, o, d, nullptr, wpack, bpack, w_sdf,
                                                                  nullptr, nullptr, sdf0, b, meta, meta_dev, scale,
                                                                  0.0f, kGeom, stream, rows);
}

template <bool F32, class Cls = RowsNarrow>
int rounds(const float* z0, const float* sdf0, const float* o, const float* d, const void* wpack,
           const float* bpack, const float* w_sdf, float* z, int b, const int* meta, const int* meta_dev,
           float scale, float base_inv_s, int rank, void* stream, float* rows = nullptr) {
  auto launch = rank ? launch_march<F32, false, true, false, true, kFixedNew, Cls>
                     : launch_march<F32, false, true, false, false, kFixedNew, Cls>;
  return launch(z0, sdf0, o, d, nullptr, wpack, bpack, w_sdf, nullptr, nullptr, z, b, meta, meta_dev, scale,
                base_inv_s, kGeom, stream, rows);
}

template <bool F32, class Cls = RowsNarrow>
int importance(const float* z0, const float* o, const float* d, const void* wpack, const float* bpack,
               const float* w_sdf, float* z, int b, const int* meta, const int* meta_dev, float scale,
               float base_inv_s, int rank, void* stream, float* rows = nullptr) {
  auto launch = rank ? launch_march<F32, true, true, false, true, kFixedNew, Cls>
                     : launch_march<F32, true, true, false, false, kFixedNew, Cls>;
  return launch(z0, nullptr, o, d, nullptr, wpack, bpack, w_sdf, nullptr, nullptr, z, b, meta, meta_dev, scale,
                base_inv_s, kGeom, stream, rows);
}

template <bool F32, class Cls = RowsNarrow>
int shadow(const float* z0, const float* o, const float* d, const float* sdist, const float* inv_s,
           const float* anneal, const void* wpack, const float* bpack, const float* w_sdf, float* tau, int b,
           const int* meta, const int* meta_dev, float scale, float base_inv_s, int rank, void* stream,
           float* rows = nullptr) {
  auto launch = rank ? launch_march<F32, true, true, true, true, kFixedNew, Cls>
                     : launch_march<F32, true, true, true, false, kFixedNew, Cls>;
  return launch(z0, nullptr, o, d, sdist, wpack, bpack, w_sdf, inv_s, anneal, tau, b, meta, meta_dev, scale,
                base_inv_s, kGeom, stream, rows);
}

}  // namespace fused
}  // namespace nrh

#define NRH_SWEEP_ARGS                                                                                     \
  const float *z0, const float *o, const float *d, const void *wpack, const float *bpack, const float *w_sdf, \
      float *sdf0, int b, const int *meta, const int *meta_dev, float scale, void *stream
#define NRH_ROUNDS_ARGS                                                                                    \
  const float *z0, const float *sdf0, const float *o, const float *d, const void *wpack, const float *bpack, \
      const float *w_sdf, float *z, int b, const int *meta, const int *meta_dev, float scale, float base_inv_s, \
      int rank, void *stream
#define NRH_IMPORTANCE_ARGS                                                                                 \
  const float *z0, const float *o, const float *d, const void *wpack, const float *bpack, const float *w_sdf, \
      float *z, int b, const int *meta, const int *meta_dev, float scale, float base_inv_s, int rank, void *stream
#define NRH_SHADOW_ARGS                                                                                     \
  const float *z0, const float *o, const float *d, const float *sdist, const float *inv_s, const float *anneal, \
      const void *wpack, const float *bpack, const float *w_sdf, float *tau, int b, const int *meta,             \
      const int *meta_dev, float scale, float base_inv_s, int rank, void *stream
#define NRH_SWEEP_CALL z0, o, d, wpack, bpack, w_sdf, sdf0, b, meta, meta_dev, scale, stream
#define NRH_ROUNDS_CALL z0, sdf0, o, d, wpack, bpack, w_sdf, z, b, meta, meta_dev, scale, base_inv_s, rank, stream
#define NRH_IMPORTANCE_CALL z0, o, d, wpack, bpack, w_sdf, z, b, meta, meta_dev, scale, base_inv_s, rank, stream
#define NRH_SHADOW_CALL \
  z0, o, d, sdist, inv_s, anneal, wpack, bpack, w_sdf, tau, b, meta, meta_dev, scale, base_inv_s, rank, stream
