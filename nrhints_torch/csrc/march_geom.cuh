// The run-time geometry instances of kernels K, L, M and N (see
// march_geom.cu): one launch helper and NRH_GEOM_ENTRIES(suffix, F32, wide),
// the C entry points of one dtype and width class, instantiated by
// march_geom.cu (bf16 march weights) and march_geom_f32.cu (f32), two
// sources so that their builds run side by side.
#pragma once

#include "march_common.cuh"

namespace nrh {
namespace geom {

constexpr int kAnyNew = 0;  // n_new read at run time

// One launch of an instance at geometry g: the f32 one with F32, the wide
// class's with wide, the rank merge's with rank (instances with rounds).
template <bool F32, bool SWEEP, bool ROUNDS, bool FINAL>
inline int launch(const float* z0, const float* sdf0, const float* o, const float* d, const float* sdist,
                  const float* inv_s, const float* anneal, const void* wpack, const float* bpack, const float* w_sdf,
                  float* out, int b, const int* meta, float scale, float base_inv_s, int rank, const MarchGeom& g,
                  void* stream, bool wide) {
  if constexpr (ROUNDS) {
    if (rank)
      return launch_march<F32, SWEEP, ROUNDS, FINAL, true, kAnyNew>(z0, sdf0, o, d, sdist, wpack, bpack, w_sdf, inv_s,
                                                                    anneal, out, b, meta, scale, base_inv_s, g,
                                                                    stream, wide);
  }
  return launch_march<F32, SWEEP, ROUNDS, FINAL, false, kAnyNew>(z0, sdf0, o, d, sdist, wpack, bpack, w_sdf, inv_s,
                                                                 anneal, out, b, meta, scale, base_inv_s, g, stream,
                                                                 wide);
}

inline MarchGeom sweep_geom(int n0) { return MarchGeom{n0, 0, 0}; }
inline MarchGeom rounds_geom(int rounds, int n_new) { return MarchGeom{NBUF - rounds * n_new, rounds, n_new}; }

}  // namespace geom
}  // namespace nrh

#define NRH_SWEEP_ARGS                                                                                     \
  const float *z0, const float *o, const float *d, const void *wpack, const float *bpack, const float *w_sdf, \
      float *sdf0, int b, const int *meta, float scale, int n0, void *stream
#define NRH_ROUNDS_ARGS                                                                                     \
  const float *z0, const float *sdf0, const float *o, const float *d, const void *wpack, const float *bpack,  \
      const float *w_sdf, float *z, int b, const int *meta, float scale, float base_inv_s, int rank, int rounds, \
      int n_new, void *stream
#define NRH_IMPORTANCE_ARGS                                                                                 \
  const float *z0, const float *o, const float *d, const void *wpack, const float *bpack, const float *w_sdf, \
      float *z, int b, const int *meta, float scale, float base_inv_s, int rank, int rounds, int n_new,       \
      void *stream
#define NRH_SHADOW_ARGS                                                                                       \
  const float *z0, const float *o, const float *d, const float *sdist, const float *inv_s, const float *anneal, \
      const void *wpack, const float *bpack, const float *w_sdf, float *tau, int b, const int *meta,             \
      float scale, float base_inv_s, int rank, int rounds, int n_new, void *stream

// One dtype and width class's entry points: SUFFIX "" (bf16), _f32, _wide
// or _f32_wide (core_mlp.ROWS_WIDE), each named <kernel><SUFFIX>_geom.
#define NRH_GEOM_ENTRIES(SUFFIX, F32, IS_WIDE)                                                                  \
  extern "C" int march_sweep##SUFFIX##_geom(NRH_SWEEP_ARGS) {                                                   \
    return nrh::geom::launch<F32, true, false, false>(z0, nullptr, o, d, nullptr, nullptr, nullptr, wpack,      \
                                                      bpack, w_sdf, sdf0, b, meta, scale, 0.0f, 0,              \
                                                      nrh::geom::sweep_geom(n0), stream, IS_WIDE);              \
  }                                                                                                              \
  extern "C" int march_rounds##SUFFIX##_geom(NRH_ROUNDS_ARGS) {                                                 \
    return nrh::geom::launch<F32, false, true, false>(z0, sdf0, o, d, nullptr, nullptr, nullptr, wpack, bpack,  \
                                                      w_sdf, z, b, meta, scale, base_inv_s, rank,               \
                                                      nrh::geom::rounds_geom(rounds, n_new), stream, IS_WIDE);  \
  }                                                                                                              \
  extern "C" int importance_march##SUFFIX##_geom(NRH_IMPORTANCE_ARGS) {                                         \
    return nrh::geom::launch<F32, true, true, false>(z0, nullptr, o, d, nullptr, nullptr, nullptr, wpack, bpack, \
                                                     w_sdf, z, b, meta, scale, base_inv_s, rank,                \
                                                     nrh::geom::rounds_geom(rounds, n_new), stream, IS_WIDE);   \
  }                                                                                                              \
  extern "C" int shadow_march##SUFFIX##_geom(NRH_SHADOW_ARGS) {                                                 \
    return nrh::geom::launch<F32, true, true, true>(z0, nullptr, o, d, sdist, inv_s, anneal, wpack, bpack,      \
                                                    w_sdf, tau, b, meta, scale, base_inv_s, rank,               \
                                                    nrh::geom::rounds_geom(rounds, n_new), stream, IS_WIDE);    \
  }
