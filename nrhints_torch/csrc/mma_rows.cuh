// The row engine of the march sweeps of kernels C, K, L, M and N
// (march_common.cuh): the 8x256 SDF MLP on up to 128 rows of one 512-thread
// block, bf16 weights and activations, f32 biases and nonlinearities, as
// _mlp_sdf_3d (nrhints_tpu/kernels/march.py:87) computes the value, and in
// dual mode also the forward-mode tangent of _mlp_sdf_dirderiv_3d (:117).
//
// * The activations lie in one bf16 tile of 128 rows in shared memory.  In
//   dual mode rows 0-63 are 64 sections' values and rows 64-127 their
//   tangents; otherwise they are 128 (or 64) independent value rows.
// * Each layer's weight streams through staged_mma.cuh's cp.async ring of
//   64-row slabs, shared by all 16 warps: one staged slab feeds every row,
//   the value and the tangent rows alike.  Each product's first slabs are
//   requested before the elementwise pass in front of it.
// * Fragments come from shared memory by ldmatrix (.trans for the row-major
//   [kp, np] weight blocks) into mma.sync.m16n8k16 (bf16 in, f32
//   accumulate).  Warp w owns 16 rows (two row tiles of 16: a section's
//   value and tangent in dual mode, 32 consecutive rows otherwise) and the
//   64 columns 64 (w % 4) .. +64: up to 16 m16n8 accumulator tiles, 64 f32
//   registers a thread.  Each output walks its k-tiles 0, 16, 32, ... in
//   order, as WMMA's 16x16x16 products walk them (the same HMMA
//   instructions), so every output equals the 32-row WMMA tiles' of the
//   first march design bit for bit, wherever its row lies in a pass.
// * The epilogue stays in registers: mma.sync's accumulator layout puts a
//   section's value z and its tangent at the same (row, column) of the two
//   row tiles of one thread, so the gate never leaves registers.  Each
//   layer's output is written in place into the tile once the product has
//   returned on every warp, rounded to bf16 where _mlp_sdf_3d rounds.
//
// Beside it, sdf_rows_f32, the engine of the f32 march weights
// (march_dtype="float32"): what _mlp_sdf_3d and _mlp_sdf_dirderiv_3d compute
// with wdt = float32, no rounding of the encoding, the activations, the skip
// concat or the tangent rows, and an f32 head.
// * Products are f32 SIMT FMAs (fmaf: the build's -fmad=false would round
//   a * b + c twice).  Each output sums its k = 0, 1, 2, ... in order, one
//   fmaf each, so a row's floats do not depend on its pass or slot.
// * An f32 tile of 128 rows (135 KB) and the ring do not fit one block's
//   shared memory, so this engine runs 64 rows a pass (a [64][260] f32 tile,
//   as large as the bf16 tile) and streams each weight through the same
//   3-stage cp.async ring in slabs of 32 f32 k-rows (3 x 32 KB).  In dual
//   mode the 64 rows are 32 sections and their 32 tangent rows.
// * Thread t owns 8 rows of its row group t / 64 and the 4 columns
//   4 (t % 64) .. +3: 32 accumulators.  Each k-step of 4 loads its 8 rows'
//   float4 (one address a warp: a broadcast) and 4 float4 of the slab (512
//   consecutive bytes a warp) for 128 FMAs.  In dual mode a thread's rows
//   are 4 sections and their 4 tangent rows, so the gate stays in registers.
// * The SDF core's f32 instances (kernels A, D, E and H at
//   compute_dtype="float32": sdf_fwd.cuh, sdf_bwd.cuh) and the reflectance
//   trunk's (F, G, I and J: mlp_stash.cu) run their products on
//   rows_product_f32 too, through gemm_rows_f32 at the end of this file
//   (the 64-point instances on RowsNarrow, the wide ones on RowsWide), with
//   a ring of kChainStagesF32 stages.
//
// Both engines come in two width classes (RowsNarrow, RowsWide), the
// template argument Cls of every routine below.  RowsNarrow takes the
// presets' widths (padded layers up to kWMax, encodings up to kEncMax) as
// described above.  RowsWide takes twice both (kWideWMax, kWideEncMax), the
// SDF core's wide class (staged_mma.cuh::CoreWide), on half the rows a pass
// so that the tile and the ring still fit one block's shared memory:
// * bf16: 64 rows a pass (dual mode: 32 sections and their 32 tangent rows)
//   in a [64][520] tile, the weights staged in slabs of 32 k-rows by up to
//   512 columns (3 x 33,280 B).  Warp w owns 32 rows of row group w / 8 and
//   the 64 columns 64 (w % 8) .. +64, so a warp's tile, its fragments a
//   k-step and its 64 accumulators a thread are the narrow class's, and the
//   whole 512-wide output of a layer is in registers when the product
//   returns: no column passes, and the output is written in place as above.
// * f32: 32 rows a pass (dual mode: 16 sections and their tangents) in a
//   [32][516] tile, the weights staged in slabs of 16 k-rows by up to 512
//   columns (3 x 32 KB); thread t owns 8 rows of row group t / 128 and the
//   4 columns 4 (t % 128) .. +3, the narrow f32 class's 32 accumulators.
// Each output keeps its k order (k-tiles 0, 16, 32, ... or one fmaf a k in
// order), so a row's floats do not depend on its pass, slot or the class's
// slab depth, and the bf16 rounding points are _mlp_sdf_3d's in both.
#pragma once

#include "staged_mma.cuh"

namespace nrh {

constexpr int kRowsMax = 128;        // rows of the engine's activation tile
constexpr int kRowsThreads = 512;    // threads of a block that runs it (= kChainThreads: the ring's copy loop)
static_assert(kRowsThreads == kChainThreads, "stage_slab strides its copies by kChainThreads");

// The f32 engine's narrow class (below): rows of its tile (a pass), k-rows
// of an f32 weight slab, floats of a ring stage (row stride kWMax).
constexpr int kRowsF32 = 64;
constexpr int kSlabF32 = 32;
constexpr int kRingStageF32 = kSlabF32 * kWMax;

// The row engine's width classes.  bf16 engine: kRows rows of a pass, kW
// the widest padded layer, kEnc the widest padded encoding, kLd the tile's
// row stride, kSlabK the k-rows of a ring slab, kLdSlab its row stride,
// kStage the bf16 of a ring stage, kColWarps the warps across a layer's
// columns (64 each).  f32 engine: kRowsF rows of a pass, kLdF the tile's
// row stride, kSlabF the k-rows of an f32 slab (row stride kW).
struct RowsNarrow {
  static constexpr int kRows = kRowsMax, kW = kWMax, kEnc = kEncMax, kLd = kLdA;
  static constexpr int kSlabK = kSlab, kLdSlab = kLdWs, kStage = kRingStage, kColWarps = 4;
  static constexpr int kRowsF = kRowsF32, kLdF = kLdZ, kSlabF = kSlabF32;
};
struct RowsWide {
  static constexpr int kRows = 64, kW = kWideWMax, kEnc = kWideEncMax, kLd = kWideWMax + 8;
  static constexpr int kSlabK = 32, kLdSlab = kWideWMax + 8, kStage = 32 * (kWideWMax + 8), kColWarps = 8;
  static constexpr int kRowsF = 32, kLdF = kWideWMax + 4, kSlabF = 16;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.  .trans transposes each matrix.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) @ b (16x8, col), f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of the engine: the activation tile (every layer written in
// place), the encoding (in dual mode rows kRows / 2 .. hold the tangent's),
// the weight ring, the rows' raw points and the head's output per row (in
// dual mode sdf[kRows / 2 + r] is section r's directional derivative).
template <class Cls>
struct RowsTile {
  __align__(16) bf16 a[Cls::kRows][Cls::kLd];
  __align__(16) float enc[Cls::kRows][Cls::kEnc];
  __align__(16) bf16 ring[kChainStages * Cls::kStage];
  float pts[Cls::kRows][3];
  float sdf[Cls::kRows];
};
using RowsSmem = RowsTile<RowsNarrow>;

// Rows of a warp's two row tiles, in row group w / kColWarps: dual mode,
// section rows 16 (w / kColWarps) and their tangent rows kRows / 2 below;
// value mode, 32 consecutive rows (MT = 2) or 16 (MT = 1).
template <bool DUAL, int MT, class Cls = RowsNarrow>
__device__ __forceinline__ int tile_row(int warp, int i) {
  const int rg = warp / Cls::kColWarps;
  return DUAL ? 16 * rg + (Cls::kRows / 2) * i : (16 * MT) * rg + 16 * i;
}

// Issue (and commit, as one group) the copy of k-slab s of the row-major
// [kp, np] weight W into ring stage s % kChainStages of a Cls engine (the
// narrow class's is the chain's own stage_slab); an empty group past kp.
template <class Cls>
__device__ __forceinline__ void stage_rows_slab(const bf16* __restrict__ W, int np, int kp, bf16* ring, int s) {
  if constexpr (Cls::kSlabK == kSlab) {
    stage_slab<false>(W, np, kp, np, ring, s);
  } else {
    const int tid = threadIdx.x, k0 = s * Cls::kSlabK, cpr = np / 8;
    bf16* dst = ring + (s % kChainStages) * Cls::kStage;
    if (k0 < kp) {
      for (int idx = tid; idx < Cls::kSlabK * cpr; idx += kRowsThreads) {
        const int r = idx / cpr, c = (idx % cpr) * 8;
        if (k0 + r < kp) cp_async16(dst + r * Cls::kLdSlab + c, W + (size_t)(k0 + r) * np + c);
      }
    }
    cp_async_commit();
  }
}

// The first kChainStages - 1 slabs of a product; the ring must be free.
template <class Cls>
__device__ __forceinline__ void stage_first_rows_slabs(const bf16* __restrict__ W, int np, int kp, bf16* ring) {
#pragma unroll
  for (int s = 0; s < kChainStages - 1; ++s) stage_rows_slab<Cls>(W, np, kp, ring, s);
}

// acc = A[rows of the warp, :kp] @ W[kp, np] after stage_first_rows_slabs<Cls>(W,
// np, kp, ring): the warp's MT row tiles x its 8 column tiles of 8 (those
// below np).  Every thread must call it; it begins with a barrier and returns
// with the ring free and every warp past its last read of A.
template <bool DUAL, int MT, class Cls = RowsNarrow>
__device__ __forceinline__ void rows_product(const bf16* A, const bf16* __restrict__ W, int kp, int np, bf16* ring,
                                             float (&acc)[MT][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c0 = (warp % Cls::kColWarps) * 64;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int nslab = (kp + Cls::kSlabK - 1) / Cls::kSlabK;
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<kChainStages - 2>();
    __syncthreads();
    stage_rows_slab<Cls>(W, np, kp, ring, s + kChainStages - 1);
    const bf16* Ws = ring + (s % kChainStages) * Cls::kStage;
    const int kend = min(Cls::kSlabK, kp - s * Cls::kSlabK);
    for (int kk = 0; kk < kend; kk += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], A + (tile_row<DUAL, MT, Cls>(warp, i) + (lane & 15)) * Cls::kLd + s * Cls::kSlabK + kk +
                          (lane >> 4) * 8);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if (c0 + 16 * f < np) {
          unsigned b[4];
          ldsm_x4_trans(b, Ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * Cls::kLdSlab + c0 + 16 * f +
                               (lane >> 4) * 8);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_16816(acc[i][2 * f + h], a[i], b[2 * h], b[2 * h + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Layer output from the accumulators, written in place into A at the
// columns below `out`: h = bf16(softplus(100 (z + b)) / 100) and, before a
// skip layer, bf16(h / sqrt2) again; in dual mode the tangent bf16(t gate),
// rounded the same way.
template <bool DUAL, int MT, class Cls = RowsNarrow>
__device__ __forceinline__ void rows_epilogue(bf16* A, const float (&acc)[MT][8][4], const float* __restrict__ b,
                                              int out, int np, bool next_skip) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c0 = (warp % Cls::kColWarps) * 64;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (c0 + 16 * (j >> 1) >= np) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + 8 * j + t2 + (e & 1), roff = g + 8 * (e >> 1);
      if (col >= out) continue;
      const float bc = b[col];
      float sp, gate;
      softplus100_gate(acc[0][j][e] + bc, &sp, &gate);
      bf16 hv = to_bf16(sp);
      if (next_skip) hv = to_bf16(bf(hv) * kInvSqrt2);
      A[(tile_row<DUAL, MT, Cls>(warp, 0) + roff) * Cls::kLd + col] = hv;
      if (MT == 2) {
        bf16 v;
        if (DUAL) {
          v = to_bf16(acc[MT - 1][j][e] * gate);
        } else {
          softplus100_gate(acc[MT - 1][j][e] + bc, &sp, &gate);
          v = to_bf16(sp);
        }
        if (next_skip) v = to_bf16(bf(v) * kInvSqrt2);
        A[(tile_row<DUAL, MT, Cls>(warp, MT - 1) + roff) * Cls::kLd + col] = v;
      }
    }
  }
}

// The SDF MLP on the engine's rows: DUAL, kRows / 2 sections (points
// S.pts[0 ..], all along direction dir) and their tangents; otherwise
// 16 MT x (16 / kColWarps) value rows (S.pts): 64 MT narrow, 64 wide.  Out:
// S.sdf[r] = sdf of row r, and in dual mode S.sdf[kRows / 2 + r] = dir .
// grad sdf of section r.  Every thread of the block calls it; it ends with
// __syncthreads.
template <bool DUAL, int MT, class Cls = RowsNarrow>
__device__ void sdf_rows(RowsTile<Cls>& S, const float* dir, const bf16* __restrict__ wpack,
                         const float* __restrict__ bpack, const float* __restrict__ w_sdf, const SdfMeta& m,
                         float scale) {
  static_assert(!DUAL || MT == 2, "dual mode runs sections and their tangent rows, two row tiles a warp");
  constexpr int kRows = 16 * MT * (16 / Cls::kColWarps), kPts = DUAL ? kRows / 2 : kRows, kEnc = Cls::kEnc;
  static_assert(kRows <= Cls::kRows, "a pass fills at most the tile");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;

  // The encoding, and the first layer's bf16 input.
  stage_first_rows_slabs<Cls>(wpack + m.w_off(0), m.np(0), m.kp(0), S.ring);
  for (int idx = tid; idx < kPts * kEnc; idx += kRowsThreads) {
    const int r = idx / kEnc, c = idx % kEnc;
    float xs[3], ts[3];
    for (int j = 0; j < 3; ++j) {
      xs[j] = S.pts[r][j] * scale;
      ts[j] = DUAL ? dir[j] * scale : 0.0f;
    }
    float t = 0.0f, v = 0.0f;
    if (c < d0) v = freq_channel(xs, ts, c, F, DUAL ? &t : nullptr);
    S.enc[r][c] = v;
    if (c < m.kp(0)) S.a[r][c] = to_bf16(v);
    if (DUAL) {
      S.enc[kPts + r][c] = t;
      if (c < m.kp(0)) S.a[kPts + r][c] = to_bf16(t);
    }
  }

  for (int i = 0; i < L; ++i) {
    const int np = m.np(i), out = m.out(i);
    const bool last = i + 1 == L, next_skip = !last && m.skip(i + 1);
    const int kp_next = last ? ((m.d_last + 15) / 16) * 16 : m.kp(i + 1);
    float acc[MT][8][4];
    rows_product<DUAL, MT, Cls>(&S.a[0][0], wpack + m.w_off(i), m.kp(i), np, S.ring, acc);
    if (!last) stage_first_rows_slabs<Cls>(wpack + m.w_off(i + 1), m.np(i + 1), m.kp(i + 1), S.ring);
    rows_epilogue<DUAL, MT, Cls>(&S.a[0][0], acc, bpack + m.b_off(i), out, np, next_skip);
    // Columns past this layer's output: the skip layer's encoding half
    // (x 1/sqrt2), then zeros up to the next padded width.
    const int tail = kp_next - out;
    for (int idx = tid; idx < kRows * tail; idx += kRowsThreads) {
      const int r = idx / tail, c = idx % tail;
      S.a[r][out + c] = to_bf16(next_skip && c < d0 ? S.enc[r][c] * kInvSqrt2 : 0.0f);
    }
  }
  __syncthreads();

  // The bf16 sdf head, one warp per row: sdf = (h . w_sdf + b_sdf) / scale,
  // and for a tangent row (th . w_sdf) / scale.
  const float b_sdf = bpack[m.bf_off + m.npf];
  for (int r = warp; r < kRows; r += kRowsThreads / 32) {
    float s = 0.0f;
    for (int c = lane; c < m.d_last; c += 32) s += bf(S.a[r][c]) * bf(to_bf16(w_sdf[c]));
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) S.sdf[r] = DUAL && r >= kPts ? s / scale : (s + b_sdf) / scale;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The f32 engine


// Shared memory of the f32 engine, laid out as RowsTile: the tile (row
// stride kLdF), the encoding (in dual mode rows kRowsF / 2 .. hold the
// tangent's), the ring, the raw points and the head's output (in dual mode
// sdf[kRowsF / 2 + r] is section r's directional derivative).  The points
// and outputs hold kRowsF32 value rows in either class: the wide class's
// value sweep runs them as two passes of its 32-row tile.
template <class Cls>
struct RowsTileF32 {
  __align__(16) float a[Cls::kRowsF][Cls::kLdF];
  __align__(16) float enc[Cls::kRowsF][Cls::kEnc];
  __align__(16) float ring[kChainStages * Cls::kSlabF * Cls::kW];
  float pts[kRowsF32][3];
  float sdf[kRowsF32];
};
using RowsSmemF32 = RowsTileF32<RowsNarrow>;

// Issue (and commit, as one group) the copy of k-slab s of the row-major f32
// [K, N] weight B of row stride ldb (a multiple of 4) into ring stage
// s % STAGES (Cls's slabs of kSlabF k-rows, row stride kW); an empty group
// past K.  The march's ring has kChainStages stages, the 64-point kernels'
// f32 instances two.
template <int STAGES = kChainStages, class Cls = RowsNarrow>
__device__ __forceinline__ void stage_slab_f32(const float* __restrict__ B, int ldb, int K, int N, float* ring,
                                               int s) {
  const int tid = threadIdx.x, k0 = s * Cls::kSlabF, cpr = N / 4;
  float* dst = ring + (s % STAGES) * (Cls::kSlabF * Cls::kW);
  if (k0 < K) {
    for (int idx = tid; idx < Cls::kSlabF * cpr; idx += kRowsThreads) {
      const int r = idx / cpr, c = (idx % cpr) * 4;
      if (k0 + r < K) cp_async16(dst + r * Cls::kW + c, B + (size_t)(k0 + r) * ldb + c);
    }
  }
  cp_async_commit();
}

template <int STAGES = kChainStages, class Cls = RowsNarrow>
__device__ __forceinline__ void stage_first_slabs_f32(const float* __restrict__ B, int ldb, int K, int N,
                                                      float* ring) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage_slab_f32<STAGES, Cls>(B, ldb, K, N, ring, s);
}

// Row i (0-7) of row group g (kRowsF / 8 groups): dual mode, sections
// 4 g .. +3 and their tangent rows kRowsF / 2 below; value mode, rows
// 8 g .. +7.
template <bool DUAL, class Cls = RowsNarrow>
__device__ __forceinline__ int f32_row(int g, int i) {
  return DUAL ? (i < 4 ? 4 * g + i : Cls::kRowsF / 2 + 4 * g + i - 4) : 8 * g + i;
}

// Threads of an f32 row group: 64 narrow (columns 0-255), 128 wide (0-511).
template <class Cls>
constexpr int kGroupThreadsF32 = kRowsThreads / (Cls::kRowsF / 8);

// acc = A[the thread's 8 rows, :kp] @ W[kp, np] at its 4 columns (zeros
// where they lie past np), after stage_first_slabs_f32<STAGES, Cls>(W, ldw,
// kp, np, ring); A's row stride is lda, W's ldw (multiples of 4).  Every
// thread must call it; it begins with a barrier and returns with the ring
// free and every thread past its last read of A.
template <bool DUAL, int STAGES = kChainStages, class Cls = RowsNarrow>
__device__ __forceinline__ void rows_product_f32(const float* A, int lda, const float* __restrict__ W, int ldw,
                                                 int kp, int np, float* ring, float (&acc)[8][4]) {
  constexpr int kGT = kGroupThreadsF32<Cls>, kSl = Cls::kSlabF;
  const int g = threadIdx.x / kGT, c0 = (threadIdx.x % kGT) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  const int nslab = (kp + kSl - 1) / kSl;
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    stage_slab_f32<STAGES, Cls>(W, ldw, kp, np, ring, s + STAGES - 1);
    const float* Ws = ring + (s % STAGES) * (kSl * Cls::kW) + c0;
    const int kend = min(kSl, kp - s * kSl);
    if (c0 < np) {
      for (int kk = 0; kk < kend; kk += 4) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(A + f32_row<DUAL, Cls>(g, i) * lda + s * kSl + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(Ws + (kk + q) * Cls::kW);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
            acc[i][0] = fmaf(av, w.x, acc[i][0]);
            acc[i][1] = fmaf(av, w.y, acc[i][1]);
            acc[i][2] = fmaf(av, w.z, acc[i][2]);
            acc[i][3] = fmaf(av, w.w, acc[i][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Layer output from the accumulators, written in place into A at the
// columns below `out`: h = softplus(100 (z + b)) / 100 and, before a skip
// layer, h / sqrt2; in dual mode the tangent t gate, / sqrt2 the same way.
template <bool DUAL, class Cls = RowsNarrow>
__device__ __forceinline__ void rows_epilogue_f32(float* A, const float (&acc)[8][4], const float* __restrict__ b,
                                                  int out, bool next_skip) {
  constexpr int kGT = kGroupThreadsF32<Cls>;
  const int g = threadIdx.x / kGT, c0 = (threadIdx.x % kGT) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = c0 + e;
    if (col >= out) continue;
    const float bc = b[col];
#pragma unroll
    for (int i = 0; i < (DUAL ? 4 : 8); ++i) {
      float sp, gate;
      softplus100_gate(acc[i][e] + bc, &sp, &gate);
      A[f32_row<DUAL, Cls>(g, i) * Cls::kLdF + col] = next_skip ? sp * kInvSqrt2 : sp;
      if (DUAL) {
        const float t = acc[i + 4][e] * gate;
        A[f32_row<DUAL, Cls>(g, i + 4) * Cls::kLdF + col] = next_skip ? t * kInvSqrt2 : t;
      }
    }
  }
}

// The SDF MLP on the f32 engine's kRowsF rows (64 narrow, 32 wide): DUAL,
// kRowsF / 2 sections (S.pts[0 ..], all along direction dir) and their
// tangents; otherwise kRowsF value rows, the points S.pts[row0 ..].  Out:
// S.sdf[row0 + r] = sdf of row r, and in dual mode S.sdf[kRowsF / 2 + r] =
// dir . grad sdf of section r.  wpack holds the f32 weights in
// pack_sdf_mlp's layout.  Every thread of the block calls it; it ends with
// __syncthreads.
template <bool DUAL, class Cls = RowsNarrow>
__device__ void sdf_rows_f32(RowsTileF32<Cls>& S, const float* dir, const float* __restrict__ wpack,
                             const float* __restrict__ bpack, const float* __restrict__ w_sdf, const SdfMeta& m,
                             float scale, int row0 = 0) {
  constexpr int kRows = Cls::kRowsF, kPts = DUAL ? kRows / 2 : kRows, kEnc = Cls::kEnc, ST = kChainStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;

  // The encoding, which is also the first layer's input.
  stage_first_slabs_f32<ST, Cls>(wpack + m.w_off(0), m.np(0), m.kp(0), m.np(0), S.ring);
  for (int idx = tid; idx < kPts * kEnc; idx += kRowsThreads) {
    const int r = idx / kEnc, c = idx % kEnc;
    float xs[3], ts[3];
    for (int j = 0; j < 3; ++j) {
      xs[j] = S.pts[row0 + r][j] * scale;
      ts[j] = DUAL ? dir[j] * scale : 0.0f;
    }
    float t = 0.0f, v = 0.0f;
    if (c < d0) v = freq_channel(xs, ts, c, F, DUAL ? &t : nullptr);
    S.enc[r][c] = v;
    if (c < m.kp(0)) S.a[r][c] = v;
    if (DUAL) {
      S.enc[kPts + r][c] = t;
      if (c < m.kp(0)) S.a[kPts + r][c] = t;
    }
  }

  for (int i = 0; i < L; ++i) {
    const int out = m.out(i);
    const bool last = i + 1 == L, next_skip = !last && m.skip(i + 1);
    const int kp_next = last ? ((m.d_last + 15) / 16) * 16 : m.kp(i + 1);
    float acc[8][4];
    rows_product_f32<DUAL, ST, Cls>(&S.a[0][0], Cls::kLdF, wpack + m.w_off(i), m.np(i), m.kp(i), m.np(i), S.ring,
                                    acc);
    if (!last)
      stage_first_slabs_f32<ST, Cls>(wpack + m.w_off(i + 1), m.np(i + 1), m.kp(i + 1), m.np(i + 1), S.ring);
    rows_epilogue_f32<DUAL, Cls>(&S.a[0][0], acc, bpack + m.b_off(i), out, next_skip);
    // Columns past this layer's output: the skip layer's encoding half
    // (x 1/sqrt2), then zeros up to the next padded width.
    const int tail = kp_next - out;
    for (int idx = tid; idx < kRows * tail; idx += kRowsThreads) {
      const int r = idx / tail, c = idx % tail;
      S.a[r][out + c] = next_skip && c < d0 ? S.enc[r][c] * kInvSqrt2 : 0.0f;
    }
  }
  __syncthreads();

  // The f32 sdf head, one warp per row: sdf = (h . w_sdf + b_sdf) / scale,
  // and for a tangent row (th . w_sdf) / scale.
  const float b_sdf = bpack[m.bf_off + m.npf];
  for (int r = warp; r < kRows; r += kRowsThreads / 32) {
    float s = 0.0f;
    for (int c = lane; c < m.d_last; c += 32) s = fmaf(S.a[r][c], w_sdf[c], s);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) S.sdf[row0 + r] = DUAL && r >= kPts ? s / scale : (s + b_sdf) / scale;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// gemm_rows_f32: the products of the SDF core's and the reflectance trunk's
// f32 instances

// The f32 chain's ring: two stages of kSlabF32 f32 k-rows (64 KB); with its
// f32 activation and carry tiles and the encoding, a 64-point block of the
// forward needs 215,040 bytes, the backward chain 215,296 (sdf_fwd.cuh,
// sdf_bwd.cuh), where three stages would need 247,808.
constexpr int kChainStagesF32 = 2;

// The dtypes argument of the SDF core's and the trunk's C entry points: bit
// 0 selects f32 dot operands (compute_dtype="float32"), bit 1 an f32 stash
// (stash_dtype="float32"); core_mlp.py::dtype_bits writes it.
constexpr int kF32Compute = 1, kF32Stash = 2;
// Bit 2 selects the wide instances (the SDF core's CoreWide, the trunk's
// TrunkWide: core_mlp.py's wide classes), at every pair of the other bits.
constexpr int kWideClass = 4;
// Bit 3 selects the SDF core's huge instances (CoreHuge: any width, bf16
// operands and stash only, so this bit stands alone).
constexpr int kHugeClass = 8;

// The 64-point kernels' shared-memory layout by operand type: the
// activation tile's row stride and the ring's elements of T.
template <typename T>
struct CoreTile;
template <>
struct CoreTile<bf16> {
  static constexpr int kLdAct = kLdA, kRing = kChainStages * kRingStage;
};
template <>
struct CoreTile<float> {
  static constexpr int kLdAct = kLdZ, kRing = kChainStagesF32 * kRingStageF32;
};

// C[R, N] = A[R, K] @ B with f32 operands (exact f32 dots: one fmaf a
// multiply-add in k order, as sdf_core_ref and mlp_relu_ref compute with
// cdt=None) on Cls's f32 engine, R = Cls::kRowsF rows, after
// stage_first_slabs_f32<kChainStagesF32, Cls>(B, ldb, K, N, ring).  A is an
// f32 tile of row stride lda, B a row-major [K, N] f32 block of row stride
// ldb (multiples of 4; N at most Cls::kW).  RowsNarrow: the 64-point
// kernels' f32 instances (the SDF core's and the reflectance trunk's), 64
// rows by up to 256 columns; RowsWide: their wide classes' (32-point
// blocks), 32 rows by up to 512 columns, on a ring of as many floats (two
// stages of 16 k-rows by 512 columns).  The same contract as the bf16
// gemm_rows64: every thread calls it, it begins with a barrier and returns
// with the ring free; C is complete after the caller's next
// __syncthreads().  C may be A itself: every thread is past its last read
// of A before any C is stored.
template <class Cls = RowsNarrow>
__device__ __forceinline__ void gemm_rows_f32(const float* A, int lda, const float* __restrict__ B, int ldb, int K,
                                              int N, float* C, int ldc, float* ring) {
  constexpr int kGT = kGroupThreadsF32<Cls>;
  float acc[8][4];
  rows_product_f32<false, kChainStagesF32, Cls>(A, lda, B, ldb, K, N, ring, acc);
  const int g = threadIdx.x / kGT, c0 = (threadIdx.x % kGT) * 4;
  if (c0 < N)
#pragma unroll
    for (int i = 0; i < 8; ++i) st_f4(C + f32_row<false, Cls>(g, i) * ldc + c0, acc[i]);
}
static_assert(kChainStagesF32 * RowsWide::kSlabF * RowsWide::kW == kChainStagesF32 * kRingStageF32,
              "the wide f32 ring holds as many floats as the 64-point one");

// The SDF core's products by width class (CoreNarrow, CoreWide) and operand
// type: the first slabs of a product (the first column pass's in the wide
// bf16 class), and the product.  bf16: gemm_rows64, or gemm_rows32's column
// passes.  f32: gemm_rows_f32 on the f32 engine's class of as many rows
// (CoreRowsF32: RowsNarrow's 64, RowsWide's 32), B the row-major [K, N] f32
// block of row stride N (ldb is not read); a transposed product, which the
// bf16 instances read as the transpose of the [N, K] weight, reads the
// weight's own transposed block of the f32 pack (core_mlp.pack_sdf_mlp's
// and pack_mlp's wtpack).  kCoreLdAct is the activation tile's row stride.
template <class Cls, typename T>
constexpr int kCoreLdAct = std::is_same<T, float>::value ? Cls::kLdC : Cls::kW + 8;
template <class Cls>
using CoreRowsF32 = typename std::conditional<Cls::kPts == kChainTP, RowsNarrow, RowsWide>::type;
static_assert(CoreRowsF32<CoreNarrow>::kRowsF == CoreNarrow::kPts && CoreRowsF32<CoreWide>::kRowsF == CoreWide::kPts &&
                  CoreRowsF32<CoreWide>::kW == CoreWide::kW,
              "the f32 engine's class of a core class covers its points and widths");

template <class Cls, bool TRANS_B, typename T>
__device__ __forceinline__ void core_stage(const T* __restrict__ B, int ldb, int K, int N, T* ring) {
  if constexpr (std::is_same<T, float>::value)
    stage_first_slabs_f32<kChainStagesF32, CoreRowsF32<Cls>>(B, N, K, N, ring);
  else
    stage_first_slabs<TRANS_B>(B, ldb, K, Cls::kPts == kChainTP && !Cls::kHuge ? N : min(N, kWMax), ring);
}

template <class Cls, bool TRANS_B, typename T>
__device__ __forceinline__ void core_gemm(const T* A, int lda, const T* __restrict__ B, int ldb, int K, int N,
                                          float* C, int ldc, T* ring) {
  if constexpr (std::is_same<T, float>::value)
    gemm_rows_f32<CoreRowsF32<Cls>>(A, lda, B, N, K, N, C, ldc, ring);
  else if constexpr (Cls::kHuge)
    gemm_rows_huge<TRANS_B>(A, lda, B, ldb, K, N, C, ldc, ring);
  else if constexpr (Cls::kPts == kChainTP)
    gemm_rows64<TRANS_B>(A, lda, B, ldb, K, N, C, ldc, ring);
  else
    gemm_rows32<TRANS_B>(A, lda, B, ldb, K, N, C, ldc, ring);
}

// The huge class's tile widths (core_mlp.huge_tiles): the widest padded
// layer input or output and feature head, and the padded encoding.
__device__ __forceinline__ int huge_width(const SdfMeta& m) {
  int w = max(m.kpf, m.npf);
  for (int i = 0; i < m.n_layers; ++i) w = max(w, max(m.kp(i), m.np(i)));
  return w;
}
__host__ __device__ inline int huge_enc(const SdfMeta& m) { return (m.d0 + 15) / 16 * 16; }
// f32 a point of the huge class's rows (core_mlp.row_layout): the bf16
// activations, the f32 carry and the f32 encoding, each huge_width /
// huge_enc wide.
__device__ __forceinline__ int huge_row(const SdfMeta& m) {
  const int w = huge_width(m);
  return w / 2 + w + huge_enc(m);
}

// A block's tiles of the SDF core (sdf_fwd.cuh, sdf_bwd.cuh): the
// activation tile of T, the f32 carry, the f32 encoding, the weight ring,
// their row strides, and the shared memory past the ring(s) (`tail`).
// Narrow and wide: all in shared memory at the class's strides.  Huge: the
// activations, carry and encoding are the block's rows of a device-memory
// scratch (`rows`, huge_row floats a point) at the meta's widths, and
// shared memory holds the weight ring, then gemm_rows_huge's row ring.
template <typename T>
struct CoreTiles {
  T* act;
  float* carry;
  float* enc;
  T* ring;
  unsigned char* tail;
  int ld_act, ld_c, ld_enc;
};

template <class Cls, typename T>
__device__ __forceinline__ CoreTiles<T> core_tiles(unsigned char* smem, float* rows, const SdfMeta& m) {
  CoreTiles<T> t;
  if constexpr (Cls::kHuge) {
    static_assert(std::is_same<T, bf16>::value, "the huge class is bf16 only");
    const int w = huge_width(m);
    t.act = reinterpret_cast<T*>(rows);
    t.carry = rows + Cls::kPts * w / 2;
    t.enc = t.carry + Cls::kPts * w;
    t.ring = reinterpret_cast<T*>(smem);
    t.tail = reinterpret_cast<unsigned char*>(t.ring + CoreTile<T>::kRing + kHugeARing);
    t.ld_act = t.ld_c = w;
    t.ld_enc = huge_enc(m);
  } else {
    constexpr int kLdAct = kCoreLdAct<Cls, T>;
    t.act = reinterpret_cast<T*>(smem);
    t.carry = reinterpret_cast<float*>(t.act + Cls::kPts * kLdAct);
    t.enc = t.carry + Cls::kPts * Cls::kLdC;
    t.ring = reinterpret_cast<T*>(t.enc + Cls::kPts * Cls::kEnc);
    t.tail = reinterpret_cast<unsigned char*>(t.ring + CoreTile<T>::kRing);
    t.ld_act = kLdAct;
    t.ld_c = Cls::kLdC;
    t.ld_enc = Cls::kEnc;
  }
  return t;
}

// Shared memory of the huge class's blocks: the weight ring and the row
// ring (138,240 bytes), and `tail` bytes after them.
constexpr size_t huge_smem(size_t tail) { return (CoreTile<bf16>::kRing + kHugeARing) * sizeof(bf16) + tail; }

// ---------------------------------------------------------------------------
// The bf16 row engine's huge class (core_mlp.ROWS_HUGE): the march sweeps of
// kernels C, K, L, M and N at any padded width and encoding (multiples of
// 16), bf16 march weights only.  A pass holds kRows = 64 rows (dual mode: 32
// sections and their 32 tangent rows).  Its rows lie in device memory as the
// SDF core's huge blocks lay theirs out (core_tiles<CoreHuge>: per row the
// bf16 activations, the f32 product output and the f32 encoding at the
// meta's widths, huge_row floats a row), every product is
// staged_mma.cuh::gemm_rows_huge (64 rows in column passes of at most kWMax,
// A's k-slabs staged from device memory through the row ring), and the
// epilogue (bias, softplus(100 .) / 100, the tangent's gate, the skip
// concat over sqrt2, the bf16 rounding of _mlp_sdf_3d) runs as elementwise
// passes over those rows.  Each output walks its k-tiles 0, 16, 32, ... in
// order and rounds where sdf_rows rounds, so a row's floats are sdf_rows's
// at the presets' widths, bit for bit.
struct RowsHuge {
  static constexpr int kRows = kChainTP;
};

// Shared memory of the huge engine: the weight ring, then gemm_rows_huge's
// row ring (138,240 bytes), the rows' raw points and the head's output per
// row (in dual mode sdf[kRows / 2 + r] is section r's directional
// derivative), and the block's rows of the device-memory scratch.
struct RowsHugeTile {
  __align__(16) bf16 ring[CoreTile<bf16>::kRing + kHugeARing];
  float pts[RowsHuge::kRows][3];
  float sdf[RowsHuge::kRows];
  float* rows;
};
static_assert(sizeof(RowsHugeTile::ring) == huge_smem(0), "the huge engine's rings are the SDF core's huge ones");

// The SDF MLP on the huge engine's 64 rows: DUAL, 32 sections (points
// S.pts[0 ..], all along direction dir) and their tangents; otherwise 64
// value rows.  Out: S.sdf[r] = sdf of row r, and in dual mode S.sdf[32 + r]
// = dir . grad sdf of section r.  Every thread of the block calls it; it
// ends with __syncthreads.
template <bool DUAL>
__device__ void sdf_rows_huge(RowsHugeTile& S, const float* dir, const bf16* __restrict__ wpack,
                              const float* __restrict__ bpack, const float* __restrict__ w_sdf, const SdfMeta& m,
                              float scale) {
  constexpr int kRows = RowsHuge::kRows, kPts = DUAL ? kRows / 2 : kRows;
  const CoreTiles<bf16> tl = core_tiles<CoreHuge, bf16>(reinterpret_cast<unsigned char*>(S.ring), S.rows, m);
  bf16* A = tl.act;
  float* Z = tl.carry;
  float* enc = tl.enc;
  const int ld = tl.ld_act, ldz = tl.ld_c, le = tl.ld_enc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;

  // The encoding, and the first layer's bf16 input.
  core_stage<CoreHuge, false>(wpack + m.w_off(0), m.np(0), m.kp(0), m.np(0), S.ring);
  for (int idx = tid; idx < kPts * le; idx += kRowsThreads) {
    const int r = idx / le, c = idx % le;
    float xs[3], ts[3];
    for (int j = 0; j < 3; ++j) {
      xs[j] = S.pts[r][j] * scale;
      ts[j] = DUAL ? dir[j] * scale : 0.0f;
    }
    float t = 0.0f, v = 0.0f;
    if (c < d0) v = freq_channel(xs, ts, c, F, DUAL ? &t : nullptr);
    enc[r * le + c] = v;
    if (c < m.kp(0)) A[r * ld + c] = to_bf16(v);
    if (DUAL) {
      enc[(kPts + r) * le + c] = t;
      if (c < m.kp(0)) A[(kPts + r) * ld + c] = to_bf16(t);
    }
  }

  for (int i = 0; i < L; ++i) {
    const int np = m.np(i), out = m.out(i);
    const bool last = i + 1 == L, next_skip = !last && m.skip(i + 1);
    const int kp_next = last ? ((m.d_last + 15) / 16) * 16 : m.kp(i + 1);
    gemm_rows_huge<false>(A, ld, wpack + m.w_off(i), np, m.kp(i), np, Z, ldz, S.ring);
    __syncthreads();
    if (!last) core_stage<CoreHuge, false>(wpack + m.w_off(i + 1), m.np(i + 1), m.kp(i + 1), m.np(i + 1), S.ring);
    // The next product's input, four columns of a row (of a section and its
    // tangent row in dual mode) an item: h = bf16(softplus(100 (z + b)) /
    // 100) and the tangent bf16(t gate), each bf16(. / sqrt2) again before a
    // skip layer; past the output, the skip layer's encoding half (x
    // 1/sqrt2), then zeros up to the next padded width (>= np).
    const float* b = bpack + m.b_off(i);
    const int w4 = kp_next / 4;
    for (int idx = tid; idx < kPts * w4; idx += kRowsThreads) {
      const int r = idx / w4, c = (idx % w4) * 4;
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f}, zt[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float h[4], ht[4];
      if (c < np) {
        ld_f4(Z + (size_t)r * ldz + c, z);
        if (DUAL) ld_f4(Z + (size_t)(kPts + r) * ldz + c, zt);
        ld_f4(b + c, bb);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ck = c + k;
        if (ck < out) {
          float sp, gate;
          softplus100_gate(z[k] + bb[k], &sp, &gate);
          bf16 hv = to_bf16(sp), tv = to_bf16(zt[k] * gate);
          if (next_skip) {
            hv = to_bf16(bf(hv) * kInvSqrt2);
            tv = to_bf16(bf(tv) * kInvSqrt2);
          }
          h[k] = bf(hv);
          ht[k] = bf(tv);
        } else {
          const bool e = next_skip && ck - out < d0;
          h[k] = e ? enc[r * le + ck - out] * kInvSqrt2 : 0.0f;
          ht[k] = e && DUAL ? enc[(kPts + r) * le + ck - out] * kInvSqrt2 : 0.0f;
        }
      }
      st_bf4(A + (size_t)r * ld + c, h);
      if (DUAL) st_bf4(A + (size_t)(kPts + r) * ld + c, ht);
    }
  }
  __syncthreads();

  // The bf16 sdf head, one warp per row: sdf = (h . w_sdf + b_sdf) / scale,
  // and for a tangent row (th . w_sdf) / scale.
  const float b_sdf = bpack[m.bf_off + m.npf];
  for (int r = warp; r < kRows; r += kRowsThreads / 32) {
    float s = 0.0f;
    for (int c = lane; c < m.d_last; c += 32) s += bf(A[(size_t)r * ld + c]) * bf(to_bf16(w_sdf[c]));
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) S.sdf[r] = DUAL && r >= kPts ? s / scale : (s + b_sdf) / scale;
  }
  __syncthreads();
}

}  // namespace nrh
