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

#include "staged_mma.cuh"

namespace nrh {

constexpr int kRowsMax = 128;        // rows of the engine's activation tile
constexpr int kRowsThreads = 512;    // threads of a block that runs it (= kChainThreads: the ring's copy loop)
static_assert(kRowsThreads == kChainThreads, "stage_slab strides its copies by kChainThreads");

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
// place), the encoding (in dual mode rows 64-127 hold the tangent's), the
// weight ring, the rows' raw points and the head's output per row (in dual
// mode sdf[64 + r] is section r's directional derivative).
struct RowsSmem {
  __align__(16) bf16 a[kRowsMax][kLdA];
  __align__(16) float enc[kRowsMax][kEncMax];
  __align__(16) bf16 ring[kChainStages * kRingStage];
  float pts[kRowsMax][3];
  float sdf[kRowsMax];
};

// Rows of a warp's two row tiles: dual mode, section rows 16 (w / 4) and
// their tangent rows 64 below; value mode, 32 consecutive rows (MT = 2) or
// 16 (MT = 1).
template <bool DUAL, int MT>
__device__ __forceinline__ int tile_row(int warp, int i) {
  return DUAL ? 16 * (warp >> 2) + 64 * i : (16 * MT) * (warp >> 2) + 16 * i;
}

// acc = A[rows of the warp, :kp] @ W[kp, np] after stage_first_slabs<false>(W,
// np, kp, np, ring): the warp's MT row tiles x its 8 column tiles of 8 (those
// below np).  Every thread must call it; it begins with a barrier and returns
// with the ring free and every warp past its last read of A.
template <bool DUAL, int MT>
__device__ __forceinline__ void rows_product(const bf16* A, const bf16* __restrict__ W, int kp, int np, bf16* ring,
                                             float (&acc)[MT][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c0 = (warp & 3) * 64;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int nslab = (kp + kSlab - 1) / kSlab;
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<kChainStages - 2>();
    __syncthreads();
    stage_slab<false>(W, np, kp, np, ring, s + kChainStages - 1);
    const bf16* Ws = ring + (s % kChainStages) * kRingStage;
    const int kend = min(kSlab, kp - s * kSlab);
    for (int kk = 0; kk < kend; kk += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], A + (tile_row<DUAL, MT>(warp, i) + (lane & 15)) * kLdA + s * kSlab + kk + (lane >> 4) * 8);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if (c0 + 16 * f < np) {
          unsigned b[4];
          ldsm_x4_trans(b, Ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdWs + c0 + 16 * f + (lane >> 4) * 8);
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
template <bool DUAL, int MT>
__device__ __forceinline__ void rows_epilogue(bf16* A, const float (&acc)[MT][8][4], const float* __restrict__ b,
                                              int out, int np, bool next_skip) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c0 = (warp & 3) * 64;
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
      A[(tile_row<DUAL, MT>(warp, 0) + roff) * kLdA + col] = hv;
      if (MT == 2) {
        bf16 v;
        if (DUAL) {
          v = to_bf16(acc[MT - 1][j][e] * gate);
        } else {
          softplus100_gate(acc[MT - 1][j][e] + bc, &sp, &gate);
          v = to_bf16(sp);
        }
        if (next_skip) v = to_bf16(bf(v) * kInvSqrt2);
        A[(tile_row<DUAL, MT>(warp, MT - 1) + roff) * kLdA + col] = v;
      }
    }
  }
}

// The SDF MLP on the engine's rows: DUAL, 64 sections (points S.pts[0..63],
// all along direction dir) and their tangents; otherwise 64 MT value rows
// (S.pts).  Out: S.sdf[r] = sdf of row r, and in dual mode S.sdf[64 + r] =
// dir . grad sdf of section r.  Every thread of the block calls it; it ends
// with __syncthreads.
template <bool DUAL, int MT>
__device__ void sdf_rows(RowsSmem& S, const float* dir, const bf16* __restrict__ wpack,
                         const float* __restrict__ bpack, const float* __restrict__ w_sdf, const SdfMeta& m,
                         float scale) {
  static_assert(!DUAL || MT == 2, "dual mode runs 64 sections and their 64 tangent rows");
  constexpr int kRows = 64 * MT, kPts = DUAL ? 64 : kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;

  // The encoding, and the first layer's bf16 input.
  stage_first_slabs<false>(wpack + m.w_off[0], m.np_[0], m.kp[0], m.np_[0], S.ring);
  for (int idx = tid; idx < kPts * kEncMax; idx += kRowsThreads) {
    const int r = idx / kEncMax, c = idx % kEncMax;
    float xs[3], ts[3];
    for (int j = 0; j < 3; ++j) {
      xs[j] = S.pts[r][j] * scale;
      ts[j] = DUAL ? dir[j] * scale : 0.0f;
    }
    float t = 0.0f, v = 0.0f;
    if (c < d0) v = freq_channel(xs, ts, c, F, DUAL ? &t : nullptr);
    S.enc[r][c] = v;
    if (c < m.kp[0]) S.a[r][c] = to_bf16(v);
    if (DUAL) {
      S.enc[64 + r][c] = t;
      if (c < m.kp[0]) S.a[64 + r][c] = to_bf16(t);
    }
  }

  for (int i = 0; i < L; ++i) {
    const int np = m.np_[i], out = m.out_dim[i];
    const bool last = i + 1 == L, next_skip = !last && m.skip[i + 1];
    const int kp_next = last ? ((m.d_last + 15) / 16) * 16 : m.kp[i + 1];
    float acc[MT][8][4];
    rows_product<DUAL, MT>(&S.a[0][0], wpack + m.w_off[i], m.kp[i], np, S.ring, acc);
    if (!last) stage_first_slabs<false>(wpack + m.w_off[i + 1], m.np_[i + 1], m.kp[i + 1], m.np_[i + 1], S.ring);
    rows_epilogue<DUAL, MT>(&S.a[0][0], acc, bpack + m.b_off[i], out, np, next_skip);
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
    if (lane == 0) S.sdf[r] = DUAL && r >= 64 ? s / scale : (s + b_sdf) / scale;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The f32 engine

constexpr int kRowsF32 = 64;                      // rows of the f32 engine's tile (a pass)
constexpr int kSlabF32 = 32;                      // k-rows of an f32 weight slab
constexpr int kRingStageF32 = kSlabF32 * kWMax;   // floats of a ring stage (row stride kWMax)

// Shared memory of the f32 engine, laid out as RowsSmem: the tile (row
// stride kLdZ), the encoding (in dual mode rows 32-63 hold the tangent's),
// the ring, the raw points and the head's output (in dual mode sdf[32 + r]
// is section r's directional derivative).
struct RowsSmemF32 {
  __align__(16) float a[kRowsF32][kLdZ];
  __align__(16) float enc[kRowsF32][kEncMax];
  __align__(16) float ring[kChainStages * kRingStageF32];
  float pts[kRowsF32][3];
  float sdf[kRowsF32];
};

// Issue (and commit, as one group) the copy of k-slab s of the row-major f32
// [K, N] weight B into ring stage s % kChainStages; an empty group past K.
__device__ __forceinline__ void stage_slab_f32(const float* __restrict__ B, int K, int N, float* ring, int s) {
  const int tid = threadIdx.x, k0 = s * kSlabF32, cpr = N / 4;
  float* dst = ring + (s % kChainStages) * kRingStageF32;
  if (k0 < K) {
    for (int idx = tid; idx < kSlabF32 * cpr; idx += kRowsThreads) {
      const int r = idx / cpr, c = (idx % cpr) * 4;
      if (k0 + r < K) cp_async16(dst + r * kWMax + c, B + (size_t)(k0 + r) * N + c);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void stage_first_slabs_f32(const float* __restrict__ B, int K, int N, float* ring) {
#pragma unroll
  for (int s = 0; s < kChainStages - 1; ++s) stage_slab_f32(B, K, N, ring, s);
}

// Row i (0-7) of row group g (0-7): dual mode, sections 4 g .. +3 and their
// tangent rows 32 below; value mode, rows 8 g .. +7.
template <bool DUAL>
__device__ __forceinline__ int f32_row(int g, int i) {
  return DUAL ? (i < 4 ? 4 * g + i : 32 + 4 * g + i - 4) : 8 * g + i;
}

// acc = A[the thread's 8 rows, :kp] @ W[kp, np] at its 4 columns (zeros
// where they lie past np), after stage_first_slabs_f32(W, kp, np, ring).
// Every thread must call it; it begins with a barrier and returns with the
// ring free and every thread past its last read of A.
template <bool DUAL>
__device__ __forceinline__ void rows_product_f32(const float* A, const float* __restrict__ W, int kp, int np,
                                                 float* ring, float (&acc)[8][4]) {
  const int g = threadIdx.x >> 6, c0 = (threadIdx.x & 63) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  const int nslab = (kp + kSlabF32 - 1) / kSlabF32;
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<kChainStages - 2>();
    __syncthreads();
    stage_slab_f32(W, kp, np, ring, s + kChainStages - 1);
    const float* Ws = ring + (s % kChainStages) * kRingStageF32 + c0;
    const int kend = min(kSlabF32, kp - s * kSlabF32);
    if (c0 < np) {
      for (int kk = 0; kk < kend; kk += 4) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(A + f32_row<DUAL>(g, i) * kLdZ + s * kSlabF32 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(Ws + (kk + q) * kWMax);
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
template <bool DUAL>
__device__ __forceinline__ void rows_epilogue_f32(float* A, const float (&acc)[8][4], const float* __restrict__ b,
                                                  int out, bool next_skip) {
  const int g = threadIdx.x >> 6, c0 = (threadIdx.x & 63) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = c0 + e;
    if (col >= out) continue;
    const float bc = b[col];
#pragma unroll
    for (int i = 0; i < (DUAL ? 4 : 8); ++i) {
      float sp, gate;
      softplus100_gate(acc[i][e] + bc, &sp, &gate);
      A[f32_row<DUAL>(g, i) * kLdZ + col] = next_skip ? sp * kInvSqrt2 : sp;
      if (DUAL) {
        const float t = acc[i + 4][e] * gate;
        A[f32_row<DUAL>(g, i + 4) * kLdZ + col] = next_skip ? t * kInvSqrt2 : t;
      }
    }
  }
}

// The SDF MLP on the f32 engine's 64 rows: DUAL, 32 sections (S.pts[0..31],
// all along direction dir) and their tangents; otherwise 64 value rows.
// Out: S.sdf[r] = sdf of row r, and in dual mode S.sdf[32 + r] = dir . grad
// sdf of section r.  wpack holds the f32 weights in pack_sdf_mlp's layout.
// Every thread of the block calls it; it ends with __syncthreads.
template <bool DUAL>
__device__ void sdf_rows_f32(RowsSmemF32& S, const float* dir, const float* __restrict__ wpack,
                             const float* __restrict__ bpack, const float* __restrict__ w_sdf, const SdfMeta& m,
                             float scale) {
  constexpr int kRows = kRowsF32, kPts = DUAL ? kRows / 2 : kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = m.n_layers, F = m.multi_res, d0 = m.d0;

  // The encoding, which is also the first layer's input.
  stage_first_slabs_f32(wpack + m.w_off[0], m.kp[0], m.np_[0], S.ring);
  for (int idx = tid; idx < kPts * kEncMax; idx += kRowsThreads) {
    const int r = idx / kEncMax, c = idx % kEncMax;
    float xs[3], ts[3];
    for (int j = 0; j < 3; ++j) {
      xs[j] = S.pts[r][j] * scale;
      ts[j] = DUAL ? dir[j] * scale : 0.0f;
    }
    float t = 0.0f, v = 0.0f;
    if (c < d0) v = freq_channel(xs, ts, c, F, DUAL ? &t : nullptr);
    S.enc[r][c] = v;
    if (c < m.kp[0]) S.a[r][c] = v;
    if (DUAL) {
      S.enc[kPts + r][c] = t;
      if (c < m.kp[0]) S.a[kPts + r][c] = t;
    }
  }

  for (int i = 0; i < L; ++i) {
    const int out = m.out_dim[i];
    const bool last = i + 1 == L, next_skip = !last && m.skip[i + 1];
    const int kp_next = last ? ((m.d_last + 15) / 16) * 16 : m.kp[i + 1];
    float acc[8][4];
    rows_product_f32<DUAL>(&S.a[0][0], wpack + m.w_off[i], m.kp[i], m.np_[i], S.ring, acc);
    if (!last) stage_first_slabs_f32(wpack + m.w_off[i + 1], m.kp[i + 1], m.np_[i + 1], S.ring);
    rows_epilogue_f32<DUAL>(&S.a[0][0], acc, bpack + m.b_off[i], out, next_skip);
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
    if (lane == 0) S.sdf[r] = DUAL && r >= kPts ? s / scale : (s + b_sdf) / scale;
  }
  __syncthreads();
}

}  // namespace nrh
