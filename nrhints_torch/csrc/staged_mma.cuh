// The staged bf16 products of the 64-point kernels: the SDF core's forward
// (sdf_fwd.cuh, kernels A, D and H's first pass) and backward chain
// (sdf_bwd.cuh, kernels E and H), the reflectance trunk's forward and chain
// (mlp_stash.cu, kernels F, G, I and J), and the weight-cotangent passes
// (dw_sum.cuh, kernels E, G, H and J); its ring also feeds the march sweeps
// of kernels C, K, M and N (mma_rows.cuh): operands copied into shared memory
// by cp.async (16-byte copies, a ring of stages, the next slabs in flight
// while the warps run WMMA on the current one), fragments read from shared
// memory only.
//
// gemm_rows64 is the product of those 64-point kernels: C[64, N] = A[64, K]
// @ B for a block of kChainThreads threads whose bf16 activations A already
// lie in shared memory.  The weight B streams through a kChainStages-stage
// ring in k-slabs of kSlab rows, shared by all 16 warps: a weight byte
// fetched from L2 serves 64 points.  Warp w owns rows 32 (w / 8) .. +32 and
// columns 32 (w % 8) .. +32 of C: 2 x 2 accumulator tiles, so each k-step
// loads 2 A and 2 B fragments for 4 products.  The caller issues the first
// slabs (stage_first_slabs) before the elementwise work that precedes the
// product, so their copies overlap it.  The elementwise passes take four
// consecutive columns of one point per item (the ld_ / st_ helpers below).
//
// gemm_rows32 is the product of the SDF core's wide instances (32-point
// blocks, widths up to 2 kWMax: sdf_fwd.cuh, sdf_bwd.cuh): C[32, N] = A[32,
// K] @ B as column passes of at most kWMax columns on the same ring, warp w
// owning rows 16 (w / 8) .. +16 and columns 32 (w % 8) .. +32 of a pass.
//
// gemm_rows_huge is the product of the SDF core's huge instances (64-point
// blocks, any width: sdf_fwd.cuh, sdf_bwd.cuh), whose activation rows lie in
// device memory: C[64, N] = A[64, K] @ B as gemm_rows64's column passes of
// at most kWMax columns, A's k-slabs streamed through a ring of their own
// beside the weight ring (kHugeARing), each A slab in the cp.async group of
// the weight slab of the same k, and C written to device memory.
#pragma once

#include <type_traits>

#include "sdf_mlp.cuh"

namespace nrh {

constexpr int kChainTP = 64;         // points per block of the 64-point kernels (A, D, E, H; F, G, I, J)
constexpr int kChainThreads = 512;   // threads per block of those kernels
constexpr int kSlab = 64;            // k-rows of a weight slab in the chain's ring
constexpr int kChainStages = 3;      // slabs in the ring
constexpr int kLdWs = kWMax + 8;     // bf16 row stride of a [kSlab][N] slab (row-major B)
constexpr int kLdWt = kSlab + 8;     // bf16 row stride of an [N][kSlab] slab (the transposed B)
constexpr int kRingStage = kSlab * kLdWs > kWMax * kLdWt ? kSlab * kLdWs : kWMax * kLdWt;
constexpr int kWidePts = 32;         // points per block of the SDF core's wide instances
constexpr int kAStage = kChainTP * kLdWt;  // bf16 of an A slab [64][kSlab] of the huge instances' row ring
constexpr int kHugeARing = kChainStages * kAStage;

// The SDF core's width classes (sdf_fwd.cuh, sdf_bwd.cuh): kPts points a
// block, kW the widest padded layer and feature head, kEnc the widest
// padded encoding, kLdC the f32 row stride of the carry tile.  The 64-point
// instances take the presets' widths; the wide ones twice them on 32-point
// blocks, each bf16 product in gemm_rows32's column passes (each f32 one on
// mma_rows.cuh's gemm_rows_f32<RowsWide>).  The huge ones (kHuge) take any
// width and encoding that are multiples of 16, bf16 only, on 64-point
// blocks: a block's activations, carry and encoding are rows of a
// device-memory scratch at the meta's widths (mma_rows.cuh::core_tiles), so
// kW, kEnc and kLdC are not theirs (0), and every product is
// gemm_rows_huge.
struct CoreNarrow {
  static constexpr int kPts = kChainTP, kW = kWMax, kEnc = kEncMax, kLdC = kLdZ;
  static constexpr bool kHuge = false;
};
struct CoreWide {
  static constexpr int kPts = kWidePts, kW = kWideWMax, kEnc = kWideEncMax, kLdC = kWideWMax + 4;
  static constexpr bool kHuge = false;
};
struct CoreHuge {
  static constexpr int kPts = kChainTP, kW = 0, kEnc = 0, kLdC = 0;
  static constexpr bool kHuge = true;
};

// 16 bytes global -> shared, zero-filled when !full (the source is then not
// read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive bf16 as floats, and four floats rounded to bf16, with one
// 8-byte access (p 8-byte aligned); four floats with one 16-byte access (p
// 16-byte aligned).
__device__ __forceinline__ void ld_bf4(const bf16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = bf(__ushort_as_bfloat16((unsigned short)(u.x & 0xffffu)));
  v[1] = bf(__ushort_as_bfloat16((unsigned short)(u.x >> 16)));
  v[2] = bf(__ushort_as_bfloat16((unsigned short)(u.y & 0xffffu)));
  v[3] = bf(__ushort_as_bfloat16((unsigned short)(u.y >> 16)));
}
__device__ __forceinline__ void st_bf4(bf16* p, const float* v) {
  uint2 u;
  u.x = (unsigned)__bfloat16_as_ushort(to_bf16(v[0])) | ((unsigned)__bfloat16_as_ushort(to_bf16(v[1])) << 16);
  u.y = (unsigned)__bfloat16_as_ushort(to_bf16(v[2])) | ((unsigned)__bfloat16_as_ushort(to_bf16(v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void ld_f4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void st_f4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The SDF core's operand type T (bf16; f32 at compute_dtype="float32") and
// stash type S by overload: four consecutive values as floats and from
// floats (ld4, st4: the helpers above), one value as a float (to_f) and
// from a float (from_f), and rnd<T>(x), the value x carries as a dot
// operand of type T (x rounded to bf16, or x itself).
__device__ __forceinline__ void ld4(const bf16* p, float* v) { ld_bf4(p, v); }
__device__ __forceinline__ void ld4(const float* p, float* v) { ld_f4(p, v); }
__device__ __forceinline__ void st4(bf16* p, const float* v) { st_bf4(p, v); }
__device__ __forceinline__ void st4(float* p, const float* v) { st_f4(p, v); }
__device__ __forceinline__ float to_f(bf16 x) { return bf(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return to_bf16(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// Issue (and commit, as one group) the copy of k-slab s of B into ring
// stage s % kChainStages; an empty group when s is past K.
template <bool TRANS_B>
__device__ __forceinline__ void stage_slab(const bf16* __restrict__ B, int ldb, int K, int N, bf16* ring, int s) {
  const int tid = threadIdx.x, k0 = s * kSlab;
  bf16* dst = ring + (s % kChainStages) * kRingStage;
  if (k0 < K) {
    if (TRANS_B) {
      for (int idx = tid; idx < N * (kSlab / 8); idx += kChainThreads) {
        const int n = idx / (kSlab / 8), c = (idx % (kSlab / 8)) * 8;
        if (k0 + c < K) cp_async16(dst + n * kLdWt + c, B + (size_t)n * ldb + k0 + c);
      }
    } else {
      const int cpr = N / 8;
      for (int idx = tid; idx < kSlab * cpr; idx += kChainThreads) {
        const int r = idx / cpr, c = (idx % cpr) * 8;
        if (k0 + r < K) cp_async16(dst + r * kLdWs + c, B + (size_t)(k0 + r) * ldb + c);
      }
    }
  }
  cp_async_commit();
}

// The first kChainStages - 1 slabs of a product; the ring must be free (the
// previous gemm_rows64 has returned on every thread).
template <bool TRANS_B>
__device__ __forceinline__ void stage_first_slabs(const bf16* __restrict__ B, int ldb, int K, int N, bf16* ring) {
#pragma unroll
  for (int s = 0; s < kChainStages - 1; ++s) stage_slab<TRANS_B>(B, ldb, K, N, ring, s);
}

// C[16 MT, N] = A[16 MT, K] @ B after stage_first_slabs with the same
// arguments, MT row tiles a warp (gemm_rows64: MT = 2).  K and N are
// multiples of 16.  N is at most kWMax: the warps' 8 column tiles of 32, and
// a ring stage holds a slab of at most kWMax columns (or, transposed, rows).
// K has no limit of its own: it is walked in kSlab-row slabs, the last one
// partial, and A's row stride lda must cover it (the trunk's first layer
// has K = 368).  B is the [K, N] row-major weight (TRANS_B = false) or the
// transpose of an [N, K] row-major weight with row stride ldb (TRANS_B =
// true; a slab is then N rows of kSlab columns, read as column-major
// fragments).  Every thread must call it.  It begins with a barrier (so A
// may be written just before) and returns with the ring free; C is
// complete after the caller's next __syncthreads().
template <int MT, bool TRANS_B>
__device__ void gemm_rows_mt(const bf16* A, int lda, const bf16* __restrict__ B, int ldb, int K, int N, float* C,
                             int ldc, bf16* ring) {
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / 8) * 16 * MT, c0 = (warp % 8) * 32;
  const int nslab = (K + kSlab - 1) / kSlab;
  using LayoutB = typename std::conditional<TRANS_B, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[i][f], 0.0f);
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<kChainStages - 2>();
    __syncthreads();
    stage_slab<TRANS_B>(B, ldb, K, N, ring, s + kChainStages - 1);
    const bf16* W = ring + (s % kChainStages) * kRingStage;
    for (int kk = 0; kk < kSlab && s * kSlab + kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) wmma::load_matrix_sync(a[i], A + (r0 + 16 * i) * lda + s * kSlab + kk, lda);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int col = c0 + 16 * f;
        if (col < N) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b;
          if (TRANS_B)
            wmma::load_matrix_sync(b, W + col * kLdWt + kk, kLdWt);
          else
            wmma::load_matrix_sync(b, W + kk * kLdWs + col, kLdWs);
#pragma unroll
          for (int i = 0; i < MT; ++i) wmma::mma_sync(acc[i][f], a[i], b, acc[i][f]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int col = c0 + 16 * f;
    if (col < N)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        wmma::store_matrix_sync(C + (r0 + 16 * i) * ldc + col, acc[i][f], ldc, wmma::mem_row_major);
  }
}

// C[64, N] = A[64, K] @ B: the 64-point kernels' product (above, MT = 2).
template <bool TRANS_B>
__device__ __forceinline__ void gemm_rows64(const bf16* A, int lda, const bf16* __restrict__ B, int ldb, int K, int N,
                                            float* C, int ldc, bf16* ring) {
  gemm_rows_mt<2, TRANS_B>(A, lda, B, ldb, K, N, C, ldc, ring);
}

// C[32, N] = A[32, K] @ B for N up to 2 kWMax, after stage_first_slabs of
// the first pass (B's first min(N, kWMax) columns or, transposed, rows):
// column passes of at most kWMax columns, each staging the next pass's
// first slabs once the ring is free.  C must not be A: every pass reads all
// of A.  The contract is gemm_rows64's otherwise.
template <bool TRANS_B>
__device__ void gemm_rows32(const bf16* A, int lda, const bf16* __restrict__ B, int ldb, int K, int N, float* C,
                            int ldc, bf16* ring) {
  for (int n0 = 0; n0 < N; n0 += kWMax) {
    const int nn = min(kWMax, N - n0);
    const bf16* Bn = TRANS_B ? B + (size_t)n0 * ldb : B + n0;
    if (n0 > 0) stage_first_slabs<TRANS_B>(Bn, ldb, K, nn, ring);
    gemm_rows_mt<1, TRANS_B>(A, lda, Bn, ldb, K, nn, C + n0, ldc, ring);
  }
}

// The copies of A's k-slab s ([64][kSlab], row stride lda, device memory)
// into stage s % kChainStages of the row ring, uncommitted; none past K.
__device__ __forceinline__ void stage_rows_slab(const bf16* A, int lda, int K, bf16* aring, int s) {
  const int k0 = s * kSlab;
  if (k0 >= K) return;
  bf16* dst = aring + (s % kChainStages) * kAStage;
  for (int idx = threadIdx.x; idx < kChainTP * (kSlab / 8); idx += kChainThreads) {
    const int r = idx / (kSlab / 8), c = (idx % (kSlab / 8)) * 8;
    if (k0 + c < K) cp_async16(dst + r * kLdWt + c, A + (size_t)r * lda + k0 + c);
  }
}

// One column pass of gemm_rows_huge: C[64, N] = A[64, K] @ B for N up to
// kWMax, after the pass's first kChainStages - 1 slabs of B and then of A
// were committed (in that order: at slab s the wait below leaves only the
// newest group in flight, never slab s's A or B).  The warps' tiles are
// gemm_rows64's; the A fragments come from the row ring.
template <bool TRANS_B>
__device__ void gemm_pass_huge(const bf16* A, int lda, const bf16* __restrict__ B, int ldb, int K, int N, float* C,
                               int ldc, bf16* ring, bf16* aring) {
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / 8) * 32, c0 = (warp % 8) * 32;
  const int nslab = (K + kSlab - 1) / kSlab;
  using LayoutB = typename std::conditional<TRANS_B, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[i][f], 0.0f);
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<kChainStages - 2>();
    __syncthreads();
    stage_rows_slab(A, lda, K, aring, s + kChainStages - 1);
    stage_slab<TRANS_B>(B, ldb, K, N, ring, s + kChainStages - 1);  // B's copies, and the group's commit
    const bf16* W = ring + (s % kChainStages) * kRingStage;
    const bf16* As = aring + (s % kChainStages) * kAStage;
    for (int kk = 0; kk < kSlab && s * kSlab + kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (r0 + 16 * i) * kLdWt + kk, kLdWt);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int col = c0 + 16 * f;
        if (col < N) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b;
          if (TRANS_B)
            wmma::load_matrix_sync(b, W + col * kLdWt + kk, kLdWt);
          else
            wmma::load_matrix_sync(b, W + kk * kLdWs + col, kLdWs);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][f], a[i], b, acc[i][f]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int col = c0 + 16 * f;
    if (col < N)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(C + (size_t)(r0 + 16 * i) * ldc + col, acc[i][f], ldc, wmma::mem_row_major);
  }
}

// C[64, N] = A[64, K] @ B for any N (a multiple of 16) with A and C rows of
// device memory (row strides lda, ldc: multiples of 8 and 4), after
// stage_first_slabs of the first pass's B (its first min(N, kWMax) columns
// or, transposed, rows); the row ring lies right after the weight ring.  It
// begins with a barrier (A may be written just before), stages each pass's
// first A slabs itself, and returns with both rings free; C is complete
// after the caller's next __syncthreads().  C must not be A.
template <bool TRANS_B>
__device__ void gemm_rows_huge(const bf16* A, int lda, const bf16* __restrict__ B, int ldb, int K, int N, float* C,
                               int ldc, bf16* ring) {
  bf16* aring = ring + kChainStages * kRingStage;
  for (int n0 = 0; n0 < N; n0 += kWMax) {
    const int nn = min(kWMax, N - n0);
    const bf16* Bn = TRANS_B ? B + (size_t)n0 * ldb : B + n0;
    if (n0 > 0)
      stage_first_slabs<TRANS_B>(Bn, ldb, K, nn, ring);
    else
      __syncthreads();
#pragma unroll
    for (int s = 0; s < kChainStages - 1; ++s) {
      stage_rows_slab(A, lda, K, aring, s);
      cp_async_commit();
    }
    gemm_pass_huge<TRANS_B>(A, lda, Bn, ldb, K, nn, C + n0, ldc, ring, aring);
  }
}

}  // namespace nrh
