// Probe of the cost of one k-slab in staged_mma.cuh::gemm_rows64, the
// product of every 64-point kernel (A, D, E, H, F, G, I, J).  Built and run
// by scripts/probe_slab_cost.py; not part of the package.
//
// Each block of kChainThreads threads runs `layers` products C[64, 256] =
// A[64, 256] @ W[256, 256] (four 64-row slabs each) with A and C in shared
// memory, as the kernels do, W cycling over four 256x256 bf16 weights that
// stay in L2.  MODE says what a product does:
//   0  gemm_rows64 itself, its first slabs staged just before it;
//   1  its loop with the weight copies left out (waits, barriers, fragment
//      loads and MMAs on whatever the ring holds);
//   2  its loop with the fragment loads and MMAs left out (copies, waits
//      and barriers);
//   3  its loop with neither (waits and barriers);
//   4  one __syncthreads() and nothing else;
//   5  mode 3's six __syncthreads() and nothing else;
//   6  mode 3's accumulator fill and store to shared memory, between two
//      __syncthreads();
//   7  mode 3 without the accumulators (commits, waits and barriers);
//   8  gemm_rows64's loop with the WMMA fragment loads and MMAs replaced by
//      ldmatrix from shared memory and mma.sync.m16n8k16: the same HMMA
//      instructions in the same k order, so the same products bit for bit;
//   9  gemm_rows64<true>, the transposed product of the backward chains
//      (C = A W^T, W [256][256] read as [N][K]);
//  10  mode 9 with ldmatrix and mma.sync, as mode 8.
// Block 0 also copies its last product C [64][256] after the per-block
// values, so that two modes' products can be compared.
#include "staged_mma.cuh"

using namespace nrh;

namespace {

constexpr size_t kProbeSmem = kChainTP * kLdA * sizeof(bf16) + kChainTP * kLdZ * sizeof(float) +
                              kChainStages * kRingStage * sizeof(bf16);

template <bool COPY>
__device__ __forceinline__ void probe_stage(const bf16* W, bf16* ring, int s) {
  if (COPY)
    stage_slab<false>(W, kWMax, kWMax, kWMax, ring, s);
  else
    cp_async_commit();
}

// gemm_rows64<false>'s loop at K = N = 256, with its copies (COPY), its
// fragment loads and MMAs (MMA) and its accumulators (ACC) each optional.
template <bool COPY, bool MMA, bool ACC = true>
__device__ void probe_gemm(const bf16* A, const bf16* W, float* C, bf16* ring) {
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / 8) * 32, c0 = (warp % 8) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  if (ACC)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[i][f], 0.0f);
  for (int s = 0; s < kChainStages - 1; ++s) probe_stage<COPY>(W, ring, s);
  for (int s = 0; s < kWMax / kSlab; ++s) {
    cp_async_wait<kChainStages - 2>();
    __syncthreads();
    probe_stage<COPY>(W, ring, s + kChainStages - 1);
    if (MMA) {
      const bf16* Ws = ring + (s % kChainStages) * kRingStage;
      for (int kk = 0; kk < kSlab; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], A + (r0 + 16 * i) * kLdA + s * kSlab + kk, kLdA);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Ws + kk * kLdWs + c0 + 16 * f, kLdWs);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][f], a[i], b, acc[i][f]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (ACC)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::store_matrix_sync(C + (r0 + 16 * i) * kLdZ + c0 + 16 * f, acc[i][f], kLdZ, wmma::mem_row_major);
}

// Mode 6: the accumulators' fill and store alone.
__device__ void probe_acc(float* C) {
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / 8) * 32, c0 = (warp % 8) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::store_matrix_sync(C + (r0 + 16 * i) * kLdZ + c0 + 16 * f, acc, kLdZ, wmma::mem_row_major);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// Modes 8 and 10: the product with ldmatrix and mma.sync.  Warp w owns the
// same 32 x 32 tile of C as in gemm_rows64: 2 row tiles (i) x 4 column
// tiles of 8 (f, h); each k-step of 16 takes one ldmatrix.x4 per row tile
// and one per 16 columns (.trans for the row-major [K][N] slab), and 8
// mma.sync.
template <bool TRANS_B>
__device__ void probe_gemm_ldsm(const bf16* A, const bf16* W, float* C, bf16* ring) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / 8) * 32, c0 = (warp % 8) * 32;
  float acc[2][2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][f][h][e] = 0.0f;
  stage_first_slabs<TRANS_B>(W, kWMax, kWMax, kWMax, ring);
  for (int s = 0; s < kWMax / kSlab; ++s) {
    cp_async_wait<kChainStages - 2>();
    __syncthreads();
    stage_slab<TRANS_B>(W, kWMax, kWMax, kWMax, ring, s + kChainStages - 1);
    const bf16* Ws = ring + (s % kChainStages) * kRingStage;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 16) {
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* pa = A + (r0 + 16 * i + (lane & 15)) * kLdA + s * kSlab + kk + (lane >> 4) * 8;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[i][0]), "=r"(a[i][1]), "=r"(a[i][2]), "=r"(a[i][3])
                     : "r"(smem_addr(pa)));
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        if (TRANS_B) {  // the slab is [N][kLdWt], k contiguous: B's .col layout as it lies
          const bf16* pb = Ws + (c0 + 16 * f + (lane & 7) + (lane >> 4) * 8) * kLdWt + kk + ((lane >> 3) & 1) * 8;
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(b[f][0]), "=r"(b[f][1]), "=r"(b[f][2]), "=r"(b[f][3])
                       : "r"(smem_addr(pb)));
        } else {
          const bf16* pb = Ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdWs + c0 + 16 * f + (lane >> 4) * 8;
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(b[f][0]), "=r"(b[f][1]), "=r"(b[f][2]), "=r"(b[f][3])
                       : "r"(smem_addr(pb)));
        }
      }
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float* c = acc[i][f][h];
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
                "{%8, %9}, {%0, %1, %2, %3};\n"
                : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]), "r"(b[f][2 * h]), "r"(b[f][2 * h + 1]));
          }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = C + (r0 + 16 * i + g) * kLdZ + c0 + 16 * f + 8 * h + 2 * t;
        row[0] = acc[i][f][h][0];
        row[1] = acc[i][f][h][1];
        row[8 * kLdZ] = acc[i][f][h][2];
        row[8 * kLdZ + 1] = acc[i][f][h][3];
      }
}

template <int MODE>
__global__ void __launch_bounds__(kChainThreads) probe_kernel(const bf16* __restrict__ w, int layers, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  float* Z = reinterpret_cast<float*>(act + kChainTP * kLdA);
  bf16* ring = reinterpret_cast<bf16*>(Z + kChainTP * kLdZ);
  for (int idx = threadIdx.x; idx < kChainTP * kLdA; idx += kChainThreads) act[idx] = to_bf16(0.01f * (idx % 7));
  for (int l = 0; l < layers; ++l) {
    const bf16* W = w + (size_t)(l % 4) * kWMax * kWMax;
    if (MODE == 0) {
      stage_first_slabs<false>(W, kWMax, kWMax, kWMax, ring);
      gemm_rows64<false>(act, kLdA, W, kWMax, kWMax, kWMax, Z, kLdZ, ring);
    } else if (MODE < 4) {
      probe_gemm<MODE == 2, MODE == 1>(act, W, Z, ring);
    } else if (MODE == 5) {
#pragma unroll
      for (int b = 0; b < 5; ++b) __syncthreads();
    } else if (MODE == 6) {
      probe_acc(Z);
    } else if (MODE == 7) {
      probe_gemm<false, false, false>(act, W, Z, ring);
    } else if (MODE == 8) {
      probe_gemm_ldsm<false>(act, W, Z, ring);
    } else if (MODE == 9) {
      stage_first_slabs<true>(W, kWMax, kWMax, kWMax, ring);
      gemm_rows64<true>(act, kLdA, W, kWMax, kWMax, kWMax, Z, kLdZ, ring);
    } else if (MODE == 10) {
      probe_gemm_ldsm<true>(act, W, Z, ring);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = Z[blockIdx.x % 64];
  if (blockIdx.x == 0)
    for (int idx = threadIdx.x; idx < kChainTP * kWMax; idx += kChainThreads)
      out[gridDim.x + idx] = Z[(idx / kWMax) * kLdZ + idx % kWMax];
}

template <int MODE>
int launch(const void* w, int layers, float* out, int blocks, void* stream) {
  int rc = (int)cudaFuncSetAttribute(probe_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kProbeSmem);
  if (rc) return rc;
  probe_kernel<MODE><<<blocks, kChainThreads, kProbeSmem, (cudaStream_t)stream>>>((const bf16*)w, layers, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_slab(int mode, const void* w, int layers, float* out, int blocks, void* stream) {
  switch (mode) {
    case 0: return launch<0>(w, layers, out, blocks, stream);
    case 1: return launch<1>(w, layers, out, blocks, stream);
    case 2: return launch<2>(w, layers, out, blocks, stream);
    case 3: return launch<3>(w, layers, out, blocks, stream);
    case 4: return launch<4>(w, layers, out, blocks, stream);
    case 5: return launch<5>(w, layers, out, blocks, stream);
    case 6: return launch<6>(w, layers, out, blocks, stream);
    case 7: return launch<7>(w, layers, out, blocks, stream);
    case 8: return launch<8>(w, layers, out, blocks, stream);
    case 9: return launch<9>(w, layers, out, blocks, stream);
    case 10: return launch<10>(w, layers, out, blocks, stream);
  }
  return (int)cudaErrorInvalidValue;
}
