// The weight-cotangent passes shared by kernels E and H (sdf_bwd.cuh) and G
// and J (mlp_stash.cu): the second half of each backward, after its
// per-point chain has written the product operands to a bf16 scratch.
//
// On the TPU the backward kernel carried every dW sum across its
// sequential grid.  Blocks on the card run in no order, so the sums are two
// passes, without atomics, so that the gradients repeat bit for bit:
//   dw_partial_kernel  C_j = A_j^T B_j for each product j (A_j [rows, ka],
//                      B_j [rows, nb], row-major bf16 in the scratch), split
//                      over `split` row chunks; each block computes one
//                      128 x 128 output tile of one chunk with bf16 WMMA and
//                      f32 accumulation, into part[chunk][...];
//   dw_reduce_kernel   dw[e] = sum over chunks of part[chunk][e], in order;
//   colsum_kernel      the per-block column sums that the point chain left
//                      (bias cotangents and other reductions), summed over
//                      the blocks in a fixed order.
// The products are bound by the scratch bytes they read.  A block streams
// its chunk's rows through a three-stage ring in shared memory, 64 rows of
// A's 128 columns and of B's 128 columns per slab, filled by cp.async
// (staged_mma.cuh); the fragments, A's column-major ones included, come
// from shared memory with padded strides.  An operand row is read once per
// 128-column output tile on the other side: twice for the 256-wide
// products of kernels E and H, four times for the 512-wide ones of their
// wide instances (any ka and nb that are multiples of 16 tile so; the
// column sums take any count of per-block rows, 2,048 of the wide
// instances' 32-point blocks at 65,536 points).
//
// The f32 instances of E and H (compute_dtype="float32") leave f32
// operands in an f32 scratch: dw_partial_f32_kernel computes the same
// tiles of the same row chunks with one fmaf a multiply-add, rows in order,
// 256 threads of 8 x 8 outputs each (rows 4 ty .. +3 and 64 + 4 ty .. +3 of
// the tile, columns 4 tx .. +3 and 64 + 4 tx .. +3, ty = t / 16, tx =
// t % 16), from a three-stage ring of 32-row f32 slabs (96 KB); each row of
// a slab gives a thread two float4 of A^T's column and two of B's for 64
// FMAs.  dw_reduce_kernel and colsum_kernel are shared, so the f32
// gradients too repeat bit for bit.
#pragma once

#include "staged_mma.cuh"

namespace nrh {

constexpr int kMaxJobs = kMaxLayers + 1;
constexpr int kDwTile = 128;   // output tile edge of dw_partial_kernel
constexpr int kDwSlab = 64;    // rows of a ring slab
constexpr int kDwStages = 3;
constexpr int kLdDw = kDwTile + 8;  // bf16 row stride of a slab
constexpr size_t kDwSmem = (size_t)kDwStages * 2 * kDwSlab * kLdDw * sizeof(bf16);

// One launch's jobs: at most kMaxJobs products, their tables kernel
// parameters.  A table of more jobs (a network deeper than kMaxLayers) is
// launched in groups of kMaxJobs (launch_dw_sums), each group's products
// over the same row chunks into the same partials, so every dW element sums
// in the same order whatever the grouping.  The backward chains read the
// scratch offsets of every job through a() and b(): the tables', or where
// the jobs outnumber kMaxJobs the whole table's copy on the card (dev),
// whose offsets are in units of the padded points (npad), so one copy
// serves every point count.
struct DwJobs {
  int n;
  long long a_off[kMaxJobs], b_off[kMaxJobs], c_off[kMaxJobs];
  int rows[kMaxJobs], ka[kMaxJobs], nb[kMaxJobs], tiles_n[kMaxJobs];
  int tile_start[kMaxJobs + 1];
  long long n_dw, npad;
  const long long* dev;   // the whole table on the card where it holds more than kMaxJobs jobs, else null
  const long long* host;  // the whole table in host memory (launch_dw_sums' groups), and its jobs
  int n_all;

  __device__ __forceinline__ long long a(int i) const { return dev ? dev[6 * i] * npad : a_off[i]; }
  __device__ __forceinline__ long long b(int i) const { return dev ? dev[6 * i + 1] * npad : b_off[i]; }
};

// Jobs first .. first + count - 1 (count <= kMaxJobs) of the host table t =
// int64 [n_jobs][6] of (a, b, m, ka, nb, c_off), as
// nrhints_torch/kernels/core_mlp.py::dw_jobs lays them out (product j's A
// operand is m npad rows of ka columns at scratch offset a npad, its B
// operand as many rows of nb columns at b npad, C_j at c_off of the dW
// vector), as one launch's tables at npad padded points; n_dw (the
// partials' row stride) covers the whole table.
inline int parse_job_group(const long long* t, int n_jobs, int first, int count, long long npad, DwJobs* j) {
  if (count < 1 || count > kMaxJobs || first + count > n_jobs || npad % 16) return (int)cudaErrorInvalidValue;
  j->n = count;
  j->tile_start[0] = 0;
  j->n_dw = 0;
  j->npad = npad;
  for (int i = 0; i < n_jobs; ++i) {
    const long long* r = t + 6 * i;
    if (r[3] % 16 || r[4] % 16 || r[5] % 16) return (int)cudaErrorInvalidValue;
    if (r[5] + r[3] * r[4] > j->n_dw) j->n_dw = r[5] + r[3] * r[4];
    if (i < first || i >= first + count) continue;
    const int k = i - first;
    j->a_off[k] = r[0] * npad;
    j->b_off[k] = r[1] * npad;
    j->rows[k] = (int)(r[2] * npad);
    j->ka[k] = (int)r[3];
    j->nb[k] = (int)r[4];
    j->c_off[k] = r[5];
    j->tiles_n[k] = (j->nb[k] + kDwTile - 1) / kDwTile;
    j->tile_start[k + 1] = j->tile_start[k] + j->tiles_n[k] * ((j->ka[k] + kDwTile - 1) / kDwTile);
  }
  j->dev = nullptr;
  j->host = t;
  j->n_all = n_jobs;
  return 0;
}

// The whole table at npad padded points: its first group's tables, and
// where it holds more than kMaxJobs jobs, jobs_dev, the same table on the
// card (null otherwise).
inline int parse_jobs(const long long* t, const long long* jobs_dev, int n_jobs, long long npad, DwJobs* j) {
  if (n_jobs < 1 || (n_jobs > kMaxJobs && !jobs_dev)) return (int)cudaErrorInvalidValue;
  const int rc = parse_job_group(t, n_jobs, 0, n_jobs < kMaxJobs ? n_jobs : kMaxJobs, npad, j);
  j->dev = n_jobs > kMaxJobs ? jobs_dev : nullptr;
  return rc;
}

// 8 warps; the 128 x 128 tile is 8 x 8 WMMA tiles: warp w takes rows
// 64 (w / 4) .. +64 (4 row tiles) and columns 32 (w % 4) .. +32 (2 column
// tiles), so each 16-row step loads 4 A and 2 B fragments for 8 products.
// Rows past the chunk, and columns past ka or nb, are never loaded: ka, nb
// and the chunk are multiples of 16, so a fragment is wholly inside or
// wholly outside, and the ones outside are skipped.
__global__ void __launch_bounds__(256)
    dw_partial_kernel(const bf16* __restrict__ scratch, float* __restrict__ part, const DwJobs jobs, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [stage][A slab, B slab][kDwSlab][kLdDw]
  const int tile = blockIdx.x, s = blockIdx.y;
  int j = 0;
  while (j + 1 < jobs.n && tile >= jobs.tile_start[j + 1]) ++j;
  const int t = tile - jobs.tile_start[j];
  const int k0 = (t / jobs.tiles_n[j]) * kDwTile, n0 = (t % jobs.tiles_n[j]) * kDwTile;
  const int ka = jobs.ka[j], nb = jobs.nb[j], rows = jobs.rows[j];
  const int chunk = ((rows + split - 1) / split + 15) / 16 * 16;
  const int r0 = s * chunk, r1 = min(rows, r0 + chunk);
  const int nsl = r1 > r0 ? (r1 - r0 + kDwSlab - 1) / kDwSlab : 0;
  const bf16* A = scratch + jobs.a_off[j];
  const bf16* B = scratch + jobs.b_off[j];
  float* C = part + (size_t)s * jobs.n_dw + jobs.c_off[j];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int kw = k0 + (warp / 4) * 64, nw = n0 + (warp % 4) * 32;

  // Slab q: rows r0 + 64 q .. of A's columns k0.. and B's columns n0..,
  // 16 copies of 16 bytes per row and operand.
  auto load = [&](int q) {
    bf16* As = ring + (q % kDwStages) * 2 * kDwSlab * kLdDw;
    bf16* Bs = As + kDwSlab * kLdDw;
    for (int idx = tid; idx < 2 * kDwSlab * (kDwTile / 8); idx += 256) {
      const int op = idx / (kDwSlab * (kDwTile / 8)), rem = idx % (kDwSlab * (kDwTile / 8));
      const int r = rem / (kDwTile / 8), c = (rem % (kDwTile / 8)) * 8, gr = r0 + q * kDwSlab + r;
      if (gr >= r1) continue;
      if (op == 0) {
        if (k0 + c < ka) cp_async16(As + r * kLdDw + c, A + (size_t)gr * ka + k0 + c);
      } else if (n0 + c < nb) {
        cp_async16(Bs + r * kLdDw + c, B + (size_t)gr * nb + n0 + c);
      }
    }
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[i][f], 0.0f);
#pragma unroll
  for (int q = 0; q < kDwStages - 1; ++q) {
    if (q < nsl) load(q);
    cp_async_commit();
  }
  for (int q = 0; q < nsl; ++q) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    if (q + kDwStages - 1 < nsl) load(q + kDwStages - 1);
    cp_async_commit();
    const bf16* As = ring + (q % kDwStages) * 2 * kDwSlab * kLdDw;
    const bf16* Bs = As + kDwSlab * kLdDw;
    for (int rr = 0; rr < kDwSlab && r0 + q * kDwSlab + rr < r1; rr += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int f = 0; f < 2; ++f)
        if (nw + 16 * f < nb) wmma::load_matrix_sync(b[f], Bs + rr * kLdDw + (nw - n0) + 16 * f, kLdDw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kw + 16 * i >= ka) continue;
        // A^T's tile: element (k, r) of A^T is A[r][k], a column-major read.
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, As + rr * kLdDw + (kw - k0) + 16 * i, kLdDw);
#pragma unroll
        for (int f = 0; f < 2; ++f)
          if (nw + 16 * f < nb) wmma::mma_sync(acc[i][f], a, b[f], acc[i][f]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int f = 0; f < 2; ++f)
      if (kw + 16 * i < ka && nw + 16 * f < nb)
        wmma::store_matrix_sync(C + (size_t)(kw + 16 * i) * nb + nw + 16 * f, acc[i][f], nb, wmma::mem_row_major);
}

constexpr int kDwSlabF32 = 32;  // rows of an f32 ring slab
constexpr size_t kDwSmemF32 = (size_t)kDwStages * 2 * kDwSlabF32 * kDwTile * sizeof(float);

__global__ void __launch_bounds__(256)
    dw_partial_f32_kernel(const float* __restrict__ scratch, float* __restrict__ part, const DwJobs jobs, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [stage][A slab, B slab][kDwSlabF32][kDwTile]
  const int tile = blockIdx.x, s = blockIdx.y;
  int j = 0;
  while (j + 1 < jobs.n && tile >= jobs.tile_start[j + 1]) ++j;
  const int t = tile - jobs.tile_start[j];
  const int k0 = (t / jobs.tiles_n[j]) * kDwTile, n0 = (t % jobs.tiles_n[j]) * kDwTile;
  const int ka = jobs.ka[j], nb = jobs.nb[j], rows = jobs.rows[j];
  const int chunk = ((rows + split - 1) / split + 15) / 16 * 16;
  const int r0 = s * chunk, r1 = min(rows, r0 + chunk);
  const int nsl = r1 > r0 ? (r1 - r0 + kDwSlabF32 - 1) / kDwSlabF32 : 0;
  const float* A = scratch + jobs.a_off[j];
  const float* B = scratch + jobs.b_off[j];
  float* C = part + (size_t)s * jobs.n_dw + jobs.c_off[j];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // Slab q: rows r0 + 32 q .. of A's columns k0.. and B's columns n0..,
  // 32 copies of 16 bytes per row and operand.
  auto load = [&](int q) {
    float* As = ring + (q % kDwStages) * 2 * kDwSlabF32 * kDwTile;
    float* Bs = As + kDwSlabF32 * kDwTile;
    for (int idx = tid; idx < 2 * kDwSlabF32 * (kDwTile / 4); idx += 256) {
      const int op = idx / (kDwSlabF32 * (kDwTile / 4)), rem = idx % (kDwSlabF32 * (kDwTile / 4));
      const int r = rem / (kDwTile / 4), c = (rem % (kDwTile / 4)) * 4, gr = r0 + q * kDwSlabF32 + r;
      if (gr >= r1) continue;
      if (op == 0) {
        if (k0 + c < ka) cp_async16(As + r * kDwTile + c, A + (size_t)gr * ka + k0 + c);
      } else if (n0 + c < nb) {
        cp_async16(Bs + r * kDwTile + c, B + (size_t)gr * nb + n0 + c);
      }
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[i][f] = 0.0f;
#pragma unroll
  for (int q = 0; q < kDwStages - 1; ++q) {
    if (q < nsl) load(q);
    cp_async_commit();
  }
  for (int q = 0; q < nsl; ++q) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    if (q + kDwStages - 1 < nsl) load(q + kDwStages - 1);
    cp_async_commit();
    const float* As = ring + (q % kDwStages) * 2 * kDwSlabF32 * kDwTile;
    const float* Bs = As + kDwSlabF32 * kDwTile;
    const int nr = min(kDwSlabF32, r1 - r0 - q * kDwSlabF32);
    for (int r = 0; r < nr; ++r) {
      float a[8], b[8];
      ld_f4(As + r * kDwTile + 4 * ty, a);
      ld_f4(As + r * kDwTile + 64 + 4 * ty, a + 4);
      ld_f4(Bs + r * kDwTile + 4 * tx, b);
      ld_f4(Bs + r * kDwTile + 64 + 4 * tx, b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int f = 0; f < 8; ++f) acc[i][f] = fmaf(a[i], b[f], acc[i][f]);
    }
  }
  cp_async_wait<0>();
  // Output rows and columns past ka or nb are not stored: ka and nb are
  // multiples of 16, so each group of 4 lies wholly inside or outside.
#pragma unroll
  for (int i = 0; i < 8; i += 4) {
    const int k = k0 + (i ? 64 : 0) + 4 * ty;
    if (k >= ka) continue;
#pragma unroll
    for (int f = 0; f < 8; f += 4) {
      const int col = n0 + (f ? 64 : 0) + 4 * tx;
      if (col >= nb) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v[4] = {acc[i + e][f], acc[i + e][f + 1], acc[i + e][f + 2], acc[i + e][f + 3]};
        st_f4(C + (size_t)(k + e) * nb + col, v);
      }
    }
  }
}

__global__ void dw_reduce_kernel(const float* __restrict__ part, int split, long long n_dw, float* __restrict__ dw) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_dw) return;
  float s = part[e];
  for (int c = 1; c < split; ++c) s += part[(size_t)c * n_dw + e];
  dw[e] = s;
}

// out[c] = sum over rows of part[row][c]: blockDim (32, 8); thread (x, y)
// sums rows y, y + 8, ... of column 32 blockIdx.x + x, then the 8 partial
// sums are added in order.
__global__ void colsum_kernel(const float* __restrict__ part, int nrows, int ncols, float* __restrict__ out) {
  __shared__ float acc[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (c < ncols)
    for (int r = threadIdx.y; r < nrows; r += 8) s += part[(size_t)r * ncols + c];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < ncols) {
    float t = acc[0][threadIdx.x];
    for (int y = 1; y < 8; ++y) t += acc[y][threadIdx.x];
    out[c] = t;
  }
}

// The three passes on `stream`; returns the first launch error.  split = 0
// launches none of them: no weight cotangent is wanted (registration's
// backward through the rays), and part_dw, dw and colsum may be null.  The
// scratch's type picks the partial products' kernel: bf16 WMMA, or f32.
// The partial products run one launch per group of kMaxJobs jobs (one
// launch up to kMaxLayers layers).
template <typename T>
inline int launch_dw_sums(const T* scratch, float* part_dw, float* dw, const DwJobs& jobs, int split,
                          const float* partial, int nblk, int pw, float* colsum, cudaStream_t stream) {
  if (split < 0) return (int)cudaErrorInvalidValue;
  if (split == 0) return 0;
  int rc;
  if constexpr (std::is_same<T, float>::value)
    rc = (int)cudaFuncSetAttribute(dw_partial_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kDwSmemF32);
  else
    rc = (int)cudaFuncSetAttribute(dw_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
  if (rc) return rc;
  for (int first = 0; first < jobs.n_all; first += kMaxJobs) {
    DwJobs group;
    const DwJobs* g = &jobs;
    if (jobs.n_all > kMaxJobs) {
      const int count = jobs.n_all - first < kMaxJobs ? jobs.n_all - first : kMaxJobs;
      rc = parse_job_group(jobs.host, jobs.n_all, first, count, jobs.npad, &group);
      if (rc) return rc;
      g = &group;
    }
    const dim3 grid(g->tile_start[g->n], split);
    if constexpr (std::is_same<T, float>::value)
      dw_partial_f32_kernel<<<grid, 256, kDwSmemF32, stream>>>(scratch, part_dw, *g, split);
    else
      dw_partial_kernel<<<grid, 256, kDwSmem, stream>>>(scratch, part_dw, *g, split);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  dw_reduce_kernel<<<(unsigned)((jobs.n_dw + 255) / 256), 256, 0, stream>>>(part_dw, split, jobs.n_dw, dw);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  colsum_kernel<<<(pw + 31) / 32, dim3(32, 8), 0, stream>>>(partial, nblk, pw, colsum);
  return (int)cudaGetLastError();
}

}  // namespace nrh
