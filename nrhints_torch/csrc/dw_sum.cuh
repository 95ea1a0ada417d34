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
//                      64 x 64 output tile of one chunk with bf16 WMMA and f32
//                      accumulation, into part[chunk][...];
//   dw_reduce_kernel   dw[e] = sum over chunks of part[chunk][e], in order;
//   colsum_kernel      the per-block column sums that the point chain left
//                      (bias cotangents and other reductions), summed over
//                      the blocks in a fixed order.
// The products are bound by the scratch bytes they read: the operands of
// one row are read once per 64-column output tile.
#pragma once

#include "sdf_mlp.cuh"

namespace nrh {

constexpr int kMaxJobs = kMaxLayers + 1;
constexpr int kDwTile = 64;

struct DwJobs {
  int n;
  long long a_off[kMaxJobs], b_off[kMaxJobs], c_off[kMaxJobs];
  int rows[kMaxJobs], ka[kMaxJobs], nb[kMaxJobs], tiles_n[kMaxJobs];
  int tile_start[kMaxJobs + 1];
  long long n_dw;
};

// jobs = int64 [n_jobs][6] of (a_off, b_off, rows, ka, nb, c_off), as
// nrhints_torch/kernels/core_mlp.py::dw_jobs lays them out.
inline int parse_jobs(const long long* t, int n_jobs, DwJobs* j) {
  if (n_jobs < 1 || n_jobs > kMaxJobs) return (int)cudaErrorInvalidValue;
  j->n = n_jobs;
  j->tile_start[0] = 0;
  j->n_dw = 0;
  for (int i = 0; i < n_jobs; ++i) {
    const long long* r = t + 6 * i;
    j->a_off[i] = r[0];
    j->b_off[i] = r[1];
    j->rows[i] = (int)r[2];
    j->ka[i] = (int)r[3];
    j->nb[i] = (int)r[4];
    j->c_off[i] = r[5];
    if (r[0] % 16 || r[1] % 16 || r[2] % 16 || r[3] % 16 || r[4] % 16 || r[5] % 16)
      return (int)cudaErrorInvalidValue;
    j->tiles_n[i] = (j->nb[i] + kDwTile - 1) / kDwTile;
    j->tile_start[i + 1] = j->tile_start[i] + j->tiles_n[i] * ((j->ka[i] + kDwTile - 1) / kDwTile);
    if (r[5] + r[3] * r[4] > j->n_dw) j->n_dw = r[5] + r[3] * r[4];
  }
  return 0;
}

// 8 warps; the 64 x 64 tile is 4 x 4 WMMA tiles: warp w takes column tile
// w % 4 and row tiles w / 4 and w / 4 + 2, so it loads each B fragment once
// for two products.
__global__ void __launch_bounds__(256)
    dw_partial_kernel(const bf16* __restrict__ scratch, float* __restrict__ part, const DwJobs jobs, int split) {
  const int tile = blockIdx.x, s = blockIdx.y;
  int j = 0;
  while (j + 1 < jobs.n && tile >= jobs.tile_start[j + 1]) ++j;
  const int t = tile - jobs.tile_start[j];
  const int k0 = (t / jobs.tiles_n[j]) * kDwTile, n0 = (t % jobs.tiles_n[j]) * kDwTile;
  const int ka = jobs.ka[j], nb = jobs.nb[j], rows = jobs.rows[j];
  const int chunk = ((rows + split - 1) / split + 15) / 16 * 16;
  const int r0 = s * chunk, r1 = min(rows, r0 + chunk);
  const bf16* A = scratch + jobs.a_off[j];
  const bf16* B = scratch + jobs.b_off[j];
  float* C = part + (size_t)s * jobs.n_dw + jobs.c_off[j];

  const int warp = threadIdx.x >> 5;
  const int n_sub = n0 + (warp % 4) * 16;
  const int k_sub[2] = {k0 + (warp / 4) * 16, k0 + (warp / 4 + 2) * 16};
  const bool b_ok = n_sub < nb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  if (b_ok) {
    for (int r = r0; r < r1; r += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + (size_t)r * nb + n_sub, nb);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (k_sub[q] < ka) {
          // A^T's tile: element (k, r) of A^T is A[r][k], a column-major read.
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, A + (size_t)r * ka + k_sub[q], ka);
          wmma::mma_sync(acc[q], a, b, acc[q]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (b_ok && k_sub[q] < ka)
      wmma::store_matrix_sync(C + (size_t)k_sub[q] * nb + n_sub, acc[q], nb, wmma::mem_row_major);
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

// The three passes on `stream`; returns the first launch error.
inline int launch_dw_sums(const bf16* scratch, float* part_dw, float* dw, const DwJobs& jobs, int split,
                          const float* partial, int nblk, int pw, float* colsum, cudaStream_t stream) {
  if (split < 1) return (int)cudaErrorInvalidValue;
  dw_partial_kernel<<<dim3(jobs.tile_start[jobs.n], split), 256, 0, stream>>>(scratch, part_dw, jobs, split);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dw_reduce_kernel<<<(unsigned)((jobs.n_dw + 255) / 256), 256, 0, stream>>>(part_dw, split, jobs.n_dw, dw);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  colsum_kernel<<<(pw + 31) / 32, dim3(32, 8), 0, stream>>>(partial, nblk, pw, colsum);
  return (int)cudaGetLastError();
}

}  // namespace nrh
