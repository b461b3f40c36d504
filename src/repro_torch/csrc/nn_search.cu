// Top-1 L2 search over the device embedding table, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/nn_search/kernel.py
// (_nn_kernel / nn_search_kernel). Per query: min over rows of
// (|q|^2 - 2 q.d) + |d|^2 — the reference's form, not (q-d)^2 — with |d|^2
// from the cached norms when given; ties go to the lowest row index.
//
// The TPU kernel walks N sequentially in one grid axis. Serving batches
// are small (B = 32) and N is in the thousands, so one block per query
// tile would leave the card idle. Here N is split across blocks: stage 1
// gives each (row split, query tile) block a partial (d2, idx); stage 2
// reduces the partials of each query. Both reductions are lexicographic
// on (d2, idx), so the tie rule survives the split.
//
// Bound on the H100: the table (N x dim f32, TOMBSTONE slack rows
// included, since the device index passes its whole preallocated table)
// is read once, a few MB at serving sizes, and the work is 2*B*N*dim
// FLOP, so it is memory-bound at about a microsecond; at that size a
// launch costs more than the bound. What the design does about it: the
// split gives every SM a share of the rows, the query tile sits in
// shared memory, and each table row is read from device memory once.

#include <cuda_runtime.h>

namespace {

constexpr int NQ = 32;              // queries per block
constexpr int TN = 32;              // table rows per shared tile
constexpr int NT = 256;             // threads per block
constexpr int LPQ = NT / NQ;        // lanes per query (8)
constexpr int MAXD = 128;           // largest embedding width
constexpr float BIG = 1e30f;

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(NT) nn_partial_kernel(
    const float* __restrict__ q, const float* __restrict__ db,
    const float* __restrict__ norms, int B, int N, int dim,
    int rows_per_split, float* __restrict__ part_d,
    int* __restrict__ part_i) {
  __shared__ float sQ[NQ][MAXD + 1];
  __shared__ float sD[TN][MAXD + 1];
  __shared__ float sQn[NQ];
  __shared__ float sDn[TN];
  const int split = blockIdx.x;
  const int qb0 = blockIdx.y * NQ;
  const int tid = threadIdx.x;
  const int qi = tid / LPQ, lj = tid % LPQ;

  for (int i = tid; i < NQ * dim; i += NT) {
    const int r = i / dim, d = i % dim;
    sQ[r][d] = qb0 + r < B ? q[(size_t)(qb0 + r) * dim + d] : 0.f;
  }
  __syncthreads();
  if (tid < NQ) {
    float s = 0.f;
    for (int d = 0; d < dim; ++d) s += sQ[tid][d] * sQ[tid][d];
    sQn[tid] = s;
  }

  float best = BIG;
  int bidx = 0;
  const int n0 = split * rows_per_split;
  const int n1 = min(N, n0 + rows_per_split);
  for (int t0 = n0; t0 < n1; t0 += TN) {
    __syncthreads();
    for (int i = tid; i < TN * dim; i += NT) {
      const int j = i / dim, d = i % dim, row = t0 + j;
      sD[j][d] = row < n1 ? db[(size_t)row * dim + d] : 0.f;
    }
    if (norms != nullptr && tid < TN)
      sDn[tid] = t0 + tid < n1 ? norms[t0 + tid] : 0.f;
    __syncthreads();
    if (norms == nullptr && tid < TN) {
      float s = 0.f;
      for (int d = 0; d < dim; ++d) s += sD[tid][d] * sD[tid][d];
      sDn[tid] = s;
    }
    __syncthreads();
    for (int j = lj; j < TN; j += LPQ) {
      const int row = t0 + j;
      if (row >= n1) break;
      float dot = 0.f;
      for (int d = 0; d < dim; ++d) dot += sQ[qi][d] * sD[j][d];
      const float d2 = (sQn[qi] - 2.f * dot) + sDn[j];
      if (better(d2, row, best, bidx)) {
        best = d2;
        bidx = row;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < LPQ; off <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (better(od, oi, best, bidx)) {
      best = od;
      bidx = oi;
    }
  }
  if (lj == 0 && qb0 + qi < B) {
    part_d[(size_t)split * B + qb0 + qi] = best;
    part_i[(size_t)split * B + qb0 + qi] = bidx;
  }
}

// one warp per query over the splits' partials
__global__ void nn_reduce_kernel(const float* __restrict__ part_d,
                                 const int* __restrict__ part_i, int B,
                                 int n_split, float* __restrict__ out_d,
                                 int* __restrict__ out_i) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B) return;
  float best = BIG;
  int bidx = 0;
  for (int s = lane; s < n_split; s += 32) {
    const float d = part_d[(size_t)s * B + warp];
    const int i = part_i[(size_t)s * B + warp];
    if (better(d, i, best, bidx)) {
      best = d;
      bidx = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (better(od, oi, best, bidx)) {
      best = od;
      bidx = oi;
    }
  }
  if (lane == 0) {
    out_d[warp] = best;
    out_i[warp] = bidx;
  }
}

}  // namespace

// q (B,dim) f32, db (N,dim) f32, norms (N,) f32 or null; scratch
// part_d/part_i (n_split, B); out_d (B,) f32, out_i (B,) int32.
// Returns cudaGetLastError().
extern "C" int nn_search_f32(const void* q, const void* db, const void* norms,
                             void* part_d, void* part_i, void* out_d,
                             void* out_i, int B, int N, int dim,
                             int rows_per_split, int n_split, void* stream) {
  if (dim > MAXD) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  dim3 grid1(n_split, (B + NQ - 1) / NQ);
  nn_partial_kernel<<<grid1, NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(db),
      static_cast<const float*>(norms), B, N, dim, rows_per_split,
      static_cast<float*>(part_d), static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = 8;
  nn_reduce_kernel<<<(B + warps_per_block - 1) / warps_per_block,
                     32 * warps_per_block, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i), B,
      n_split, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
