// Online-softmax attention over one tile of query rows, shared by
// memo_attention.cu (its miss branch) and flash_attention.cu.
//
// A block of NT threads owns BQ query rows of one (batch row, head);
// TPR threads share a row, each holding DH / TPR output columns in
// registers. Key/value tiles of BK rows stream through shared memory.
// Scores are scaled by dh^-1/2 and masked by kpos < len, causal
// kpos <= qpos and window kpos > qpos - window with NEG_INF = -1e30;
// a fully masked row keeps m = NEG_INF, its probabilities are zeroed and
// its output is 0. Key tiles that are wholly masked (at or past len,
// after the causal diagonal, before the window) are neither loaded nor
// computed: exact, since such a tile changes neither the running max
// nor the sum. Q/K/V rows are read at their own sequence strides, so a
// caller's (B,S,H,dh) layout needs no transpose, and the ragged last
// tile is masked here, so it needs no padding either.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace attn_tile {

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 32;          // keys per tile
constexpr int TPR = 4;          // threads per query row
constexpr int NT = BQ * TPR;    // threads per block
constexpr float NEG_INF = -1e30f;

template <int DH>
struct Smem {
  float Q[BQ][DH + 1];
  float K[BK][DH + 1];
  float V[BK][DH];
  float P[BQ][BK + 1];
};

// V[j] = v row k0 + j (rows vs apart), zero past S
template <int DH>
__device__ __forceinline__ void load_v_tile(Smem<DH>& sm, const float* vb,
                                            size_t vs, int k0, int S) {
  for (int i = threadIdx.x; i < BK * DH; i += NT) {
    const int j = i / DH, d = i % DH, s = k0 + j;
    sm.V[j][d] = s < S ? vb[(size_t)s * vs + d] : 0.f;
  }
}

// acc += P[r, :] @ V[:, columns t, t + TPR, ...]
template <int DH>
__device__ __forceinline__ void accumulate_pv(const Smem<DH>& sm, int r,
                                              int t,
                                              float (&acc)[DH / TPR]) {
#pragma unroll 4
  for (int j = 0; j < BK; ++j) {
    const float p = sm.P[r][j];
#pragma unroll
    for (int c = 0; c < DH / TPR; ++c) acc[c] += p * sm.V[j][t + TPR * c];
  }
}

// Rows [q0, q0 + BQ) of q (rows qs apart) attend over keys [0, len) of
// k/v (rows ks / vs apart). acc must start at 0; it ends holding this
// thread's columns of the unnormalised output. Returns the row's softmax
// denominator, clamped at 1e-30 so a fully masked row divides to 0.
template <int DH>
__device__ __forceinline__ float online_softmax(
    Smem<DH>& sm, const float* qb, size_t qs, const float* kb, size_t ks,
    const float* vb, size_t vs, int S, int len, int q0, int causal,
    int has_window, int window, float scale, float (&acc)[DH / TPR]) {
  constexpr int KPT = BK / TPR;   // scores per thread per key tile
  const int tid = threadIdx.x;
  const int r = tid / TPR, t = tid % TPR;
  const int qpos = q0 + r;
  for (int i = tid; i < BQ * DH; i += NT) {
    const int rr = i / DH, d = i % DH, s = q0 + rr;
    sm.Q[rr][d] = s < S ? qb[(size_t)s * qs + d] : 0.f;
  }
  len = len < S ? len : S;
  int kend = len;
  if (causal && q0 + BQ < kend) kend = q0 + BQ;
  int kstart = 0;
  if (has_window) {
    const int lo = q0 - window + 1;   // first key any row may see
    if (lo > 0) kstart = (lo / BK) * BK;
  }
  float m_run = NEG_INF, l_run = 0.f;
  for (int k0 = kstart; k0 < kend; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * DH; i += NT) {
      const int j = i / DH, d = i % DH, s = k0 + j;
      sm.K[j][d] = s < S ? kb[(size_t)s * ks + d] : 0.f;
    }
    load_v_tile<DH>(sm, vb, vs, k0, S);
    __syncthreads();
    float sc[KPT];
    float tmax = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = t + TPR * jj, kpos = k0 + j;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) dot += sm.Q[r][d] * sm.K[j][d];
      dot *= scale;
      bool ok = kpos < len;
      if (causal) ok = ok && kpos <= qpos;
      if (has_window) ok = ok && kpos > qpos - window;
      sc[jj] = ok ? dot : NEG_INF;
      tmax = fmaxf(tmax, sc[jj]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = sc[jj] <= NEG_INF * 0.5f ? 0.f : expf(sc[jj] - m_new);
      sm.P[r][t + TPR * jj] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < DH / TPR; ++c) acc[c] *= alpha;
    __syncwarp();
    accumulate_pv<DH>(sm, r, t, acc);
  }
  return fmaxf(l_run, 1e-30f);
}

// out row qpos (rows os apart) = acc / denom, for qpos < S
template <int DH>
__device__ __forceinline__ void store_rows(float* ob, size_t os, int S,
                                           int q0, float denom,
                                           const float (&acc)[DH / TPR]) {
  const int r = threadIdx.x / TPR, t = threadIdx.x % TPR;
  if (q0 + r >= S) return;
  float* row = ob + (size_t)(q0 + r) * os;
#pragma unroll
  for (int c = 0; c < DH / TPR; ++c) row[t + TPR * c] = acc[c] / denom;
}

}  // namespace attn_tile
