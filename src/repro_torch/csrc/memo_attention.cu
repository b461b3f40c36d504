// Fused memoized attention for Hopper (sm_90a), f32 on the SIMT cores.
//
// Replaces the TPU kernel src/repro/kernels/memo_attention/kernel.py
// (_memo_kernel / memo_attention_bhsd) together with its wrapper's
// ragged-S padding and _fit_db (ops.py).
//
// One block per (q-tile of BQ rows, head, batch row). The block reads its
// own hit[b], hit_idx[b] and lengths[b]:
//   hit  — never loads Q or K. Streams the entry's APM tiles straight
//          from the device DB (int8 codes dequantized in registers
//          against the entry's per-row f16 scale, multiplied in f32 with
//          no f16 round, or f16 values), and accumulates APM·V. No
//          renormalisation: stored rows already sum to 1.
//   miss — never touches the DB. Online-softmax attention over K/V tiles
//          with scale dh^-1/2, the mask kpos < lengths[b], causal and
//          window, NEG_INF = -1e30, fully masked rows zeroed: the
//          online_softmax tile of attention_tile.cuh, which
//          flash_attention.cu shares.
// The DB is indexed with its own L stride and only [:S, :S] is read (zero
// past L), which replaces the reference's pad/slice copies; the ragged
// last q-tile and k-tile are masked here. GQA reads K/V at h / group.
//
// Bound on the H100: at the serving shapes (B=32, S=128, H=12, dh=64,
// about half the rows hitting) the work is ~1.2 GFLOP of f32 dot
// products against ~41 MB (Q/K/V/out in f32; an int8 APM entry is S*S*H
// bytes), so in f32 on the SIMT cores (67 TFLOP/s) it is bound by
// operations (~18 us) more than by bytes (~12 us at 3.35 TB/s). This
// first version computes in f32 on the SIMT cores for parity with the
// reference; tensor cores (wgmma) and TMA come later. What the design
// does about the bound: a hit block does only the APM·V half of the
// work and reads V plus the compressed APM, a miss block reads Q/K/V
// and nothing of the DB, and fully masked key tiles (past lengths[b],
// after the causal diagonal, before the window) are neither loaded nor
// computed.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::BK;
using attn_tile::BQ;
using attn_tile::NT;
using attn_tile::TPR;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) { return (float)x; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}

template <int DH, typename DB_T, bool QUANT>
__global__ void __launch_bounds__(NT) memo_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const DB_T* __restrict__ db,
    const __half* __restrict__ scales, const int* __restrict__ hit_idx,
    const int* __restrict__ hit, const int* __restrict__ lengths,
    float* __restrict__ out, int S, int H, int Hkv, int L, int N,
    int causal, int has_window, int window, float scale) {
  __shared__ attn_tile::Smem<DH> sm;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR, t = tid % TPR;
  const int hk = h / (H / Hkv);
  const size_t q_row = (size_t)H * DH, kv_row = (size_t)Hkv * DH;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)hk * DH;

  float acc[DH / TPR];
#pragma unroll
  for (int c = 0; c < DH / TPR; ++c) acc[c] = 0.f;
  float denom = 1.f;

  if (hit[b] == 1) {
    int e = hit_idx[b];
    e = e < 0 ? 0 : (e >= N ? N - 1 : e);
    const size_t plane = ((size_t)e * H + h) * (size_t)L;
    const int kend = S < L ? S : L;
    for (int k0 = 0; k0 < kend; k0 += BK) {
      __syncthreads();
      attn_tile::load_v_tile<DH>(sm, vb, kv_row, k0, S);
      for (int i = tid; i < BQ * BK; i += NT) {
        const int rr = i / BK, j = i % BK;
        const int qs = q0 + rr, ks = k0 + j;
        float a = 0.f;
        if (qs < kend && ks < kend) {
          a = to_f32<DB_T>(db[(plane + qs) * L + ks]);
          if (QUANT) a *= __half2float(scales[plane + qs]);
        }
        sm.P[rr][j] = a;
      }
      __syncthreads();
      attn_tile::accumulate_pv<DH>(sm, r, t, acc);
    }
  } else {
    denom = attn_tile::online_softmax<DH>(
        sm, q + (size_t)b * S * q_row + (size_t)h * DH, q_row,
        k + (size_t)b * S * kv_row + (size_t)hk * DH, kv_row, vb, kv_row, S,
        lengths[b], q0, causal, has_window, window, scale, acc);
  }
  attn_tile::store_rows<DH>(out + (size_t)b * S * q_row + (size_t)h * DH,
                            q_row, S, q0, denom, acc);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const void* db, const __half* scales, const int* hit_idx,
                   const int* hit, const int* lengths, float* out, int B,
                   int S, int H, int Hkv, int L, int N, int db_kind,
                   int causal, int has_window, int window, float scale,
                   cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  if (db_kind == 1) {
    memo_attention_kernel<DH, int8_t, true><<<grid, NT, 0, stream>>>(
        q, k, v, static_cast<const int8_t*>(db), scales, hit_idx, hit,
        lengths, out, S, H, Hkv, L, N, causal, has_window, window, scale);
  } else {
    memo_attention_kernel<DH, __half, false><<<grid, NT, 0, stream>>>(
        q, k, v, static_cast<const __half*>(db), scales, hit_idx, hit,
        lengths, out, S, H, Hkv, L, N, causal, has_window, window, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q (B,S,H,dh), k/v (B,S,Hkv,dh) f32 contiguous; db (N,H,L,L) int8
// (db_kind 1, with scales (N,H,L) f16) or f16 (db_kind 0); hit_idx, hit,
// lengths (B,) int32; out (B,S,H,dh) f32. Returns cudaGetLastError().
extern "C" int memo_attention_f32(
    const void* q, const void* k, const void* v, const void* db,
    const void* scales, const void* hit_idx, const void* hit,
    const void* lengths, void* out, int B, int S, int H, int Hkv, int dh,
    int L, int N, int db_kind, int causal, int has_window, int window,
    float scale, void* stream) {
  auto* qf = static_cast<const float*>(q);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* sc = static_cast<const __half*>(scales);
  auto* hi = static_cast<const int*>(hit_idx);
  auto* hm = static_cast<const int*>(hit);
  auto* ln = static_cast<const int*>(lengths);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<16>(qf, kf, vf, db, sc, hi, hm, ln, o, B, S, H, Hkv, L,
                        N, db_kind, causal, has_window, window, scale, st);
    case 32:
      return launch<32>(qf, kf, vf, db, sc, hi, hm, ln, o, B, S, H, Hkv, L,
                        N, db_kind, causal, has_window, window, scale, st);
    case 64:
      return launch<64>(qf, kf, vf, db, sc, hi, hm, ln, o, B, S, H, Hkv, L,
                        N, db_kind, causal, has_window, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
