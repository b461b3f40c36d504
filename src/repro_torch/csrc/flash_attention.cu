// Forward flash attention for Hopper (sm_90a), f32 on the SIMT cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_bhsd) together with its wrapper's
// transposes to (B*H, S, dh) and its padding of S to the block
// (ops.py::flash_attention).
//
// One block per (q-tile of 32 rows, head, batch row) runs the
// online-softmax tile of attention_tile.cuh, which memo_attention.cu's
// miss branch shares: scale dh^-1/2, masks kpos < S, causal
// kpos <= qpos, window kpos > qpos - window, f32 accumulators,
// NEG_INF = -1e30, fully masked rows zeroed. Q/K/V are read in the
// model's (B,S,H,dh) layout by their strides (the last dim contiguous),
// and the ragged last tile is masked in the kernel: no transpose, no
// padding copy. GQA reads K/V at kv head h / (H / Hkv).
//
// Bound on the H100: at gpt2_small's shape (B=8, S=1024, H=12, dh=64,
// causal) the visible (q, k) pairs need ~12.9 GFLOP of f32 work (QK^T
// and PV at 2*dh each, plus the softmax) against ~100 MB of Q/K/V/out,
// so in f32 on the SIMT cores (67 TFLOP/s) it is bound by operations
// (~0.19 ms) far more than by bytes (~0.03 ms at 3.35 TB/s). What the
// design does about it: key tiles that are wholly masked (after the
// causal diagonal, before the window) are skipped, which halves the
// work at S=1024 causal; score and probability tiles never leave
// shared memory. It computes with scalar FMAs out of shared memory for
// parity with the f32 reference; tensor cores (wgmma) and TMA are the
// next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::BQ;
using attn_tile::NT;
using attn_tile::TPR;

template <int DH>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S, int H,
    int Hkv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int causal, int has_window, int window, float scale) {
  __shared__ attn_tile::Smem<DH> sm;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int hk = h / (H / Hkv);
  float acc[DH / TPR];
#pragma unroll
  for (int c = 0; c < DH / TPR; ++c) acc[c] = 0.f;
  const float denom = attn_tile::online_softmax<DH>(
      sm, q + b * q_sb + h * q_sh, q_ss, k + b * k_sb + hk * k_sh, k_ss,
      v + b * v_sb + hk * v_sh, v_ss, S, S, q0, causal, has_window, window,
      scale, acc);
  const size_t o_row = (size_t)H * DH;
  attn_tile::store_rows<DH>(out + (size_t)b * S * o_row + (size_t)h * DH,
                            o_row, S, q0, denom, acc);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, int B, int S, int H, int Hkv,
                   const int64_t* st, int causal, int has_window, int window,
                   float scale, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<DH><<<grid, NT, 0, stream>>>(
      q, k, v, out, S, H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,S,H,dh), k/v (B,S,Hkv,dh) f32, each with a contiguous last dim and
// element strides (batch, seq, head) given in that order in strides[9]
// (q, then k, then v); out (B,S,H,dh) f32 contiguous. Returns
// cudaGetLastError().
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int Hkv, int dh,
                                   const int64_t* strides, int causal,
                                   int has_window, int window, float scale,
                                   void* stream) {
  auto* qf = static_cast<const float*>(q);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<16>(qf, kf, vf, o, B, S, H, Hkv, strides, causal,
                        has_window, window, scale, st);
    case 32:
      return launch<32>(qf, kf, vf, o, B, S, H, Hkv, strides, causal,
                        has_window, window, scale, st);
    case 64:
      return launch<64>(qf, kf, vf, o, B, S, H, Hkv, strides, causal,
                        has_window, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
