// Forward flash attention for Hopper (sm_90a) on the tensor cores, in
// split TF32 (3xTF32) with f32 accumulators and f32 softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_bhsd) together with its wrapper's
// transposes to (B*H, S, dh) and its padding of S to the block
// (ops.py::flash_attention).
//
// One block of 128 threads per (q-tile of 64 rows, head, batch row) runs
// the online-softmax tile of attention_tile.cuh, which memo_attention.cu's
// miss branch shares: scale dh^-1/2, masks kpos < S, causal
// kpos <= qpos, window kpos > qpos - window, NEG_INF = -1e30, fully
// masked rows zeroed. Q/K/V are read in the model's (B,S,H,dh) layout by
// their strides (the last dim contiguous; base and strides 16-byte
// aligned, which the wrapper ensures, as cp.async needs), and the ragged
// last tile is masked in the kernel: no transpose, no padding copy. GQA
// reads K/V at kv head h / (H / Hkv).
//
// Bound on the H100: at gpt2_small's shape (B=8, S=1024, H=12, dh=64,
// causal) the 50.4 M visible (q, k) pairs need 4*dh flops each, 12.9
// GFLOP, which at 3xTF32's 494.7 / 3 TFLOP/s take 0.078 ms: set by
// operations, not by the 100.7 MB of Q/K/V/out (0.030 ms at 3.35 TB/s).
// At qwen2_1_5b's serving shape (B=32, S=128, H=12, Hkv=2, dh=128,
// causal) the 58.7 MB of Q/K/V/out (0.0175 ms) outweigh the 1.62 GFLOP of
// products (0.0098 ms): set by bytes; at qwen3_8b's (B=2, S=1024, H=32,
// Hkv=8) the 17.2 GFLOP of products take 0.104 ms: set by operations.
// What the design does about it: QK^T and P·V run on the tensor cores
// (mma.sync m16n8k8 tf32, three products per f32 product), K/V tiles of
// 64 keys stream by cp.async through a two-stage ring in dynamic shared
// memory (69,632 bytes at dh = 64; at dh = 128 the ring's 135,168 plus
// the Q fragments' 65,536, attention_tile.cuh) while the previous tile
// computes, key
// tiles after the causal diagonal or before the window are skipped, and
// the q-tiles with the most key tiles launch first (the block index runs
// from the last q-tile down), so the long causal tiles do not finish last.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::BQ;
using attn_tile::NT;

template <int DH>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S, int H,
    int Hkv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int causal, int has_window, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Lay = attn_tile::Layout<DH>;
  constexpr int DV = Lay::DV, NCOL = Lay::NCOL;
  // block i: (column block, head, batch row) fastest, q-tiles from the
  // last one down
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_hb = gridDim.x / n_qt;
  const int hbc = blockIdx.x % n_hb;
  const int q0 = (n_qt - 1 - blockIdx.x / n_hb) * BQ;
  const int cb = hbc % NCOL, hb = hbc / NCOL;
  const int h = hb % H, b = hb / H;
  const int hk = h / (H / Hkv);
  float o[DV / 8][4] = {};
  float l[2];
  attn_tile::online_softmax<DH, 0>(
      smem, q + b * q_sb + h * q_sh, q_ss, k + b * k_sb + hk * k_sh, k_ss,
      v + b * v_sb + hk * v_sh + cb * DV, v_ss, S, S, q0, causal,
      has_window, window, scale, o, l);
  const size_t o_row = (size_t)H * DH;
  attn_tile::store_rows<DV>(
      out + (size_t)b * S * o_row + (size_t)h * DH + cb * DV, o_row, S, q0,
      o, l);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, int B, int S, int H, int Hkv,
                   const int64_t* st, int causal, int has_window, int window,
                   float scale, cudaStream_t stream) {
  constexpr int smem = attn_tile::Layout<DH>::SMEM;
  static unsigned smem_set = 0;
  const cudaError_t e =
      attn_tile::allow_smem(flash_attention_kernel<DH>, smem, smem_set);
  if (e != cudaSuccess) return e;
  const int blocks =
      (S + BQ - 1) / BQ * attn_tile::Layout<DH>::NCOL * H * B;
  flash_attention_kernel<DH><<<blocks, NT, smem, stream>>>(
      q, k, v, out, S, H, Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,S,H,dh), k/v (B,S,Hkv,dh) f32, each with a contiguous last dim,
// a 16-byte-aligned base and element strides (batch, seq, head), each a
// multiple of 4, given in that order in strides[9] (q, then k, then v);
// out (B,S,H,dh) f32 contiguous. Returns cudaGetLastError().
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
    case 112:
      return launch<112>(qf, kf, vf, o, B, S, H, Hkv, strides, causal,
                         has_window, window, scale, st);
    case 128:
      return launch<128>(qf, kf, vf, o, B, S, H, Hkv, strides, causal,
                         has_window, window, scale, st);
    case 256:
      return launch<256>(qf, kf, vf, o, B, S, H, Hkv, strides, causal,
                         has_window, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
