// Fused memoized attention for Hopper (sm_90a) on the tensor cores, in
// split TF32 (3xTF32) with f32 accumulators and f32 softmax.
//
// Replaces the TPU kernel src/repro/kernels/memo_attention/kernel.py
// (_memo_kernel / memo_attention_bhsd) together with its wrapper's
// ragged-S padding and _fit_db (ops.py).
//
// One block of 128 threads per (q-tile of 64 rows, head, batch row). The
// block reads its own hit[b], hit_idx[b] (clamped to [0, N)) and
// lengths[b]:
//   hit  — never loads Q or K. Streams the entry's APM rows straight from
//          the device DB, 16 bytes per thread by cp.async, and V beside
//          them; dequantizes each int8 code against its row's f16 scale
//          in f32 with no f16 round (or widens f16 values) into the A
//          operand and accumulates APM·V on the tensor cores. No
//          renormalisation: stored rows already sum to 1.
//   miss — never touches the DB. Online-softmax attention over K/V tiles
//          with scale dh^-1/2, the mask kpos < lengths[b], causal and
//          window, NEG_INF = -1e30, fully masked rows zeroed: the
//          online_softmax tile of attention_tile.cuh, which
//          flash_attention.cu shares.
// The DB is indexed with its own L stride and only [:S, :S] is read (zero
// past L), which replaces the reference's pad/slice copies; the ragged
// last q-tile and k-tile are masked here. Where a DB row is not 16-byte
// aligned (L * element size not a multiple of 16) the APM tile is read
// element by element instead. GQA reads K/V at h / group.
//
// Bound on the H100: at bert_base's serving shape (B=32, S=128, H=12,
// dh=64) all-miss attention moves 50.3 MB of Q/K/V/out (0.015 ms at 3.35
// TB/s) against 1.61 GFLOP of products (0.0098 ms at 3xTF32's 494.7 / 3
// TFLOP/s): set by bytes; half the rows hitting, 40.9 MB, 0.0122 ms. At
// qwen2_1_5b's (B=32, S=128, H=12, Hkv=2, dh=128) all-miss is 58.7 MB,
// 0.0175 ms, also set by bytes.
// What the design does about it: products run on the tensor cores at
// f32-level accuracy (three TF32 products each), a hit block reads V
// plus the compressed APM and no Q/K, a miss block reads Q/K/V and
// nothing of the DB, tiles stream through a two-stage cp.async ring in
// dynamic shared memory (69,632 bytes at dh = 64, 200,704 with the Q
// fragments at dh = 128; the APM tile takes the
// K tile's place), and fully masked key tiles (past lengths[b], after the
// causal diagonal, before the window) are neither loaded nor computed.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using attn_tile::BQ;
using attn_tile::NT;

// APM tile of rows [q0, q0 + BQ) and keys [k0, k0 + KT) of one DB plane
// (rows L elements apart, row r at db + (plane + r) * L) into an A region
// of APM_LD-byte rows, raw codes; zero at or past kend in either index.
template <typename RAW_T, int APM_LD, int KT>
__device__ __forceinline__ void load_apm(unsigned char* A, const RAW_T* db,
                                         size_t plane, int L, int q0, int k0,
                                         int kend, int vec) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(RAW_T);   // elements per 16 bytes
    constexpr int CPR = KT / EPC;
#pragma unroll
    for (int it = 0; it < BQ * CPR / NT; ++it) {
      const int i = threadIdx.x + it * NT, j = i / CPR, c = i % CPR;
      const int r = q0 + j, ks = k0 + c * EPC;
      int n = kend - ks;
      n = r < kend ? (n < 0 ? 0 : (n > EPC ? EPC : n)) : 0;
      attn_tile::cp_async16(A + j * APM_LD + c * 16,
                            n > 0 ? db + (plane + r) * L + ks : db,
                            n * (int)sizeof(RAW_T));
    }
  } else {
    for (int i = threadIdx.x; i < BQ * KT; i += NT) {
      const int j = i / KT, c = i % KT, r = q0 + j, ks = k0 + c;
      reinterpret_cast<RAW_T*>(A + j * APM_LD)[c] =
          r < kend && ks < kend ? db[(plane + r) * L + ks] : RAW_T(0);
    }
  }
}

// codes (row, key 2t) and (row, key 2t + 1) at p, dequantized in f32
__device__ __forceinline__ float2 dequant2(const unsigned char* p, float s,
                                          int8_t) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x * s, (float)c.y * s);
}
__device__ __forceinline__ float2 dequant2(const unsigned char* p, float,
                                          uint16_t) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// o += APM[rows q0.., keys 0..kend) · V over the DB plane: the hit branch
// (V's DV columns from vb on: the block's column block)
template <int DH, typename RAW_T, bool QUANT>
__device__ __forceinline__ void apm_pv(
    unsigned char* smem, const RAW_T* db, const __half* scales, size_t plane,
    int L, int kend, int vec, const float* vb, size_t vs, int S, int q0,
    float (&o)[attn_tile::out_cols(DH) / 8][4]) {
  using Lay = attn_tile::Layout<DH, sizeof(RAW_T)>;
  constexpr int DV = Lay::DV, LDV = Lay::LDV, KT = Lay::KT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = warp * 16 + g;            // local row of a0
  float s[2] = {1.f, 1.f};
  if (QUANT) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + rl + 8 * i;
      s[i] = r < kend ? __half2float(scales[plane + r]) : 0.f;
    }
  }
  if (kend > 0) {
    load_apm<RAW_T, Lay::APM_LD, KT>(Lay::a(smem, 0), db, plane, L, q0, 0,
                                     kend, vec);
    attn_tile::load_rows_async<DV, LDV, KT>(Lay::v(smem, 0), vb, vs, 0, S);
    attn_tile::cp_commit();
  }
  int st = 0;
  for (int k0 = 0; k0 < kend; k0 += KT, st ^= 1) {
    if (k0 + KT < kend) {
      load_apm<RAW_T, Lay::APM_LD, KT>(Lay::a(smem, st ^ 1), db, plane, L,
                                       q0, k0 + KT, kend, vec);
      attn_tile::load_rows_async<DV, LDV, KT>(Lay::v(smem, st ^ 1), vb, vs,
                                              k0 + KT, S);
      attn_tile::cp_commit();
      attn_tile::cp_wait<1>();
    } else {
      attn_tile::cp_wait<0>();
    }
    __syncthreads();
    const unsigned char* A = Lay::a(smem, st) + rl * Lay::APM_LD;
    float acc[DV / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {   // codes past kend are 0
      const unsigned char* p = A + (kk * 8 + 2 * t) * sizeof(RAW_T);
      const float2 x0 = dequant2(p, s[0], RAW_T());
      const float2 x1 = dequant2(p + 8 * Lay::APM_LD, s[1], RAW_T());
      uint32_t ph[4], pl[4];
      attn_tile::split(x0.x, ph[0], pl[0]);
      attn_tile::split(x1.x, ph[1], pl[1]);
      attn_tile::split(x0.y, ph[2], pl[2]);
      attn_tile::split(x1.y, ph[3], pl[3]);
      attn_tile::pv_slice<DV, LDV>(acc, ph, pl, Lay::v(smem, st), kk);
    }
    attn_tile::add_tile<DV>(o, acc, {1.f, 1.f});
    __syncthreads();
  }
}

template <int DH, typename RAW_T, bool QUANT>
__global__ void __launch_bounds__(NT) memo_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const RAW_T* __restrict__ db,
    const __half* __restrict__ scales, const int* __restrict__ hit_idx,
    const int* __restrict__ hit, const int* __restrict__ lengths,
    float* __restrict__ out, int S, int H, int Hkv, int L, int N, int db_vec,
    int causal, int has_window, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DV = attn_tile::out_cols(DH), NCOL = DH / DV;
  const int h = blockIdx.y, b = blockIdx.z;
  // block x: the q-tile, then its column block (past dh 128)
  const int q0 = blockIdx.x / NCOL * BQ, cb = blockIdx.x % NCOL;
  const int hk = h / (H / Hkv);
  const size_t q_row = (size_t)H * DH, kv_row = (size_t)Hkv * DH;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)hk * DH + cb * DV;

  float o[DV / 8][4] = {};
  float l[2] = {1.f, 1.f};
  if (hit[b] == 1) {
    int e = hit_idx[b];
    e = e < 0 ? 0 : (e >= N ? N - 1 : e);
    apm_pv<DH, RAW_T, QUANT>(smem, db, scales, ((size_t)e * H + h) * L, L,
                             S < L ? S : L, db_vec, vb, kv_row, S, q0, o);
  } else {
    attn_tile::online_softmax<DH, sizeof(RAW_T)>(
        smem, q + (size_t)b * S * q_row + (size_t)h * DH, q_row,
        k + (size_t)b * S * kv_row + (size_t)hk * DH, kv_row, vb, kv_row, S,
        lengths[b], q0, causal, has_window, window, scale, o, l);
  }
  attn_tile::store_rows<DV>(
      out + (size_t)b * S * q_row + (size_t)h * DH + cb * DV, q_row, S, q0,
      o, l);
}

template <int DH, typename RAW_T, bool QUANT>
cudaError_t launch_db(const float* q, const float* k, const float* v,
                      const void* db, const __half* scales,
                      const int* hit_idx, const int* hit, const int* lengths,
                      float* out, int B, int S, int H, int Hkv, int L, int N,
                      int causal, int has_window, int window, float scale,
                      cudaStream_t stream) {
  constexpr int smem = attn_tile::Layout<DH, sizeof(RAW_T)>::SMEM;
  static unsigned smem_set = 0;
  const cudaError_t e = attn_tile::allow_smem(
      memo_attention_kernel<DH, RAW_T, QUANT>, smem, smem_set);
  if (e != cudaSuccess) return e;
  const int db_vec = (uintptr_t)db % 16 == 0 &&
                     (size_t)L * sizeof(RAW_T) % 16 == 0;
  dim3 grid((S + BQ - 1) / BQ * attn_tile::Layout<DH>::NCOL, H, B);
  memo_attention_kernel<DH, RAW_T, QUANT><<<grid, NT, smem, stream>>>(
      q, k, v, static_cast<const RAW_T*>(db), scales, hit_idx, hit, lengths,
      out, S, H, Hkv, L, N, db_vec, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const void* db, const __half* scales, const int* hit_idx,
                   const int* hit, const int* lengths, float* out, int B,
                   int S, int H, int Hkv, int L, int N, int db_kind,
                   int causal, int has_window, int window, float scale,
                   cudaStream_t stream) {
  // int8 codes (db_kind 1) or f16 values, the latter moved as raw bits
  if (db_kind == 1)
    return launch_db<DH, int8_t, true>(q, k, v, db, scales, hit_idx, hit,
                                       lengths, out, B, S, H, Hkv, L, N,
                                       causal, has_window, window, scale,
                                       stream);
  return launch_db<DH, uint16_t, false>(q, k, v, db, scales, hit_idx, hit,
                                        lengths, out, B, S, H, Hkv, L, N,
                                        causal, has_window, window, scale,
                                        stream);
}

}  // namespace

// q (B,S,H,dh), k/v (B,S,Hkv,dh) f32 contiguous with 16-byte-aligned
// bases; db (N,H,L,L) int8 (db_kind 1, with scales (N,H,L) f16) or f16
// (db_kind 0); hit_idx, hit, lengths (B,) int32; out (B,S,H,dh) f32.
// Returns cudaGetLastError().
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
    case 112:
      return launch<112>(qf, kf, vf, db, sc, hi, hm, ln, o, B, S, H, Hkv, L,
                         N, db_kind, causal, has_window, window, scale, st);
    case 128:
      return launch<128>(qf, kf, vf, db, sc, hi, hm, ln, o, B, S, H, Hkv, L,
                         N, db_kind, causal, has_window, window, scale, st);
    case 256:
      return launch<256>(qf, kf, vf, db, sc, hi, hm, ln, o, B, S, H, Hkv, L,
                         N, db_kind, causal, has_window, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
