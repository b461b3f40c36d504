// Attention tiles on Hopper's tensor cores in split TF32, shared by
// flash_attention.cu and memo_attention.cu (its miss branch runs
// online_softmax; its hit branch, apm_pv, runs pv_slice on the APM).
//
// Replaces the inner loops of the TPU kernels
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel) and
// src/repro/kernels/memo_attention/kernel.py (_memo_kernel): QK^T,
// online softmax and P·V over one tile of query rows.
//
// Bound on the H100: f32-accurate products on the tensor cores cost three
// TF32 products each, so they run at 494.7 / 3 ~ 165 TFLOP/s dense. At
// gpt2_small's shape (B=8, S=1024, H=12, dh=64, causal) the 50.4 M
// visible (q, k) pairs need 4*dh flops each, 12.9 GFLOP: 0.078 ms, set
// by operations (the 100.7 MB of Q/K/V/out take 0.030 ms). At
// bert_base's serving shape (B=32, S=128) memo_attention is set by bytes:
// 50.3 MB all-miss, 0.015 ms.
//
// What the design does about it:
// * Products run as mma.sync.m16n8k8 tf32 with f32 accumulators. Each
//   f32 operand x splits into hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x -
//   hi), and each product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, in that
//   order, the small terms first (3xTF32): f32-level error, where one
//   TF32 product keeps about 3 decimal digits.
// * A block of NT = 128 threads (4 warps) owns BQ = 64 query rows; each
//   warp owns 16 rows, whose Q hi/lo fragments are split once for the
//   whole key loop. Key tiles hold KT = 64 rows and are computed in two
//   online-softmax steps of KC = 32 keys, which keeps the score and
//   per-step P·V accumulators to 16 + DH / 2 registers: at dh = 64 the
//   kernels take up to 253 registers with no spills, two blocks per SM.
//   A step has no branch inside, so the accumulators' mma chains
//   interleave. (64-key steps, and a cap of 170 registers for three
//   blocks per SM, which spills, both ran slower on an H100:
//   scripts/attention_tile_variants.py.)
// * Where the Q fragments live depends on the width (Layout::Q_SMEM).
//   Up to dh = 64 they stay in registers. At dh = 128 they would take 128
//   registers beside O's 64, the step's P·V accumulator's 64 and the
//   scores' 16: past the 255 a thread may have. There each warp stores
//   its fragments once, in fragment order, to a region of shared memory
//   past the ring (BQ x DH x 2 words, 65,536 bytes: 200,704 with the
//   135,168-byte ring, of the 232,448 a block may use; one block of 4
//   warps per SM) and reads them back with two 16-byte loads per 8
//   columns in each 32-key step, the columns in the outer loop, so a
//   fragment is read once a step. Only the lane that stored a fragment
//   reads it, so no barrier is needed, and the loads are contiguous
//   across the warp (no bank conflict). The numerics do not change: every
//   score sums the same products in the same order. Chosen over splitting
//   O's columns between warp pairs (which needs a score exchange through
//   shared memory and a barrier in every step, and twice the softmax
//   work) and over 32-key tiles (which shrink the ring but not the 272
//   registers), as the change that keeps one tile for every width and
//   leaves the dh <= 64 code as it was. Q in shared memory at every
//   width (variant "Q in shared memory at every width" of
//   scripts/attention_tile_variants.py) runs flash_attention at dh 64
//   1% faster (0.3900 vs 0.3942 ms at B=8, S=1024) but memo_attention
//   1.6% slower (0.0558 vs 0.0549 ms, mixed rows at B=32, S=128) and
//   4.3% slower all-hit (0.0336 vs 0.0322), its larger shared memory
//   leaving fewer blocks per SM (H100 80GB HBM3, 700 W); so dh <= 64
//   keeps Q in registers. dh = 112 (kimi_k2: 7168 / 64 heads) takes the
//   dh-128 layout unchanged: 14 column steps of 8, O and the step's
//   accumulator at 56 registers each, a 118,784-byte ring and 57,344
//   bytes of Q fragments (176,128 in all); its rows, LD = 116 floats
//   apart (116 mod 32 = 20), keep both fragment reads conflict-free.
// * dh = 256 (recurrentgemma_2b: 10 heads of 256 over one KV head) does
//   not fit that layout: a 266,240-byte ring beside 131,072 bytes of Q
//   fragments, and O plus the step's P·V accumulator at 128 registers
//   each. There a block owns a 128-column block of O (out_cols; the row
//   tile's NCOL = 2 blocks are neighbours in the grid): the scores still
//   take all 256 columns of Q and K, the softmax runs whole in each
//   block, and P·V, O and the stored rows take the block's 128 columns
//   of V. Registers are then dh 128's (O and the accumulator at 64
//   each), the Q fragments stay in shared memory (131,072 bytes), and
//   key tiles shrink to KT = 32 keys (one softmax step): a stage is a
//   33,280-byte K tile and a 16,896-byte V tile, 231,424 bytes in all of
//   the 232,448. The price is QK^T and the softmax computed twice per
//   row tile, 1.5x the products; chosen over a warp pair sharing scores
//   through shared memory (a barrier in every step) and over O in two
//   passes inside one block (the same recomputation, half the blocks),
//   as the layout that changes no dh <= 128 code: KT, DV and NCOL
//   reduce to 64, DH and 1 there. K rows (LD = 260, 260 mod 32 = 4) and
//   V rows (LDV = 132) keep both fragment reads conflict-free. Blocks of
//   64 columns (variant "dh 256 in 64-column blocks" of
//   scripts/attention_tile_variants.py: 168 and 128 registers, four
//   softmax passes a row tile) ran flash_attention 1.83x slower at
//   B=1, S=2560, 10 heads over 1, causal (3.1508 vs 1.7201 ms; its flash
//   kernel spilled 12 bytes) and memo_attention 1.21x slower on mixed
//   rows at B=32, S=128 (0.2913 vs 0.2407 ms), so a block keeps 128
//   columns (H100 80GB HBM3, 700 W).
// * The tensor cores do not round their f32 sums to nearest, so a long
//   chain of products into one accumulator drifts: each step's P·V sums
//   into a fresh accumulator that joins O in f32 (add_tile), and each
//   score sums its small products apart from its large ones.
// * K/V tiles arrive by cp.async, 16 bytes per thread, into a ring of
//   STAGES = 2 stages in dynamic shared memory: the next tile's copy
//   overlaps this tile's products. Rows past S are zero-filled by the
//   copy itself (src-size 0), so the ragged last tile needs no padding.
//   One stage is a K (or APM) region and a V region of KT rows of DH + 4
//   floats: 69,632 bytes for the two stages at dh = 64 and 135,168 at
//   dh = 128, which needs cudaFuncAttributeMaxDynamicSharedMemorySize
//   (allow_smem).
// * The row padding DH + 4 makes both fragment reads conflict-free: K is
//   read as B with n = key (8 rows apart by 4 banks) and V as B with
//   k = key (rows 2t and 2t+1, 8 banks apart).
// * P never leaves registers: the k index of the P·V product is
//   permuted so that A column t is key 2t and column t + 4 key 2t + 1,
//   which is where the m16n8 accumulator of QK^T holds them, and V's
//   rows are read in the same order.
// * Softmax, max and exp stay f32 on the SIMT cores: scale dh^-1/2, masks
//   kpos < len, causal kpos <= qpos, window kpos > qpos - window, with
//   NEG_INF = -1e30; a fully masked row keeps m = NEG_INF, its
//   probabilities are zeroed and its output is 0. Key tiles that are
//   wholly masked for the block (at or past len, after the causal
//   diagonal, before the window) are neither loaded nor computed, and a
//   warp skips the 32-key steps that are wholly masked for its 16 rows:
//   exact, since those slices change neither the running max nor the sum.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), lane = 4 g + t:
//   A (16x8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8x8, col):  b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C (16x8 f32):  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace attn_tile {

constexpr int BQ = 64;          // query rows per block
constexpr int NT = 128;         // threads per block: 4 warps of 16 rows
constexpr int STAGES = 2;       // K/V ring depth
constexpr int KC = 32;          // keys per online-softmax step
constexpr float NEG_INF = -1e30f;

// Output columns one block computes: all of them up to dh = 128; past it
// a block owns a 128-column block of O (blockIdx), and the NCOL = DH / DV
// blocks of a row tile each run the whole softmax
__host__ __device__ constexpr int out_cols(int dh) {
  return dh > 128 ? 128 : dh;
}

// Dynamic shared memory of one block. A stage is an A region (a K tile,
// or an APM tile of APM_ELEM-byte values, whichever is larger) and a V
// tile of the block's DV columns; K rows are LD floats apart, V rows LDV,
// APM rows APM_LD bytes. A tile holds KT keys: 64, or 32 past dh = 128.
template <int DH, int APM_ELEM = 0>
struct Layout {
  static constexpr int DV = out_cols(DH);
  static constexpr int NCOL = DH / DV;
  static constexpr int KT = DH > 128 ? 32 : 64;
  static constexpr int LD = DH + 4;
  static constexpr int LDV = DV + 4;
  static constexpr int K_BYTES = KT * LD * 4;
  static constexpr int V_BYTES = KT * LDV * 4;
  static constexpr int APM_LD = KT * APM_ELEM + 16;
  static constexpr int A_BYTES =
      K_BYTES > BQ * APM_LD ? K_BYTES : BQ * APM_LD;
  static constexpr int STAGE = A_BYTES + V_BYTES;
  // past dh = 64 the Q hi/lo fragments live in shared memory, after the
  // ring: per warp, per 8 columns d, the hi then the lo fragment, each 32
  // lanes' uint4 in lane order
  static constexpr bool Q_SMEM = DH > 64;
  static constexpr int Q_BYTES = Q_SMEM ? BQ * DH * 2 * 4 : 0;
  static constexpr int SMEM = STAGES * STAGE + Q_BYTES;
  // what every width relies on: whole 8-column fragment steps, rows
  // 16-byte aligned for cp.async (LD = 116 at dh = 112: 464 bytes), whole
  // softmax steps in a tile, and a block's shared memory within the 227 KB
  // an H100 block may take (176,128 bytes at dh = 112, 231,424 at dh =
  // 256); the row copy's tiling is checked in load_rows_async
  static_assert(DH % 8 == 0 && DH % DV == 0, "head_dim must be a multiple "
                "of 8, and of 128 past 128");
  static_assert(LD * 4 % 16 == 0 && LDV * 4 % 16 == 0,
                "rows must be 16-byte aligned");
  static_assert(KT % KC == 0, "a tile must hold whole softmax steps");
  static_assert(SMEM <= 227 * 1024, "shared memory past 227 KB");
  __device__ static unsigned char* a(unsigned char* sm, int st) {
    return sm + st * STAGE;
  }
  __device__ static float* v(unsigned char* sm, int st) {
    return reinterpret_cast<float*>(sm + st * STAGE + A_BYTES);
  }
  // lane's hi fragment of columns [8 d, 8 d + 8) of warp w; lo is 32 on
  __device__ static uint4* q(unsigned char* sm, int w, int d, int lane) {
    return reinterpret_cast<uint4*>(sm + STAGES * STAGE) +
           (w * (DH / 8) + d) * 64 + lane;
  }
};

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device (above 48 KB it must ask). `done` is the caller's per-device
// bitmask, so the attribute is set once per kernel and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || bytes <= 48 * 1024 || (done >> dev & 1u)) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done |= 1u << dev;
  return e;
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in split TF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi. With
// `small` given, the two small products go there instead, to be added to
// d in f32 once the sum is complete.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1, float (&small)[4]) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(small, al, bh0, bh1);
  mma(small, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  mma3(d, ah, al, b0, b1, d);
}

// 16 bytes global -> shared; bytes past `src_bytes` (0..16) are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- tiles

// dst row j (LD floats apart) = columns [0, COLS) of src row r0 + j (rows
// `stride` apart), for ROWS rows by cp.async; rows at or past rmax are
// zeroed. Each thread keeps one 16-byte chunk column c of a row and steps
// RPP rows a pass, so its offsets are affine in the pass: where the
// chunks per row (COLS / 4 = 28 at dh 112) do not divide the block, the
// flat index i / CPR, i % CPR left 14 distinct offsets live across the
// key loop, and the dh-112 kernels spilled (4-20 bytes at 255 registers;
// 167-207 registers and no spill this way,
// scripts/attention_tile_variants.py). Lanes past the row's chunks
// (c >= CPR, at dh 112) copy nothing.
template <int COLS, int LD, int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                size_t stride, int r0,
                                                int rmax) {
  constexpr int CPR = COLS / 4;   // 16-byte chunks per row
  constexpr int CPP = CPR <= 4    ? 4
                      : CPR <= 8  ? 8
                      : CPR <= 16 ? 16
                      : CPR <= 32 ? 32
                                  : 64;
  constexpr int RPP = NT / CPP;  // rows a pass
  static_assert(CPR <= 64 && ROWS % RPP == 0, "row copy must tile the rows");
  const int c = threadIdx.x % CPP;
  if (c >= CPR) return;
#pragma unroll
  for (int it = 0; it < ROWS / RPP; ++it) {
    const int j = threadIdx.x / CPP + it * RPP;
    const bool ok = r0 + j < rmax;
    cp_async16(dst + j * LD + c * 4,
               ok ? src + (size_t)(r0 + j) * stride + c * 4 : src,
               ok ? 16 : 0);
  }
}

// K rows (all DH columns) and V rows (the block's DV columns: vb already
// points at the first) of the tile at key k0 into stage st
template <int DH, int APM_ELEM>
__device__ __forceinline__ void load_kv_async(unsigned char* smem, int st,
                                              const float* kb, size_t ks,
                                              const float* vb, size_t vs,
                                              int k0, int S) {
  using Lay = Layout<DH, APM_ELEM>;
  load_rows_async<DH, Lay::LD, Lay::KT>(
      reinterpret_cast<float*>(Lay::a(smem, st)), kb, ks, k0, S);
  load_rows_async<Lay::DV, Lay::LDV, Lay::KT>(Lay::v(smem, st), vb, vs, k0,
                                              S);
}

// o += P · V for key slice kk (8 keys) of the V tile (DV columns, rows
// LDV floats apart): P as A fragments, column t holding key 2t and
// column t + 4 key 2t + 1. The tensor cores do not round their f32 sums
// to nearest, so a caller sums one key tile per accumulator and adds the
// tiles in f32 (add_tile).
template <int DV, int LDV>
__device__ __forceinline__ void pv_slice(float (&o)[DV / 8][4],
                                         const uint32_t (&ph)[4],
                                         const uint32_t (&pl)[4],
                                         const float* V, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* v0 = V + (kk * 8 + 2 * t) * LDV + g;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) mma3(o[n], ph, pl, v0[n * 8], v0[LDV + n * 8]);
}

// o = o * alpha + acc, rows g (alpha[0]) and g + 8 (alpha[1])
template <int DV>
__device__ __forceinline__ void add_tile(float (&o)[DV / 8][4],
                                         const float (&acc)[DV / 8][4],
                                         const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[n][e] = fmaf(o[n][e], alpha[e >> 1], acc[n][e]);
  }
}

// Rows [q0, q0 + BQ) of q (rows qs apart) attend over keys [0, len) of
// k/v (rows ks / vs apart); warp w owns rows q0 + 16 w + {g, g + 8}. The
// scores take all DH columns of q and k; P·V takes the DV = out_cols(DH)
// columns of v from vb on (the block's column block).
// o must start at 0 and ends holding this thread's columns
// (8 n + 2t, 8 n + 2t + 1) of its two rows' unnormalised outputs; l ends
// holding their softmax denominators, clamped at 1e-30 so a fully masked
// row divides to 0. smem is the block's Layout<DH, APM_ELEM> ring.
template <int DH, int APM_ELEM>
__device__ __forceinline__ void online_softmax(
    unsigned char* smem, const float* qb, size_t qs, const float* kb,
    size_t ks, const float* vb, size_t vs, int S, int len, int q0,
    int causal, int has_window, int window, float scale,
    float (&o)[out_cols(DH) / 8][4], float (&l)[2]) {
  using Lay = Layout<DH, APM_ELEM>;
  constexpr int LD = Lay::LD, LDV = Lay::LDV, DV = Lay::DV, KT = Lay::KT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq = q0 + warp * 16;           // the warp's first row
  const int row[2] = {wq + g, wq + g + 8};

  len = len < S ? len : S;
  int kend = len;
  if (causal && q0 + BQ < kend) kend = q0 + BQ;
  int kstart = 0;
  if (has_window) {
    const int lo = q0 - window + 1;        // first key any row may see
    if (lo > 0) kstart = (lo / KT) * KT;
  }
  // keys [kstart_w, kend_w) hold every key any row of this warp may see
  const int kend_w = causal && wq + 16 < kend ? wq + 16 : kend;
  const int kstart_w = has_window ? wq - window + 1 : 0;

  if (kstart < kend) {
    load_kv_async<DH, APM_ELEM>(smem, 0, kb, ks, vb, vs, kstart, S);
    cp_commit();
  }
  // the warp's Q rows as A fragments, split once for the whole key loop:
  // kept in registers, or stored to the block's Q region (Q_SMEM)
  constexpr bool QS = Lay::Q_SMEM;
  uint32_t qh[QS ? 1 : DH / 8][4], ql[QS ? 1 : DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e & 1], c = d * 8 + t + (e >> 1) * 4;
      split(r < S ? qb[(size_t)r * qs + c] : 0.f, hi[e], lo[e]);
    }
    if constexpr (QS) {
      uint4* f = Lay::q(smem, warp, d, lane);
      f[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      f[32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qh[d][e] = hi[e];
        ql[d][e] = lo[e];
      }
    }
  }

  float m[2] = {NEG_INF, NEG_INF};
  l[0] = l[1] = 0.f;
  int st = 0;
  for (int k0 = kstart; k0 < kend; k0 += KT, st ^= 1) {
    if (k0 + KT < kend) {
      load_kv_async<DH, APM_ELEM>(smem, st ^ 1, kb, ks, vb, vs, k0 + KT, S);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // the tile in chunks of KC keys, each a step of the online softmax
#pragma unroll 1
    for (int c0 = k0; c0 < k0 + KT; c0 += KC) {
      if (c0 >= kend_w || c0 + KC <= kstart_w) continue;   // all masked
      const float* K = reinterpret_cast<const float*>(Lay::a(smem, st)) +
                       (c0 - k0) * LD;
      const float* V = Lay::v(smem, st) + (c0 - k0) * LDV;

      // S = Q K^T; each score's small products sum apart and join its
      // large ones in f32
      float s[KC / 8][4];
      if constexpr (QS) {
        // columns outer, so each Q fragment is read from shared memory
        // once a step; every score still sums over d in order
        float small[KC / 8][4] = {};
#pragma unroll
        for (int n = 0; n < KC / 8; ++n)
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int d = 0; d < DH / 8; ++d) {
          const uint4* f = Lay::q(smem, warp, d, lane);
          const uint4 h4 = f[0], l4 = f[32];
          const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w};
          const uint32_t al[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
          for (int n = 0; n < KC / 8; ++n) {
            const float* k_row = K + (n * 8 + g) * LD + t + d * 8;
            mma3(s[n], ah, al, k_row[0], k_row[4], small[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < KC / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = small[n][e] + s[n][e];
        }
      } else {
#pragma unroll
        for (int n = 0; n < KC / 8; ++n) {
          float small[4] = {0.f, 0.f, 0.f, 0.f};
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
          const float* k_row = K + (n * 8 + g) * LD + t;
#pragma unroll
          for (int d = 0; d < DH / 8; ++d)
            mma3(s[n], qh[d], ql[d], k_row[d * 8], k_row[d * 8 + 4], small);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = small[e] + s[n][e];
        }
      }

      // scale, mask, running max (rows g, g + 8: a quad shares a row)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row[e >> 1], kpos = c0 + n * 8 + 2 * t + (e & 1);
          bool ok = kpos < kend_w;   // kend_w <= len
          if (causal) ok = ok && kpos <= r;
          if (has_window) ok = ok && kpos > r - window;
          s[n][e] = ok ? s[n][e] * scale : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[n][e] <= NEG_INF * 0.5f
                              ? 0.f
                              : expf(s[n][e] - m[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }
      }

      // O = O alpha + P V: P's accumulator is its A operand
      float acc[DV / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        uint32_t ph[4], pl[4];
        split(s[kk][0], ph[0], pl[0]);
        split(s[kk][2], ph[1], pl[1]);
        split(s[kk][1], ph[2], pl[2]);
        split(s[kk][3], ph[3], pl[3]);
        pv_slice<DV, LDV>(acc, ph, pl, V, kk);
      }
      add_tile<DV>(o, acc, alpha);
    }
    __syncthreads();   // stage st is refilled two tiles on
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
}

// out rows q0 + 16 w + {g, g + 8} (rows os apart), DV columns from ob
// on, = o / l, for rows < S
template <int DV>
__device__ __forceinline__ void store_rows(float* ob, size_t os, int S,
                                           int q0, const float (&o)[DV / 8][4],
                                           const float (&l)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + (threadIdx.x >> 5) * 16 + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= S) continue;
    float* out = ob + (size_t)r * os + 2 * t;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(o[n][2 * i] / l[i], o[n][2 * i + 1] / l[i]);
  }
}

}  // namespace attn_tile
