// The attention tile at head_dim 112, 128 and 256 on Hopper's warpgroup
// MMA (wgmma.mma_async), in split TF32. flash_attention.cu and
// memo_attention.cu (both its branches) run it at those widths;
// attention_tile.cuh's mma.sync tile keeps head_dim 16, 32 and 64.
//
// Replaces, at those widths, the inner loops of the TPU kernels
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel) and
// src/repro/kernels/memo_attention/kernel.py (_memo_kernel): QK^T, online
// softmax and P·V over one tile of query rows, and the hit branch's APM·V.
//
// The function is attention_tile.cuh's: each f32 operand x splits into
// hi = rna(x) and lo = rna(x - hi), rna the TF32 rounding of
// cvt.rna.tf32.f32, and each product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// (3xTF32); softmax in f32 with scale dh^-1/2, masks kpos < len, causal
// and window, NEG_INF = -1e30, fully masked rows zeroed; the hit branch
// dequantizes in f32. The tensor cores do not round their f32 sums to
// nearest, so one long chain drifts: each 32-key step's P·V sums into a
// fresh accumulator joined to O in f32, and each score's two small
// products sum apart from its large one (two chains of their own, joined
// in f32 before the large one is added).
//
// Bound on the H100: at qwen3_8b's forward (B=2, S=1024, H=32 over 8,
// dh=128, causal) 17.2 GFLOP of products at 3xTF32's 494.7 / 3 TFLOP/s:
// 0.104 ms, set by operations; at qwen2_1_5b's serving shape (B=32,
// S=128, H=12 over 2) the 58.7 MB of Q/K/V/out at 3.35 TB/s, 0.0175 ms:
// set by bytes. At recurrentgemma_2b's forward (B=1, S=2,560, H=10 over
// 1, dh=256, causal, window 2,048) 32.2 GFLOP: 0.195 ms, set by
// operations.
//
// What the design does about it (the mma.sync tile ran these widths at
// 4-12x their bound: one block of 4 warps per SM, each warp splitting
// every K and V element of every tile):
// * A block of NT = 256 threads is two warpgroups. Warpgroup 0 (the
//   consumer) owns the BQ = 64 query rows and issues every product as
//   wgmma.m64nNk8.f32.tf32.tf32. QK^T takes, per 8 columns of dh, one
//   m64n64 product of Q hi with [K hi; K lo] (the large products and Q hi
//   K lo side by side) and one m64n32 of Q lo with K hi, A and B from
//   shared memory. P·V and APM·V take P (or the dequantized APM) hi/lo
//   from registers in the m64k8 A layout and V^T hi/lo from shared memory,
//   O's columns in two halves (m64n64 at dh 128 and 256, m64n56 at dh
//   112), so that consecutive wgmmas never wait on each other's sums.
//   Warpgroup 1 (the producer) copies K/V tiles and splits them: each K
//   and V element is split once per tile per block, and two warps share
//   each scheduler. The split rounds with integer operations (half a TF32
//   ulp added to the magnitude, 13 bits cleared: cvt.rna's bits).
// * TF32 wgmma reads only K-major operands. K's rows (dh contiguous) are
//   K-major for QK^T as they come; P·V needs keys contiguous per column of
//   V, so the split writes V transposed (V^T: one row per column of O, of
//   KT = 32 keys). Every operand lies in the 128-byte swizzle: rows of 128
//   bytes (32 values), chunk c of row r at chunk c ^ (r mod 8), 8-row
//   groups 1,024 bytes apart (SBO), a k-step of 8 values 32 bytes on
//   within an atom. Rows wider than 32 values are atoms side by side (Q
//   and K: 4 atoms); dh 112's last atom is half used and its other chunks
//   are never read (14 k-steps), so no padding is written. Every
//   shared-memory access is conflict-free: K's copy and in-place split and
//   Q's split (4 rows x 8 chunks of one atom a warp), V's row-major
//   landing tile (a warp's 32 consecutive chunks), and V^T's split, where
//   a lane takes the 4 keys of one 16-byte V^T chunk from one column of V
//   (a warp: 32 consecutive columns) and stores the chunk (8 lanes: 8
//   rows, whose swizzled chunks differ).
// * P never leaves registers: V^T's key columns are permuted within each
//   8-key slice (column t holds key 2t, column t + 4 key 2t + 1), which is
//   where the m64nN accumulator of QK^T holds P for the A layout.
// * dh 256 (recurrentgemma_2b: 10 heads over one KV head): the two blocks
//   of a row tile (NCOL = 2, neighbours in the grid) run as a thread-block
//   cluster of 2 (cudaLaunchKernelEx, cudaLaunchAttributeClusterDimension),
//   each the dh-128 tile over half of dh: block rank cb holds Q hi/lo and K
//   hi/lo for dh columns [128 cb, 128 cb + 128) (DQ = 128: dh 128's
//   regions and swizzle offsets, 4 atoms a row) and V^T for its 128 output
//   columns (DV = 128). Each block's partial scores (its small chains
//   joined to its large one in f32, as at dh 128) go to its peer's shared
//   memory (st.async at the mapa'd address, 16 floats a thread, 8,192
//   bytes a block a tile, counted as transaction bytes on the peer's
//   mbarrier), and each block adds the two partials: f32
//   addition is commutative, so both hold rank 0's + rank 1's bit for bit,
//   and both run the same softmax on the same P, then P·V over their own
//   columns. The products are those of the function (1x; the mma.sync
//   tile computed QK^T in both blocks, 1.5x), a block's Q fill halves and
//   its registers are dh 128's. A hit cluster's blocks read the same APM
//   tile and exchange nothing: hit[b] is the same in both blocks of a
//   cluster, so both skip the cluster barriers together.
// * Shared memory, from the block's first 1,024-byte boundary (1,024
//   bytes reserved for the alignment): Q hi and lo (64 rows x 4 atoms x
//   128 B each: 65,536 bytes), then STAGES = 2 stages of the K region (per
//   atom 32 K hi rows, where the copy lands and is split in place, then 32
//   K lo rows: 32,768), V^T hi and lo (DV rows x 128 B each: 32,768
//   [28,672 at dh 112]) and, at dh 112 and 128, V's landing tile (32 x DH
//   f32: 16,384 [14,336]): 81,920 [75,776] a stage, 230,400 bytes in all
//   at dh 128, 218,112 at dh 112, of the 232,448 a block may use: one
//   block (8 warps) a SM. At dh 256 V lands through registers (each
//   producer thread loads the 32 values it splits, a tile ahead), so no
//   landing tile: 65,536 a stage, then two exchange buffers (8,192 each)
//   and their two mbarriers (16): 214,032 bytes. One exchange buffer
//   beside the landing tiles would take 238,592. Two buffers need no
//   "buffer free" signal: a block writes its peer's buffer j % 2 for tile
//   j + 2 only after waiting for the peer's whole tile j + 1 partial,
//   which each peer thread sends (st.async's complete-tx releases at
//   cluster scope) after reading its tile j values from that buffer
//   (program order). A hit block's APM codes (64 x 32, rows of KT *
//   elem + 16 bytes) take the K region; one launch has one shared-memory
//   size, so hit blocks too run one a SM.
// * The producer keeps two tiles in flight: tile j lands (at dh 112/128 a
//   barrier of the producer's own, LANDED, since a thread splits V that
//   others copied; at dh 256 a thread splits only what it loaded), waits
//   for its stage's K lo and V^T (tile j - 2's P·V: V_FREE), is split and
//   handed over (FULL, after fence.proxy.async so the wgmma's async proxy
//   sees the split's stores); tile j + 2's copy into the stage is issued
//   once tile j's QK^T is done with K hi (A_FREE). Named barriers,
//   bar.arrive by one warpgroup and bar.sync by the other, carry the
//   hand-offs; every arrival has its wait. The consumer splits Q itself
//   (Q_READY, its own barrier) while the producer splits the first tiles.
//   Cluster synchronisation at dh 256, per miss block: two barrier.cluster
//   arrive/wait pairs by every thread of both blocks. The first opens the
//   cluster after thread 0 made the mbarriers (arrive at once; a consumer
//   thread waits after Q's fill, before its first remote store, a
//   producer thread after its ring, before it arrives again), the second
//   closes it (arrive and wait before exit, so no block leaves while its
//   peer may still write to it). Per key tile j, one phase of the
//   block's mbarrier j % 2 (parity (j / 2) % 2): one arrival, thread 0's
//   expect_tx of 8,192 bytes, and the peer's 512 16-byte st.async
//   complete it; each of the 128 consumer threads waits on it
//   (try_wait.parity.acquire.cluster) before reading the buffer. A block
//   waits in tile j for exactly the bytes its peer sends in tile j, and
//   thread 0 opens a phase only after it waited on the previous one of
//   that mbarrier. Registers: 182 [166] a thread in flash_attention, 180
//   [164] in memo_attention at dh 128 [112], 226 and 180 at dh 256, no
//   spills; 256 threads leave every thread 255.
// * Measured with scripts/attention_tile_variants.py --dh 112 128
//   (PERF.md): the producer's split and the copies' latency set the pace
//   more than the products do. Fewer producer warps and cvt.rna in the
//   split ran slower; one stage, or 64-key tiles in one stage (252
//   registers), were no better on the serving rows; a consumer that
//   issued QK^T(j + 1) before P·V(j), to run tile j + 1's softmax under
//   tile j's products, needed more registers and ran slower. At dh 256
//   the design measured against the cluster is one block a column half
//   (CLUSTER = false: Q and K over all 256 columns, 8 atoms, one stage,
//   QK^T and the softmax in both blocks of a row tile, 230,400 bytes):
//   variant "wgmma: dh 256 in one block", 32% slower at the forward and
//   15-24% on the serving rows. Plain remote stores with one release
//   arrival a thread in place of st.async ran 1-4% slower, and the
//   opening cluster barrier waited on before Q's fill ~1.5% slower on
//   all-miss rows; without any exchange (a diagnostic, wrong output) the
//   rows run 1-5% faster (PERF.md).
//
// Layouts (PTX ISA, wgmma .m64nNk8 .tf32), lane = 4 g + t, warp w of the
// warpgroup owns rows 16 w + {g, g + 8}:
//   A (registers): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   D (f32):       d[4j..4j+3] = (g, 8j+2t), (g, 8j+2t+1), (g+8, 8j+2t),
//                  (g+8, 8j+2t+1)
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace attn_wg {

using attn_tile::BQ;
using attn_tile::NEG_INF;

constexpr int KT = 32;         // keys a tile: one online-softmax step
constexpr int STAGES = 2;      // tiles in the ring
constexpr int PW = 4;          // producer warps
constexpr int NC = 128;        // consumer threads: warpgroup 0
constexpr int NT = NC + 32 * PW;
// dh 256: the row tile's two column blocks as a cluster exchanging
// partial scores (false: each block computes all of QK^T itself)
constexpr bool CLUSTER = true;
static_assert(NT <= 256, "255 registers for every thread");
// named barriers (0 is __syncthreads), one a stage each: the stage's
// operands are ready (FULL), its A region (K, or the APM codes) is free
// (A_FREE), its V^T is free (V_FREE); the consumer's Q is split (Q_READY,
// the consumer's threads only); a tile has landed (LANDED, the producer's
// threads only)
constexpr int FULL = 1, A_FREE = FULL + STAGES, V_FREE = A_FREE + STAGES,
              Q_READY = V_FREE + STAGES, LANDED = Q_READY + 1;
static_assert(KT % 32 == 0 && LANDED < 16, "whole atoms, 16 barriers");

__host__ __device__ constexpr bool uses(int dh) {
  return dh == 112 || dh == 128 || dh == 256;
}
__host__ __device__ constexpr int threads(int dh) {
  return uses(dh) ? NT : attn_tile::NT;
}
// blocks a row tile: past dh 128 each owns half of O's columns
__host__ __device__ constexpr int ncol(int dh) { return dh > 128 ? 2 : 1; }

// Byte offsets from the block's 1,024-aligned base (see the head comment)
template <int DH, int APM_ELEM = 0>
struct Layout {
  static constexpr int NCOL = ncol(DH);
  static constexpr int DV = DH / NCOL;            // O's columns a block owns
  static constexpr bool PAIR = NCOL > 1 && CLUSTER;
  static constexpr int DQ = PAIR ? DV : DH;       // Q/K columns a block holds
  static constexpr int ST = NCOL > 1 && !PAIR ? 1 : STAGES;   // stages
  static constexpr bool VREG = NCOL > 1;          // V lands through registers
  static constexpr int ATOMS = (DQ + 31) / 32;    // 128-byte atoms a row
  static constexpr int Q_BYTES = ATOMS * BQ * 128;
  // K hi rows 0..KT-1 and K lo rows KT..2 KT-1 of each atom
  static constexpr int K_BYTES = ATOMS * 2 * KT * 128;
  static constexpr int VT_BYTES = DV * KT * 4;
  static constexpr int VL_BYTES = VREG ? 0 : KT * DV * 4;
  static constexpr int X_BYTES = PAIR ? BQ * KT * 4 : 0;   // partial scores
  static constexpr int APM_LD = KT * APM_ELEM + 16;
  static constexpr int STAGE = K_BYTES + 2 * VT_BYTES + VL_BYTES;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + ST * STAGE + 2 * X_BYTES + (PAIR ? 16 : 0);
  static constexpr int QHI = 0, QLO = Q_BYTES;
  static_assert(DH % 16 == 0, "whole 16-column copy passes");
  static_assert(!VREG || DV % 32 == 0, "V^T rows in groups of 32");
  static_assert(BQ * APM_LD <= K_BYTES, "APM codes fit the K region");
  static_assert(SMEM <= 227 * 1024, "shared memory past 227 KB");
  __host__ __device__ static constexpr int k(int st) {
    return 2 * Q_BYTES + st * STAGE;
  }
  __host__ __device__ static constexpr int vth(int st) {
    return k(st) + K_BYTES;
  }
  __host__ __device__ static constexpr int vtl(int st) {
    return vth(st) + VT_BYTES;
  }
  __host__ __device__ static constexpr int vl(int st) {
    return vtl(st) + VT_BYTES;
  }
  // exchange buffer i (the peer's partial scores of tiles j = i mod 2)
  // and its mbarrier
  __host__ __device__ static constexpr int x(int i) {
    return 2 * Q_BYTES + ST * STAGE + i * X_BYTES;
  }
  __host__ __device__ static constexpr int bar(int i) {
    return x(2) + 8 * i;
  }
};

// attn_tile::Layout's or Layout's SMEM, whichever tile DH runs
template <int DH, int APM_ELEM = 0>
__host__ __device__ constexpr int smem_bytes() {
  if constexpr (uses(DH))
    return Layout<DH, APM_ELEM>::SMEM;
  else
    return attn_tile::Layout<DH, APM_ELEM>::SMEM;
}

// blocks of a cluster: 2 where a row tile's blocks exchange scores
template <int DH>
__host__ __device__ constexpr int cluster_size() {
  if constexpr (uses(DH))
    return Layout<DH>::PAIR ? Layout<DH>::NCOL : 1;
  else
    return 1;
}

// ---------------------------------------------------------------- PTX

template <int COUNT = NT>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(COUNT) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(NT) : "memory");
}
// generic-proxy stores to shared memory, seen by wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits for all of this warpgroup's wgmma groups
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps reads of d after the wgmma.wait_group above it
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// keeps the writes of A fragments before the wgmma.fence below it
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
  }
}

// the block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// the cluster barrier: every thread of every block of the cluster arrives
// (release), and waits (acquire) before it arrives again
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// the shared::cluster address of shared address a in block `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// 16 bytes to shared::cluster address a (a peer's), counted as complete
// transaction bytes on the peer's mbarrier at shared::cluster address
// mbar once written (release at cluster scope)
__device__ __forceinline__ void st_async(uint32_t a, float x, float y,
                                         float z, float w, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      ::"r"(a), "f"(x), "f"(y), "f"(z), "f"(w), "r"(mbar) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t a, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               ::"r"(a), "r"(count) : "memory");
}
// one arrival on this block's mbarrier at a, whose phase then also waits
// for tx transaction bytes
__device__ __forceinline__ void mbar_expect(uint32_t a, int tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(a), "r"(tx) : "memory");
}
// waits until the phase of parity `parity` of this block's mbarrier at a
// has completed; the peer's stores before its arrivals are seen after
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(a), "r"(parity) : "memory");
}

// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), as attn_tile::split,
// the rounding done with integer operations (half a TF32 ulp added to the
// magnitude bits, the 13 low bits cleared: the same bits for every finite
// x, in two ALU operations where the conversion is slower)
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));
}

// K-major operand in the 128-byte swizzle: byte offset of 16-byte chunk c
// (values 4c..4c+3) of row r in a tile of R rows
template <int R>
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c ^ r) & 7) << 4);
}

// descriptor of a K-major 128-byte-swizzle tile at shared address a: LBO
// unused (1), SBO 1,024 bytes (8 rows), layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}
// the descriptor of k-step kk (8 values) of a tile of R rows
template <int R>
__device__ __forceinline__ uint64_t kstep(uint64_t d, int kk) {
  return d + (uint64_t)((((kk >> 2) * R * 128) + (kk & 3) * 32) >> 4);
}

// d (m64nN f32) = A · B (+ d if scale_d), A and B K-major tf32 in shared
// memory: N = 32, 64, 128 (16, 32, 64 registers)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64nN f32) = A · B (+ d if scale_d), A tf32 from registers (the
// m64k8 A layout), B K-major tf32 in shared memory: N = 56, 64 (half
// of dh 112's and dh 128's columns, and of a dh-256 block's)
__device__ __forceinline__ void wgmma_rs(float (&d)[28],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// acc = A (hi ah / lo al) · V^T over the KT keys of a tile: a_lo*v_hi +
// a_hi*v_lo + a_hi*v_hi per 8-key slice, into fresh accumulators. V^T's
// DV rows (O's columns) go in two halves, acc[0] and acc[1], so
// consecutive wgmmas never wait on each other's sums.
template <int DV>
__device__ __forceinline__ void av(float (&acc)[2][DV / 4],
                                   uint32_t (&ah)[KT / 8][4],
                                   uint32_t (&al)[KT / 8][4], uint64_t vh,
                                   uint64_t vl) {
  constexpr uint64_t HALF = DV / 2 * 128 >> 4;   // V^T row DV / 2
  hold(ah);
  hold(al);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wgmma_rs(acc[h], al[kk], kstep<DV>(vh, kk) + h * HALF, kk > 0);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wgmma_rs(acc[h], ah[kk], kstep<DV>(vl, kk) + h * HALF, 1);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wgmma_rs(acc[h], ah[kk], kstep<DV>(vh, kk) + h * HALF, 1);
  }
  wg_commit();
  wg_wait();
  hold(acc[0]);
  hold(acc[1]);
}

// o = o * alpha + acc, rows g (alpha[0]) and g + 8 (alpha[1]); o's column
// block n is acc[n / (DV / 16)]'s block n % (DV / 16)
template <int DV>
__device__ __forceinline__ void add_tile(float (&o)[DV / 8][4],
                                         const float (&acc)[2][DV / 4],
                                         const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[n][e] = fmaf(o[n][e], alpha[e >> 1],
                     acc[n / (DV / 16)][4 * (n % (DV / 16)) + e]);
  }
}

// ------------------------------------------------------------- producer
// Producer thread p is 0..32 PW - 1.

// K rows [k0, k0 + KT) of kb (rows ks floats apart, the block's DQ
// columns; zero at or past S) into the K hi rows, swizzled: a warp copies
// 4 keys x 8 chunks of one atom a pass
template <class Lay>
__device__ __forceinline__ void load_k(unsigned char* kr, const float* kb,
                                       size_t ks, int k0, int S, int p) {
  const int w = p >> 5, lane = p & 31;
#pragma unroll
  for (int it = 0; it < KT / 4 * Lay::ATOMS / PW; ++it) {
    const int wi = w + PW * it;
    const int r = wi % (KT / 4) * 4 + (lane >> 3);
    const int c = wi / (KT / 4) * 8 + (lane & 7);
    if (c < Lay::DQ / 4) {
      const bool ok = k0 + r < S;
      attn_tile::cp_async16(kr + sw<2 * KT>(r, c),
                            ok ? kb + (size_t)(k0 + r) * ks + c * 4 : kb,
                            ok ? 16 : 0);
    }
  }
}

// K hi rows (as landed) -> K hi, K lo in place: the chunks this thread
// copied (load_k)
template <class Lay>
__device__ __forceinline__ void split_k(unsigned char* kr, int p) {
  const int w = p >> 5, lane = p & 31;
#pragma unroll
  for (int it = 0; it < KT / 4 * Lay::ATOMS / PW; ++it) {
    const int wi = w + PW * it;
    const int r = wi % (KT / 4) * 4 + (lane >> 3);
    const int c = wi / (KT / 4) * 8 + (lane & 7);
    if (c < Lay::DQ / 4) {
      uint4* h = reinterpret_cast<uint4*>(kr + sw<2 * KT>(r, c));
      const float4 x = *reinterpret_cast<const float4*>(h);
      uint4 hi, lo;
      split(x.x, hi.x, lo.x);
      split(x.y, hi.y, lo.y);
      split(x.z, hi.z, lo.z);
      split(x.w, hi.w, lo.w);
      h[0] = hi;
      h[KT * 128 / 16] = lo;   // row r + KT: the same swizzle
    }
  }
}

// V rows [k0, k0 + KT) (the block's DV columns, zero at or past S) into
// the landing tile, row major (KT x DV f32): chunk i of the tile (row
// i / (DV / 4)) at byte 16 i
template <class Lay>
__device__ __forceinline__ void load_v(unsigned char* vl, const float* vb,
                                       size_t vs, int k0, int S, int p) {
  constexpr int DV = Lay::DV;
#pragma unroll
  for (int it = 0; it < KT * DV / 4 / (32 * PW); ++it) {
    const int i = p + 32 * PW * it, r = i / (DV / 4), c = i % (DV / 4);
    const bool ok = k0 + r < S;
    attn_tile::cp_async16(vl + i * 16,
                          ok ? vb + (size_t)(k0 + r) * vs + c * 4 : vb,
                          ok ? 16 : 0);
  }
}

// One pass of V^T's split: the V^T chunk (4 key columns q) of row d that
// producer thread p writes in pass `it`, and its 4 keys' rows in the tile
// (columns 4q..4q+3: keys 8 (q / 2) + 2t (+1 for odd q), t = 0..3)
struct VtChunk {
  int q, d, r0;
  __device__ __forceinline__ VtChunk(int p, int it) {
    const int wi = (p >> 5) + PW * it;
    q = wi % (KT / 4);
    d = wi / (KT / 4) * 32 + (p & 31);
    r0 = (q >> 1) * 8 + (q & 1);
  }
};
// V^T hi/lo chunk at row d, key columns 4q..4q+3 = split of x
template <class Lay>
__device__ __forceinline__ void store_vt(unsigned char* vth, const VtChunk& c,
                                         float x0, float x1, float x2,
                                         float x3) {
  uint4 hi, lo;
  split(x0, hi.x, lo.x);
  split(x1, hi.y, lo.y);
  split(x2, hi.z, lo.z);
  split(x3, hi.w, lo.w);
  *reinterpret_cast<uint4*>(vth + sw<Lay::DV>(c.d, c.q)) = hi;
  *reinterpret_cast<uint4*>(vth + Lay::VT_BYTES + sw<Lay::DV>(c.d, c.q)) =
      lo;
}

// the landing tile (every producer thread's copies landed) -> V^T hi, lo:
// row d, key column j holds key perm(j) (column t of each 8-key slice key
// 2t, column t + 4 key 2t + 1). A warp writes one 16-byte chunk (4 key
// columns) of 32 rows a pass, reading its 4 keys a row at a time.
template <class Lay>
__device__ __forceinline__ void split_v(unsigned char* vth,
                                        const unsigned char* vl, int p) {
  constexpr int DV = Lay::DV, DG = (DV + 31) / 32;   // groups of 32 rows
  const float* v = reinterpret_cast<const float*>(vl);
#pragma unroll
  for (int it = 0; it < DG * KT / 4 / PW; ++it) {
    const VtChunk c(p, it);
    if (c.d < DV)
      store_vt<Lay>(vth, c, v[(c.r0 + 0) * DV + c.d],
                    v[(c.r0 + 2) * DV + c.d], v[(c.r0 + 4) * DV + c.d],
                    v[(c.r0 + 6) * DV + c.d]);
  }
}

// V through registers (Lay::VREG): the values this thread splits into
// V^T (split_v's chunks) loaded straight from V rows [k0, k0 + KT) (the
// block's DV columns; zero at or past S), a warp's 32 lanes on 32
// consecutive columns of one row
template <class Lay>
struct VRegs {
  static constexpr int N = Lay::DV / 32 * KT / 4 / PW;
  float x[N][4];
};
template <class Lay>
__device__ __forceinline__ void ldg_v(VRegs<Lay>& vr, const float* vb,
                                      size_t vs, int k0, int S, int p) {
#pragma unroll
  for (int it = 0; it < VRegs<Lay>::N; ++it) {
    const VtChunk c(p, it);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = k0 + c.r0 + 2 * e;
      vr.x[it][e] = r < S ? vb[(size_t)r * vs + c.d] : 0.f;
    }
  }
}
template <class Lay>
__device__ __forceinline__ void split_v_regs(unsigned char* vth,
                                             const VRegs<Lay>& vr, int p) {
#pragma unroll
  for (int it = 0; it < VRegs<Lay>::N; ++it)
    store_vt<Lay>(vth, VtChunk(p, it), vr.x[it][0], vr.x[it][1],
                  vr.x[it][2], vr.x[it][3]);
}

// Issues the copies of the first ST tiles (load(j, stage)), one cp.async
// group each; produce() then carries the ring to tile n - 1.
template <int ST, typename Load>
__device__ __forceinline__ void prefetch(int n, Load load) {
#pragma unroll
  for (int j = 0; j < ST; ++j) {
    if (j < n) {
      load(j, j);
      attn_tile::cp_commit();
    }
  }
}

// The producer's ring of ST stages: tile j lands (every producer thread's
// copies, where LANDED_SYNC: a thread prepares what others copied), waits
// for its stage's K lo and V^T (tile j - ST's P·V), is made into operands
// (prepare(j, stage)) and handed over; tile j + ST's copy is issued once
// tile j's A region is free (which all producer threads pass only after
// preparing tile j, so a landing tile is free too).
template <int ST, bool LANDED_SYNC, typename Load, typename Prepare>
__device__ __forceinline__ void produce(int n, Load load, Prepare prepare) {
  static_assert(ST == 1 || ST == 2, "cp.async groups in flight: 1 or 2");
  for (int j = 0; j < n; ++j) {
    const int st = j % ST;
    if (ST > 1 && j + 1 < n)
      attn_tile::cp_wait<ST - 1>();
    else
      attn_tile::cp_wait<0>();
    if (LANDED_SYNC) bar_sync<32 * PW>(LANDED);
    if (j >= ST) bar_sync(V_FREE + st);
    prepare(j, st);
    fence_proxy_async();
    bar_arrive(FULL + st);
    if (j + ST < n) {
      bar_sync(A_FREE + st);
      load(j + ST, st);
      attn_tile::cp_commit();
    }
  }
}

// Q rows [q0, q0 + BQ) (the block's DQ columns from qb on; zero at or
// past S) -> Q hi, lo, swizzled, by the consumer's NC threads: a warp
// takes 4 rows x 8 chunks of one atom a pass, up to 4 atoms loaded before
// they are split. Then the consumer's own barrier: the producer never
// reads Q.
template <class Lay>
__device__ __forceinline__ void load_q(unsigned char* base, const float* qb,
                                       size_t qs, int q0, int S) {
  constexpr int DQ = Lay::DQ, GA = Lay::ATOMS < 4 ? Lay::ATOMS : 4;
  constexpr int IT = BQ / 4 * GA / (NC / 32);
  static_assert(Lay::ATOMS % GA == 0, "whole groups of atoms");
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int a0 = 0; a0 < Lay::ATOMS; a0 += GA) {
    float4 x[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int wi = w + (NC / 32) * it;
      const int r = (wi & 15) * 4 + (lane >> 3);
      const int c = (a0 + (wi >> 4)) * 8 + (lane & 7);
      x[it] = c < DQ / 4 && q0 + r < S
                  ? *reinterpret_cast<const float4*>(
                        qb + (size_t)(q0 + r) * qs + c * 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int wi = w + (NC / 32) * it;
      const int r = (wi & 15) * 4 + (lane >> 3);
      const int c = (a0 + (wi >> 4)) * 8 + (lane & 7);
      if (c < DQ / 4) {
        uint4 hi, lo;
        split(x[it].x, hi.x, lo.x);
        split(x[it].y, hi.y, lo.y);
        split(x[it].z, hi.z, lo.z);
        split(x[it].w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(base + Lay::QHI + sw<BQ>(r, c)) = hi;
        *reinterpret_cast<uint4*>(base + Lay::QLO + sw<BQ>(r, c)) = lo;
      }
    }
  }
  fence_proxy_async();
  bar_sync<NC>(Q_READY);
}

// the block's dynamic shared memory from its first 1,024-byte boundary
__device__ __forceinline__ unsigned char* aligned(unsigned char* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return smem + ((1024 - (a & 1023)) & 1023);
}
__device__ __forceinline__ uint32_t saddr(const unsigned char* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- clusters

// Where a row tile's blocks form a cluster (Lay::PAIR): thread 0 makes
// the two exchange mbarriers (one arrival a phase, its own expect_tx),
// then every thread of both blocks arrives on the cluster barrier. Each
// thread waits on it before its first remote access (the consumer, after
// Q's fill: attend) or before its next arrival (the producer), so neither
// block touches the other's shared memory before it is running and its
// mbarriers exist. Called by every thread of the block, first.
template <class Lay>
__device__ __forceinline__ void cluster_open(unsigned char* smem) {
  if constexpr (Lay::PAIR) {
    unsigned char* base = aligned(smem);
    if (threadIdx.x == 0) {
      mbar_init(saddr(base + Lay::bar(0)), 1);
      mbar_init(saddr(base + Lay::bar(1)), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_arrive();
  }
}
// ... and last: no block exits while its peer may still write to it
template <class Lay>
__device__ __forceinline__ void cluster_close() {
  if constexpr (Lay::PAIR) {
    cluster_arrive();
    cluster_wait();
  }
}

// Tile j's partial scores s (this block's DQ columns of dh, the D layout
// of an m64n32 product) -> the full scores: s goes to the peer's exchange
// buffer j % 2 (thread i's 16 values at float4 k NC + i, k = 0..3) by
// st.async, each store counted on the peer's mbarrier j % 2, whose phase
// (j / 2) % 2 its thread 0 opens expecting X_BYTES; the peer's partial is
// read from this block's buffer j % 2 once that phase is complete here
// and added: rank 0's + rank 1's in both blocks (f32 addition is
// commutative, so the two sums are the same bits).
template <class Lay>
__device__ __forceinline__ void exchange(unsigned char* base,
                                         float (&s)[KT / 8][4], int j) {
  const int b = j & 1;
  const uint32_t peer = cluster_rank() ^ 1u;
  const int i = threadIdx.x;
  const uint32_t bar = saddr(base + Lay::bar(b));
  if (i == 0) mbar_expect(bar, Lay::X_BYTES);
  const uint32_t there = mapa(saddr(base + Lay::x(b)) + i * 16, peer);
  const uint32_t there_bar = mapa(bar, peer);
#pragma unroll
  for (int k = 0; k < KT / 8; ++k)
    st_async(there + k * NC * 16, s[k][0], s[k][1], s[k][2], s[k][3],
             there_bar);
  mbar_wait(bar, (j >> 1) & 1);
#pragma unroll
  for (int k = 0; k < KT / 8; ++k) {
    const float4 y = *reinterpret_cast<const float4*>(
        base + Lay::x(b) + (k * NC + i) * 16);
    s[k][0] += y.x;
    s[k][1] += y.y;
    s[k][2] += y.z;
    s[k][3] += y.w;
  }
}

// ------------------------------------------------------------- the tile

// Rows [q0, q0 + BQ) of q (rows qs apart) attend over keys [0, len) of
// k/v (rows ks / vs apart), and the rows below S are stored to out (rows
// os apart, from ob on): block cb of the row tile's NCOL owns O's columns
// [cb DV, cb DV + DV) and takes Q/K columns [cb DQ, cb DQ + DQ) where
// they are split between the blocks (PAIR). Every thread of the block
// calls it: the producer warps run the K/V ring, the consumer warpgroup
// (threadIdx.x < NC) the products and the softmax; a fully masked row's
// denominator is clamped at 1e-30, so it divides to 0.
template <int DH, int APM_ELEM>
__device__ __forceinline__ void attend(
    unsigned char* smem, int cb, const float* qb, size_t qs, const float* kb,
    size_t ks, const float* vb, size_t vs, int S, int len, int q0,
    int causal, int has_window, int window, float scale, float* ob,
    size_t os) {
  using Lay = Layout<DH, APM_ELEM>;
  constexpr int DV = Lay::DV, DQ = Lay::DQ, ST = Lay::ST;
  unsigned char* base = aligned(smem);
  if (Lay::PAIR) {
    qb += cb * DQ;
    kb += cb * DQ;
  }
  vb += cb * DV;
  ob += cb * DV;
  len = len < S ? len : S;
  int kend = len;
  if (causal && q0 + BQ < kend) kend = q0 + BQ;
  int kstart = 0;
  if (has_window) {
    const int lo = q0 - window + 1;        // first key any row may see
    if (lo > 0) kstart = (lo / KT) * KT;
  }
  const int n = kstart < kend ? (kend - kstart + KT - 1) / KT : 0;

  if (threadIdx.x >= NC) {
    const int p = threadIdx.x - NC;
    if constexpr (Lay::VREG) {
      auto load = [&](int j, int st) {
        load_k<Lay>(base + Lay::k(st), kb, ks, kstart + j * KT, S, p);
      };
      VRegs<Lay> vr;
      if (n > 0) ldg_v<Lay>(vr, vb, vs, kstart, S, p);
      prefetch<ST>(n, load);
      produce<ST, false>(n, load, [&](int j, int st) {
        split_k<Lay>(base + Lay::k(st), p);
        split_v_regs<Lay>(base + Lay::vth(st), vr, p);
        if (j + 1 < n) ldg_v<Lay>(vr, vb, vs, kstart + (j + 1) * KT, S, p);
      });
      if constexpr (Lay::PAIR) cluster_wait();   // cluster_open's
    } else {
      auto load = [&](int j, int st) {
        load_k<Lay>(base + Lay::k(st), kb, ks, kstart + j * KT, S, p);
        load_v<Lay>(base + Lay::vl(st), vb, vs, kstart + j * KT, S, p);
      };
      prefetch<ST>(n, load);
      produce<ST, true>(n, load, [&](int, int st) {
        split_k<Lay>(base + Lay::k(st), p);
        split_v<Lay>(base + Lay::vth(st), base + Lay::vl(st), p);
      });
    }
    return;
  }
  load_q<Lay>(base, qb, qs, q0, S);
  if constexpr (Lay::PAIR) cluster_wait();   // cluster_open's

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const uint64_t dqh = desc(saddr(base + Lay::QHI));
  const uint64_t dql = desc(saddr(base + Lay::QLO));
  float o[DV / 8][4] = {};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n; ++j) {
    const int st = j % ST, c0 = kstart + j * KT;
    bar_sync(FULL + st);
    // S = Q K^T: hk = Q hi [K hi; K lo] (one m64n(2 KT) product: the large
    // products in its first KT columns, Q hi K lo in the rest), lk = Q lo
    // K hi (m64nKT)
    const uint64_t dk = desc(saddr(base + Lay::k(st)));
    float hk[KT], lk[KT / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQ / 8; ++kk) {
      wgmma_ss(hk, kstep<BQ>(dqh, kk), kstep<2 * KT>(dk, kk), kk > 0);
      wgmma_ss(lk, kstep<BQ>(dql, kk), kstep<2 * KT>(dk, kk), kk > 0);
    }
    wg_commit();
    wg_wait();
    hold(hk);
    hold(lk);
    if (j + ST < n) bar_arrive(A_FREE + st);

    // each score's small products join in f32, then its large one; a
    // cluster's blocks add their halves of dh
    float s[KT / 8][4];
#pragma unroll
    for (int nn = 0; nn < KT / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nn][e] = (hk[KT / 2 + 4 * nn + e] + lk[4 * nn + e]) + hk[4 * nn + e];
    }
    if constexpr (Lay::PAIR) exchange<Lay>(base, s, j);

    // scale, mask, running max (rows g, g + 8: a quad shares a row)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nn = 0; nn < KT / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1], kpos = c0 + nn * 8 + 2 * t + (e & 1);
        bool ok = kpos < kend;   // kend <= len
        if (causal) ok = ok && kpos <= r;
        if (has_window) ok = ok && kpos > r - window;
        s[nn][e] = ok ? s[nn][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nn][e]);
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
    // P as A fragments: column t of 8-key slice kk is key 2t, t + 4 key
    // 2t + 1 (V^T's column order)
    uint32_t ph[KT / 8][4], pl[KT / 8][4];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[e] = s[kk][e] <= NEG_INF * 0.5f ? 0.f
                                           : expf(s[kk][e] - m[e >> 1]);
        l[e >> 1] += pr[e];
      }
      split(pr[0], ph[kk][0], pl[kk][0]);
      split(pr[2], ph[kk][1], pl[kk][1]);
      split(pr[1], ph[kk][2], pl[kk][2]);
      split(pr[3], ph[kk][3], pl[kk][3]);
    }

    // O = O alpha + P V
    float acc[2][DV / 4];
    av<DV>(acc, ph, pl, desc(saddr(base + Lay::vth(st))),
           desc(saddr(base + Lay::vtl(st))));
    if (j + ST < n) bar_arrive(V_FREE + st);
    add_tile<DV>(o, acc, alpha);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  attn_tile::store_rows<DV>(ob, os, S, q0, o, l);
}

// Launches kernel over `grid` blocks of threads(DH) threads and `smem`
// dynamic shared bytes on `stream`; where a row tile's blocks exchange
// scores (cluster_size<DH>() > 1) as clusters of that many blocks along
// x (grid.x a multiple of it).
template <int DH, typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int smem,
                   cudaStream_t stream, Args... args) {
  if constexpr (cluster_size<DH>() > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads(DH));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster_size<DH>();
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
  } else {
    kernel<<<grid, threads(DH), smem, stream>>>(args...);
    return cudaGetLastError();
  }
}

// out[0] = the cluster's blocks, out[1] = clusters of them resident on
// this card at once (cudaOccupancyMaxActiveClusters; 0 where blocks do
// not form clusters)
template <int DH, typename Kernel>
cudaError_t cluster_resources(Kernel kernel, int smem, int* out) {
  out[0] = cluster_size<DH>();
  out[1] = 0;
  if constexpr (cluster_size<DH>() > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster_size<DH>());
    cfg.blockDim = dim3(threads(DH));
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster_size<DH>();
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(&out[1], kernel, &cfg);
  }
  return cudaSuccess;
}

}  // namespace attn_wg
