// RWKV-6 wkv recurrence for Hopper (sm_90a), f32 on the SIMT cores.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv_kernel / wkv6_chunked_bhsn) together with its wrapper's padding
// of S to the chunk and its transposes to (B*nh, S, N)
// (ops.py::wkv6_chunked). It computes the same function, the wkv output
// from a zero state:
//   o_t = r_t . (S_t + diag(u) k_t v_t^T),  S_{t+1} = diag(w_t) S_t + k_t v_t^T
// with the sequential step's arithmetic, not the TPU's chunked matrix
// form: that form exists to feed the TPU's matrix unit, and its exp(-L)
// terms need w clamped at 1e-12 (kernel.py:42) and overflow f32 under
// fast decay. Here there is no clamp, no log and no exp, so the two
// differ only where some w < 1e-12.
//
// Bound on the H100: at rwkv6_3b's shape (B=4, S=1024, nh=40, N=64) the
// work must read r, k, v, w and write o, 5 x 42 MB = 210 MB in f32
// (0.063 ms at 3.35 TB/s), against 5 N^2 flops per head and step, 3.4
// GFLOP (0.051 ms at 67 TFLOP/s): bound by bytes.
//
// Why a first design (one block per (b, h) walking all S steps, 4N
// threads, a value column's state in the registers of four lanes) stayed
// 7.4x off that bound: it was not the latency of a step's chain but the
// shared-memory pipe. Each lane loaded r, k, w of its N/4 rows every
// step and used each value for one state element: 12 float4 loads per
// lane-step, four wavefronts each (a 16-byte load is served a quarter-
// warp at a time), ~50 wavefronts per 512 element-steps of a warp. At
// one wavefront per clock per SM that is 0.28 ms for rwkv6_3b's layer
// spread evenly over 132 SMs, and 0.46 ms on the 28 SMs that hold two of
// the 160 blocks: what it measured. Splitting the sequence alone did not
// help (PERF.md): the pipe, not the parallelism, was full.
//
// So the thread tile changes: 2N threads; a thread holds N/8 rows x 4
// columns of the state (32 registers at N = 64), so each r, k, w value
// it loads serves four columns and each v value N/8 rows: ~35
// wavefronts (6 row-vector loads, 3 broadcast loads, 4 shuffles, 1
// store) per 1024 element-steps of a warp, 3x fewer than before. The
// step is the sequential one with the bonus term taken out of the sum
// over rows, o_j = sum_i r_i S_ij + v_j b with b = sum_i r_i u_i k_i
// computed once per step for the whole head (not once per element):
// per element kv = k_i v_j, o_j += r_i S_ij, S_ij = w_i S_ij + kv, three
// f32 operations instead of four. A column's sum over its 8 lanes is
// reduced and scattered in four shuffles.
//
// The schedule cuts the sequence into nc = ceil(S / C) chunks of C steps,
// so that B * nh * nc blocks share the work evenly over the SMs. With
// D_c = prod of w_t over chunk c and U_c chunk c's end state from a zero
// start, the state entering chunk c+1 is H_c = diag(D_c) H_{c-1} + U_c
// (H_{-1} = 0):
//   phase 1  wkv6_states_kernel, grid (nc-1, nh, B): U_c and D_c from a
//            zero state, reading k, v, w only (no r, u or o);
//   phase 2  wkv6_scan_kernel: one thread per 4 state elements walks
//            c = 1 .. nc-2 in place, H_c = D_c * H_{c-1} + U_c;
//   phase 3  wkv6_out_kernel, grid (nc, nh, B): each chunk's outputs
//            from H_{c-1} (zero for c = 0), reading r, k, v, w, u once
//            and writing o once.
// nc == 1 is one launch (phase 3 alone); nc == 2 skips phase 2, which
// has nothing to do (H_0 = U_0). Against the sequential recurrence the
// f32 rounding moves only in the order of the sums over rows and where a
// state crosses a chunk boundary. Scratch: U (B, nh, nc-1, N, N) and D (B, nh,
// nc-1, N) f32, allocated by the wrapper; U is stored column-major
// ([j][i]), so eight lanes' row vectors of one column are contiguous, read
// and written coalesced. It crosses device memory four times (written in
// phase 1, read and written in phase 2, read in phase 3): (nc-1) * B *
// nh * N^2 * 4 bytes, 39 MB at C = 64, 18 MB at C = 128, 8 MB at C = 256
// for rwkv6_3b's shape, against the 50 MB L2. Smaller C gives more
// blocks and more scratch; the wrapper's default C is the fastest of
// chip_smoke's sweep.
//
// Inputs arrive by cp.async, 16 bytes a copy, into a two-stage ring of
// T = 16-step tiles in shared memory (the next tile in flight while this
// one is computed); o of a tile is staged in shared memory and written
// back coalesced. Inputs are read in the model's (B,S,nh,N) layout and
// ragged tiles are zero-filled by the copy: no transpose, no padding
// copy. __launch_bounds__ asks for 4 blocks of 2N threads per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 16;             // steps per staged tile
constexpr int LG = 8;             // lanes per column group (row groups)
constexpr int CT = 4;             // value columns per thread
constexpr int SCAN_THREADS = 256;
constexpr int MIN_BLOCKS = 4;     // resident blocks per SM asked of ptxas
constexpr unsigned FULL = 0xffffffffu;

// The thread tile at head size N: 2N threads; thread tid holds columns
// 4 * (tid / 8) .. +3 and, with g = tid % 8, the rows of vector groups
// q = g + 8m (m < NV), rows VEC * q .. VEC * q + VEC - 1: N/8 rows in
// all. Eight lanes of one column group read eight neighbouring vectors
// of a step row (one shared-memory wavefront a quarter-warp).
template <int N>
struct Tile {
  static constexpr int NT = 2 * N;              // threads per block
  static constexpr int RT = N / LG;             // rows per thread
  static constexpr int VEC = RT < 4 ? RT : 4;   // floats per row vector
  static constexpr int NV = RT / VEC;           // row vectors per thread
  static constexpr int C4 = N / 4;              // float4 per step row
  static constexpr int COPIES = T * C4 / NT;    // 16-byte copies per tile
  static_assert(NT % 32 == 0 && COPIES * NT == T * C4, "tile shape");
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    static_assert(V == 2, "row vectors of 2 or 4 floats");
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

// 16 bytes global -> shared; bytes past `src_bytes` (0 or 16) are zeroed
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

template <int W>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(W) : "memory");
}

// steps t0 .. t0+T-1 of one input, (b, h) at `base`, into dst; steps at
// or past `end` are zero-filled
template <int N>
__device__ __forceinline__ void load_tile(float (&dst)[T][N],
                                          const float* src, size_t base,
                                          size_t row, int t0, int end) {
  using L = Tile<N>;
#pragma unroll
  for (int p = 0; p < L::COPIES; ++p) {
    const int idx = threadIdx.x + p * L::NT;
    const int tt = idx / L::C4, c4 = idx % L::C4;
    const bool ok = t0 + tt < end;
    cp_async16(&dst[tt][4 * c4],
               ok ? src + base + (size_t)(t0 + tt) * row + 4 * c4 : src,
               ok ? 16 : 0);
  }
}

// where the state of (b, h) after chunk c lies in the scratch (phase 1
// writes U_c there, phase 2 turns it into H_c): column j, rows i at
// offset j * N + i
template <int N>
__device__ __forceinline__ size_t state_at(int b, int h, int nh, int nc1,
                                           int c) {
  return (((size_t)b * nh + h) * nc1 + c) * N * N;
}

// phase 1: U_c and D_c of chunk c < nc - 1 (a full chunk) from zero
template <int N>
__global__ void __launch_bounds__(Tile<N>::NT, MIN_BLOCKS)
    wkv6_states_kernel(const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ w, float* __restrict__ states,
                       float* __restrict__ decays, int S, int nh, int chunk) {
  using L = Tile<N>;
  constexpr int NV = L::NV, VEC = L::VEC;
  __shared__ __align__(16) float sK[2][T][N];
  __shared__ __align__(16) float sV[2][T][N];
  __shared__ __align__(16) float sW[2][T][N];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc1 = gridDim.x;
  const int tid = threadIdx.x, g = tid % LG, j0 = CT * (tid / LG);
  const size_t row = (size_t)nh * N;
  const size_t base = (size_t)b * S * row + (size_t)h * N;
  const int start = c * chunk, end = start + chunk;

  float st[NV][VEC][CT];
#pragma unroll
  for (int m = 0; m < NV; ++m)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int q = 0; q < CT; ++q) st[m][e][q] = 0.f;
  float d = 1.f;                   // threads tid < N: the decay of row tid

  auto load = [&](int s, int t0) {
    load_tile<N>(sK[s], k, base, row, t0, end);
    load_tile<N>(sV[s], v, base, row, t0, end);
    load_tile<N>(sW[s], w, base, row, t0, end);
  };
  const int ntiles = (chunk + T - 1) / T;
  load(0, start);
  cp_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = start + it * T, s = it & 1;
    if (it + 1 < ntiles) load(s ^ 1, t0 + T);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int steps = end - t0 < T ? end - t0 : T;
    for (int tt = 0; tt < steps; ++tt) {
      float vv[CT];
      load_vec<CT>(&sV[s][tt][j0], vv);
      if (tid < N) d *= sW[s][tt][tid];
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int i0 = VEC * (g + LG * m);
        float kk[VEC], ww[VEC];
        load_vec<VEC>(&sK[s][tt][i0], kk);
        load_vec<VEC>(&sW[s][tt][i0], ww);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
#pragma unroll
          for (int q = 0; q < CT; ++q)
            st[m][e][q] = fmaf(ww[e], st[m][e][q], kk[e] * vv[q]);
      }
    }
    __syncthreads();
  }
  float* U = states + state_at<N>(b, h, nh, nc1, c);
#pragma unroll
  for (int m = 0; m < NV; ++m)
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      float x[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = st[m][e][q];
      store_vec<VEC>(U + (size_t)(j0 + q) * N + VEC * (g + LG * m), x);
    }
  if (tid < N) decays[(((size_t)b * nh + h) * nc1 + c) * N + tid] = d;
}

// phase 2: H_c = D_c * H_{c-1} + U_c for c = 1 .. nc1-1, in place
// (H_0 = U_0 needs nothing); 4 elements (i .. i+3 of one column) a thread
__global__ void __launch_bounds__(SCAN_THREADS) wkv6_scan_kernel(
    float* __restrict__ states, const float* __restrict__ decays, int nbh,
    int nc1, int N) {
  const size_t per = (size_t)N * N / 4;            // float4 per state
  const size_t g = (size_t)blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (g >= (size_t)nbh * per) return;
  const size_t bh = g / per, e = g % per;
  const int n4 = N / 4;
  float4* U = reinterpret_cast<float4*>(states) + bh * nc1 * per + e;
  const float4* D =
      reinterpret_cast<const float4*>(decays) + bh * nc1 * n4 + e % n4;
  float4 s = U[0];
  float4 x = U[per];                               // nc1 >= 2
  for (int c = 1; c < nc1; ++c) {
    const float4 nx = c + 1 < nc1 ? U[(c + 1) * per] : x;
    const float4 dc = __ldg(D + c * n4);
    s.x = fmaf(dc.x, s.x, x.x);
    s.y = fmaf(dc.y, s.y, x.y);
    s.z = fmaf(dc.z, s.z, x.z);
    s.w = fmaf(dc.w, s.w, x.w);
    U[c * per] = s;
    x = nx;
  }
}

// phase 3: chunk c's outputs from H_{c-1} (zero for c = 0)
template <int N>
__global__ void __launch_bounds__(Tile<N>::NT, MIN_BLOCKS)
    wkv6_out_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ states, float* __restrict__ o,
                    int S, int nh, int chunk) {
  using L = Tile<N>;
  constexpr int NV = L::NV, VEC = L::VEC;
  __shared__ __align__(16) float sR[2][T][N];
  __shared__ __align__(16) float sK[2][T][N];
  __shared__ __align__(16) float sV[2][T][N];
  __shared__ __align__(16) float sW[2][T][N];
  __shared__ __align__(16) float sO[T][N];
  __shared__ float sB[T];          // each step's bonus sum_i r_i u_i k_i

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, g = tid % LG, j0 = CT * (tid / LG);
  const int jo = j0 + ((g >> 1) & 3);   // the column whose o this lane sums
  const size_t row = (size_t)nh * N;
  const size_t base = (size_t)b * S * row + (size_t)h * N;
  const int start = c * chunk;
  const int end = S - start < chunk ? S : start + chunk;
  // the bonus of step tb of a tile: N/8 lanes, 8 rows i = lb + N/8 * e each
  constexpr int LB = N / 8;
  static_assert(L::NT / LB == T, "one bonus per step of a tile");
  const int tb = tid / LB, lb = tid % LB;
  float ub[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) ub[e] = u[(size_t)h * N + lb + LB * e];

  float st[NV][VEC][CT];
  const float* H =
      c > 0 ? states + state_at<N>(b, h, nh, gridDim.x - 1, c - 1) : nullptr;
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int i0 = VEC * (g + LG * m);
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      float x[VEC];
      if (H) {
        load_vec<VEC>(H + (size_t)(j0 + q) * N + i0, x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) st[m][e][q] = x[e];
    }
  }

  auto load = [&](int s, int t0) {
    load_tile<N>(sR[s], r, base, row, t0, end);
    load_tile<N>(sK[s], k, base, row, t0, end);
    load_tile<N>(sV[s], v, base, row, t0, end);
    load_tile<N>(sW[s], w, base, row, t0, end);
  };
  const int ntiles = (end - start + T - 1) / T;
  load(0, start);
  cp_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = start + it * T, s = it & 1;
    if (it + 1 < ntiles) load(s ^ 1, t0 + T);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    {
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = lb + LB * e;
        x = fmaf(sR[s][tb][i] * sK[s][tb][i], ub[e], x);
      }
#pragma unroll
      for (int off = LB / 2; off > 0; off /= 2)
        x += __shfl_xor_sync(FULL, x, off);
      if (lb == 0) sB[tb] = x;
    }
    __syncthreads();
    const int steps = end - t0 < T ? end - t0 : T;
    for (int tt = 0; tt < steps; ++tt) {
      float vv[CT], acc[CT];
      load_vec<CT>(&sV[s][tt][j0], vv);
#pragma unroll
      for (int q = 0; q < CT; ++q) acc[q] = 0.f;
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int i0 = VEC * (g + LG * m);
        float rr[VEC], kk[VEC], ww[VEC];
        load_vec<VEC>(&sR[s][tt][i0], rr);
        load_vec<VEC>(&sK[s][tt][i0], kk);
        load_vec<VEC>(&sW[s][tt][i0], ww);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
#pragma unroll
          for (int q = 0; q < CT; ++q) {
            acc[q] = fmaf(rr[e], st[m][e][q], acc[q]);
            st[m][e][q] = fmaf(ww[e], st[m][e][q], kk[e] * vv[q]);
          }
      }
      // the 4 column sums over the column group's 8 lanes, reduced and
      // scattered: lane g ends with column j0 + ((g >> 1) & 3), as does
      // lane g ^ 1
      const bool hi4 = g & 4, hi2 = g & 2;
      float k0 = hi4 ? acc[2] : acc[0], k1 = hi4 ? acc[3] : acc[1];
      k0 += __shfl_xor_sync(FULL, hi4 ? acc[0] : acc[2], 4);
      k1 += __shfl_xor_sync(FULL, hi4 ? acc[1] : acc[3], 4);
      float sum = hi2 ? k1 : k0;
      sum += __shfl_xor_sync(FULL, hi2 ? k0 : k1, 2);
      sum += __shfl_xor_sync(FULL, sum, 1);
      if (!(g & 1)) sO[tt][jo] = fmaf(sV[s][tt][jo], sB[tt], sum);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < L::COPIES; ++p) {
      const int idx = tid + p * L::NT, tt = idx / L::C4, c4 = idx % L::C4;
      if (t0 + tt < end)
        *reinterpret_cast<float4*>(o + base + (size_t)(t0 + tt) * row +
                                   4 * c4) =
            *reinterpret_cast<const float4*>(&sO[tt][4 * c4]);
    }
  }
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, float* o, float* states,
                   float* decays, int B, int S, int nh, int chunk,
                   cudaStream_t stream) {
  const int nc = (S + chunk - 1) / chunk;
  if (nc > 1) {
    wkv6_states_kernel<N><<<dim3(nc - 1, nh, B), Tile<N>::NT, 0, stream>>>(
        k, v, w, states, decays, S, nh, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (nc > 2) {
      const size_t n4 = (size_t)B * nh * N * N / 4;
      wkv6_scan_kernel<<<(unsigned)((n4 + SCAN_THREADS - 1) / SCAN_THREADS),
                         SCAN_THREADS, 0, stream>>>(states, decays, B * nh,
                                                    nc - 1, N);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  wkv6_out_kernel<N><<<dim3(nc, nh, B), Tile<N>::NT, 0, stream>>>(
      r, k, v, w, u, states, o, S, nh, chunk);
  return cudaGetLastError();
}

// blocks per SM, registers and local (spill) bytes of the three kernels
template <int N>
cudaError_t resources(int* out) {
  const void* fns[3] = {reinterpret_cast<const void*>(wkv6_states_kernel<N>),
                        reinterpret_cast<const void*>(wkv6_scan_kernel),
                        reinterpret_cast<const void*>(wkv6_out_kernel<N>)};
  const int threads[3] = {Tile<N>::NT, SCAN_THREADS, Tile<N>::NT};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[i], fns[i],
                                                      threads[i], 0);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fns[i]);
    if (err != cudaSuccess) return err;
    out[3 + i] = attr.numRegs;
    out[6 + i] = (int)attr.localSizeBytes;
  }
  return cudaSuccess;
}

}  // namespace

// r, k, v, w (B,S,nh,N) f32 contiguous, 16-byte aligned; u (nh,N) f32
// contiguous; o (B,S,nh,N) f32 contiguous. N in {16, 32, 64}; 1 <= chunk
// <= S. With nc = ceil(S / chunk) > 1, states (B,nh,nc-1,N,N) and decays
// (B,nh,nc-1,N) are f32 scratch (else unused, may be null). Up to three
// launches; returns the first nonzero cudaGetLastError() after one.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* o, void* states,
                        void* decays, int B, int S, int nh, int N, int chunk,
                        void* stream) {
  auto* rf = static_cast<const float*>(r);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* wf = static_cast<const float*>(w);
  auto* uf = static_cast<const float*>(u);
  auto* of = static_cast<float*>(o);
  auto* sf = static_cast<float*>(states);
  auto* df = static_cast<float*>(decays);
  auto st = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > S) return (int)cudaErrorInvalidValue;
  switch (N) {
    case 16:
      return launch<16>(rf, kf, vf, wf, uf, of, sf, df, B, S, nh, chunk, st);
    case 32:
      return launch<32>(rf, kf, vf, wf, uf, of, sf, df, B, S, nh, chunk, st);
    case 64:
      return launch<64>(rf, kf, vf, wf, uf, of, sf, df, B, S, nh, chunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out[0..2]: resident blocks per SM of phases 1, 2, 3
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); out[3..5] their
// registers per thread; out[6..8] their local memory (spill) bytes.
extern "C" int wkv6_resources(int N, void* out) {
  auto* o = static_cast<int*>(out);
  switch (N) {
    case 16: return (int)resources<16>(o);
    case 32: return (int)resources<32>(o);
    case 64: return (int)resources<64>(o);
    default: return (int)cudaErrorInvalidValue;
  }
}
