// RWKV-6 wkv recurrence for Hopper (sm_90a), f32 on the SIMT cores.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv_kernel / wkv6_chunked_bhsn) together with its wrapper's padding
// of S to the chunk and its transposes to (B*nh, S, N)
// (ops.py::wkv6_chunked). It computes the same function, the wkv output
// from a zero state:
//   o_t = r_t . (S_t + diag(u) k_t v_t^T),  S_{t+1} = diag(w_t) S_t + k_t v_t^T
// but as the sequential recurrence, not the chunked form: the chunked
// form exists to feed the TPU's matrix unit, and its exp(-L) terms need
// w clamped at 1e-12 (kernel.py:42). This form has no such terms and no
// clamp, so the two differ only where some w < 1e-12.
//
// One block per (batch row, head), 4N threads. Value column j of the
// N x N state belongs to four lanes of one warp, each holding N/4 of its
// rows in registers; the four partial sums of o_t[j] meet by two
// shuffles. r, k, v, w of T = 32 steps are staged in shared memory
// (read as float4 broadcasts), and the next chunk's global loads are
// issued into registers before the current chunk is computed, so they
// overlap it. o of a chunk is staged in shared memory and written back
// coalesced. Inputs are read in the model's (B,S,nh,N) layout; the
// ragged last chunk is masked here: no transpose, no padding copy.
//
// Bound on the H100: at rwkv6_3b's shape (B=4, S=1024, nh=40, N=64) the
// kernel must read r, k, v, w and write o, 5 x 42 MB = 210 MB in f32
// (0.063 ms at 3.35 TB/s), against 5 N^2 flops per head and step
// (o: N^2 multiply-adds; the update: w*S, k v^T and their sum), 3.4
// GFLOP (0.051 ms at 67 TFLOP/s): bound by bytes. What the design does
// about it: the state never leaves registers and every input byte is
// read once, coalesced. Its weakness is parallelism: B * nh blocks (160
// at B=4) of one sequential chain each, so the time is the latency of
// 1024 dependent steps rather than the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PARTS = 4;   // lanes sharing one value column
constexpr int T = 32;      // steps staged per chunk
constexpr int PF = T / 16; // float4 per thread per input per chunk

template <int N>
__global__ void __launch_bounds__(N * PARTS) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, float* __restrict__ o, int S, int nh) {
  constexpr int NT = N * PARTS;
  constexpr int G = N / 16;       // float4 row groups per thread
  constexpr int C4 = N / 4;       // float4 per step row
  static_assert(T * C4 == PF * NT, "chunk load must tile the block");
  __shared__ __align__(16) float sR[T][N];
  __shared__ __align__(16) float sK[T][N];
  __shared__ __align__(16) float sW[T][N];
  __shared__ __align__(16) float sV[T][N];
  __shared__ __align__(16) float sO[T][N];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int part = lane & (PARTS - 1);
  const int j = (tid >> 5) * 8 + (lane >> 2);     // value column
  const size_t row = (size_t)nh * N;             // elements per step
  const size_t base = (size_t)b * S * row + (size_t)h * N;

  // this thread's state rows: float4 groups q = part + 4m, rows 4q..4q+3
  float st[G][4], uu[G][4];
#pragma unroll
  for (int m = 0; m < G; ++m) {
    const float4 u4 =
        *reinterpret_cast<const float4*>(u + (size_t)h * N + 4 * (part + 4 * m));
    uu[m][0] = u4.x; uu[m][1] = u4.y; uu[m][2] = u4.z; uu[m][3] = u4.w;
#pragma unroll
    for (int c = 0; c < 4; ++c) st[m][c] = 0.f;
  }

  float4 pr[PF], pk[PF], pv[PF], pw[PF];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int idx = tid + p * NT, tt = idx / C4, c4 = idx % C4;
      const int t = t0 + tt;
      if (t < S) {
        const size_t off = base + (size_t)t * row + 4 * c4;
        pr[p] = *reinterpret_cast<const float4*>(r + off);
        pk[p] = *reinterpret_cast<const float4*>(k + off);
        pv[p] = *reinterpret_cast<const float4*>(v + off);
        pw[p] = *reinterpret_cast<const float4*>(w + off);
      } else {
        pr[p] = pk[p] = pv[p] = make_float4(0.f, 0.f, 0.f, 0.f);
        pw[p] = make_float4(1.f, 1.f, 1.f, 1.f);
      }
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += T) {
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int idx = tid + p * NT, tt = idx / C4, c4 = idx % C4;
      *reinterpret_cast<float4*>(&sR[tt][4 * c4]) = pr[p];
      *reinterpret_cast<float4*>(&sK[tt][4 * c4]) = pk[p];
      *reinterpret_cast<float4*>(&sV[tt][4 * c4]) = pv[p];
      *reinterpret_cast<float4*>(&sW[tt][4 * c4]) = pw[p];
    }
    __syncthreads();
    if (t0 + T < S) fetch(t0 + T);
    const int steps = S - t0 < T ? S - t0 : T;
    for (int tt = 0; tt < steps; ++tt) {
      const float vj = sV[tt][j];
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int m = 0; m < G; ++m) {
        const int i0 = 4 * (part + 4 * m);
        const float4 r4 = *reinterpret_cast<const float4*>(&sR[tt][i0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sK[tt][i0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sW[tt][i0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kk[c] * vj;
          const float a = rr[c] * fmaf(uu[m][c], kv, st[m][c]);
          if (c & 1) acc1 += a; else acc0 += a;
          st[m][c] = fmaf(ww[c], st[m][c], kv);
        }
      }
      float acc = acc0 + acc1;
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) sO[tt][j] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int idx = tid + p * NT, tt = idx / C4, c4 = idx % C4;
      const int t = t0 + tt;
      if (t < S)
        *reinterpret_cast<float4*>(o + base + (size_t)t * row + 4 * c4) =
            *reinterpret_cast<const float4*>(&sO[tt][4 * c4]);
    }
  }
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, float* o, int B, int S,
                   int nh, cudaStream_t stream) {
  dim3 grid(nh, B);
  wkv6_kernel<N><<<grid, N * PARTS, 0, stream>>>(r, k, v, w, u, o, S, nh);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w (B,S,nh,N) f32 contiguous, 16-byte aligned; u (nh,N) f32
// contiguous; o (B,S,nh,N) f32 contiguous. N in {16, 32, 64}. Returns
// cudaGetLastError().
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* o, int B, int S,
                        int nh, int N, void* stream) {
  auto* rf = static_cast<const float*>(r);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* wf = static_cast<const float*>(w);
  auto* uf = static_cast<const float*>(u);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16:
      return launch<16>(rf, kf, vf, wf, uf, of, B, S, nh, st);
    case 32:
      return launch<32>(rf, kf, vf, wf, uf, of, B, S, nh, st);
    case 64:
      return launch<64>(rf, kf, vf, wf, uf, of, B, S, nh, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
