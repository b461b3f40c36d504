// Per-quantum three-way branch on a device hit mask, as CUDA-graph
// conditional nodes (CUDA 12.4+), for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the port's counterpart of the
// reference's nested jax.lax.cond in src/repro/core/engine.py
// (_layer_fused's and _layer_fused_prefill's `bucketed`): per quantum of
// a hit-first batch, n_hit == size -> all_hit, else n_hit == 0 ->
// all_miss, else mixed. XLA branches on the device scalar; eager
// PyTorch would need a host read of n_hit, a sync per quantum per layer.
// Here the branch is taken on the card:
// * the caller captures each (quantum, branch) body as an ordinary
//   PyTorch CUDA graph (allocations in the engine's graph pool, as any
//   capture), reading and writing fixed buffers;
// * graph_cond_build makes one parent graph: a one-block kernel node
//   that counts each quantum's hits and sets three conditional handles
//   per quantum with cudaGraphSetConditional, then 3 * nq IF nodes in a
//   chain (quanta share scratch in the pool, so they run in turn), each
//   IF body holding its branch graph as a child graph node. Exactly one
//   IF of each quantum is true; the other two cost an empty conditional.
// A body is captured whole by PyTorch and cloned into the IF body, not
// captured into it with cudaStreamBeginCaptureToGraph: PyTorch's
// allocator sends a capture's allocations to the graph pool only for
// streams of that capture's id, and a stream capturing into a body graph
// has another id, so its tensors would come from the ordinary pool and
// be handed out again while the graph still uses them.
// Bound: the set kernel reads B bytes and is launch-bound (one block);
// the branch bodies are the attention the quanta run.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_QUANTA = 64;

struct Handles {
  cudaGraphConditionalHandle h[3 * MAX_QUANTA];
};

__global__ void graph_cond_set_kernel(const unsigned char* hit, int B,
                                      int nq, Handles hs) {
  const int g = threadIdx.x;
  if (g >= nq) return;
  const int qs = B / nq;
  int n = 0;
  for (int i = g * qs; i < (g + 1) * qs; ++i) n += hit[i] != 0;
  cudaGraphSetConditional(hs.h[3 * g + 0], n == qs ? 1u : 0u);
  cudaGraphSetConditional(hs.h[3 * g + 1], n == 0 ? 1u : 0u);
  cudaGraphSetConditional(hs.h[3 * g + 2], (n != qs && n != 0) ? 1u : 0u);
}

}  // namespace

// hit: (B,) bool on the card, read at every launch of the graph. bodies:
// 3 * nq cudaGraph_t, (all_hit, all_miss, mixed) of quantum 0, then of
// quantum 1, ...; each is cloned, so the caller keeps ownership. Writes
// the instantiated parent and its graph; returns a cudaError_t.
extern "C" int graph_cond_build(const void* hit, int B, int nq,
                                void* const* bodies, void** exec_out,
                                void** graph_out) {
  if (nq < 1 || nq > MAX_QUANTA || B < nq || B % nq != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t parent = nullptr;
  cudaError_t e = cudaGraphCreate(&parent, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  Handles hs = {};
  for (int k = 0; k < 3 * nq && e == cudaSuccess; ++k)
    e = cudaGraphConditionalHandleCreate(&hs.h[k], parent, 0,
                                         cudaGraphCondAssignDefault);
  cudaGraphNode_t prev = nullptr;
  if (e == cudaSuccess) {
    const unsigned char* hit_p = static_cast<const unsigned char*>(hit);
    void* args[] = {&hit_p, &B, &nq, &hs};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(graph_cond_set_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(MAX_QUANTA);
    kp.kernelParams = args;
    e = cudaGraphAddKernelNode(&prev, parent, nullptr, 0, &kp);
  }
  for (int k = 0; k < 3 * nq && e == cudaSuccess; ++k) {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = hs.h[k];
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    cudaGraphNode_t node = nullptr;
    e = cudaGraphAddNode(&node, parent, &prev, 1, &cp);
    if (e == cudaSuccess && bodies[k] != nullptr) {
      cudaGraphNode_t child = nullptr;
      e = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                     nullptr, 0,
                                     static_cast<cudaGraph_t>(bodies[k]));
    }
    prev = node;
  }
  cudaGraphExec_t exec = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, parent, 0);
  if (e != cudaSuccess) {
    cudaGraphDestroy(parent);
    return static_cast<int>(e);
  }
  *exec_out = exec;
  *graph_out = parent;
  return 0;
}

extern "C" int graph_cond_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int graph_cond_destroy(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = e2;
  }
  return static_cast<int>(e);
}
