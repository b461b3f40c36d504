"""The device branch of the fast path: the port's counterpart of the
reference's nested ``jax.lax.cond`` over a quantum's hit count
(``core/engine.py``'s ``bucketed``, in ``_layer_fused`` and
``_layer_fused_prefill``). This module is the only place that knows how
such a branch is taken.

A batch sorted hit-first is cut into ``nq`` quanta of equal rows; each
quantum runs one of three bodies, chosen as the reference nests its
conds: ``n_hit == size`` → ``all_hit``, else ``n_hit == 0`` →
``all_miss``, else ``mixed`` (``branch_of``).

* On a CPU tensor the predicate is read with a Python ``if``: a CPU read
  costs no sync. The CPU tests run this.
* On a CUDA tensor the branch is taken on the card, with no host read:
  each (quantum, branch) body is captured once as a PyTorch CUDA graph
  over fixed buffers, and ``csrc/graph_cond.cu`` puts the bodies under
  CUDA-graph conditional (IF) nodes behind a kernel that counts each
  quantum's hits and sets the conditionals. A replay copies the batch
  into the fixed inputs, launches that graph on the current stream and
  copies the outputs out. There is no other path on the card: a missing
  facility raises.

``GraphCache`` holds one engine's captured sites, keyed by ``site_key``:
the site's static description and the device addresses of the weights
its bodies read (a graph reads them by address, so a moved weight must
never replay a stale graph: the site is captured anew and the stale one
dropped). All sites share one memory pool and one set of fixed buffers
per shape; a lock and an event order their replays, so a server's
worker and a caller of ``infer`` never share fixed buffers at once.
"""
from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable, Optional, Sequence

import torch

BRANCHES = ("all_hit", "all_miss", "mixed")


def branch_of(n_hit: int, size: int) -> int:
    """Index into ``BRANCHES`` of a quantum with ``n_hit`` hits of
    ``size`` rows, nested as the reference's ``lax.cond``s are."""
    if n_hit == size:
        return 0
    return 1 if n_hit == 0 else 2


def n_quanta(device_quanta: int, B: int) -> int:
    """The reference's ``nq``: quanta must tile the batch, else one
    whole-batch quantum."""
    return (device_quanta if 1 < device_quanta <= B
            and B % device_quanta == 0 else 1)


def quantum_branches(hit_sorted: Sequence[bool], nq: int) -> list:
    """Host bookkeeping: the branch each quantum of a hit-first ``hit``
    takes (tests and measurements; the serving path never calls it)."""
    hit_sorted = [bool(h) for h in hit_sorted]
    qs = len(hit_sorted) // nq
    return [branch_of(sum(hit_sorted[g * qs:(g + 1) * qs]), qs)
            for g in range(nq)]


def site_key(slot, spec, weights: Sequence[torch.Tensor]) -> tuple:
    """A site's cache key: its ``slot`` (layer and site name), its static
    ``spec`` (kinds, shapes, quanta, dtypes, codec: what the reference's
    jit key holds) and the addresses of the weights its bodies read."""
    return (slot, spec, tuple(int(w.data_ptr()) for w in weights))


def _tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _rows(t: Optional[torch.Tensor], sl: slice):
    return None if t is None else t[sl]


def run_quanta(hit: torch.Tensor, nq: int,
               branches: Sequence[Callable], operands: Sequence,
               *, cache: Optional["GraphCache"] = None,
               key: Optional[tuple] = None) -> tuple:
    """Per quantum ``g`` of ``nq`` equal row ranges of a (hit-first)
    batch: ``branches[branch_of(sum(hit_g), size)](*operands_g)``, where
    ``operands_g`` slices every operand (``None`` passes through) to the
    quantum's rows. Each body returns a tensor or a tuple of tensors with
    rows first; returns the tuple of outputs, quanta concatenated.

    On a CUDA tensor the branch is taken on the card through ``cache``
    under ``key`` (``site_key``); both are required there."""
    if hit.device.type != "cuda":
        B = hit.shape[0]
        qs = B // nq
        outs = []
        for g in range(nq):
            sl = slice(g * qs, (g + 1) * qs)
            b = branch_of(int(hit[sl].sum()), qs)
            outs.append(_tuple(branches[b](*(_rows(o, sl)
                                             for o in operands))))
        if nq == 1:
            return outs[0]
        return tuple(torch.cat(parts, 0) for parts in zip(*outs))
    if cache is None or key is None:
        raise RuntimeError(
            "run_quanta on a CUDA tensor takes its branch on the card "
            "through a GraphCache and a site key")
    return cache.run(key, hit, nq, branches, operands)


run_quanta.launches = 0


def _library():
    from repro_torch.kernels import build
    return build.library()


# One capture stream a device, shared by every engine's cache, and a lock
# that lets one capture use it at a time: each new stream would keep
# cuBLAS workspaces of its own for the life of the process.
_CAPTURE_STREAMS: dict = {}
_CAPTURE_LOCK = threading.Lock()


def _capture_stream(dev: torch.device):
    s = _CAPTURE_STREAMS.get(dev.index)
    if s is None:
        s = _CAPTURE_STREAMS[dev.index] = torch.cuda.Stream(device=dev)
    return s


def _check_facilities() -> None:
    """Raise, naming it, when the card path lacks what it needs."""
    if not hasattr(torch.cuda, "CUDAGraph") \
            or not hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"):
        raise RuntimeError(
            "the device branch needs torch.cuda.CUDAGraph(keep_graph=True)"
            ".raw_cuda_graph() to place captured bodies under conditional "
            "nodes; this PyTorch has no raw_cuda_graph")
    major, minor = (int(p) for p in torch.version.cuda.split(".")[:2])
    if (major, minor) < (12, 4):
        raise RuntimeError(
            f"CUDA-graph conditional nodes need CUDA 12.4 or later; this "
            f"PyTorch was built for CUDA {torch.version.cuda}")


class _Site:
    """One captured branch site: the (quantum, branch) body graphs, the
    conditional parent graph over them, and its fixed buffers."""

    def __init__(self, statics_in, hit_static, statics_out, bodies, exec_,
                 graph):
        self.statics_in = statics_in
        self.hit_static = hit_static
        self.statics_out = statics_out
        self.bodies = bodies           # torch CUDAGraphs, kept alive
        self.exec = exec_
        self.graph = graph

    def close(self) -> None:
        if self.exec is not None:
            _library().graph_cond_destroy(self.exec, self.graph)
            self.exec = self.graph = None
        self.bodies = []

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter teardown: the library may be gone
            pass


class GraphCache:
    """One engine's captured branch sites (see the module docstring)."""

    def __init__(self):
        self.lock = threading.Lock()
        self._sites: dict = {}
        self._buffers: dict = {}
        self._pool = None
        self._done = None
        self.capture_seconds = 0.0
        self.captures = 0

    def __len__(self):
        return len(self._sites)

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in this cache's graph pool."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) ==
                   tuple(self._pool))

    def buffer_bytes(self) -> int:
        """Bytes of the fixed input and output buffers."""
        return sum(t.numel() * t.element_size()
                   for ts in self._buffers.values() for t in ts
                   if t is not None)

    # -- capture ----------------------------------------------------------
    def _buffer(self, tag, like: Sequence[Optional[torch.Tensor]]):
        """Fixed buffers shaped like ``like``, shared by every site of the
        same shapes (sites replay one at a time)."""
        sig = (tag,) + tuple(None if t is None else (tuple(t.shape), t.dtype)
                             for t in like)
        bufs = self._buffers.get(sig)
        if bufs is None:
            bufs = self._buffers[sig] = tuple(
                None if t is None else torch.empty_like(
                    t, memory_format=torch.contiguous_format)
                for t in like)
        return bufs

    def _capture(self, hit, nq, branches, operands) -> _Site:
        _check_facilities()
        lib = _library()
        t0 = time.perf_counter()
        dev = hit.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(dev)
        statics_in = self._buffer("in", operands)
        (hit_static,) = self._buffer("hit", (hit,))
        for s, o in zip(statics_in, operands):
            if s is not None:
                s.copy_(o)
        hit_static.copy_(hit)
        B = hit.shape[0]
        qs = B // nq
        quanta = [tuple(_rows(s, slice(g * qs, (g + 1) * qs))
                        for s in statics_in) for g in range(nq)]
        side = _capture_stream(dev)
        with _CAPTURE_LOCK, torch.cuda.stream(side):
            side.wait_stream(cur)
            # warm-up: every body once, eagerly, on the capture stream
            # (cuBLAS handles and workspaces, lazy inits): a capture
            # records only, so a body that never ran might not capture
            warm = [_tuple(f(*quanta[0])) for f in branches]
            statics_out = self._buffer(
                "out", tuple(torch.empty((B,) + tuple(o.shape[1:]),
                                         dtype=o.dtype, device=dev)
                             for o in warm[0]))
            del warm
            bodies = []
            for g in range(nq):
                sl = slice(g * qs, (g + 1) * qs)
                for f in branches:
                    cg = torch.cuda.CUDAGraph(keep_graph=True)
                    cg.capture_begin(pool=self._pool,
                                     capture_error_mode="thread_local")
                    try:
                        outs = _tuple(f(*quanta[g]))
                        for s, o in zip(statics_out, outs):
                            s[sl].copy_(o)
                        del outs
                    finally:
                        cg.capture_end()
                    bodies.append(cg)
            cur.wait_stream(side)
        raw = (ctypes.c_void_p * len(bodies))(
            *[cg.raw_cuda_graph() for cg in bodies])
        exec_, graph = ctypes.c_void_p(), ctypes.c_void_p()
        err = lib.graph_cond_build(hit_static.data_ptr(), B, nq, raw,
                                   ctypes.byref(exec_), ctypes.byref(graph))
        if err != 0:
            raise RuntimeError(
                f"graph_cond_build failed: cudaError {err} "
                f"{lib.kernels_error_string(err).decode()}")
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        return _Site(statics_in, hit_static, statics_out, bodies,
                     exec_.value, graph.value)

    # -- replay -----------------------------------------------------------
    def run(self, key, hit, nq, branches, operands) -> tuple:
        """Capture ``key``'s site on first use, then replay it: copy the
        batch in, launch the conditional graph on the current stream,
        copy the outputs out. All of it is device work."""
        from repro_torch.kernels import build
        with self.lock:
            site = self._sites.get(key)
            cur = torch.cuda.current_stream(hit.device)
            if self._done is not None:
                cur.wait_event(self._done)
            if site is None:
                stale = [k for k in self._sites
                         if k[0] == key[0] and k[2] != key[2]]
                for k in stale:          # a weight moved: never replay
                    self._sites.pop(k).close()
                site = self._sites[key] = self._capture(
                    hit, nq, branches, operands)
            else:
                for s, o in zip(site.statics_in, operands):
                    if s is not None:
                        s.copy_(o)
                site.hit_static.copy_(hit)
            build.check(_library().graph_cond_launch(site.exec,
                                                     cur.cuda_stream),
                        "graph_cond")
            run_quanta.launches += 1
            outs = tuple(s.clone() for s in site.statics_out)
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(cur)
            return outs
