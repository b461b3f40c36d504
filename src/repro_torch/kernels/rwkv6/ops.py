"""rwkv6: the RWKV-6 wkv recurrence from a zero state.

Replaces the TPU kernel ``src/repro/kernels/rwkv6/kernel.py``
(``wkv6_chunked_bhsn``, body ``_wkv_kernel``) and its wrapper
``ops.py::wkv6_chunked``. Hand-written CUDA C++ for ``sm_90a``:
``csrc/rwkv6.cu``. Its bound at rwkv6_3b's shape is bytes: r, k, v, w
read and o written once, 210 MB in f32, 0.063 ms at 3.35 TB/s.

A first design (one block per (b, h) walking all S steps, each lane
loading r, k, w for every state element it updates) was held by the
shared-memory pipe, and by the SMs that got two of its B * nh blocks.
So a thread now updates N/8 rows x 4 columns of the state, each loaded
value serving four columns, and the sequence is cut into
nc = ceil(S / chunk) chunks that run in parallel and spread the work
evenly over the SMs, with the sequential step's arithmetic (no w clamp,
no log, no exp: unlike the TPU's chunked form, the two differ only where
some w < 1e-12):

1. each chunk but the last, from a zero state: its end state U_c and its
   decay D_c = prod of w over the chunk (k, v, w only);
2. a scan over chunks, H_c = diag(D_c) H_{c-1} + U_c: the state entering
   chunk c + 1;
3. each chunk's outputs from the state entering it (r, k, v, w, u read
   and o written once).

One call is up to three CUDA launches: one when nc == 1 (``chunk >= S``,
one block per (b, h) walking all S steps), two when nc == 2, three
otherwise. The wrapper
allocates the scratch with ``torch.empty``: U (B, nh, nc-1, N, N) and
D (B, nh, nc-1, N) f32, (nc-1) * B * nh * N^2 * 4 bytes (8 MB at
rwkv6_3b's shape and the default chunk 256, 18 MB at 128, 39 MB at 64).
``chunk`` defaults to ``CHUNK``, the fastest in chip_smoke's sweep at
rwkv6_3b's shape (C = 64, 128, 256, S) on an H100.

Contract (the JAX layout): r, k, v, w (B,S,nh,N), u (nh,N) →
o (B,S,nh,N). The kernel takes f32 and N in {16, 32, 64}.

On CPU tensors the plain version (``ref.py::wkv6_ref``, the sequential
recurrence) runs whatever the chunk; ``ref.py::wkv6_chunked_schedule_ref``
emulates the kernel's schedule for tests. On CUDA tensors the kernel
launches or the call raises. ``wkv6.launches`` counts wrapper calls that
launched the kernel, one per call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.rwkv6.ref import wkv6_ref

_N = (16, 32, 64)
CHUNK = 256   # steps per chunk; see the module doc


def _launch(r, k, v, w, u, chunk):
    B, S, nh, N = r.shape
    if N not in _N:
        raise ValueError(f"rwkv6 kernel takes head size in {_N}, got {N}")
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (nh, N):
        raise ValueError(f"bad r/k/v/w/u shapes {tuple(r.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} "
                         f"{tuple(w.shape)} {tuple(u.shape)}")
    ts = [t.contiguous() for t in (r, k, v, w, u)]
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv6 kernel takes f32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError("rwkv6 operands must share one device")
        if t.data_ptr() % 16:
            raise ValueError("rwkv6 kernel reads 16-byte aligned tensors")
    o = torch.empty((B, S, nh, N), dtype=torch.float32, device=r.device)
    if B * S == 0:
        return o
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    states = decays = None
    if nc > 1:
        states = torch.empty((B, nh, nc - 1, N, N), dtype=torch.float32,
                             device=r.device)
        decays = torch.empty((B, nh, nc - 1, N), dtype=torch.float32,
                             device=r.device)
    lib = build.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_f32(*(t.data_ptr() for t in ts), o.data_ptr(),
                           None if states is None else states.data_ptr(),
                           None if decays is None else decays.data_ptr(),
                           B, S, nh, N, chunk, stream)
    build.check(err, "rwkv6")
    wkv6.launches += 1
    return o


def wkv6(r, k, v, w, u, *, chunk=CHUNK):
    """The wkv output from a zero state, the sequence cut into chunks of
    ``chunk`` steps on the card (see module doc)."""
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6 runs on cpu or cuda tensors, not "
                         f"{r.device}")
    refuse_grad("rwkv6", r, k, v, w, u)
    return _launch(r, k, v, w, u, chunk)


wkv6.launches = 0


def resources(N: int) -> dict:
    """Per phase (``states``, ``scan``, ``out``) of the kernel at head
    size ``N``: resident blocks per SM, registers per thread and local
    (spill) bytes, as the CUDA runtime reports them for this card."""
    import ctypes
    out = (ctypes.c_int * 9)()
    build.check(build.library().wkv6_resources(N, ctypes.addressof(out)),
                "rwkv6 resources")
    return {phase: dict(blocks_per_sm=out[i], registers=out[3 + i],
                        local_bytes=out[6 + i])
            for i, phase in enumerate(("states", "scan", "out"))}
