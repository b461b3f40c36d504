"""rwkv6: the RWKV-6 wkv recurrence from a zero state.

Replaces the TPU kernel ``src/repro/kernels/rwkv6/kernel.py``
(``wkv6_chunked_bhsn``, body ``_wkv_kernel``) and its wrapper
``ops.py::wkv6_chunked``. Hand-written CUDA C++ for ``sm_90a``:
``csrc/rwkv6.cu`` (design, bound and what the design does about it are
in that file's header). The kernel runs the sequential recurrence rather
than the chunked form, so it does not clamp w at 1e-12 as the TPU kernel
does: the two differ only where some w < 1e-12.

Contract (the JAX layout): r, k, v, w (B,S,nh,N), u (nh,N) →
o (B,S,nh,N). The kernel takes f32 and N in {16, 32, 64}.

On CPU tensors the plain version (``ref.py``) runs; on CUDA tensors the
kernel launches or the call raises. ``wkv6.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6.ref import wkv6_ref

_N = (16, 32, 64)


def _launch(r, k, v, w, u):
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
    lib = build.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_f32(*(t.data_ptr() for t in ts), o.data_ptr(), B, S,
                           nh, N, stream)
    build.check(err, "rwkv6")
    wkv6.launches += 1
    return o


def wkv6(r, k, v, w, u):
    """The wkv output from a zero state (see module doc)."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6 runs on cpu or cuda tensors, not "
                         f"{r.device}")
    return _launch(r, k, v, w, u)


wkv6.launches = 0
