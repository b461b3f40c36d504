"""flash_attention: forward attention with causal / sliding-window masks
and GQA.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_bhsd``, body ``_flash_kernel``) and its wrapper
``ops.py::flash_attention``. Hand-written CUDA C++ for ``sm_90a``:
``csrc/flash_attention.cu``, whose online-softmax tiles
``memo_attention``'s miss branch shares: ``csrc/attention_wgmma.cuh``
(wgmma) at head_dim 112 and 128, ``csrc/attention_tile.cuh`` (mma.sync)
at the other widths.

Contract (the JAX layout): q (B,S,H,dh), k/v (B,S,Hkv,dh) → (B,S,H,dh),
``causal``, ``window``; query head h reads kv head h // (H/Hkv). The
kernel takes f32 and head_dim in {16, 32, 64, 112, 128, 256} (any other
head_dim raises) and reads q/k/v by their strides. Its 16-byte
asynchronous copies need a contiguous last dim, a 16-byte-aligned base and batch/seq/head strides that are multiples of 4
elements; a view that has not is copied to a fresh contiguous tensor
first (a layout copy: the kernel still runs).

On CPU tensors the plain version (``ref.py``) runs; on CUDA tensors the
kernel launches or the call raises. ``flash_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DH = (16, 32, 64, 112, 128, 256)


def _async_readable(t) -> bool:
    """Whether the kernel's 16-byte cp.async can read ``t`` as it lies:
    unit last stride, aligned base, other strides multiples of 16 bytes."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:3]))


def _launch(q, k, v, causal, window):
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    if dh not in _DH:
        raise ValueError(f"flash_attention kernel takes head_dim in {_DH}, "
                         f"got {dh}")
    if k.shape != (B, S, Hkv, dh) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"bad q/k/v shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention kernel takes f32 {name}, got "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError("flash_attention operands must share one "
                             "device")
    q, k, v = (t if _async_readable(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    strides = (ctypes.c_int64 * 9)(*(s for t in (q, k, v)
                                     for s in t.stride()[:3]))
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    if S == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, Hkv, dh, strides, int(causal), int(window is not None),
            int(window or 0), ctypes.c_float(dh ** -0.5), stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=None):
    """Full-sequence attention (see module doc)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not "
                         f"{q.device}")
    refuse_grad("flash_attention", q, k, v)
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0


def resources(dh: int) -> dict:
    """The kernel at head_dim ``dh`` as the CUDA runtime reports it for
    this card: resident blocks per SM, registers per thread, local (spill)
    bytes, dynamic shared bytes and threads of a block, blocks of a
    cluster (1 where blocks form none) and clusters resident at once (0
    there)."""
    out = (ctypes.c_int * 7)()
    build.check(build.library().flash_attention_resources(
        dh, ctypes.addressof(out)), "flash_attention resources")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "shared_bytes", "threads", "cluster",
                     "max_active_clusters"), out))
