"""memo_attention: the fused memoized-attention dispatch.

Replaces the TPU kernel ``src/repro/kernels/memo_attention/kernel.py``
(``memo_attention_bhsd``, body ``_memo_kernel``) and its wrapper
``ops.py::memo_attention``. Hand-written CUDA C++ for ``sm_90a``:
``csrc/memo_attention.cu`` (design, bound and what the design does
about it are in that file's header).

Contract (the JAX layout): q (B,S,H,dh), k/v (B,S,Hkv,dh), db (N,H,L,L)
f16 — or int8 codes with ``db_scales`` (N,H,L) f16 — hit_idx/hit (B,)
→ (B,S,H,dh). ``lengths`` (B,) masks padded keys of misses. The kernel
takes f32 q/k/v and head_dim in {16, 32, 64, 112, 128, 256}; any other
head_dim raises.

On CPU tensors the plain version (``ref.py``) runs; on CUDA tensors the
kernel launches or the call raises. ``memo_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.memo_attention.ref import memo_attention_ref

_DH = (16, 32, 64, 112, 128, 256)


def _launch(q, k, v, db_apm, hit_idx, hit, db_scales, lengths, causal,
            window):
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    dev = q.device
    if dh not in _DH:
        raise ValueError(f"memo_attention kernel takes head_dim in {_DH}, "
                         f"got {dh}")
    if k.shape != (B, S, Hkv, dh) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"bad q/k/v shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"memo_attention kernel takes f32 {name}, got "
                            f"{t.dtype}")
    N, Hd, L, L2 = db_apm.shape
    if Hd != H or L2 != L or N < 1:
        raise ValueError(f"db shape {tuple(db_apm.shape)} does not match "
                         f"{H} heads")
    if db_scales is not None:
        if db_apm.dtype != torch.int8 or db_scales.dtype != torch.float16 \
                or tuple(db_scales.shape) != (N, H, L):
            raise TypeError("int8 DB needs int8 codes and (N,H,L) f16 "
                            "scales")
        db_kind = 1
    elif db_apm.dtype == torch.float16:
        db_kind = 0
    else:
        raise TypeError(f"memo_attention kernel takes an f16 DB or int8 "
                        f"codes + scales, got {db_apm.dtype}")
    tensors = [q, k, v, db_apm, hit_idx, hit, lengths]
    if db_scales is not None:
        tensors.append(db_scales)
    if any(t.device != dev for t in tensors):
        raise ValueError("memo_attention operands must share one device")
    # the kernel's 16-byte asynchronous copies need aligned rows
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else
               t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    db_apm = db_apm.contiguous()
    hit_idx = hit_idx.to(torch.int32).contiguous()
    hit = hit.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if db_scales is not None:
        db_scales = db_scales.contiguous()
    out = torch.empty_like(q)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.memo_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), db_apm.data_ptr(),
            db_scales.data_ptr() if db_scales is not None else None,
            hit_idx.data_ptr(), hit.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, S, H, Hkv, dh, L, N, db_kind, int(causal),
            int(window is not None), int(window or 0),
            ctypes.c_float(dh ** -0.5), stream)
    build.check(err, "memo_attention")
    return out


def memo_attention(q, k, v, db_apm, hit_idx, hit, *, db_scales=None,
                   lengths=None, causal=True, window=None):
    """Memoized attention over a mixed hit/miss batch (see module doc)."""
    if q.device.type == "cpu":
        return memo_attention_ref(q, k, v, db_apm, hit_idx, hit,
                                  db_scales=db_scales, lengths=lengths,
                                  causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"memo_attention runs on cpu or cuda tensors, not "
                         f"{q.device}")
    refuse_grad("memo_attention", q, k, v, db_apm, db_scales)
    if lengths is None:
        lengths = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                             device=q.device)
    out = _launch(q, k, v, db_apm, hit_idx, hit, db_scales, lengths, causal,
                  window)
    memo_attention.launches += 1
    return out


memo_attention.launches = 0
