"""nn_search: top-1 L2 search over the device embedding table.

Replaces the TPU kernel ``src/repro/kernels/nn_search/kernel.py``
(``nn_search_kernel``, body ``_nn_kernel``) and ``ops.py::nn_search``.
Hand-written CUDA C++ for ``sm_90a``: ``csrc/nn_search.cu`` (split-N
partial argmins plus a lexicographic reduction; bound and design in that
file's header).

On CPU tensors the plain version (``ref.py``) runs; on CUDA tensors the
kernel launches or the call raises. ``nn_search.launches`` counts
kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.nn_search.ref import nn_search_ref

_TILE_ROWS = 32      # csrc/nn_search.cu TN: splits are whole tiles
_QUERIES = 32        # csrc/nn_search.cu NQ
_MAX_DIM = 128


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_rows(B: int, N: int, n_sms: int) -> int:
    """Rows per block: enough splits for about two blocks per SM."""
    q_tiles = -(-B // _QUERIES)
    want = max(1, (2 * n_sms) // q_tiles)
    rows = -(-N // want)
    return max(_TILE_ROWS, -(-rows // _TILE_ROWS) * _TILE_ROWS)


def _launch(q, db, db_norms):
    B, dim = q.shape
    N = db.shape[0]
    dev = q.device
    if db.shape[1] != dim or dim > _MAX_DIM or B < 1 or N < 1:
        raise ValueError(f"nn_search kernel takes q (B,dim), db (N,dim) with "
                         f"dim <= {_MAX_DIM}: {tuple(q.shape)} "
                         f"{tuple(db.shape)}")
    tensors = [q, db] + ([db_norms] if db_norms is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("nn_search kernel takes f32 operands")
    if any(t.device != dev for t in tensors):
        raise ValueError("nn_search operands must share one device")
    if db_norms is not None and tuple(db_norms.shape) != (N,):
        raise ValueError(f"db_norms must be ({N},), got "
                         f"{tuple(db_norms.shape)}")
    q, db = q.contiguous(), db.contiguous()
    if db_norms is not None:
        db_norms = db_norms.contiguous()
    rows = split_rows(B, N, _n_sms(dev.index or 0))
    n_split = -(-N // rows)
    part_d = torch.empty((n_split, B), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_split, B), dtype=torch.int32, device=dev)
    out_d = torch.empty((B,), dtype=torch.float32, device=dev)
    out_i = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nn_search_f32(
            q.data_ptr(), db.data_ptr(),
            db_norms.data_ptr() if db_norms is not None else None,
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), B, N, dim, rows, n_split, stream)
    build.check(err, "nn_search")
    return out_d, out_i


def nn_search(q, db, *, db_norms=None):
    """Top-1 L2 over the DB. Returns (squared_dists (B,) f32, idx (B,)
    int32). ``db_norms`` (N,) f32 carries precomputed per-row ‖d‖²."""
    if q.device.type == "cpu":
        return nn_search_ref(q, db, db_norms)
    if q.device.type != "cuda":
        raise ValueError(f"nn_search runs on cpu or cuda tensors, not "
                         f"{q.device}")
    out = _launch(q, db, db_norms)
    nn_search.launches += 1
    return out


nn_search.launches = 0
