"""nn_search: top-1 L2 search over the device embedding table.

Replaces the TPU kernel ``src/repro/kernels/nn_search/kernel.py``
(``nn_search_kernel``, body ``_nn_kernel``) and ``ops.py::nn_search``.
Hand-written CUDA C++ for ``sm_90a``: ``csrc/nn_search.cu``, one launch
per call — row ranges × query tiles, table tiles streamed through a
``cp.async`` ring, the cross-block top-1 reduced in the same kernel by a
64-bit ``atomicMin`` key and a ticket (bound and design in that file's
header). ``ref.py::nn_search_blocked_ref`` emulates that schedule.

On CPU tensors the plain version (``ref.py``) runs; on CUDA tensors the
kernel launches or the call raises. ``nn_search.launches`` counts
kernel launches (one per call).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.nn_search.ref import nn_search_ref

TILE_ROWS = 64       # csrc/nn_search.cu TN: ranges are whole tiles
QUERY_TILE = 32      # csrc/nn_search.cu NQ
BLOCKS_PER_SM = 2    # csrc/nn_search.cu MIN_BLOCKS (85 KB shared each)
_MAX_DIM = 128

# The kernel's cross-block workspace, per (device index, stream handle):
# (keys (cap,) int64 all ones, tickets (ceil(cap / 32),) int32 zero). The
# kernel leaves both so on exit, so calls on one stream share it and it
# is initialised only when it grows; another stream gets its own.
_WORKSPACE: dict = {}


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_ranges(B: int, N: int, n_sms: int) -> int:
    """Row ranges per query tile: enough blocks to fill every SM
    ``BLOCKS_PER_SM`` deep, and no more ranges than ``TILE_ROWS``-row
    tiles (a range is whole tiles)."""
    n_tiles = -(-N // TILE_ROWS)
    q_tiles = -(-B // QUERY_TILE)
    return max(1, min(n_tiles, (BLOCKS_PER_SM * n_sms) // q_tiles))


def _workspace(dev: torch.device, stream: int, B: int):
    """The (keys, tickets) of this device and stream, grown to ``B``
    queries: allocated and initialised only when it grows."""
    ws = _WORKSPACE.get((dev.index, stream))
    if ws is None or ws[0].numel() < B:
        keys = torch.full((B,), -1, dtype=torch.int64, device=dev)
        tickets = torch.zeros((-(-B // QUERY_TILE),), dtype=torch.int32,
                              device=dev)
        ws = _WORKSPACE[(dev.index, stream)] = (keys, tickets)
    return ws


def _launch(q, db, db_norms):
    B, dim = q.shape
    N = db.shape[0]
    dev = q.device
    if db.shape[1] != dim or not 1 <= dim <= _MAX_DIM or B < 1 or N < 1:
        raise ValueError(f"nn_search kernel takes q (B,dim), db (N,dim) with "
                         f"1 <= dim <= {_MAX_DIM}, B, N >= 1: "
                         f"{tuple(q.shape)} {tuple(db.shape)}")
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
    vec4 = dim % 4 == 0 and q.data_ptr() % 16 == 0 and db.data_ptr() % 16 == 0
    n_ranges = split_ranges(B, N, _n_sms(dev.index or 0))
    out_d = torch.empty((B,), dtype=torch.float32, device=dev)
    out_i = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        keys, tickets = _workspace(dev, stream, B)
        err = lib.nn_search_f32(
            q.data_ptr(), db.data_ptr(),
            db_norms.data_ptr() if db_norms is not None else None,
            keys.data_ptr(), tickets.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), B, N, dim, n_ranges, int(vec4), stream)
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
    # a search has no gradient in either package: its inputs go detached
    out = _launch(q.detach(), db.detach(),
                  None if db_norms is None else db_norms.detach())
    nn_search.launches += 1
    return out


nn_search.launches = 0


def resources() -> dict:
    """Per build of the kernel (``vec4``: 16-byte copies; ``scalar``:
    4-byte copies for dim % 4 != 0 or unaligned rows): resident blocks
    per SM, registers per thread, local (spill) bytes and dynamic shared
    bytes per block, as the CUDA runtime reports them for this card."""
    out = (ctypes.c_int * 8)()
    build.check(build.library().nn_search_resources(ctypes.addressof(out)),
                "nn_search resources")
    return {kind: dict(blocks_per_sm=out[4 * i], registers=out[4 * i + 1],
                       local_bytes=out[4 * i + 2], shared_bytes=out[4 * i + 3])
            for i, kind in enumerate(("vec4", "scalar"))}
