"""Index database — search over hidden-state embeddings (paper §5.3),
the counterpart of the reference's ``core/index.py``.

* ``ExactIndex``  — exact batched L2 top-k on the host (numpy staging,
                    torch arithmetic on the CPU).
* ``DeviceIndex`` — the serving tier: the embedding table is a device
                    tensor and top-1 search goes through the ``nn_search``
                    kernel wrapper (the CUDA kernel on the card, its
                    plain version on the CPU).

Index rows are slot-aligned with the ``AttentionDB`` arena; dead and
slack rows hold ``TOMBSTONE``, a far-away finite value that can never win
a search yet keeps the matmul-form distance NaN-free. The clustered/IVF
layouts wait for a later slice.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.nn_search.ops import nn_search
from repro_torch.kernels.nn_search.ref import sq_dists

# sentinel coordinate for dead/slack index rows (see the reference)
TOMBSTONE = 1.0e6


def _grown(arr: Optional[np.ndarray], need: int, dim: int) -> np.ndarray:
    """Geometric numpy growth with TOMBSTONE-filled slack."""
    cap = 0 if arr is None else arr.shape[0]
    if need <= cap:
        return arr
    new_cap = max(need, 2 * cap, 8)
    out = np.full((new_cap, dim), TOMBSTONE, np.float32)
    if arr is not None and cap:
        out[:cap] = arr
    return out


def _row_norms(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(t * t, dim=-1)


def _top1(d2: torch.Tensor):
    idx = torch.argmin(d2, -1)
    return d2.gather(1, idx[:, None]), idx[:, None]


class ExactIndex:
    def __init__(self, dim: int):
        self.dim = dim
        self._embs: Optional[np.ndarray] = None

    def __len__(self):
        return 0 if self._embs is None else self._embs.shape[0]

    def assign(self, slots: Sequence[int], embs: np.ndarray):
        """Slot-aligned write (admission into recycled or fresh slots)."""
        slots = np.asarray(slots).reshape(-1)
        if slots.size == 0:
            return
        self._embs = _grown(self._embs, int(slots.max()) + 1, self.dim)
        self._embs[slots] = np.asarray(embs, np.float32)

    def remove(self, slots: Sequence[int]):
        """Tombstone slots: they keep their row (slot ids stay stable)."""
        slots = np.asarray(slots).reshape(-1)
        if slots.size and self._embs is not None:
            self._embs[slots] = TOMBSTONE

    def search(self, q, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """q: (B, dim) → (dists (B,k) L2, idx (B,k)) as numpy."""
        d2 = sq_dists(torch.as_tensor(np.asarray(q, np.float32)),
                      torch.from_numpy(self._embs))
        if k == 1:
            dist, idx = _top1(d2)
        else:
            neg, idx = torch.topk(-d2, k, dim=-1)
            dist = -neg
        return (np.sqrt(np.maximum(dist.numpy(), 0.0)), idx.numpy())


class DeviceIndex:
    """Device-resident exact top-k index — the serving tier.

    The table is preallocated (slack rows are TOMBSTONE) and lives on
    ``device``; ``search_device`` is device-only tensor work, so the
    engine's per-layer lookup never synchronizes with the host. Every
    mutation is copy-on-write (the reference's functional ``.at[].set``):
    it swaps in a fresh table, so a ``search_args`` pair a snapshot
    captured never changes."""

    def __init__(self, dim: int, *, capacity: int = 0, device=None):
        self.dim = dim
        self.device = torch.device(device if device is not None else "cpu")
        self._table: Optional[torch.Tensor] = None
        self._norms: Optional[torch.Tensor] = None   # cached per generation
        self._n = 0
        self.transfer_bytes = 0
        if capacity:
            self._ensure_capacity(capacity)

    def __len__(self):
        return self._n

    @property
    def capacity(self) -> int:
        return 0 if self._table is None else self._table.shape[0]

    @property
    def table(self) -> torch.Tensor:
        """The full preallocated table (slack rows are TOMBSTONE)."""
        return self._table

    @property
    def _embs(self):
        return None if self._table is None else (
            self._table[: self._n].cpu().numpy())

    def _ensure_capacity(self, need: int):
        cap = self.capacity
        if need <= cap:
            return
        new_cap = max(need, 2 * cap, 8)
        table = torch.full((new_cap, self.dim), TOMBSTONE,
                           dtype=torch.float32, device=self.device)
        if self._n:
            table[: self._n] = self._table[: self._n]
        self._table = table
        self._norms = None
        self.transfer_bytes += self._n * self.dim * 4   # prefix re-upload

    def add(self, embs):
        embs = torch.as_tensor(np.asarray(embs, np.float32)).to(self.device)
        b = embs.shape[0]
        self._ensure_capacity(self._n + b)
        rows = torch.arange(self._n, self._n + b, device=self.device)
        self._table = self._table.index_copy(0, rows, embs)
        self._norms = None
        self._n += b
        self.transfer_bytes += int(embs.nbytes)

    def assign(self, slots: Sequence[int], embs):
        """Slot-aligned delta write into a fresh table (copy-on-write,
        see ``DeviceDB.update``)."""
        from repro_torch.core.database import pad_delta_pow2
        slots = np.asarray(slots).reshape(-1)
        if slots.size == 0:
            return
        n_max = int(slots.max())
        self._ensure_capacity(n_max + 1)
        slots, values = pad_delta_pow2(slots, np.asarray(embs, np.float32))
        self._table = self._table.index_copy(
            0, torch.from_numpy(slots.astype(np.int64)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(values)).to(self.device))
        self._norms = None
        self._n = max(self._n, n_max + 1)
        self.transfer_bytes += int(values.nbytes + slots.size * 4)

    def remove(self, slots: Sequence[int]):
        """Tombstone slots in a fresh table (copy-on-write)."""
        from repro_torch.core.database import pad_delta_pow2
        slots = np.asarray(slots).reshape(-1)
        if slots.size and self._table is not None:
            slots, _ = pad_delta_pow2(slots)
            self._table = self._table.index_fill(
                0, torch.from_numpy(slots.astype(np.int64)).to(self.device),
                TOMBSTONE)
            self._norms = None
            self.transfer_bytes += int(slots.size * 4)

    @property
    def norms(self) -> Optional[torch.Tensor]:
        """Cached per-row squared norms ‖d‖² of the FULL table, computed
        once per mutation generation."""
        if self._norms is None and self._table is not None:
            self._norms = _row_norms(self._table)
        return self._norms

    @property
    def search_args(self):
        """``(table, row_norms)``: what ``search_device`` consumes — a
        StoreSnapshot freezes the pair at publish."""
        return (self._table, self.norms)

    def search_device(self, q, k: int = 1, *, args=None, fused: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """q: (B, dim) device tensor → (sq_dists (B, k), idx (B, k)) —
        SQUARED L2. ``args`` is the ``search_args`` pair a snapshot
        captured (the serving path always passes it); ``None`` searches
        the current table. Top-1 goes through the nn_search kernel
        wrapper; ``fused=True`` is the reference's kernel-mode prologue
        contract (one matmul with the cached norms, no search kernel)."""
        table, norms = args if args is not None else self.search_args
        q = q.float()
        if k == 1:
            if fused:
                d2, idx = _top1(sq_dists(q, table, norms))
                return d2, idx.to(torch.int32)
            d2, idx = nn_search(q, table, db_norms=norms)
            return d2[:, None], idx[:, None]
        neg, idx = torch.topk(-sq_dists(q, table, norms), k, dim=-1)
        return -neg, idx.to(torch.int32)

    def search(self, q, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Host-compat API, same contract as ExactIndex.search."""
        q = torch.as_tensor(np.asarray(q, np.float32)).to(self.device)
        d2, idx = self.search_device(q, k)
        return (np.sqrt(np.maximum(d2.cpu().numpy(), 0.0)),
                idx.cpu().numpy())


def _later(kind: str, slice_name: str):
    def factory(*_a, **_k):
        raise NotImplementedError(
            f"the {kind!r} index waits for the {slice_name} slice")
    return factory


from repro_torch.core.registry import DEVICE_INDEXES, HOST_INDEXES  # noqa: E402

HOST_INDEXES.register("exact", lambda dim, **_: ExactIndex(dim))
HOST_INDEXES.register("ivf", _later("ivf", "clustered/IVF index"))
HOST_INDEXES.register(
    "device", lambda dim, *, device=None, **_: DeviceIndex(dim, device=device))
DEVICE_INDEXES.register(
    "flat", lambda dim, *, capacity=0, device=None, **_:
    DeviceIndex(dim, capacity=capacity, device=device))
DEVICE_INDEXES.register("clustered",
                        _later("clustered", "clustered/IVF index"))
