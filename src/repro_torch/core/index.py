"""Index database — search over hidden-state embeddings (paper §5.3),
the counterpart of the reference's ``core/index.py``.

* ``ExactIndex``  — exact batched L2 top-k on the host (numpy staging,
                    torch arithmetic on the CPU).
* ``IVFIndex``    — the host k-means coarse quantizer: exact search in the
                    ``nprobe`` nearest lists.
* ``DeviceIndex`` — the serving tier: the embedding table is a device
                    tensor and top-1 search goes through the ``nn_search``
                    kernel wrapper (the CUDA kernel on the card, its
                    plain version on the CPU).
* ``ClusteredDeviceIndex`` — the scale tier: an IVF layout of the device
                    table (k-means centroids, int8 packed clusters, an
                    exact-searched overflow buffer of later admissions),
                    searched by a chain of dense torch ops with no host
                    synchronization. The k-means rebuild is host work on
                    the sync boundary; its assignment products run on the
                    index's device.

Index rows are slot-aligned with the ``AttentionDB`` arena; dead and
slack rows hold ``TOMBSTONE``, a far-away finite value that can never win
a search yet keeps the matmul-form distance NaN-free.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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

    def add(self, embs: np.ndarray):
        embs = np.asarray(embs, np.float32)
        self._embs = (embs if self._embs is None
                      else np.concatenate([self._embs, embs], 0))

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


_KMEANS_ROWS = 1 << 18     # rows per assignment product (bounds its memory)


def _kmeans(x: np.ndarray, k: int, iters: int, seed: int, device=None):
    """Plain Lloyd k-means: (centroids (k, dim) f32, assignment (n,)
    int64), the reference's ``_kmeans`` with its assignment products on
    ``device`` (the CPU by default). Each centroid is the mean of its
    members in index order, as the reference's masked mean, here over
    one stable grouping per iteration instead of a mask per cluster."""
    n = x.shape[0]
    k = max(1, min(k, n))
    rng = np.random.default_rng(seed)
    cent = x[rng.choice(n, k, replace=False)].copy()
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def nearest(c):
        ct = torch.from_numpy(c).to(device)
        return torch.cat([torch.argmin(sq_dists(xt[i:i + _KMEANS_ROWS], ct),
                                       1)
                          for i in range(0, n, _KMEANS_ROWS)]).cpu().numpy()

    for _ in range(iters):
        assign = nearest(cent)
        order = np.argsort(assign, kind="stable")
        xs = x[order]
        ends = np.cumsum(np.bincount(assign, minlength=k))
        lo = 0
        for c in range(k):
            if ends[c] > lo:
                cent[c] = xs[lo:ends[c]].mean(0)
            lo = ends[c]
    return cent, nearest(cent)


class IVFIndex:
    """k-means coarse quantizer; lists stored as a padded dense array so
    the probe search stays one gather + one product (the reference's,
    numpy staging, torch arithmetic on the CPU)."""

    def __init__(self, dim: int, n_lists: int = 16, nprobe: int = 4,
                 kmeans_iters: int = 10, seed: int = 0):
        self.dim = dim
        self.n_lists = n_lists
        self.nprobe = min(nprobe, n_lists)
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self._embs: Optional[np.ndarray] = None
        self._built = False

    def __len__(self):
        return 0 if self._embs is None else self._embs.shape[0]

    def add(self, embs: np.ndarray):
        embs = np.asarray(embs, np.float32)
        self._embs = (embs if self._embs is None
                      else np.concatenate([self._embs, embs], 0))
        self._built = False

    def assign(self, slots: Sequence[int], embs: np.ndarray):
        slots = np.asarray(slots).reshape(-1)
        if slots.size == 0:
            return
        self._embs = _grown(self._embs, int(slots.max()) + 1, self.dim)
        self._embs[slots] = np.asarray(embs, np.float32)
        self._built = False

    def remove(self, slots: Sequence[int]):
        """Tombstoned rows land in (or become) a far-away cluster the
        coarse quantizer never probes for live queries."""
        slots = np.asarray(slots).reshape(-1)
        if slots.size and self._embs is not None:
            self._embs[slots] = TOMBSTONE
            self._built = False

    def _build(self):
        x = self._embs
        n = x.shape[0]
        k = min(self.n_lists, n)
        cent, assign = _kmeans(x, k, self.kmeans_iters, self.seed)
        k = cent.shape[0]
        cap = max(1, int(np.bincount(assign, minlength=k).max()))
        lists = np.full((k, cap), -1, np.int64)
        fill = np.zeros(k, np.int64)
        for i, c in enumerate(assign):
            lists[c, fill[c]] = i
            fill[c] += 1
        self._cent = cent
        self._lists = lists
        self._padded = np.where(lists[..., None] >= 0, x[lists.clip(0)],
                                np.inf).astype(np.float32)
        self._built = True

    def search(self, q, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        if not self._built:
            self._build()
        q = np.asarray(q, np.float32)
        B = q.shape[0]
        dc = sq_dists(torch.from_numpy(q),
                      torch.from_numpy(self._cent)).numpy()
        probes = np.argsort(dc, 1)[:, : self.nprobe]           # (B, nprobe)
        cand_ids = self._lists[probes].reshape(B, -1)          # (B, nprobe*cap)
        cand = self._padded[probes].reshape(B, -1, self.dim)
        diff = cand - q[:, None]
        d2 = np.where(np.isfinite(cand).all(-1),
                      np.einsum("bcd,bcd->bc", diff, diff), np.inf)
        order = np.argsort(d2, 1)[:, :k]
        dist = np.sqrt(np.maximum(np.take_along_axis(d2, order, 1), 0.0))
        idx = np.take_along_axis(cand_ids, order, 1)
        return dist, idx


class DeviceIndex:
    """Device-resident exact top-k index — the serving tier.

    The table is preallocated (slack rows are TOMBSTONE) and lives on
    ``device``; ``search_device`` is device-only tensor work, so the
    engine's per-layer lookup never synchronizes with the host. Every
    mutation is copy-on-write (the reference's functional ``.at[].set``):
    it swaps in a fresh table, so a ``search_args`` pair a snapshot
    captured never changes."""

    def __init__(self, dim: int, *, capacity: int = 0, device=None,
                 mesh=None):
        self.dim = dim
        self.device = torch.device(device if device is not None else "cpu")
        # a ``shard.StoreMesh``: top-1 then goes through
        # ``shard.mesh_search`` over a row-split copy of the table
        self.mesh = mesh
        self._split = None          # (table it was cut from, split copy)
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
        StoreSnapshot freezes the pair at publish. Under a mesh a third
        member is the row-split copy ``mesh_search`` searches, cut once
        per table generation."""
        if self.mesh is None:
            return (self._table, self.norms)
        return (self._table, self.norms, self._mesh_split(self._table))

    def _mesh_split(self, table):
        from repro_torch.core.shard import split_table
        if self._split is None or self._split[0] is not table:
            self._split = (table, split_table(table, self.mesh))
        return self._split[1]

    def search_device(self, q, k: int = 1, *, args=None, fused: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """q: (B, dim) device tensor → (sq_dists (B, k), idx (B, k)) —
        SQUARED L2. ``args`` is the ``search_args`` pair a snapshot
        captured (the serving path always passes it); ``None`` searches
        the current table. Top-1 goes through the nn_search kernel
        wrapper; ``fused=True`` is the reference's kernel-mode prologue
        contract (one matmul with the cached norms, no search kernel)."""
        table, norms, *split = (args if args is not None
                                else self.search_args)
        q = q.float()
        if k == 1:
            if self.mesh is not None:
                from repro_torch.core.shard import mesh_search
                d2, idx = mesh_search(split[0] if split else table, q,
                                      self.mesh)
                return d2[:, None], idx[:, None]
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


class ClusteredDeviceIndex(DeviceIndex):
    """Two-stage clustered (IVF) device index — the serving tier once N
    outgrows the exhaustive-search crossover (the reference's, op for op).

    * **packed clusters** — int8 member vectors stored contiguously per
      cluster: ``pvecs (C, m_pad, dim) int8``, per-entry ``pscales
      (C, m_pad) f16`` and slot ids ``pids (C, m_pad) i32`` (−1 pads
      masked at score time). The k-means assignment is balance-capped
      (≤ ``balance_cap`` × the mean size): fat clusters are 2-means split,
      and what is still over the cap spills to the overflow buffer.
    * **batch-shared, vote-priority probes** — stage 1 scores the
      centroids and probes one set for the whole batch: every cluster
      that is some query's top-1 ranks ahead of every cluster that is no
      one's. Stage 2 copies the ``nprobe`` probed blocks, appends the
      overflow buffer and scores them with one dense product.
    * **overflow buffer** — entries admitted or overwritten since the
      last rebuild live in a small side table (``ovecs/oscales/oids``,
      power-of-2 padded) scored with every probe; overwritten slots also
      patch their packed row. Past ``rebuild_frac`` × N post-rebuild
      growth, a host k-means rebuild folds everything back in.

    Every device array is written copy-on-write (``index_copy`` out of
    place, fresh tensors on a rebuild), and each mutation ends by
    publishing one ``_packed`` tuple, so a ``search_args`` tuple that a
    snapshot captured never changes. ``search_device`` is device ops
    only. Under a mesh, search falls back to ``shard.mesh_search`` over a
    lazily made f32 copy of the host mirror (``table``), as the
    reference's does."""

    def __init__(self, dim: int, *, n_clusters: Optional[int] = None,
                 nprobe: int = 16, kmeans_iters: int = 8,
                 rebuild_frac: float = 0.25, balance_cap: float = 1.5,
                 seed: int = 0, capacity: int = 0, device=None, mesh=None):
        self.dim = dim
        self.device = torch.device(device if device is not None else "cpu")
        self.mesh = mesh
        self._split = None
        self._mesh_table: Optional[torch.Tensor] = None
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self.rebuild_frac = rebuild_frac
        self.balance_cap = balance_cap
        self.seed = seed
        self._host: Optional[np.ndarray] = None      # f32 mirror (rebuilds)
        self._slot_loc: Optional[np.ndarray] = None  # (cap, 2) packed (c,pos)
        self._centroids: Optional[torch.Tensor] = None
        self._pvecs: Optional[torch.Tensor] = None   # (C, m_pad, dim) int8
        self._pscales: Optional[torch.Tensor] = None  # (C, m_pad) f16
        self._pids: Optional[torch.Tensor] = None    # (C, m_pad) i32
        self._overflow: List[int] = []               # slot ids, insert order
        self._opos: dict = {}                        # slot -> overflow pos
        self._overflow_base = 0                      # size seeded by rebuild
        self._ovecs: Optional[torch.Tensor] = None
        self._oscales: Optional[torch.Tensor] = None
        self._oids: Optional[torch.Tensor] = None
        self._table = None          # no flat table: ``table`` is a copy
        # the published search tuple: every mutation ends by assigning a
        # fresh one in a single reference write (see the class doc)
        self._packed: Optional[tuple] = None
        self._built = False
        self._n = 0
        self.n_rebuilds = 0
        self.transfer_bytes = 0
        if capacity:
            self._ensure_capacity(capacity)

    # -------------------------------------------------------------- storage
    @staticmethod
    def _quant(rows: np.ndarray):
        from repro_torch.core.codec import _quantize_rows
        return _quantize_rows(rows)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @property
    def capacity(self) -> int:
        return 0 if self._host is None else self._host.shape[0]

    @property
    def table(self) -> Optional[torch.Tensor]:
        """f32 copy of the host mirror (the mesh fallback's table, and
        debugging — not the hot path): made on first use after a change,
        counted in ``transfer_bytes``."""
        if self._host is None:
            return None
        if self._mesh_table is None:
            self._mesh_table = self._dev(np.array(self._host))
            self.transfer_bytes += int(self._host.nbytes)
        return self._mesh_table

    @property
    def _embs(self):
        return None if self._host is None else self._host[: self._n]

    def _ensure_capacity(self, need: int):
        cap = self.capacity
        if need <= cap:
            return
        new_cap = max(need, 2 * cap, 8)
        host = np.full((new_cap, self.dim), TOMBSTONE, np.float32)
        loc = np.full((new_cap, 2), -1, np.int32)
        if self._host is not None and self._n:
            host[: self._n] = self._host[: self._n]
            loc[: self._n] = self._slot_loc[: self._n]
        self._host = host
        self._slot_loc = loc

    # ------------------------------------------------------------ mutation
    def add(self, embs):
        embs = np.asarray(embs, np.float32)
        b = embs.shape[0]
        if b == 0:
            return
        self._ensure_capacity(self._n + b)
        slots = np.arange(self._n, self._n + b)
        self._host[slots] = embs
        self._n += b
        self._on_rows_changed(slots)

    def assign(self, slots: Sequence[int], embs):
        slots = np.asarray(slots).reshape(-1)
        if slots.size == 0:
            return
        self._ensure_capacity(int(slots.max()) + 1)
        self._host[slots] = np.asarray(embs, np.float32)
        self._n = max(self._n, int(slots.max()) + 1)
        self._on_rows_changed(slots)

    def remove(self, slots: Sequence[int]):
        slots = np.asarray(slots).reshape(-1)
        if slots.size == 0 or self._host is None:
            return
        self._host[slots] = TOMBSTONE
        self._on_rows_changed(slots, removing=True)

    def _on_rows_changed(self, slots: np.ndarray, removing: bool = False):
        """Propagate mirror changes to the device copies: nothing before
        the first build; after it, patch packed rows and route new or
        overwritten slots through the overflow buffer."""
        self._mesh_table = None
        if not self._built:
            return
        slots = np.asarray(slots).reshape(-1)
        packed = slots[self._slot_loc[slots, 0] >= 0]
        if packed.size:
            self._patch_packed(packed)
        changed = [int(s) for s in slots if int(s) in self._opos]
        if not removing:
            for s in slots:
                s = int(s)
                if s not in self._opos:
                    self._opos[s] = len(self._overflow)
                    self._overflow.append(s)
                    changed.append(s)
        if changed:
            self._sync_overflow(changed=changed)
        # trigger on post-rebuild GROWTH only: the rebuild itself seeds
        # the buffer with balance-cap spills, which must not re-trigger
        grown = len(self._overflow) - self._overflow_base
        if grown > max(8, int(self.rebuild_frac * max(1, self._n))):
            self.rebuild()
        else:
            self._republish()

    def _republish(self):
        """Publish the current packed + overflow arrays as one tuple."""
        self._packed = (self._centroids, self._pvecs, self._pscales,
                        self._pids, self._ovecs, self._oscales, self._oids)

    def _patch_packed(self, slots: np.ndarray):
        """Write current (possibly tombstoned) rows into their packed
        positions of FRESH arrays: values stay truthful even when the
        cluster is stale, and the published tuple keeps the old ones."""
        from repro_torch.core.database import pad_delta_pow2
        locs = self._slot_loc[slots]                       # (k, 2)
        C, m_pad, _ = self._pvecs.shape
        flat = (locs[:, 0].astype(np.int64) * m_pad + locs[:, 1])
        codes, scales = self._quant(self._host[slots])
        flat, codes = pad_delta_pow2(flat, codes)
        _, scales = pad_delta_pow2(self._slot_loc[slots][:, 0], scales)
        fl = self._dev(flat)
        self._pvecs = self._pvecs.reshape(C * m_pad, self.dim).index_copy(
            0, fl, self._dev(codes)).reshape(C, m_pad, self.dim)
        self._pscales = self._pscales.reshape(C * m_pad).index_copy(
            0, fl, self._dev(scales)).reshape(C, m_pad)
        self.transfer_bytes += int(codes.nbytes + scales.nbytes
                                   + flat.size * 4)

    def _sync_overflow(self, changed=None):
        """Ship the overflow side table (pow2-padded): a full upload when
        its padded size changes or on a rebuild (``changed=None``), else
        the changed positions as a padded copy-on-write delta."""
        from repro_torch.core.database import pad_delta_pow2
        ids = np.asarray(self._overflow, np.int64)
        p = 1
        while p < max(1, ids.size):
            p *= 2
        if changed is None or self._oids is None or self._oids.shape[0] != p:
            vecs = np.zeros((p, self.dim), np.float32)
            if ids.size:
                vecs[: ids.size] = self._host[ids]
            codes, scales = self._quant(vecs)
            oids = np.full(p, -1, np.int32)
            oids[: ids.size] = ids
            self._ovecs = self._dev(codes)
            self._oscales = self._dev(scales)
            self._oids = self._dev(oids)
            self.transfer_bytes += int(codes.nbytes + scales.nbytes
                                       + oids.nbytes)
            return
        pos = sorted({self._opos[int(s)] for s in changed
                      if int(s) in self._opos})
        if not pos:
            return
        pos = np.asarray(pos, np.int64)
        slot_ids = ids[pos]
        codes, scales = self._quant(self._host[slot_ids])
        pos_p, codes = pad_delta_pow2(pos, codes)
        _, scales = pad_delta_pow2(pos, scales)
        _, oid_vals = pad_delta_pow2(pos, slot_ids.astype(np.int32))
        pl = self._dev(pos_p)
        self._ovecs = self._ovecs.index_copy(0, pl, self._dev(codes))
        self._oscales = self._oscales.index_copy(0, pl, self._dev(scales))
        self._oids = self._oids.index_copy(0, pl, self._dev(oid_vals))
        self.transfer_bytes += int(codes.nbytes + scales.nbytes
                                   + oid_vals.nbytes + pos_p.size * 4)

    # ------------------------------------------------------------- build
    def _live_slots(self) -> np.ndarray:
        if self._host is None or self._n == 0:
            return np.zeros(0, np.int64)
        rows = self._host[: self._n]
        return np.flatnonzero(np.abs(rows[:, 0]) < TOMBSTONE / 2)

    def rebuild(self):
        """Host k-means over the live mirror (assignment products on the
        index's device) with balance-capped assignment; ships centroids
        and packed int8 arrays as fresh tensors."""
        live = self._live_slots()
        if live.size == 0:
            # searchable but empty: one tombstone centroid, an empty
            # packed row and overflow buffer — every candidate is id −1,
            # so a search returns a BIG distance (a guaranteed miss)
            self._centroids = torch.full((1, self.dim), TOMBSTONE,
                                         dtype=torch.float32,
                                         device=self.device)
            self._pvecs = torch.zeros((1, 1, self.dim), dtype=torch.int8,
                                      device=self.device)
            self._pscales = torch.zeros((1, 1), dtype=torch.float16,
                                        device=self.device)
            self._pids = torch.full((1, 1), -1, dtype=torch.int32,
                                    device=self.device)
            if self._slot_loc is not None:
                self._slot_loc[:, :] = -1
            self._overflow = []
            self._opos = {}
            self._overflow_base = 0
            self._sync_overflow()
            self._built = True
            self._republish()
            return
        x = self._host[live]
        k = self.n_clusters or max(1, int(np.sqrt(live.size)))
        cent, assign = _kmeans(x, k, self.kmeans_iters, self.seed,
                               device=self.device)
        # balance: every probe pays for m_pad, so over-cap clusters are
        # 2-means SPLIT (up to four rounds); entries still over the cap go
        # to the always-scored overflow buffer, not to a far cluster
        cap = max(1, int(np.ceil(self.balance_cap * live.size / k)))
        for _ in range(4):
            sizes = np.bincount(assign, minlength=cent.shape[0])
            fat = np.flatnonzero(sizes > cap)
            if fat.size == 0:
                break
            for c in fat:
                m = np.flatnonzero(assign == c)
                sub_c, sub_a = _kmeans(x[m], 2, 4, self.seed + int(c) + 1,
                                       device=self.device)
                if sub_c.shape[0] < 2:
                    continue
                new_id = cent.shape[0]
                cent = np.concatenate([cent, sub_c[1:]], 0)
                cent[c] = sub_c[0]
                assign[m[sub_a == 1]] = new_id
        k = cent.shape[0]
        # the reference's first-come packing, vectorized: the i-th live
        # row (in slot order) of a cluster takes packed position i of it
        # while i < cap, and spills otherwise
        counts = np.bincount(assign, minlength=k)
        order = np.argsort(assign, kind="stable")
        rank = np.empty(live.size, np.int64)
        rank[order] = np.arange(live.size) - np.repeat(
            np.cumsum(counts) - counts, counts)
        keep = rank < cap
        c_k, p_k = assign[keep], rank[keep]
        m_pad = max(1, int(np.minimum(counts, cap).max()))
        pvecs = np.zeros((k, m_pad, self.dim), np.float32)
        pids = np.full((k, m_pad), -1, np.int32)
        pvecs[c_k, p_k] = x[keep]
        pids[c_k, p_k] = live[keep]
        self._slot_loc[:, :] = -1
        self._slot_loc[live[keep]] = np.stack([c_k, p_k], 1)
        codes, scales = self._quant(pvecs.reshape(k * m_pad, self.dim))
        self._pvecs = self._dev(codes.reshape(k, m_pad, self.dim))
        self._pscales = self._dev(scales.reshape(k, m_pad))
        self._pids = self._dev(pids)
        self._centroids = self._dev(cent)
        self._overflow = [int(s) for s in live[~keep]]
        self._opos = {s: j for j, s in enumerate(self._overflow)}
        self._overflow_base = len(self._overflow)
        self._sync_overflow()
        self.transfer_bytes += int(cent.nbytes + codes.nbytes
                                   + scales.nbytes + pids.nbytes)
        self._built = True
        self._republish()
        self.n_rebuilds += 1

    @property
    def search_args(self):
        """(centroids, pvecs, pscales, pids, ovecs, oscales, oids) — what
        ``search_device`` consumes; a StoreSnapshot freezes the tuple.
        Under a mesh: (the f32 ``table``, its row-split copy)."""
        if self.mesh is not None:
            t = self.table
            return (t, self._mesh_split(t))
        if not self._built:
            self.rebuild()
        return self._packed

    # ------------------------------------------------------------- search
    def search_device(self, q, k: int = 1, *, args=None, fused: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """q: (B, dim) device tensor → (sq_dists (B, k), idx (B, k) i32),
        device ops only (no host read). ``fused`` is accepted for API
        parity: the search launches no kernel of its own either way."""
        if args is None:
            args = self.search_args
        q = q.float()
        if self.mesh is not None:
            t, split = args
            if k == 1:
                from repro_torch.core.shard import mesh_search
                d2, idx = mesh_search(split, q, self.mesh)
                return d2[:, None], idx[:, None]
            neg, idx = torch.topk(-sq_dists(q, t), k, dim=-1)
            return -neg, idx.to(torch.int32)
        centroids, pvecs, pscales, pids, ovecs, oscales, oids = args
        C, m_pad, dim = pvecs.shape
        # stage 1: one (B, C) product → vote-priority probes: a cluster
        # that is some query's top-1 outranks every cluster that is no
        # one's; the normalized batch-min distance breaks ties below 1
        d2c = sq_dists(q, centroids)
        nprobe = min(self.nprobe, C)
        votes = torch.zeros(C, dtype=torch.float32, device=q.device)
        votes.index_add_(0, torch.argmin(d2c, 1),
                         torch.ones(q.shape[0], dtype=torch.float32,
                                    device=q.device))
        dmin = torch.amin(d2c, 0)
        priority = votes - dmin / (torch.amax(dmin) + 1e-9)
        probes = torch.topk(priority, nprobe).indices            # (P,)
        # stage 2: P block copies + the overflow side table, dequantized
        # once, scored with ONE dense (B, K) product
        cand_vecs = torch.cat([pvecs.index_select(0, probes).reshape(-1, dim),
                               ovecs], 0)
        cand_sc = torch.cat([pscales.index_select(0, probes).reshape(-1),
                             oscales], 0)
        cand_ids = torch.cat([pids.index_select(0, probes).reshape(-1),
                              oids], 0)                          # (K,)
        vecs = cand_vecs.float() * cand_sc.float()[:, None]
        # BIG (not inf): downstream sqrt/calibration must stay NaN-free
        d2 = sq_dists(q, vecs).masked_fill((cand_ids < 0)[None, :], 1e30)
        if k == 1:
            best = torch.argmin(d2, -1)
            idx = cand_ids.index_select(0, best)
            return d2.gather(1, best[:, None]), idx[:, None]
        neg, pos = torch.topk(-d2, k, dim=-1)
        return -neg, cand_ids[pos]

    def search(self, q, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.as_tensor(np.asarray(q, np.float32)).to(self.device)
        d2, idx = self.search_device(q, k)
        return (np.sqrt(np.maximum(d2.cpu().numpy(), 0.0)),
                idx.cpu().numpy())


def recall_at_1(index, oracle: ExactIndex, queries) -> float:
    """Fraction of queries where the index returns the oracle's top-1."""
    _, ia = index.search(queries, 1)
    _, ib = oracle.search(queries, 1)
    return float((ia[:, 0] == ib[:, 0]).mean())


from repro_torch.core.registry import DEVICE_INDEXES, HOST_INDEXES  # noqa: E402

HOST_INDEXES.register("exact", lambda dim, **_: ExactIndex(dim))
HOST_INDEXES.register(
    "ivf", lambda dim, *, n_lists=None, **_: IVFIndex(dim,
                                                      n_lists=n_lists or 8))
HOST_INDEXES.register(
    "device", lambda dim, *, device=None, mesh=None, **_:
    DeviceIndex(dim, device=device, mesh=mesh))
DEVICE_INDEXES.register(
    "flat", lambda dim, *, capacity=0, device=None, mesh=None, **_:
    DeviceIndex(dim, capacity=capacity, device=device, mesh=mesh))
DEVICE_INDEXES.register(
    "clustered", lambda dim, *, capacity=0, nprobe=16, n_clusters=None,
    device=None, mesh=None, **_:
    ClusteredDeviceIndex(dim, nprobe=nprobe, n_clusters=n_clusters,
                         capacity=capacity, device=device, mesh=mesh))
