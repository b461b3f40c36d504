"""Sharded memo store — the multi-device tier (DESIGN.md §2.12), the
counterpart of the reference's ``core/shard.py``.

One device's memo store stops scaling at that device's memory. This
module partitions the device tier over an ordered list of devices, so
capacity and search throughput grow with the device count. The
reference drives its shards with ``shard_map`` over a one-axis JAX mesh
from one controller; the port keeps the one controller: a single
process owns the whole store (host tier, positions, CLOCK hands,
centroids) and drives every shard through a ``StoreMesh``, an ordered
tuple of ``torch.device``s. The same code runs on one card, on several,
and on the CPU; a mesh may name one device more than once
(``StoreMesh((cuda:0,) * 4)``), which is how four shards run on one
card, as ``--xla_force_host_platform_device_count`` runs them on one
JAX host.

* ``ShardedDeviceDB`` / ``ShardedDeviceIndex`` — every row-indexed leaf
  (embedding table, slot map, codec-part arenas) is split by rows: shard
  ``s`` holds positions ``[s*M, (s+1)*M)`` as its own tensors on
  ``mesh.devices[s]``. Routing state (k-means centroids and their owning
  shard) and a small hot-entry set are replicated on every device.

* Centroid-routed search: a query computes its ``route_nprobe`` nearest
  centroids; only shards owning one of them compete (the others submit
  +inf), so the per-shard work is one ``nn_search`` over the shard's
  rows. Every shard also scores the replicated hot set. Shard winners —
  distance, global slot id and the candidate's codec-part rows — move to
  the lead device in exactly ONE combine (``_ALL_GATHER``), followed by
  an argmin there.

* ``ShardedMemoStore`` — admission and CLOCK eviction become per-shard
  under the same global byte budget: a dirty slot routes to the shard
  owning its nearest centroid; a full shard runs a shard-local CLOCK
  sweep before spilling to the emptiest shard. Delta sync ships only the
  touched shards' positions and bumps only their generations
  (``shard_snapshots``).

``mesh_search`` is the plain entry-sharded exact search, used by the
flat and clustered device indexes when they are given a mesh.

Every mutation is copy-on-write (a fresh tensor for each touched shard),
so a ``StoreSnapshot`` a serving batch holds never changes under a delta
sync, as the reference's immutable arrays do not. The search issues no
host synchronization.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.database import pad_delta_parts, pad_delta_pow2
from repro_torch.core.faults import MemoStoreError
from repro_torch.core.index import TOMBSTONE, _kmeans
from repro_torch.core.registry import DEVICE_INDEXES
from repro_torch.core.store import MemoStore
from repro_torch.device import resolve_device
from repro_torch.kernels.nn_search.ops import nn_search


@dataclass(frozen=True)
class StoreMesh:
    """The store's mesh: an ordered tuple of devices on one axis (the
    counterpart of a one-axis ``jax.sharding.Mesh``). ``devices[0]`` is
    the lead device, where queries come from and the combine lands."""
    devices: Tuple[torch.device, ...]
    axis: str = "store"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a StoreMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def all_gather(payloads: Sequence[Tuple[torch.Tensor, ...]],
               device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The combine: every shard's payload tuple moves to ``device`` and
    each leaf stacks over shards → (S, ...) per leaf."""
    return tuple(torch.stack([p[j].to(device, non_blocking=True)
                              for p in payloads])
                 for j in range(len(payloads[0])))


# module-level indirection so the combine count is observable: tests
# monkeypatch ``shard._ALL_GATHER`` and assert a whole sharded search
# makes exactly ONE cross-shard combine
_ALL_GATHER = all_gather


def make_store_mesh(n_shards: Optional[int] = None, axis: str = "store",
                    device=None) -> StoreMesh:
    """A mesh over the local devices of ``device``'s type (the card by
    default). Requests past the device count clamp, as the reference's
    do past ``jax.device_count()``: an 8-shard spec on one H100 gives
    S = 1, and the CPU always gives S = 1. To run S > 1 on one device,
    build ``StoreMesh((dev,) * S)`` and hand it to the store."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        lead = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        n = count if n_shards is None else max(1, min(int(n_shards), count))
        devs = tuple(torch.device("cuda", (lead + i) % count)
                     for i in range(n))
    else:
        devs = (dev,)
    return StoreMesh(devs, axis)


def row_split(n: int, S: int) -> List[Tuple[int, int]]:
    """Shard s's rows [lo, hi) of an n-row table: ceil(n / S) rows a
    shard, the last ones shorter (the port's ``memo_row_spec``)."""
    m = max(1, -(-n // S))
    return [(min(s * m, n), min((s + 1) * m, n)) for s in range(S)]


def split_table(table: torch.Tensor, mesh: StoreMesh, norms=None):
    """A row-split copy of a table over the mesh: a tuple of (offset,
    rows, row norms) per non-empty shard, each on its shard's device (a
    view where the device is the table's own)."""
    if norms is None:
        norms = torch.sum(table * table, dim=-1)
    out = []
    for (lo, hi), dev in zip(row_split(int(table.shape[0]), mesh.size),
                             mesh.devices):
        if hi > lo:
            out.append((lo, table[lo:hi].to(dev), norms[lo:hi].to(dev)))
    return tuple(out)


def mesh_search(embs, queries, mesh: StoreMesh):
    """Distributed exact top-1 over a row-split embedding table: each
    shard's local argmin through ``nn_search``, then ONE combine of the
    (min, global idx) pairs to the lead device and the global argmin there
    (ties go to the lowest shard, as ``jnp.argmin`` over the gathered
    axis). ``embs``: a table (split here) or ``split_table``'s tuple.
    Returns (sq_dists (B,), global idx (B,) int32)."""
    split = (split_table(embs, mesh) if isinstance(embs, torch.Tensor)
             else embs)
    q = queries.float()
    payloads = []
    for off, rows, norms in split:
        loc_min, loc_arg = nn_search(q.to(rows.device, non_blocking=True),
                                     rows, db_norms=norms)
        payloads.append((loc_min, loc_arg + off))
    mins, idxs = _ALL_GATHER(payloads, q.device)       # (shards, B)
    best = torch.argmin(mins, dim=0)
    cols = torch.arange(q.shape[0], device=q.device)
    return mins[best, cols], idxs[best, cols]


class ShardSnapshot(NamedTuple):
    """Per-shard publish record: the generation bumps only when that
    shard's rows changed."""
    shard: int
    generation: int
    live: int          # occupied positions
    free: int          # free positions remaining


def _replicate(arr: np.ndarray, mesh: StoreMesh) -> Tuple[torch.Tensor, ...]:
    """One copy of a host array per distinct mesh device, as a tuple
    indexed by shard (repeated devices share their copy). Always a copy:
    the host array may change later."""
    host = torch.from_numpy(np.array(arr))
    copies: Dict[torch.device, torch.Tensor] = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = host.to(d)
    return tuple(copies[d] for d in mesh.devices)


def _split_rows(arr: np.ndarray, mesh: StoreMesh) -> Tuple[torch.Tensor, ...]:
    """A host (S*M, ...) array → S tensors of M rows on their shards
    (copies: the host array may change later)."""
    S = mesh.size
    M = arr.shape[0] // S
    return tuple(torch.from_numpy(np.array(arr[s * M:(s + 1) * M])).to(d)
                 for s, d in enumerate(mesh.devices))


def _scatter_rows(shards: Tuple[torch.Tensor, ...], positions: np.ndarray,
                  values: Optional[np.ndarray], fill=None
                  ) -> Tuple[torch.Tensor, ...]:
    """Write rows at global positions into fresh copies of the touched
    shards (copy-on-write); untouched shards keep their tensor."""
    M = int(shards[0].shape[0])
    out = list(shards)
    for s in np.unique(positions // M):
        sel = positions // M == s
        t = shards[int(s)]
        local = torch.from_numpy((positions[sel] - s * M).astype(np.int64)
                                 ).to(t.device)
        if values is None:
            out[int(s)] = t.index_fill(0, local, fill)
        else:
            v = torch.from_numpy(np.ascontiguousarray(values[sel])).to(
                t.device, t.dtype)
            out[int(s)] = t.index_copy(0, local, v)
    return tuple(out)


class ShardedDeviceDB:
    """Position-indexed device arenas, split by rows over the mesh.

    The surface of ``DeviceDB`` (``parts``, ``update``, ``capacity``,
    ``nbytes``, ``transfer_bytes``), but rows are device POSITIONS
    (shard*M + row), not host slot ids, and ``parts[j][s]`` is codec part
    ``j``'s (M, ...) rows on shard ``s``. The sharded index returns each
    winner's codec rows from its combine, so the engine never indexes
    these arenas by slot."""

    def __init__(self, host_parts: Sequence[np.ndarray], mesh: StoreMesh,
                 axis: str = "store", codec=None):
        self.codec = codec
        self.mesh = mesh
        self.axis = axis
        self.parts: Tuple[Tuple[torch.Tensor, ...], ...] = tuple(
            _split_rows(np.asarray(p), mesh) for p in host_parts)
        self.transfer_bytes = self.nbytes

    @property
    def capacity(self) -> int:
        return sum(int(t.shape[0]) for t in self.parts[0])

    @property
    def nbytes(self) -> int:
        return sum(int(t.nbytes) for part in self.parts for t in part)

    def __len__(self):
        return self.capacity

    def update(self, positions: np.ndarray,
               host_parts: Sequence[np.ndarray]) -> int:
        """Scatter compressed rows into device positions of fresh copies
        of the touched shards (copy-on-write; pow2-padded as the
        reference pads, so the receipts match). Returns bytes."""
        positions = np.asarray(positions).reshape(-1)
        if positions.size == 0:
            return 0
        if int(positions.max()) >= self.capacity:
            raise ValueError("sharded delta past device position capacity")
        pos, parts = pad_delta_parts(positions, host_parts)
        shipped = int(pos.size * 8)
        fresh = []
        for arr, p in zip(self.parts, parts):
            p = np.asarray(p)
            fresh.append(_scatter_rows(arr, pos, p))
            shipped += int(p.nbytes)
        self.parts = tuple(fresh)
        self.transfer_bytes += shipped
        return shipped


class ShardedDeviceIndex:
    """Centroid-routed sharded top-1 index (DESIGN.md §2.12).

    Per shard: ``table`` (M, dim) embeddings at its positions, ``slot_at``
    (M,) the GLOBAL host slot each position holds (−1 free), both on the
    shard's device. Replicated on every device: k-means ``centroids``
    (C, dim) + ``owner`` (C,) shard id per centroid, and the hot set
    (``hot_table`` / ``hot_slots`` / ``hot_parts`` — top reuse-count
    rows).

    ``search_fetch`` runs the whole search with ONE ``_ALL_GATHER``
    combine and returns (d2, slot, codec rows) — global slot ids, so the
    engine's length gate and reuse drain are those of the single-device
    path."""

    is_sharded = True

    def __init__(self, dim: int, *, mesh: StoreMesh, axis: str = "store",
                 capacity: int = 0, nprobe: int = 4, hot_k: int = 32, **_):
        self.dim = dim
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.size
        self.nprobe = max(1, int(nprobe))
        self.hot_k = max(0, int(hot_k))
        self.transfer_bytes = 0
        self._tables: Optional[Tuple[torch.Tensor, ...]] = None
        self._slot_at: Optional[Tuple[torch.Tensor, ...]] = None
        self._norms: Optional[Tuple[torch.Tensor, ...]] = None
        self._centroids: Optional[Tuple[torch.Tensor, ...]] = None
        self._owner: Optional[Tuple[torch.Tensor, ...]] = None
        H = max(1, self.hot_k)
        self._hot_table = _replicate(
            np.full((H, dim), TOMBSTONE, np.float32), mesh)
        self._hot_slots = _replicate(np.full((H,), -1, np.int32), mesh)
        self._hot_parts: Tuple[Tuple[torch.Tensor, ...], ...] = tuple(
            () for _ in mesh.devices)
        if capacity:
            S = self.n_shards
            total = S * max(1, -(-int(capacity) // S))
            self.load(np.full((total, dim), TOMBSTONE, np.float32),
                      np.full((total,), -1, np.int64))
            self.set_centroids(np.full((1, dim), TOMBSTONE, np.float32),
                               np.zeros((1,), np.int32))

    # ------------------------------------------------------------- state
    @property
    def capacity(self) -> int:
        return (0 if self._tables is None
                else sum(int(t.shape[0]) for t in self._tables))

    def __len__(self):
        return self.capacity

    def load(self, table: np.ndarray, slot_at: np.ndarray) -> None:
        """Full rebuild: upload the position-indexed table + slot map."""
        table = np.asarray(table, np.float32)
        slot_at = np.asarray(slot_at, np.int64)
        self._tables = _split_rows(table, self.mesh)
        self._slot_at = _split_rows(slot_at, self.mesh)
        self._norms = None
        self.transfer_bytes += int(table.nbytes + slot_at.nbytes)

    def set_centroids(self, centroids: np.ndarray,
                      owner: np.ndarray) -> None:
        centroids = np.asarray(centroids, np.float32)
        owner = np.asarray(owner, np.int32)
        self._centroids = _replicate(centroids, self.mesh)
        self._owner = _replicate(owner.astype(np.int64), self.mesh)
        self.transfer_bytes += int(centroids.nbytes + owner.nbytes)

    def set_hot(self, table: np.ndarray, slots: np.ndarray,
                parts: Tuple[np.ndarray, ...]) -> int:
        """Refresh the replicated hot set (fixed H rows). Returns the
        bytes shipped (one copy's worth, as the reference counts)."""
        table = np.asarray(table, np.float32)
        slots = np.asarray(slots, np.int32)
        self._hot_table = _replicate(table, self.mesh)
        self._hot_slots = _replicate(slots, self.mesh)
        reps = [_replicate(np.asarray(p), self.mesh) for p in parts]
        self._hot_parts = tuple(tuple(r[s] for r in reps)
                                for s in range(self.n_shards))
        shipped = int(table.nbytes + slots.nbytes
                      + sum(int(np.asarray(p).nbytes) for p in parts))
        self.transfer_bytes += shipped
        return shipped

    def update(self, positions: np.ndarray, embs: np.ndarray,
               slots: np.ndarray) -> int:
        """Delta: write embedding rows + their global slot ids at device
        positions (copy-on-write, pow2-padded)."""
        positions = np.asarray(positions).reshape(-1)
        if positions.size == 0:
            return 0
        pos, vals = pad_delta_pow2(positions, np.asarray(embs, np.float32))
        _, sl = pad_delta_pow2(positions, np.asarray(slots, np.int64))
        self._tables = _scatter_rows(self._tables, pos, vals)
        self._slot_at = _scatter_rows(self._slot_at, pos, sl)
        self._norms = None
        shipped = int(vals.nbytes + sl.nbytes + pos.size * 8)
        self.transfer_bytes += shipped
        return shipped

    def kill(self, positions: np.ndarray) -> int:
        """Tombstone freed device positions (slot −1, TOMBSTONE row)."""
        positions = np.asarray(positions).reshape(-1)
        if positions.size == 0:
            return 0
        pos, _ = pad_delta_pow2(positions)
        self._tables = _scatter_rows(self._tables, pos, None, TOMBSTONE)
        self._slot_at = _scatter_rows(self._slot_at, pos, None, -1)
        self._norms = None
        shipped = int(pos.size * 8)
        self.transfer_bytes += shipped
        return shipped

    # ------------------------------------------------------------ search
    @property
    def search_args(self):
        """What the search consumes, per shard: the tables with their
        row norms (cached per mutation generation, read at publish), the
        slot maps, the centroids with their norms and owners, the hot
        set with its norms, slots and codec rows. A snapshot freezes the
        tuple; every mutation replaces tensors, never writes into them."""
        if self._norms is None:
            self._norms = tuple(torch.sum(t * t, dim=-1)
                                for t in self._tables)
        cnorms = tuple(torch.sum(c * c, dim=-1) for c in self._centroids)
        hnorms = tuple(torch.sum(h * h, dim=-1) for h in self._hot_table)
        return (self._tables, self._norms, self._slot_at, self._centroids,
                cnorms, self._owner, self._hot_table, hnorms,
                self._hot_slots, self._hot_parts)

    def _combine(self, args, q, parts, with_rows: bool):
        """The one-combine sharded search. Per shard: the local top-1
        through ``nn_search`` + the centroid-routing mask + the
        replicated hot-set scores + (``with_rows``) the winner's codec
        rows; then ONE ``_ALL_GATHER`` of every shard's (d2, slot,
        rows...) to the lead device and the argmin there. Masked shards
        (no probed centroid owned) submit +inf. Ties: the first shard
        wins (``argmin`` returns the first minimum), and the hot set wins
        only where it is strictly nearer than that shard's own winner."""
        (tables, norms, slot_at, cents, cnorms, owner, hot_t, hnorms,
         hot_s, hot_parts) = args
        lead = q.device
        q = q.float()
        nprobe = min(self.nprobe, int(cents[0].shape[0]))
        inf = float("inf")
        payloads = []
        for me, dev in enumerate(self.mesh.devices):
            qs = q.to(dev, non_blocking=True)
            dloc, loc = nn_search(qs, tables[me], db_norms=norms[me])
            loc = loc.long()
            qq = torch.sum(qs * qs, dim=-1, keepdim=True)          # (B, 1)
            # centroid routing: only shards owning one of the query's
            # nprobe nearest centroids compete for it. The probe set is
            # taken by a STABLE ascending sort of the centroid distances,
            # so equal distances go to the lower centroid index, as
            # ``lax.top_k(-cd)`` orders them (torch.topk leaves the
            # order of equal values unspecified)
            cd = cnorms[me][None, :] - 2.0 * (qs @ cents[me].T)      # (B, C)
            probes = torch.sort(cd, dim=1, stable=True).indices[:, :nprobe]
            mine = torch.any(owner[me][probes] == me, dim=1)         # (B,)
            dloc = torch.where(mine, dloc, inf)
            sloc = slot_at[me].index_select(0, loc)
            # replicated hot set: every shard scores it (H is tiny), so
            # a skew-hot entry is served without routing to its shard
            dh = qq + hnorms[me][None, :] - 2.0 * (qs @ hot_t[me].T)  # (B, H)
            hloc = torch.argmin(dh, dim=1)
            dhot = dh.gather(1, hloc[:, None])[:, 0]
            use_hot = dhot < dloc
            payload = [torch.where(use_hot, dhot, dloc),
                       torch.where(use_hot,
                                   hot_s[me].index_select(0, hloc).long(),
                                   sloc)]
            if with_rows:
                for p, hp in zip(parts, hot_parts[me]):
                    lr = p[me].index_select(0, loc)                 # (B, ...)
                    hr = hp.index_select(0, hloc)
                    sel = use_hot.reshape((-1,) + (1,) * (lr.ndim - 1))
                    payload.append(torch.where(sel, hr, lr))
            payloads.append(tuple(payload))
        g = _ALL_GATHER(payloads, lead)                     # ONE combine
        win = torch.argmin(g[0], dim=0)                     # (B,)
        cols = torch.arange(g[0].shape[1], device=lead)
        out = [g[0][win, cols], g[1][win, cols]]
        if with_rows:
            out.append(tuple(r[win, cols] for r in g[2:]))
        return tuple(out)

    def search_device(self, q, k: int = 1, *, args=None, fused: bool = False):
        """DeviceIndex-compat search: (sq_dists (B, k), slot ids (B, k)).
        Top-1 only (the combine carries one winner a shard); ``fused`` is
        accepted for API parity."""
        if k != 1:
            raise NotImplementedError("sharded index serves top-1 only")
        if args is None:
            args = self.search_args
        d2, slot = self._combine(args, q, None, with_rows=False)
        return d2[:, None], slot.to(torch.int32)[:, None]

    def search_fetch(self, q, *, args, parts):
        """Search + fetch in the SAME combine: returns (sq_dists (B, 1),
        slot ids (B, 1), codec-part rows tuple (B, ...)). The winning
        shard's arena rows ride the combine's payload, so the engine never
        gathers from the position-indexed arenas by slot."""
        d2, slot, rows = self._combine(args, q, parts, with_rows=True)
        return d2[:, None], slot.to(torch.int32)[:, None], rows

    def search(self, q, k: int = 1):
        """Host-compat API (L2, not squared — same as ExactIndex)."""
        q = torch.as_tensor(np.asarray(q, np.float32)).to(self.mesh.lead)
        d2, idx = self.search_device(q, k)
        return (np.sqrt(np.maximum(d2.cpu().numpy(), 0.0)),
                idx.cpu().numpy())


class ShardedMemoStore(MemoStore):
    """MemoStore whose device tier is partitioned over a ``StoreMesh``.

    The host tier (arena, host index, capacity tier, budgets) is the base
    store's — global admission still enforces the ONE byte budget. What
    changes is device placement: every live slot gets a device POSITION
    on the shard owning its nearest centroid; a full shard runs a
    shard-local CLOCK sweep before spilling to the emptiest shard. Delta
    sync ships only the touched shards' positions and bumps only their
    ``shard_snapshots`` generations; full sync re-runs k-means and
    rebalances ownership. The host bookkeeping is the reference's numpy,
    line for line."""

    def __init__(self, apm_shape, embed_dim, *, n_shards: int = 0,
                 shard_axis: str = "store", hot_k: int = 32,
                 route_nprobe: Optional[int] = None,
                 refresh_spills: int = 0, mesh: Optional[StoreMesh] = None,
                 **kw):
        if kw.get("index_kind") == "device":
            raise MemoStoreError(
                "ShardedMemoStore needs a host-tier index separate from "
                "the device table (index_kind='device' is single-host "
                "only); use index_kind='exact' or 'ivf'")
        if mesh is None:
            mesh = make_store_mesh(n_shards or None, shard_axis,
                                   device=kw.get("device"))
        kw.pop("device_index_kind", None)   # the sharded layout is fixed
        if kw.get("device") is None:
            kw["device"] = mesh.lead
        super().__init__(apm_shape, embed_dim,
                         device_index_kind="sharded", mesh=None, **kw)
        self.shard_mesh = mesh
        self.shard_axis = shard_axis
        self.n_shards = mesh.size
        self.hot_k = max(0, int(hot_k))
        self.route_nprobe = (max(1, int(route_nprobe))
                             if route_nprobe is not None
                             else max(1, int(self.nprobe)))
        # position bookkeeping (all rebuilt by each full sync)
        self._pos_per_shard = 0
        self._slot_pos: Dict[int, int] = {}
        self._pos_slot = np.full((0,), -1, np.int64)
        self._shard_free: List[List[int]] = [[] for _ in
                                             range(self.n_shards)]
        self._shard_hands = [0] * self.n_shards
        self._centroids_host = np.full((1, embed_dim), TOMBSTONE,
                                       np.float32)
        self._owner_host = np.zeros((1,), np.int32)
        self._shard_gens = np.zeros(self.n_shards, np.int64)
        self.shard_snapshots: Tuple[ShardSnapshot, ...] = ()
        self.n_shard_evictions = 0
        self.n_spills = 0
        # routing-drift repair: after this many delta-sync spills since
        # the last centroid fit, refit the centroids from the resident
        # embeddings (0 disables)
        self.refresh_spills = max(0, int(refresh_spills))
        self._spills_since_refresh = 0
        self.n_centroid_refreshes = 0

    # -------------------------------------------------------- accounting
    def shard_occupancy(self) -> np.ndarray:
        """(S,) live positions per shard — the balance probe."""
        occ = np.zeros(self.n_shards, np.int64)
        if self._pos_per_shard:
            held = np.flatnonzero(self._pos_slot >= 0)
            np.add.at(occ, held // self._pos_per_shard, 1)
        return occ

    def shard_stats(self) -> Dict[str, object]:
        occ = self.shard_occupancy()
        mean = float(occ.mean()) if occ.size else 0.0
        return {
            "n_shards": self.n_shards,
            "positions_per_shard": self._pos_per_shard,
            "occupancy": [int(c) for c in occ],
            "imbalance": (float(occ.max()) / mean if mean > 0 else 1.0),
            "hot_k": self.hot_k,
            "n_shard_evictions": self.n_shard_evictions,
            "n_spills": self.n_spills,
            "n_centroid_refreshes": self.n_centroid_refreshes,
        }

    @property
    def per_shard_budget_bytes(self) -> Optional[int]:
        """The byte budget one shard's positions can hold."""
        if self._pos_per_shard == 0:
            return None
        return self._pos_per_shard * self.entry_nbytes

    # ---------------------------------------------------------- routing
    def _route_shards(self, embs: np.ndarray) -> np.ndarray:
        """Host-side nearest-centroid → owning shard per row."""
        c = self._centroids_host
        d2 = ((c * c).sum(1)[None, :] - 2.0 * embs @ c.T)
        return self._owner_host[np.argmin(d2, axis=1)]

    def _free_position_locked(self, slot: int,
                              killed: List[int]) -> None:
        pos = self._slot_pos.pop(int(slot), None)
        if pos is not None:
            self._pos_slot[pos] = -1
            self._shard_free[pos // self._pos_per_shard].append(pos)
            killed.append(pos)

    def _evict_shard_locked(self, shard: int, n: int) -> List[int]:
        """Shard-local CLOCK: sweep only this shard's positions with the
        global clock's decaying-second-chance rule; falls back to the
        coldest resident when everything is hot. Victims retire through
        the shared path (demotion, tombstones, dirty marking)."""
        M = self._pos_per_shard
        lo = shard * M
        counts = self.db.reuse_counts
        hand = self._shard_hands[shard]
        victims: List[int] = []
        scanned = 0
        while len(victims) < n and scanned < 2 * M:
            pos = lo + (hand % M)
            hand += 1
            scanned += 1
            slot = int(self._pos_slot[pos])
            if slot < 0 or not self.db._live[slot]:
                continue
            if counts[slot] > 0:
                counts[slot] //= 2
            else:
                victims.append(slot)
        self._shard_hands[shard] = hand % M
        if len(victims) < n:      # all hot: coldest resident on the shard
            res = [int(s) for s in self._pos_slot[lo: lo + M]
                   if s >= 0 and self.db._live[s] and s not in victims]
            res.sort(key=lambda s: int(counts[s]))
            victims.extend(res[: n - len(victims)])
        if victims:
            self._retire_slots_locked(victims)
            self.stats.n_evicted += len(victims)
            self.n_shard_evictions += len(victims)
        return victims

    # ------------------------------------------------------------- sync
    def _need_full_sync_locked(self, n: int, force_full: bool) -> bool:
        if (force_full or self.device_db is None
                or self.device_index is None or self._dev_lens is None
                or n > int(self._dev_lens.shape[0])):
            return True
        pending = sum(1 for s in self._dirty
                      if s < n and self.db._live[s]
                      and s not in self._slot_pos)
        total_free = sum(len(f) for f in self._shard_free)
        return pending > total_free

    def _full_sync_device_locked(self, n: int) -> int:
        S = self.n_shards
        live = (np.flatnonzero(self.db.live_mask[:n]) if n
                else np.zeros(0, np.int64))
        nl = int(live.size)
        # per-shard position capacity: the whole live set + device slack,
        # rounded up so every shard can absorb deltas before a re-pack
        budgeted = nl + max(8, int(nl * self.device_slack))
        M = max(4, -(-budgeted // S))
        total = S * M
        # centroids: at least one per shard (ownership must cover the
        # mesh) — k-means clamps k <= live rows itself
        C = int(self.n_clusters or round(math.sqrt(max(1, nl))))
        C = max(S, min(max(1, C), max(1, nl)))
        if nl:
            cents, assign = _kmeans(self._embs_host[live], C, iters=5,
                                    seed=0)
        else:
            cents = np.full((1, self.embed_dim), TOMBSTONE, np.float32)
            assign = np.zeros(0, np.int64)
        # balanced ownership: biggest clusters first, each to the
        # least-loaded shard
        sizes = np.bincount(assign, minlength=cents.shape[0])
        owner = np.zeros(cents.shape[0], np.int32)
        load = np.zeros(S, np.int64)
        for c in np.argsort(-sizes, kind="stable"):
            s = int(np.argmin(load))
            owner[int(c)] = s
            load[s] += int(sizes[int(c)])
        self._centroids_host = np.asarray(cents, np.float32)
        self._owner_host = owner
        # every live slot gets a position on its owning shard; overfull
        # shards spill to the globally emptiest
        self._pos_per_shard = M
        self._pos_slot = np.full((total,), -1, np.int64)
        self._slot_pos = {}
        nxt = [s * M for s in range(S)]
        pref = (owner[assign] if nl else np.zeros(0, np.int32))
        for slot, p in zip(live, pref):
            p = int(p)
            if nxt[p] >= (p + 1) * M:
                p = int(np.argmin([nxt[s] - s * M for s in range(S)]))
                self.n_spills += 1
            pos = nxt[p]
            nxt[p] += 1
            self._slot_pos[int(slot)] = pos
            self._pos_slot[pos] = int(slot)
        self._shard_free = [
            list(range((s + 1) * M - 1, nxt[s] - 1, -1))
            for s in range(S)]
        self._shard_hands = [0] * S
        shipped = self._upload_layout_locked(n)
        shipped += self._refresh_hot_locked()
        self._shard_gens += 1
        self._spills_since_refresh = 0    # fresh fit: drift clock restarts
        return shipped

    def _upload_layout_locked(self, n: int) -> int:
        """Materialize the current host layout (positions, centroids,
        owners) as a fresh device tier: host staging at positions → the
        shards' tensors, and the slot-indexed device lengths."""
        total = int(self._pos_slot.shape[0])
        table = np.full((total, self.embed_dim), TOMBSTONE, np.float32)
        held = np.flatnonzero(self._pos_slot >= 0)
        slots_held = self._pos_slot[held]
        table[held] = self._embs_host[slots_held]
        host_parts = [np.zeros((total,) + p.shape, p.dtype)
                      for p in self.codec.parts]
        if held.size:
            rows = self.db.parts_at(slots_held)
            for dst, src in zip(host_parts, rows):
                dst[held] = src
        self.device_db = ShardedDeviceDB(host_parts, self.shard_mesh,
                                         self.shard_axis, codec=self.codec)
        di = ShardedDeviceIndex(
            self.embed_dim, mesh=self.shard_mesh, axis=self.shard_axis,
            nprobe=self.route_nprobe, hot_k=self.hot_k)
        di._registry_kind = "sharded"
        di.load(table, self._pos_slot)
        di.set_centroids(self._centroids_host, self._owner_host)
        self.device_index = di
        # slot-indexed device lengths on the lead device (tiny, and the
        # length gate indexes it by the GLOBAL slot id the combine returns)
        cap_slots = n + max(8, int(n * self.device_slack))
        lens = np.full((cap_slots,), -1, np.int32)
        lens[:n] = self._lens_host[:n]
        self._dev_lens = torch.from_numpy(lens).to(self.device)
        return (self.device_db.transfer_bytes
                + di.transfer_bytes + int(lens.nbytes))

    def _delta_sync_device_locked(self, n: int, slots: np.ndarray) -> int:
        M = self._pos_per_shard
        killed: List[int] = []
        touched = set(int(s) for s in slots)
        # every dirty slot's old position frees first: dead slots stay
        # free, live ones re-route by their CURRENT embedding (an evicted
        # slot recycled by admission may belong to another shard now)
        for s in slots:
            self._free_position_locked(int(s), killed)
        live = [int(s) for s in slots if self.db._live[s]]
        write_pos: List[int] = []
        write_slots: List[int] = []
        if live:
            pref = self._route_shards(self._embs_host[np.asarray(live)])
            for slot, p in zip(live, pref):
                if not self.db._live[slot]:
                    continue    # evicted below by an earlier shard sweep
                p = int(p)
                if not self._shard_free[p]:
                    # placement pressure: the routed shard is full —
                    # whether resolved by eviction or by spilling, it is
                    # the drift signal the centroid refresh triggers on
                    self._spills_since_refresh += 1
                    for v in self._evict_shard_locked(p, 1):
                        touched.add(int(v))
                        self._free_position_locked(int(v), killed)
                    if not self._shard_free[p]:
                        p = int(max(range(self.n_shards),
                                    key=lambda s: len(
                                        self._shard_free[s])))
                        self.n_spills += 1
                        if not self._shard_free[p]:
                            raise MemoStoreError(
                                "sharded device tier out of positions "
                                "(needs a full resync)")
                pos = self._shard_free[p].pop()
                self._slot_pos[slot] = pos
                self._pos_slot[pos] = slot
                write_pos.append(pos)
                write_slots.append(slot)
        shipped = 0
        if write_pos:
            posa = np.asarray(write_pos, np.int64)
            sla = np.asarray(write_slots, np.int64)
            shipped += self.device_db.update(posa, self.db.parts_at(sla))
            shipped += self.device_index.update(
                posa, self._embs_host[sla], sla)
        kill = sorted(set(killed) - set(write_pos))
        if kill:
            shipped += self.device_index.kill(np.asarray(kill, np.int64))
        # slot-indexed device lengths for every slot this sync touched
        # (dirty + shard-eviction victims), into a fresh tensor
        ta = np.asarray(sorted(touched), np.int64)
        ta = ta[ta < int(self._dev_lens.shape[0])]
        if ta.size:
            sl, vals = pad_delta_pow2(ta, self._lens_host[ta])
            self._dev_lens = self._dev_lens.index_copy(
                0, torch.from_numpy(sl).to(self.device),
                torch.from_numpy(vals).to(self.device))
            shipped += int(vals.nbytes + sl.size * 4)
        for sh in {pos // M for pos in write_pos + killed}:
            self._shard_gens[sh] += 1
        if self.refresh_spills \
                and self._spills_since_refresh >= self.refresh_spills:
            shipped += self._refresh_centroids_locked()
        shipped += self._refresh_hot_locked()
        return shipped

    def _refresh_centroids_locked(self) -> int:
        """Routing-drift repair between full syncs: once enough delta-sync
        admissions spilled off their preferred shard, re-run k-means over
        the RESIDENT rows' embeddings and re-derive each centroid's owner
        by majority vote of its rows' resident shard — no row moves; only
        the small replicated routing state ships."""
        self._spills_since_refresh = 0
        M = self._pos_per_shard
        if M == 0 or not self._slot_pos or self.device_index is None:
            return 0
        n = len(self.db)
        if n == 0:
            return 0
        resident = np.asarray(sorted(self._slot_pos), np.int64)
        resident = resident[resident < n]
        resident = resident[self.db.live_mask[resident]]
        if resident.size == 0:
            return 0
        # keep the centroid count (and the search_args shapes) fixed:
        # k-means may clamp k below C on tiny stores — pad back with
        # TOMBSTONE rows, which are never the nearest probe
        C = int(self._centroids_host.shape[0])
        cents, assign = _kmeans(self._embs_host[resident], C, iters=5,
                                seed=1 + self.n_centroid_refreshes)
        row_shard = np.asarray(
            [self._slot_pos[int(s)] // M for s in resident], np.int64)
        c_eff = int(cents.shape[0])
        owner = np.zeros(C, np.int32)
        for c in range(c_eff):
            m = assign == c
            if np.any(m):
                owner[c] = np.int32(np.bincount(
                    row_shard[m], minlength=self.n_shards).argmax())
            elif c < self._owner_host.shape[0]:
                owner[c] = self._owner_host[c]
        if c_eff < C:
            pad = np.full((C - c_eff, self.embed_dim), TOMBSTONE,
                          np.float32)
            cents = np.concatenate([np.asarray(cents, np.float32), pad])
        self._centroids_host = np.asarray(cents, np.float32)
        self._owner_host = owner
        self.device_index.set_centroids(self._centroids_host,
                                        self._owner_host)
        self.n_centroid_refreshes += 1
        return int(self._centroids_host.nbytes + owner.nbytes)

    def _hot_slots_locked(self) -> np.ndarray:
        """The top ``hot_k`` live slots by reuse count."""
        n = len(self.db)
        live = np.flatnonzero(self.db.live_mask[:n]) if n else \
            np.zeros(0, np.int64)
        if not (self.hot_k and live.size):
            return np.zeros(0, np.int64)
        order = np.argsort(-self.db.reuse_counts[live], kind="stable")
        return live[order[: self.hot_k]]

    def _refresh_hot_locked(self, take: Optional[np.ndarray] = None) -> int:
        """Rebuild the replicated hot set — ``take`` (default the top
        ``hot_k`` live slots by reuse count) — shipped as fixed-H padded
        arrays (embedding, slot id, codec rows). Runs on every sync."""
        if self.device_index is None:
            return 0
        H = max(1, self.hot_k)
        if take is None:
            take = self._hot_slots_locked()
        take = np.asarray(take, np.int64)
        table = np.full((H, self.embed_dim), TOMBSTONE, np.float32)
        slots = np.full((H,), -1, np.int32)
        parts = [np.zeros((H,) + p.shape, p.dtype)
                 for p in self.codec.parts]
        if take.size:
            table[: take.size] = self._embs_host[take]
            slots[: take.size] = take
            for dst, src in zip(parts, self.db.parts_at(take)):
                dst[: take.size] = src
        return self.device_index.set_hot(table, slots, tuple(parts))

    # ----------------------------------------------------------- publish
    def _publish_locked(self):
        snap = super()._publish_locked()
        occ = self.shard_occupancy()
        self.shard_snapshots = tuple(
            ShardSnapshot(shard=s, generation=int(self._shard_gens[s]),
                          live=int(occ[s]),
                          free=len(self._shard_free[s]))
            for s in range(self.n_shards))
        return snap


DEVICE_INDEXES.register(
    "sharded", lambda dim, *, capacity=0, nprobe=16, device=None,
    mesh=None, axis="store", hot_k=32, **_:
    ShardedDeviceIndex(dim, mesh=(mesh if mesh is not None
                                  else make_store_mesh(None, axis,
                                                       device=device)),
                       axis=axis, capacity=capacity, nprobe=nprobe,
                       hot_k=hot_k))
