"""MemoStore — the lifecycle-managed memo subsystem, the counterpart of
the reference's ``core/store.py``.

The host tier (``AttentionDB`` arena + slot-aligned host index) is the
reference's numpy code, so the same admit/evict/sync sequence leaves
byte-identical arrays in both packages (``state_dict``). The device tier
(``DeviceDB`` + a ``DeviceIndex``, flat or clustered — ``auto`` takes
the clustered layout from ``cluster_crossover`` entries on) is torch
tensors on ``device``. The capacity tier (``core/capacity.py``, opt-in
with ``capacity_dir``) is the durable mmap-backed disk tier behind the
host budget, numpy like the reference's.

* ``admit(apms, embs)`` — admission under a byte budget, recycling
                          free slots (stable slot ids, no compaction).
* ``evict(n)``          — the registered eviction policy (CLOCK).
* ``sync()``            — generation-counted incremental device sync: a
                          no-op when clean, deltas of the dirty slots
                          when the device slack holds them, a full
                          re-materialization otherwise. Ends by
                          publishing a ``StoreSnapshot``.

With a capacity tier every admission is written through to the disk
(journal first, then the arenas), so eviction becomes demotion (the host
copy is dropped, the disk copy stays live) and ``promote_for`` brings
disk rows whose calibrated similarity clears the threshold back into the
host arena bit-identically (``put_parts``). Promoted slots are dirty
host slots like admitted ones: they reach the device through the
copy-on-write delta sync, never by a write into a published snapshot.
Any disk error or stall detaches the tier (``capacity_error``) and
serving goes on RAM-only until ``reattach_capacity``.

Snapshots never change once published, as the reference's immutable jnp
arrays do not. A delta sync is copy-on-write: the device arena parts,
the index's arrays (the flat table and its row norms, or the clustered
index's packed and overflow arrays) and the entry lengths are written
into fresh tensors (``DeviceDB.update``, the index's ``assign`` /
``remove``) and ``publish()`` swaps the references. A generation stays
alive until the last ``PreparedBatch`` holding it is dropped, so a
maintenance worker may sync while a batch is still serving the previous
snapshot (``core/runtime.py``). Its price is one copy of the device tier
per delta sync.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.capacity import CapacityTier
from repro_torch.core.database import AttentionDB, DeviceDB, pad_delta_pow2
from repro_torch.core.faults import FaultInjector, MemoStoreError, fire
from repro_torch.core.index import (TOMBSTONE, ClusteredDeviceIndex,
                                    DeviceIndex)
from repro_torch.core.registry import DEVICE_INDEXES, EVICTIONS, HOST_INDEXES


class StoreSnapshot(NamedTuple):
    """The device tier as one batch serves it (read once per batch)."""
    generation: int
    db_parts: Tuple[torch.Tensor, ...]    # DeviceDB codec parts
    index: object                         # the DeviceIndex of search_args
    search_args: object                   # flat: (table, row_norms);
    #                                       clustered: (centroids, pvecs,
    #                                       pscales, pids, ovecs, oscales,
    #                                       oids)
    index_key: str
    codec_key: object
    lengths: torch.Tensor                 # (cap,) int32 entry lengths
    sim_a: float                          # dist→similarity calibration
    sim_b: float


@dataclass
class StoreStats:
    """Lifecycle + transfer accounting (the delta-vs-full receipts)."""
    n_admitted: int = 0
    n_evicted: int = 0
    n_noop_syncs: int = 0
    n_delta_syncs: int = 0
    n_full_syncs: int = 0
    bytes_delta: int = 0          # bytes moved by delta syncs
    bytes_full: int = 0           # bytes moved by full re-materializations
    n_quarantined: int = 0        # entries tombstoned on checksum mismatch
    n_evict_rejected: int = 0     # bogus policy slots the store refused
    # capacity tier (DESIGN.md §2.11)
    n_demoted: int = 0            # evictions that kept a disk copy (cooled)
    n_promoted: int = 0           # disk rows re-admitted into the host tier
    n_disk_quarantined: int = 0   # disk rows retired on checksum mismatch
    n_disk_errors: int = 0        # tier ops that failed (→ RAM-only)

    @property
    def bytes_total(self) -> int:
        return self.bytes_delta + self.bytes_full


class MemoStore:
    """Both memo tiers behind one lifecycle (lookup/admit/evict/sync)."""

    def __init__(self, apm_shape: Tuple[int, int, int], embed_dim: int, *,
                 index_kind: str = "exact", budget_bytes: Optional[int] = None,
                 capacity: int = 64, device=None, device_slack: float = 1.0,
                 n_lists: Optional[int] = None, codec: str = "f16",
                 apm_rank: Optional[int] = None,
                 device_index_kind: str = "auto",
                 cluster_crossover: int = 4096, nprobe: int = 16,
                 n_clusters: Optional[int] = None, eviction: str = "clock",
                 faults: Optional[FaultInjector] = None,
                 capacity_dir: Optional[str] = None,
                 capacity_budget_mb: Optional[float] = None,
                 capacity_fsync: bool = True,
                 capacity_stall_s: float = 5.0, mesh=None):
        self.apm_shape = tuple(apm_shape)
        self.embed_dim = embed_dim
        self.index_kind = index_kind
        self.budget_bytes = budget_bytes
        self.device_slack = device_slack
        self.device = torch.device(device if device is not None else "cpu")
        # a ``shard.StoreMesh``: the flat/clustered device indexes (and
        # the 'device' host index) search through ``shard.mesh_search``
        # over a row-split copy of their table
        self._mesh = mesh
        self.device_index_kind = device_index_kind  # flat|clustered|auto
        self.cluster_crossover = cluster_crossover
        self.nprobe = nprobe
        self.n_clusters = n_clusters
        self.db = AttentionDB(self.apm_shape, capacity=capacity,
                              codec=codec, rank=apm_rank)
        self.eviction_kind = eviction
        self._evict_policy = EVICTIONS.resolve(eviction)
        if device_index_kind != "auto":
            DEVICE_INDEXES.resolve(device_index_kind)   # fail-fast only
        self.index = HOST_INDEXES.resolve(index_kind)(
            embed_dim, n_lists=n_lists, device=self.device, mesh=mesh)
        self.sim_cal: Tuple[float, float] = (-1.0, 1.0)
        self._embs_host = np.full((capacity, embed_dim), TOMBSTONE,
                                  np.float32)
        self._lens_host = np.full((capacity,), -1, np.int32)
        self._dev_lens: Optional[torch.Tensor] = None
        self._lock = threading.RLock()
        self._snapshot: Optional[StoreSnapshot] = None
        self._faults = faults
        self.generation = 0           # bumped on every host-tier mutation
        self.device_generation = -1   # generation the device tier reflects
        self._dirty: set = set()      # host slots changed since last sync
        self._synced_n = 0            # arena prefix length at last sync
        self._clock_hand = 0
        self.stats = StoreStats()
        self.device_db: Optional[DeviceDB] = None
        self.device_index = None
        # capacity tier: any disk error detaches it (``capacity_error``
        # set) and serving goes on RAM-only; ``reattach_capacity``
        # re-opens it
        self._capacity_dir = capacity_dir
        self._capacity_budget_mb = capacity_budget_mb
        self._capacity_fsync = capacity_fsync
        self._capacity_stall_s = float(capacity_stall_s)
        self.capacity: Optional[CapacityTier] = None
        self.capacity_error: Optional[str] = None
        self._host_to_disk: Dict[int, int] = {}
        self._disk_to_host: Dict[int, int] = {}
        # host seconds of promote_for's legs, summed over its calls
        # (search over the disk embeddings, the CRC re-check, put_parts)
        self.promote_secs: Dict[str, float] = {"search": 0.0, "crc": 0.0,
                                               "put_parts": 0.0}
        if capacity_dir is not None:
            try:
                self._open_capacity_locked()
            except Exception as e:       # noqa: BLE001 — degrade, don't die
                self._capacity_fail(e)

    # ------------------------------------------------------------ accounting
    @property
    def codec(self):
        return self.db.codec

    @property
    def entry_nbytes(self) -> int:
        """Codec-true bytes per entry (compressed APM + f32 embedding)."""
        return self.db.entry_nbytes + self.embed_dim * 4

    @property
    def logical_entry_nbytes(self) -> int:
        """What an uncompressed f16 entry would cost (receipt baseline)."""
        return self.db.logical_entry_nbytes + self.embed_dim * 4

    @property
    def live_count(self) -> int:
        return self.db.live_count

    @property
    def budget_entries(self) -> Optional[int]:
        if self.budget_bytes is None:
            return None
        return max(1, int(self.budget_bytes) // self.entry_nbytes)

    @property
    def device_stale(self) -> bool:
        return (self.device_db is None
                or self.device_generation != self.generation
                or len(self.db) > self._synced_n)

    def __len__(self):
        return len(self.db)

    # --------------------------------------------------------------- lookup
    def lookup(self, embs, k: int = 1):
        """Host-tier search: (L2 dists (B,k), slots (B,k))."""
        return self.index.search(np.asarray(embs, np.float32), k)

    def note_reuse(self, slots: Sequence[int]) -> None:
        """Record device-tier hits (drained once per batch)."""
        slots = np.asarray(slots).reshape(-1)
        if slots.size:
            with self._lock:
                np.add.at(self.db.reuse_counts, slots, 1)

    @property
    def default_len(self) -> int:
        return int(self.apm_shape[-1])

    def entry_lengths(self, slots) -> np.ndarray:
        """Valid sequence length per slot (−1 for dead slots): the host
        leg of the length gate; the device leg rides in the snapshot."""
        slots = np.asarray(slots).reshape(-1)
        return self._lens_host[slots]

    def embeddings_at(self, slots) -> np.ndarray:
        slots = np.asarray(slots).reshape(-1)
        return self._embs_host[slots].copy()

    # ------------------------------------------------------- capacity tier
    @property
    def capacity_ok(self) -> bool:
        """True while the disk tier is attached and error-free."""
        return self.capacity is not None and self.capacity_error is None

    def _open_capacity_locked(self) -> None:
        budget = (None if self._capacity_budget_mb is None
                  else int(float(self._capacity_budget_mb) * 1e6))
        self.capacity = CapacityTier(
            self._capacity_dir, codec=self.db.codec,
            embed_dim=self.embed_dim, capacity=self.db.capacity,
            budget_bytes=budget, faults=self._faults,
            fsync=self._capacity_fsync)
        self.capacity.on_retire = self._on_disk_retire
        self.capacity.on_compact = self._on_disk_compact
        # a recovered manifest carries the calibration it was
        # checkpointed under: a dir-load serves with the sim map its
        # entries were admitted against
        cal = (self.capacity.extra_meta or {}).get("sim_cal")
        if cal is not None and len(cal) == 2:
            self.sim_cal = (float(cal[0]), float(cal[1]))

    def _capacity_fail(self, e: BaseException) -> None:
        """Disk fault: flag the tier offline (RAM-only serving); never
        raise into admission, eviction or serving."""
        self.capacity_error = f"{type(e).__name__}: {e}"
        self.stats.n_disk_errors += 1

    def _on_disk_retire(self, slots) -> None:
        """Tier callback: disk rows retired (budget/quarantine); drop any
        host↔disk mapping so a recycled disk slot cannot alias."""
        for d in np.asarray(slots).reshape(-1):
            h = self._disk_to_host.pop(int(d), None)
            if h is not None:
                self._host_to_disk.pop(h, None)

    def _on_disk_compact(self, old_slots, new_slots) -> None:
        """Tier callback: compaction renumbered every live disk slot;
        rewrite the host↔disk maps so mirrored entries stay linked."""
        remap = {int(o): int(w) for o, w in zip(
            np.asarray(old_slots).reshape(-1),
            np.asarray(new_slots).reshape(-1))}
        h2d, d2h = {}, {}
        for h, d in self._host_to_disk.items():
            w = remap.get(int(d))
            if w is not None:
                h2d[h] = w
                d2h[w] = h
        self._host_to_disk, self._disk_to_host = h2d, d2h

    def _capacity_op(self, fn, *args, **kwargs):
        """Run one tier op under the stall watchdog: an op slower than
        ``capacity_stall_s`` (a ``stall_s`` rider, a hung disk) fails the
        tier like an IO error, so a stalled promotion degrades to
        RAM-only serving instead of blocking it."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        if dt > self._capacity_stall_s:
            raise TimeoutError(
                f"capacity tier op {getattr(fn, '__name__', fn)!r} took "
                f"{dt:.3f}s (stall threshold {self._capacity_stall_s}s)")
        return out

    def _mirror_to_capacity_locked(self, slots) -> None:
        """Write-through: durably append the given host slots' encoded
        rows (and their recorded checksums) to the disk tier. Slots
        already mirrored are skipped, so demotion is free."""
        fresh = [int(s) for s in np.asarray(slots).reshape(-1)
                 if int(s) not in self._host_to_disk]
        if not fresh:
            return
        arr = np.asarray(fresh, np.int64)
        parts = self.db.parts_at(arr)
        csums = [c[arr] for c in self.db.checksums]
        dslots = self._capacity_op(
            self.capacity.append, parts, self._embs_host[arr],
            self._lens_host[arr], csums)
        for h, d in zip(fresh, dslots):
            self._host_to_disk[h] = int(d)
            self._disk_to_host[int(d)] = h

    def _adopt_disk_rows_locked(self, parts, dembs, dlens, dcsums,
                                dslots) -> np.ndarray:
        """Land disk rows in the host arena bit-identically (their bytes
        and recorded checksums, ``put_parts``), mirror them into the
        slot-aligned staging and the host index, mark them dirty for the
        next delta sync and link them to their disk slots."""
        slots = self.db.put_parts(parts, dcsums)
        self._ensure_emb_capacity(int(slots.max()) + 1)
        self._embs_host[slots] = dembs
        self._lens_host[slots] = dlens
        if self.index is not self.device_index:
            self.index.assign(slots, dembs)
        self._dirty.update(int(s) for s in slots)
        self.generation += 1
        self.capacity.note_reuse(dslots)
        for h, d in zip(slots, dslots):
            self._host_to_disk[int(h)] = int(d)
            self._disk_to_host[int(d)] = int(h)
        return slots

    def promote_for(self, embs, lengths=None, *, threshold: float,
                    max_promote: int = 64) -> np.ndarray:
        """Promotion disk → host → device: search the disk tier for the
        given miss embeddings; rows whose calibrated predicted similarity
        clears ``threshold`` (and whose stored length matches) come back
        into the host arena bit-identically after a per-row CRC re-check
        (corrupt disk rows are retired). Promoted slots are dirty; the
        next delta sync ships them to the device tier. Returns a (B,)
        bool mask of queries a disk-resident entry satisfies (a match
        already resident counts: its capture need not be admitted)."""
        embs = np.asarray(embs, np.float32)
        B = embs.shape[0]
        satisfied = np.zeros(B, bool)
        if B == 0 or not self.capacity_ok:
            return satisfied
        secs = self.promote_secs
        with self._lock:
            tier = self.capacity
            lens = (np.full(B, self.default_len, np.int32)
                    if lengths is None
                    else np.asarray(lengths, np.int32).reshape(-1))
            t0 = time.perf_counter()
            try:
                d2, dslots = self._capacity_op(tier.search, embs, 1)
            except Exception as e:      # noqa: BLE001 — degrade
                self._capacity_fail(e)
                return satisfied
            finally:
                secs["search"] += time.perf_counter() - t0
            a, b = self.sim_cal
            sim = a * np.sqrt(np.maximum(d2[:, 0], 0.0)) + b
            chosen = np.full(B, -1, np.int64)   # query → disk slot
            picks: List[int] = []               # unique disk slots to pull
            for i in range(B):
                d = int(dslots[i, 0])
                if d < 0 or sim[i] < float(threshold) \
                        or int(tier._lens[d]) != int(lens[i]):
                    continue
                h = self._disk_to_host.get(d)
                if h is not None and self.db._live[h]:
                    satisfied[i] = True         # already resident
                    continue
                if d in picks or len(picks) < int(max_promote):
                    satisfied[i] = True
                    chosen[i] = d
                    if d not in picks:
                        picks.append(d)
            if not picks:
                return satisfied
            dlist = np.asarray(picks, np.int64)
            t0 = time.perf_counter()
            try:
                parts, dembs, dlens, dcsums = self._capacity_op(
                    tier.rows_at, dlist)
            except Exception as e:      # noqa: BLE001 — degrade
                self._capacity_fail(e)
                return np.zeros(B, bool)
            good = np.ones(dlist.size, bool)
            for p, c in zip(parts, dcsums):
                good &= AttentionDB._crc_rows(p) == c
            secs["crc"] += time.perf_counter() - t0
            if not good.all():
                bad = dlist[~good]
                try:
                    tier.retire(bad)
                except Exception as e:  # noqa: BLE001
                    self._capacity_fail(e)
                self.stats.n_disk_quarantined += int(bad.size)
                satisfied[np.isin(chosen, bad)] = False
                dlist = dlist[good]
                parts = tuple(p[good] for p in parts)
                dembs, dlens = dembs[good], dlens[good]
                dcsums = tuple(c[good] for c in dcsums)
            if dlist.size == 0:
                return satisfied
            cap = self.budget_entries
            if cap is not None:
                over = self.live_count + int(dlist.size) - cap
                if over > 0:
                    self.evict(over)
            t0 = time.perf_counter()
            slots = self._adopt_disk_rows_locked(parts, dembs, dlens,
                                                 dcsums, dlist)
            secs["put_parts"] += time.perf_counter() - t0
            self.stats.n_promoted += int(slots.size)
        return satisfied

    def checkpoint(self) -> bool:
        """Flush the disk tier's WAL into a fresh shadow manifest (the
        maintenance actor calls this every ``checkpoint_every`` applied
        payloads). Failures detach the tier, never raise."""
        with self._lock:
            if not self.capacity_ok:
                return False
            try:
                self._capacity_op(
                    self.capacity.checkpoint,
                    {"sim_cal": [float(self.sim_cal[0]),
                                 float(self.sim_cal[1])]})
                return True
            except Exception as e:      # noqa: BLE001 — degrade
                self._capacity_fail(e)
                return False

    def compact_capacity(self, min_retired: float = 0.0) -> Optional[dict]:
        """Re-compact the disk tier when at least ``min_retired`` of its
        allocated slots are retired holes. Returns the tier's compaction
        report, or ``None`` below the threshold or with the tier
        detached. Failures detach the tier, never raise."""
        with self._lock:
            if not self.capacity_ok:
                return None
            tier = self.capacity
            if tier.retired_fraction < float(min_retired):
                return None
            try:
                # not under the stall watchdog: rewriting every live row
                # is proportional to the arena, not a hung-disk signal
                return tier.compact()
            except Exception as e:      # noqa: BLE001 — degrade
                self._capacity_fail(e)
                return None

    def reattach_capacity(self) -> bool:
        """Re-open the capacity tier after a disk fault (the
        ``MemoServer.recover`` path): recover the directory, clear the
        error, rebuild the host↔disk mapping by checksum and write
        through whatever the disk missed during the outage."""
        with self._lock:
            if self._capacity_dir is None:
                return False
            old, self.capacity = self.capacity, None
            if old is not None:
                try:
                    old.close()
                except Exception:       # noqa: BLE001 — already failed
                    pass
            self.capacity_error = None
            self._host_to_disk.clear()
            self._disk_to_host.clear()
            try:
                self._open_capacity_locked()
                self._remirror_locked()
                return True
            except Exception as e:      # noqa: BLE001 — stay detached
                self._capacity_fail(e)
                return False

    def _remirror_locked(self) -> None:
        """Reconcile host tier → disk tier: map host entries to disk rows
        whose primary-part checksum matches (no duplicate appends), then
        write through the rest."""
        tier = self.capacity
        by_csum: Dict[int, int] = {}
        for d in tier.live_slots:
            by_csum.setdefault(int(tier._csums[0][d]), int(d))
        unmapped: List[int] = []
        for h in np.flatnonzero(self.db.live_mask):
            h = int(h)
            if h in self._host_to_disk:
                continue
            d = by_csum.get(int(self.db.checksums[0][h]))
            if d is not None and d not in self._disk_to_host:
                self._host_to_disk[h] = d
                self._disk_to_host[d] = h
            else:
                unmapped.append(h)
        if unmapped:
            self._mirror_to_capacity_locked(unmapped)

    def demote_to_budget(self) -> List[int]:
        """Cool the host tier down to its byte budget (a plain evict with
        no disk tier; with one, every evicted entry keeps its disk
        copy)."""
        cap = self.budget_entries
        if cap is None:
            return []
        over = self.live_count - cap
        return self.evict(over) if over > 0 else []

    def adopt_capacity(self, max_entries: Optional[int] = None) -> int:
        """Populate an EMPTY host tier from the recovered disk tier (the
        ``MemoSession.load(<capacity dir>)`` warm start): hottest disk
        rows first, up to ``max_entries`` and the byte budget, admitted
        bit-identically. Returns the number of entries taken; the rest
        stay on disk, promotable on demand."""
        with self._lock:
            if not self.capacity_ok:
                return 0
            tier = self.capacity
            live = tier.live_slots
            if live.size == 0:
                return 0
            order = live[np.argsort(-tier._reuse[live], kind="stable")]
            cap = self.budget_entries
            take = live.size if max_entries is None else int(max_entries)
            if cap is not None:
                take = min(take, max(0, cap - self.live_count))
            order = order[:take]
            if order.size == 0:
                return 0
            try:
                parts, dembs, dlens, dcsums = tier.rows_at(order)
            except Exception as e:      # noqa: BLE001 — degrade
                self._capacity_fail(e)
                return 0
            slots = self._adopt_disk_rows_locked(parts, dembs, dlens,
                                                 dcsums, order)
            return int(slots.size)

    # --------------------------------------------------------------- admit
    def _ensure_emb_capacity(self, need: int) -> None:
        cap = self._embs_host.shape[0]
        if need <= cap:
            return
        new = np.full((max(need, 2 * cap), self.embed_dim), TOMBSTONE,
                      np.float32)
        new[:cap] = self._embs_host
        self._embs_host = new
        lens = np.full((new.shape[0],), -1, np.int32)
        lens[:cap] = self._lens_host
        self._lens_host = lens

    def admit(self, apms, embs, lengths=None, kv=None) -> np.ndarray:
        """Admission under the byte budget. apms: (B, H, L, L), embs:
        (B, embed_dim), lengths: optional (B,) true lengths, kv: the
        codec's side-channel payload (the (B, 2, S, D) K/V planes under a
        prefill codec; plain APM codecs ignore it). Returns the assigned
        arena slots (recycled free slots first, then appends)."""
        with self._lock:
            return self._admit_locked(apms, embs, lengths, kv)

    def _admit_locked(self, apms, embs, lengths, kv=None) -> np.ndarray:
        apms = np.asarray(apms, self.db.dtype)
        embs = np.asarray(embs, np.float32)
        if kv is not None:
            kv = np.asarray(kv)
        lengths = (np.full(apms.shape[0], self.default_len, np.int32)
                   if lengths is None
                   else np.asarray(lengths, np.int32).reshape(-1))
        n_new = apms.shape[0]
        if n_new == 0:
            return np.zeros(0, np.int64)
        cap = self.budget_entries
        if cap is not None:
            if n_new > cap:
                apms, embs = apms[-cap:], embs[-cap:]
                lengths = lengths[-cap:]
                if kv is not None:
                    kv = kv[-cap:]
                n_new = cap
            over = self.live_count + n_new - cap
            if over > 0:
                self.evict(over)
        slots = self.db.put(apms, aux=kv)
        self._ensure_emb_capacity(int(slots.max()) + 1)
        self._embs_host[slots] = embs
        self._lens_host[slots] = lengths
        if self.index is not self.device_index:
            self.index.assign(slots, embs)
        self._dirty.update(int(s) for s in slots)
        self.generation += 1
        self.stats.n_admitted += n_new
        # write-through: journal and append every admission to the disk
        # tier now, so demotion later is free. Before the corrupt_row
        # fault site: the disk keeps the bytes as encoded, like the
        # recorded checksums
        if self.capacity_ok:
            try:
                self._mirror_to_capacity_locked(slots)
            except Exception as e:      # noqa: BLE001 — degrade
                self._capacity_fail(e)
        if fire(self._faults, "store.corrupt_row") is not None:
            row = self.db._arenas[0][int(slots[-1])]
            row.view(np.uint8)[...] ^= 0xFF
        return slots

    # --------------------------------------------------------------- evict
    def evict(self, n: int = 1) -> List[int]:
        """Evict ``n`` entries chosen by the registered policy; evicted
        slots are released to the free-list and tombstoned in the index."""
        db = self.db
        if n <= 0 or db._n == 0 or db.live_count == 0:
            return []
        with self._lock:
            n = min(n, db.live_count)
            evicted = [int(s) for s in self._evict_policy(self, n)]
            if fire(self._faults, "store.evict_bogus") is not None:
                dead = np.flatnonzero(~db.live_mask)
                evicted += ([evicted[0]] if evicted else []) \
                    + [db._n + 7] \
                    + ([int(dead[0])] if dead.size else [])
            seen: set = set()
            valid = []
            for s in evicted:
                if 0 <= s < db._n and db._live[s] and s not in seen:
                    valid.append(s)
                    seen.add(s)
                else:
                    self.stats.n_evict_rejected += 1
            evicted = valid
            if not evicted:
                return evicted
            self._retire_slots_locked(evicted)
            self.stats.n_evicted += len(evicted)
        return evicted

    def _retire_slots_locked(self, slots: List[int],
                             demote: bool = True) -> None:
        """Release the arena slots and tombstone every index row, so a
        hit on them is impossible. With a healthy capacity tier and
        ``demote=True`` (eviction) the entries are cooled, not lost: any
        not yet mirrored are written through first, and only the host
        copy goes. Quarantine passes ``demote=False`` (its host bytes are
        corrupt; a disk copy written at admission survives)."""
        if demote and self.capacity_ok:
            try:
                self._mirror_to_capacity_locked(slots)
                self.stats.n_demoted += len(slots)
            except Exception as e:      # noqa: BLE001 — plain eviction
                self._capacity_fail(e)
        for h in slots:                 # host slots recycle; unlink maps
            d = self._host_to_disk.pop(int(h), None)
            if d is not None:
                self._disk_to_host.pop(d, None)
        self.db.release(slots)
        self.index.remove(slots)
        self._ensure_emb_capacity(max(slots) + 1)
        self._embs_host[slots] = TOMBSTONE
        self._lens_host[slots] = -1
        self._dirty.update(slots)
        self.generation += 1

    # ------------------------------------------------------------ integrity
    def _quarantine_locked(self, bad: np.ndarray) -> List[int]:
        bad = [int(s) for s in np.asarray(bad).reshape(-1)]
        if bad:
            self._retire_slots_locked(bad, demote=False)
            self.stats.n_quarantined += len(bad)
        return bad

    def verify_integrity(self, quarantine: bool = True) -> List[int]:
        """Recompute every live entry's checksums; quarantine mismatches.
        With a capacity tier attached the sweep extends to every live
        disk row (mismatches retired there, counted in
        ``stats.n_disk_quarantined``); the returned ids stay host
        slots."""
        with self._lock:
            if self.capacity_ok:
                try:
                    dbad = self.capacity.verify()
                    if dbad.size and quarantine:
                        self.capacity.retire(dbad)
                        self.stats.n_disk_quarantined += int(dbad.size)
                except Exception as e:  # noqa: BLE001 — degrade
                    self._capacity_fail(e)
            bad = self.db.verify()
            if quarantine:
                return self._quarantine_locked(bad)
            return [int(s) for s in bad]

    # ---------------------------------------------------------------- sync
    def _device_index_kind(self, n: int) -> str:
        """flat | clustered: ``auto`` flips to the clustered index once
        the entry count reaches ``cluster_crossover``."""
        if self.device_index_kind == "auto":
            return ("clustered" if n >= self.cluster_crossover else "flat")
        return self.device_index_kind

    @staticmethod
    def _device_index_kind_of(index) -> Optional[str]:
        if index is None:
            return None
        kind = getattr(index, "_registry_kind", None)
        if kind is not None:
            return kind
        return ("clustered" if isinstance(index, ClusteredDeviceIndex)
                else "flat")

    def _absorb_external_growth(self) -> None:
        """Backstop for out-of-band ``db.add``/``index.add`` growth."""
        lo, hi = self._synced_n, len(self.db)
        if hi <= lo:
            return
        fresh = [s for s in range(lo, hi) if s not in self._dirty]
        if fresh:
            rows = getattr(self.index, "_embs", None)
            self._ensure_emb_capacity(hi)
            for s in fresh:
                if rows is not None and s < rows.shape[0]:
                    self._embs_host[s] = rows[s]
                self._lens_host[s] = self.default_len
            self._dirty.update(fresh)
            self.generation += 1

    def sync(self, force_full: bool = False) -> Dict[str, object]:
        """Incremental device sync; publishes a fresh ``StoreSnapshot``."""
        with self._lock:
            return self._sync_locked(force_full)

    def _need_full_sync_locked(self, n: int, force_full: bool) -> bool:
        return (force_full or self.device_db is None
                or n > self.device_db.capacity
                or self.device_index is None
                or n > self.device_index.capacity
                or self._device_index_kind(n)
                != self._device_index_kind_of(self.device_index))

    def _full_sync_device_locked(self, n: int) -> int:
        cap = n + max(8, int(n * self.device_slack))
        kind = self._device_index_kind(n)
        di = DEVICE_INDEXES.resolve(kind)(
            self.embed_dim, capacity=cap, nprobe=self.nprobe,
            n_clusters=self.n_clusters, device=self.device, mesh=self._mesh)
        di._registry_kind = kind
        di.add(self._embs_host[:n])
        if isinstance(di, ClusteredDeviceIndex):
            # build eagerly: the k-means belongs on the sync boundary, not
            # in the first serving batch, and the full-sync receipt must
            # include the shipped clusters
            di.rebuild()
        self.device_db = DeviceDB.from_host(self.db, capacity=cap,
                                            device=self.device)
        if isinstance(self.index, DeviceIndex):
            # the device table IS the host-tier index: one object
            self.index = di
        self.device_index = di
        lens = np.full((cap,), -1, np.int32)
        lens[:n] = self._lens_host[:n]
        self._dev_lens = torch.from_numpy(lens).to(self.device)
        return (self.device_db.transfer_bytes
                + self.device_index.transfer_bytes + int(lens.nbytes))

    def _delta_sync_device_locked(self, n: int, slots: np.ndarray) -> int:
        shipped = self.device_db.update(slots, self.db.parts_at(slots))
        b0 = self.device_index.transfer_bytes
        dead = slots[~self.db._live[slots]]
        live = slots[self.db._live[slots]]
        if live.size:
            self.device_index.assign(live, self._embs_host[live])
        if dead.size:
            self.device_index.remove(dead)
        shipped += self.device_index.transfer_bytes - b0
        if slots.size:
            sl, vals = pad_delta_pow2(slots, self._lens_host[slots])
            self._dev_lens = self._dev_lens.index_copy(
                0, torch.from_numpy(sl.astype(np.int64)).to(self.device),
                torch.from_numpy(vals).to(self.device))
            shipped += int(vals.nbytes + sl.size * 4)
        return shipped

    def _sync_locked(self, force_full: bool) -> Dict[str, object]:
        if fire(self._faults, "store.sync_fail") is not None:
            raise MemoStoreError(
                f"injected delta-sync failure (store generation "
                f"{self.generation})")
        self._absorb_external_growth()
        n = len(self.db)
        if (self.device_db is not None and not force_full
                and not self._dirty):
            self.stats.n_noop_syncs += 1
            if self._snapshot is None:
                self.publish()
            return {"kind": "noop", "bytes": 0}
        need_full = self._need_full_sync_locked(n, force_full)
        check = (None if need_full
                 else np.asarray(sorted(self._dirty), np.int64))
        bad = self.db.verify(check)
        if bad.size:
            self._quarantine_locked(bad)
        if need_full:
            shipped = self._full_sync_device_locked(n)
            self.stats.n_full_syncs += 1
            self.stats.bytes_full += shipped
            kind = "full"
        else:
            slots = np.asarray(sorted(self._dirty), np.int64)
            slots = slots[slots < n]
            shipped = self._delta_sync_device_locked(n, slots)
            self.stats.n_delta_syncs += 1
            self.stats.bytes_delta += shipped
            kind = "delta"
        self._dirty.clear()
        self._synced_n = n
        self.device_generation = self.generation
        self.publish()
        return {"kind": kind, "bytes": shipped}

    # ------------------------------------------------------------- publish
    @property
    def snapshot(self) -> Optional[StoreSnapshot]:
        return self._snapshot

    def publish(self) -> StoreSnapshot:
        """Build and install a fresh ``StoreSnapshot`` (end of every sync
        and after a calibration change)."""
        with self._lock:
            return self._publish_locked()

    def _publish_locked(self) -> StoreSnapshot:
        di = self.device_index
        snap = StoreSnapshot(
            generation=self.generation,
            db_parts=self.device_db.parts,
            index=di,
            search_args=di.search_args,
            index_key=type(di).__name__,
            codec_key=self.codec.key,
            lengths=self._dev_lens,
            sim_a=float(self.sim_cal[0]),
            sim_b=float(self.sim_cal[1]))
        self._snapshot = snap
        return snap

    # --------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Every host-tier array needed to reconstruct this store exactly
        (the reference's layout, so a state moves between packages)."""
        with self._lock:
            n = len(self.db)
            out = {
                "n": np.asarray(n, np.int64),
                "free": np.asarray(self.db._free, np.int64),
                "live": self.db._live[:n].copy(),
                "reuse": self.db.reuse_counts[:n].copy(),
                "embs": self._embs_host[:n].copy(),
                "lens": self._lens_host[:n].copy(),
                "clock_hand": np.asarray(self._clock_hand, np.int64),
                "sim_cal": np.asarray(self.sim_cal, np.float64),
            }
            for spec, arena, csum in zip(self.codec.parts, self.db._arenas,
                                         self.db.checksums):
                out[f"part_{spec.name}"] = arena[:n].copy()
                out[f"csum_{spec.name}"] = csum[:n].copy()
            # the host index's staging array at its FULL grown shape: the
            # ivf index's k-means runs over the slack rows too, so its
            # searches reproduce only from the exact array
            embs = getattr(self.index, "_embs", None)
            if embs is not None:
                out["index_embs"] = np.asarray(embs).copy()
            return out

    def load_state_dict(self, state: Dict[str, np.ndarray],
                        adopt_arenas: bool = False) -> None:
        """Restore ``state_dict`` output — this package's or the
        reference's — into this freshly constructed, identically
        configured store. The device tier stays unmaterialized; the next
        ``sync()`` performs the full upload.

        ``adopt_arenas=True`` (``MemoSession.load(..., mmap=True)``)
        installs the given part arrays AS the arenas instead of copying
        rows in: with format-3 copy-on-write memmaps the arena bytes stay
        on disk until first read or written."""
        with self._lock:
            n = int(np.asarray(state["n"]).reshape(-1)[0])
            db = self.db
            db._grow_to(n)
            parts_state = [state.get(f"part_{spec.name}")
                           for spec in self.codec.parts]
            adopted = (adopt_arenas and n > 0 and db.capacity == n
                       and all(p is not None
                               and p.shape == a.shape and p.dtype == a.dtype
                               for p, a in zip(parts_state, db._arenas)))
            if adopted:
                db._arenas = [p if isinstance(p, np.memmap)
                              else np.ascontiguousarray(p)
                              for p in parts_state]
            for spec, arena, csum in zip(self.codec.parts, db._arenas,
                                         db.checksums):
                if not adopted:
                    arena[:n] = state[f"part_{spec.name}"]
                saved = state.get(f"csum_{spec.name}")
                csum[:n] = (saved if saved is not None
                            else db._crc_rows(arena[:n]))
            db._n = n
            db._live[:n] = state["live"]
            db.reuse_counts[:n] = state["reuse"]
            db._free = [int(s) for s in state["free"]]
            self._ensure_emb_capacity(n)
            self._embs_host[:n] = state["embs"]
            self._lens_host[:n] = state["lens"]
            self._clock_hand = int(
                np.asarray(state["clock_hand"]).reshape(-1)[0])
            self.sim_cal = tuple(
                float(v) for v in np.asarray(state["sim_cal"]).reshape(-1))
            # the host index from the saved staging array at its EXACT
            # shape (ivf k-means over the slack rows; assign()'s growth
            # would change it)
            embs = state.get("index_embs")
            if embs is not None and len(embs):
                try:
                    self.index._embs = np.asarray(embs, np.float32).copy()
                    if hasattr(self.index, "_built"):
                        self.index._built = False
                except AttributeError:     # computed staging view
                    self.index.assign(np.arange(len(embs)), embs)
            elif n:
                self.index.assign(np.arange(n), self._embs_host[:n])
            self._dirty.clear()
            self._synced_n = n
            self.generation = 0
            self.device_generation = -1
            self.device_db = None
            self.device_index = None
            self._dev_lens = None
            self._snapshot = None
            # a capacity dir attached to a file-load: reconcile the two
            # (checksum-matched mapping, write-through for the rest) so
            # the disk tier mirrors the loaded host tier from the start
            if self.capacity_ok:
                try:
                    self._remirror_locked()
                except Exception as e:  # noqa: BLE001 — degrade
                    self._capacity_fail(e)


# ------------------------------------------------------ eviction policies
def clock_eviction(store: MemoStore, n: int) -> List[int]:
    """Reuse-aware CLOCK (the reference's policy, line for line)."""
    db = store.db
    counts = db.reuse_counts
    evicted: List[int] = []
    hand = store._clock_hand % db._n
    scanned, limit = 0, 2 * db._n
    while len(evicted) < n and scanned < limit:
        slot, hand = hand, (hand + 1) % db._n
        scanned += 1
        if not db._live[slot]:
            continue
        if counts[slot] > 0:
            counts[slot] //= 2
        else:
            evicted.append(slot)
    store._clock_hand = hand
    if len(evicted) < n:   # all hot: fall back to coldest-first
        live = np.flatnonzero(db.live_mask)
        live = live[~np.isin(live, evicted)]
        order = live[np.argsort(counts[live], kind="stable")]
        evicted.extend(int(s) for s in order[: n - len(evicted)])
    return evicted


def coldest_eviction(store: MemoStore, n: int) -> List[int]:
    """Strict coldest-first (ties broken by slot id)."""
    db = store.db
    live = np.flatnonzero(db.live_mask)
    order = live[np.argsort(db.reuse_counts[live], kind="stable")]
    return [int(s) for s in order[:n]]


EVICTIONS.register("clock", clock_eviction)
EVICTIONS.register("coldest", coldest_eviction)
