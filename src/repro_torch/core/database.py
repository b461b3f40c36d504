"""Attention database — the big-memory APM store (paper §5.1, §5.3),
the counterpart of the reference's ``core/database.py``.

* ``AttentionDB`` — host-RAM tier: a numpy copy of the reference (one
  preallocated arena per codec part, LIFO free-list recycling, per-row
  CRC32 checksums), so both packages hold byte-identical arenas.
* ``DeviceDB`` — the device-resident tier on torch tensors: each codec
  part is one preallocated tensor with slack. A delta sync is
  copy-on-write, the counterpart of the reference's functional
  ``.at[].set``: ``update`` writes the rows into fresh tensors and swaps
  ``parts``, so a published snapshot's tensors never change and a batch
  still serving an older generation keeps reading its own.
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.codec import ApmCodec, F16Codec, get_codec


def pad_delta_pow2(slots: np.ndarray, values: Optional[np.ndarray] = None):
    """Pad a scatter delta to the next power-of-2 row count by repeating
    the first (slot, value) pair. A duplicate index writing the identical
    value is a no-op. The reference pads to bound XLA scatter compiles;
    eager PyTorch compiles nothing, but the port pads the same way so its
    sync receipts (``transfer_bytes``, ``StoreStats``) equal the
    reference's byte for byte."""
    n = slots.size
    p = 1
    while p < n:
        p *= 2
    if p != n:
        slots = np.concatenate([slots, np.repeat(slots[:1], p - n)])
        if values is not None:
            values = np.concatenate(
                [values, np.repeat(values[:1], p - n, axis=0)])
    return slots, values


def pad_delta_parts(slots: np.ndarray, parts: Sequence[np.ndarray]):
    """`pad_delta_pow2` for a multi-part (codec) payload: one padded slot
    vector shared by every part's scatter."""
    padded_slots, _ = pad_delta_pow2(slots)
    pad = padded_slots.size - slots.size
    if pad == 0:
        return padded_slots, tuple(np.asarray(p) for p in parts)
    return padded_slots, tuple(
        np.concatenate([p, np.repeat(p[:1], pad, axis=0)])
        for p in (np.asarray(p) for p in parts))


class AttentionDB:
    def __init__(self, apm_shape: Tuple[int, int, int], capacity: int = 1024,
                 dtype=np.float16, codec="f16", rank: Optional[int] = None):
        """apm_shape: (H, L, L) per entry; ``codec`` picks the storage
        format (``f16`` | ``int8`` | ``lowrank`` or an ApmCodec)."""
        self.apm_shape = tuple(apm_shape)
        self.capacity = capacity
        self.dtype = dtype                    # logical (decode) dtype
        self.codec: ApmCodec = get_codec(codec, self.apm_shape, rank=rank,
                                         dtype=dtype)
        self._arenas: List[np.ndarray] = [
            np.zeros((capacity,) + p.shape, p.dtype)
            for p in self.codec.parts]
        self._n = 0
        self.reuse_counts = np.zeros(capacity, np.int64)
        self._live = np.zeros(capacity, bool)
        self._free: List[int] = []           # released slots, LIFO recycled
        # per-codec-part CRC32 of each entry's arena row, recorded at
        # write time (add/put/overwrite) — the store's integrity layer
        # (DESIGN.md §2.9): ``verify`` recomputes and flags any slot
        # whose bytes drifted since they were encoded
        self.checksums: List[np.ndarray] = [
            np.zeros(capacity, np.uint32) for _ in self.codec.parts]

    def __len__(self):
        return self._n

    @property
    def _arena(self) -> np.ndarray:
        """The primary part's arena (codes for int8, the f16 arena for
        identity) — capacity/shape introspection and debugging; readers
        of *values* must go through ``get``/``parts_at``."""
        return self._arenas[0]

    @property
    def entry_nbytes(self) -> int:
        """Codec-true bytes per entry (the compressed payload, NOT the
        logical f16 shape — budget accounting depends on this)."""
        return self.codec.entry_nbytes

    @property
    def logical_entry_nbytes(self) -> int:
        """Bytes an uncompressed f16 entry would occupy (the baseline
        the compression receipts are quoted against)."""
        return int(np.prod(self.apm_shape)) * 2

    @property
    def live_count(self) -> int:
        return self._n - len(self._free)

    @property
    def live_mask(self) -> np.ndarray:
        return self._live[: self._n]

    @property
    def nbytes(self) -> int:
        """Bytes of live entries (budget accounting); the allocation is
        ``capacity * entry_nbytes``."""
        return self.live_count * self.entry_nbytes

    def parts_at(self, indices) -> Tuple[np.ndarray, ...]:
        """Raw compressed rows, one gather per codec part."""
        indices = np.asarray(indices).reshape(-1)
        return tuple(a[indices] for a in self._arenas)

    def parts_prefix(self, n: int) -> Tuple[np.ndarray, ...]:
        """Zero-copy views of the first ``n`` rows of every part."""
        return tuple(a[:n] for a in self._arenas)

    def _grow_to(self, need: int) -> None:
        if need <= self.capacity:
            return
        new_cap = max(2 * self.capacity, need)
        arenas = []
        for a in self._arenas:
            fresh = np.zeros((new_cap,) + a.shape[1:], a.dtype)
            fresh[: self._n] = a[: self._n]
            arenas.append(fresh)
        self._arenas = arenas
        counts = np.zeros(new_cap, np.int64)
        counts[: self._n] = self.reuse_counts[: self._n]
        self.reuse_counts = counts
        live = np.zeros(new_cap, bool)
        live[: self._n] = self._live[: self._n]
        self._live = live
        csums = []
        for c in self.checksums:
            fresh = np.zeros(new_cap, np.uint32)
            fresh[: self._n] = c[: self._n]
            csums.append(fresh)
        self.checksums = csums
        self.capacity = new_cap

    # ------------------------------------------------------------ integrity
    @staticmethod
    def _crc_rows(part_rows: np.ndarray) -> np.ndarray:
        """(B, ...) encoded part rows → (B,) CRC32 per row."""
        b = part_rows.shape[0]
        out = np.empty(b, np.uint32)
        rows = np.ascontiguousarray(part_rows)
        for i in range(b):
            out[i] = zlib.crc32(rows[i].tobytes())
        return out

    def _record_checksums(self, slots: np.ndarray,
                          parts: Sequence[np.ndarray]) -> None:
        for csum, p in zip(self.checksums, parts):
            csum[slots] = self._crc_rows(np.asarray(p))

    def verify(self, slots=None) -> np.ndarray:
        """Recompute per-part checksums for ``slots`` (default: every
        live slot) and return the slot ids whose stored bytes no longer
        match — corruption candidates for the store's
        quarantine-and-tombstone path. Dead slots are skipped (their
        rows are garbage by design until ``put`` recycles them)."""
        if slots is None:
            slots = np.flatnonzero(self._live[: self._n])
        else:
            slots = np.asarray(slots).reshape(-1)
            slots = slots[(slots >= 0) & (slots < self._n)]
            slots = slots[self._live[slots]]
        if slots.size == 0:
            return np.zeros(0, np.int64)
        bad = np.zeros(slots.shape[0], bool)
        for csum, arena in zip(self.checksums, self._arenas):
            bad |= self._crc_rows(arena[slots]) != csum[slots]
        return slots[bad].astype(np.int64)

    def add(self, apms: np.ndarray, aux=None) -> np.ndarray:
        """apms: (B, H, L, L). Appends at the arena tail; returns indices.
        ``aux`` is the codec's side-channel payload (KV planes for the
        prefill codec; plain APM codecs ignore it).

        Growth is geometric but tight: the arena doubles (amortized O(1)
        appends) or jumps straight to the requested size, whichever is
        larger — never both, so capacity always equals the allocation."""
        b = apms.shape[0]
        self._grow_to(self._n + b)
        idx = np.arange(self._n, self._n + b)
        parts = self.codec.encode(np.asarray(apms, self.dtype), aux)
        for a, p in zip(self._arenas, parts):
            a[idx] = p
        self._record_checksums(idx, parts)
        self._live[idx] = True
        self._n += b
        return idx

    def put(self, apms: np.ndarray, aux=None) -> np.ndarray:
        """Admit entries, recycling released slots first (LIFO) and
        appending the remainder — the arena never compacts, so live slot
        ids are stable across admissions/evictions."""
        apms = np.asarray(apms, self.dtype)
        b = apms.shape[0]
        if aux is not None:
            aux = np.asarray(aux)
        n_reuse = min(b, len(self._free))
        slots = np.asarray([self._free.pop() for _ in range(n_reuse)],
                           np.int64)
        if n_reuse:
            parts = self.codec.encode(
                apms[:n_reuse], None if aux is None else aux[:n_reuse])
            for a, p in zip(self._arenas, parts):
                a[slots] = p
            self._record_checksums(slots, parts)
            self.reuse_counts[slots] = 0
            self._live[slots] = True
        if b > n_reuse:
            slots = np.concatenate([slots, self.add(
                apms[n_reuse:], None if aux is None else aux[n_reuse:])])
        return slots

    def put_parts(self, parts: Sequence[np.ndarray],
                  checksums: Optional[Sequence[np.ndarray]] = None
                  ) -> np.ndarray:
        """``put`` for rows ALREADY in the codec's encoded form — the
        capacity tier's promotion path (DESIGN.md §2.11): the stored
        bytes land in the arenas verbatim, so a demote → promote round
        trip is bit-identical for every codec. ``checksums`` (per part,
        as recorded at first admission) are adopted when given and
        recomputed otherwise."""
        parts = tuple(np.ascontiguousarray(np.asarray(p, a.dtype))
                      for p, a in zip(parts, self._arenas))
        b = int(parts[0].shape[0])
        if b == 0:
            return np.zeros(0, np.int64)
        if checksums is None:
            checksums = [self._crc_rows(p) for p in parts]
        n_reuse = min(b, len(self._free))
        slots = np.asarray([self._free.pop() for _ in range(n_reuse)],
                           np.int64)
        if b > n_reuse:
            tail = b - n_reuse
            self._grow_to(self._n + tail)
            slots = np.concatenate(
                [slots, np.arange(self._n, self._n + tail)])
            self._n += tail
        for a, p in zip(self._arenas, parts):
            a[slots] = p
        for csum, c in zip(self.checksums, checksums):
            csum[slots] = np.asarray(c, np.uint32)
        self.reuse_counts[slots] = 0
        self._live[slots] = True
        return slots

    def overwrite(self, slots: Sequence[int], apms: np.ndarray,
                  aux=None) -> None:
        """In-place update of existing slots (no allocation, no id churn)."""
        slots = np.asarray(slots).reshape(-1)
        parts = self.codec.encode(np.asarray(apms, self.dtype), aux)
        for a, p in zip(self._arenas, parts):
            a[slots] = p
        self._record_checksums(slots, parts)

    def release(self, slots: Sequence[int]) -> None:
        """Evict entries: mark slots dead and queue them for recycling.
        Idempotent per slot; released slots keep their arena rows until
        ``put`` overwrites them (readers must go through the index, which
        tombstones the slot first)."""
        for s in np.asarray(slots).reshape(-1):
            s = int(s)
            if 0 <= s < self._n and self._live[s]:
                self._live[s] = False
                self.reuse_counts[s] = 0
                self._free.append(s)

    def get(self, indices, count_reuse: bool = True) -> np.ndarray:
        """Batched decoded fetch: one fancy-index gather per codec part
        (no per-entry copies) — compare benchmarks/table6_gather.py."""
        indices = np.asarray(indices).reshape(-1)
        if count_reuse:
            np.add.at(self.reuse_counts, indices, 1)
        return self.codec.decode(tuple(a[indices] for a in self._arenas))

    def get_naive(self, indices) -> np.ndarray:
        """The paper's 'memory copy' strawman: per-entry slice + copy +
        re-stack (what PyTorch-style per-tensor gathering does)."""
        parts = [self.codec.decode(
            tuple(a[int(i): int(i) + 1].copy() for a in self._arenas))[0]
            for i in np.asarray(indices)]
        return np.stack(parts, 0)

    def reuse_histogram(self):
        used = self.reuse_counts[: self._n]
        return np.bincount(used[used >= 0])


class DeviceDB:
    """Device-resident APM store.

    ``capacity`` rows are preallocated (``capacity >= n``): the slack lets
    MemoStore land admissions as delta syncs, each written into fresh
    copies of the parts (copy-on-write, ``update``). Every host→device byte
    is tallied in ``transfer_bytes`` at the codec's compressed width; the
    hot path consumes ``parts`` and dequantizes on the fly (inside the
    memo_attention kernel for int8)."""

    def __init__(self, apms, capacity: Optional[int] = None, *,
                 codec: Optional[ApmCodec] = None, device=None):
        if codec is None:                 # identity construction from array
            apms = np.asarray(apms)
            codec = F16Codec(apms.shape[1:], dtype=apms.dtype)
            host_parts = (apms,)
        else:
            host_parts = tuple(np.asarray(p) for p in apms)
        self.codec = codec
        self.device = torch.device(device if device is not None else "cpu")
        n = host_parts[0].shape[0]
        capacity = max(int(capacity or 0), n)
        parts = []
        for p in host_parts:
            # zero-filled where it lives, then one copy of the live prefix
            # from the host rows as they are: no full-capacity staging
            # array on the host, and a memory-mapped arena (a loaded file)
            # is read once, straight into the upload
            dtype = torch.from_numpy(np.empty(0, p.dtype)).dtype
            full = torch.zeros((capacity,) + p.shape[1:], dtype=dtype,
                               device=self.device)
            if n:
                if not p.flags.writeable:     # a read-only map ('r' mode)
                    p = np.array(p)
                full[:n].copy_(torch.from_numpy(np.ascontiguousarray(p)))
            parts.append(full)
        self.parts: Tuple[torch.Tensor, ...] = tuple(parts)
        self._n = n
        self.transfer_bytes = sum(int(p.nbytes) for p in self.parts)

    @classmethod
    def from_host(cls, db: AttentionDB, capacity: Optional[int] = None,
                  device=None) -> "DeviceDB":
        """Materialize the serving copy of a host arena (one transfer of
        the live prefix — compressed parts, codec carried over)."""
        return cls(db.parts_prefix(len(db)), capacity=capacity,
                   codec=db.codec, device=device)

    def update(self, slots, values) -> int:
        """Delta sync: scatter compressed rows into ``slots`` of fresh
        copies of the parts (copy-on-write; the old tensors stay as they
        were for whoever still holds them). ``values``: a parts tuple (or
        a bare decoded array, identity codec only). Returns the bytes
        shipped (the power-of-2 padded delta, as the reference counts
        them)."""
        slots = np.asarray(slots).reshape(-1)
        if slots.size == 0:
            return 0
        if int(slots.max()) >= self.capacity:
            raise ValueError("delta update past device capacity; "
                             "caller must full-resync with more slack")
        if not isinstance(values, (tuple, list)):
            values = self.codec.encode(np.asarray(values))
        n_max = int(slots.max())
        slots, parts = pad_delta_parts(slots, values)
        slots_dev = torch.from_numpy(slots.astype(np.int64)).to(self.device)
        shipped = int(slots.size * 4)
        fresh = []
        for arr, p in zip(self.parts, parts):
            p = torch.from_numpy(np.ascontiguousarray(p)).to(
                self.device, arr.dtype)
            fresh.append(arr.index_copy(0, slots_dev, p))
            shipped += int(p.nbytes)
        self.parts = tuple(fresh)
        self._n = max(self._n, n_max + 1)
        self.transfer_bytes += shipped
        return shipped

    @property
    def apms(self) -> torch.Tensor:
        """The full arena, decoded. For the identity codec this is the
        raw tensor; for compressed codecs it materializes the decoded
        arena — tests and debugging only, never the hot path."""
        if isinstance(self.codec, F16Codec):
            return self.parts[0]
        return self.codec.decode_rows(self.parts)

    @property
    def capacity(self) -> int:
        return self.parts[0].shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def entry_nbytes(self) -> int:
        """Compressed bytes per entry resident on the device."""
        return self.codec.entry_nbytes

    @property
    def nbytes(self) -> int:
        """Total device bytes of the allocation (all parts, slack too)."""
        return sum(int(p.nbytes) for p in self.parts)

    def __len__(self):
        return self._n

    def gather_parts(self, indices) -> Tuple[torch.Tensor, ...]:
        """Compressed gather (B,) → per-part rows."""
        return tuple(p.index_select(0, indices) for p in self.parts)

    def gather(self, indices):
        """Decoded gather (B,) → (B, H, L, L) f16."""
        return self.codec.decode_rows(self.gather_parts(indices))
