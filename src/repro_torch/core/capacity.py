"""Crash-consistent big-memory capacity tier (DESIGN.md §2.11), the
counterpart of the reference's ``core/capacity.py``. The module is numpy
only in both packages and this is a copy of it, line for line but for
the fault module it imports (``repro_torch.core.faults``): the bytes of a
format-3 file, a journal frame, a manifest and an arena are the
reference's, so a file or a tier directory written by either package
opens in the other.

AttMemo's database is meant to live on a *big memory* system — far
larger than the serving process's RAM budget — and to be gathered by
memory-mapping rather than copies (paper §5.3). This module is that
third tier, plus the durability layer:

* **Save format 3** — an uncompressed, page-aligned single-file layout
  (``write_format3`` / ``read_format3``): a CRC-framed JSON header
  followed by raw C-order array segments, each starting on a 4096-byte
  page boundary so ``np.memmap`` can open every array zero-copy
  (``MemoSession.load(..., mmap=True)``). Format 2 (compressed npz)
  cannot be mmapped and stays readable through the legacy path.

* **Journal** — a write-ahead redo log of CRC32-framed records. Every
  frame is ``magic | payload_len | payload_crc | payload`` with the
  payload an uncompressed npz, so replay can stop cleanly at the first
  torn/corrupt frame: a process killed mid-append loses at most the
  un-journaled tail, never an earlier record.

* **CapacityTier** — mmap-backed codec-part arenas in a directory, with
  the WAL + shadow-checkpoint protocol: mutations journal first (fsync),
  then land in the arenas; a checkpoint flushes the maps, shadow-writes
  the bookkeeping manifest (temp file + fsync + ``os.replace``) and
  truncates the journal. Recovery = manifest + in-order journal replay
  (idempotent) + a full per-row CRC32 sweep that retires torn or
  bit-flipped rows — so reopening after SIGKILL at ANY instant yields a
  tier whose every live row verifies.

Fault points (``capacity.*`` in ``core/faults.py``) are threaded through
the same way as the store's: ``disk_write_io`` (append raises — or
stalls, with a ``stall_s`` rider), ``journal_torn`` (a deliberately
short frame hits the disk, then the append fails), ``checkpoint_crash``
(the shadow write dies after the temp file, before the replace),
``mmap_bitflip`` (an arena byte flips after the row's checksum was
recorded) and ``compact_crash`` (a compaction dies before its publish).
"""
from __future__ import annotations

import io
import json
import os
import re
import struct
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import FaultInjector, MemoStoreError, fire

PAGE = 4096                     # segment alignment: mmap-friendly pages
MAGIC3 = b"MEMOSAV3"            # format-3 file prelude
_FRAME_MAGIC = 0x334F4D4D       # journal frame marker ("MMO3")
_FRAME_HDR = struct.Struct("<III")   # magic, payload_len, payload_crc


def _align(n: int) -> int:
    return (n + PAGE - 1) // PAGE * PAGE


def _pid_alive(pid: int) -> bool:
    """Best-effort liveness probe for stale-lock detection. ``kill(pid,
    0)`` raising ``ProcessLookupError`` is the only *certain* answer
    (dead); ``PermissionError`` means the pid exists under another uid —
    treat as alive (refusing is the safe direction for a lock)."""
    if pid <= 0:
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return True
    return True


def _fsync_dir(path: str) -> None:
    """Durability for renames: fsync the containing directory (best
    effort — not every filesystem supports dir fds)."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# --------------------------------------------------------------- format 3
def is_format3(path: str) -> bool:
    """True when ``path`` starts with the format-3 magic."""
    try:
        with open(str(path), "rb") as f:
            return f.read(len(MAGIC3)) == MAGIC3
    except OSError:
        return False


def write_format3(path: str, meta: dict, arrays: Dict[str, np.ndarray], *,
                  fsync: bool = True,
                  faults: Optional[FaultInjector] = None,
                  fault_point: Optional[str] = None,
                  fault_raises: bool = False) -> bool:
    """Atomically write a format-3 file: temp file in the target
    directory, fsync, ``os.replace`` — a crash (or an injected
    ``fault_point``, fired after the temp is complete but before the
    replace) can only ever leave a stray ``*.tmp``; an existing good
    file at ``path`` is never clobbered.

    Returns True when the file was published; False when ``fault_point``
    fired with ``fault_raises=False`` (the simulated-crash path:
    truncated temp left behind, target untouched)."""
    path = str(path)
    # NB: ascontiguousarray PROMOTES 0-d arrays to shape (1,) — keep
    # scalars 0-d so shapes round-trip exactly
    arrays = {k: (a if a.ndim == 0 else np.ascontiguousarray(a))
              for k, a in ((k, np.asarray(v)) for k, v in arrays.items())}
    # the header carries absolute segment offsets, which depend on the
    # header's own (digit-count-sensitive) length — iterate to fixpoint
    entries = {k: {"offset": 0, "shape": list(a.shape),
                   "dtype": np.dtype(a.dtype).str,
                   "crc32": zlib.crc32(a.tobytes())}
               for k, a in arrays.items()}
    header = b""
    for _ in range(8):
        off = _align(len(MAGIC3) + _FRAME_HDR.size + len(header))
        for k in arrays:
            entries[k]["offset"] = off
            off = _align(off + int(arrays[k].nbytes))
        fresh = json.dumps({"format": 3, "meta": meta, "arrays": entries},
                           sort_keys=True).encode()
        if len(fresh) == len(header):
            header = fresh
            break
        header = fresh
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, f".{os.path.basename(path)}.{os.getpid()}.tmp")
    fired = False
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC3)
            f.write(_FRAME_HDR.pack(_FRAME_MAGIC, len(header),
                                    zlib.crc32(header)))
            f.write(header)
            for k, a in arrays.items():
                f.seek(entries[k]["offset"])
                f.write(a.tobytes())
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        if fault_point and fire(faults, fault_point) is not None:
            # simulated crash between the temp write and the publish:
            # tear the temp (as a dying process would) and stop — the
            # target keeps whatever good bytes it already had
            fired = True
            size = os.path.getsize(tmp)
            with open(tmp, "rb+") as f:
                f.truncate(max(1, int(size * 0.6)))
            if fault_raises:
                raise OSError(f"injected crash before publishing {path!r} "
                              f"(torn temp left at {tmp!r})")
            return False
        os.replace(tmp, path)
    finally:
        if not fired and os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    if fsync:
        _fsync_dir(d)
    return True


def read_format3(path: str, *, mmap: bool = False, verify: bool = True
                 ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Read a format-3 file → ``(meta, arrays)``. With ``mmap=True``
    every array is an ``np.memmap`` in copy-on-write mode (``'c'``):
    zero-copy until written, and writes never touch the file. Per-array
    CRC verification (``verify``) is skipped under mmap by callers that
    verify lazily — the header CRC and segment bounds are always
    checked. Failures raise ``MemoStoreError`` naming the problem."""
    path = str(path)
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            prelude = f.read(len(MAGIC3) + _FRAME_HDR.size)
            if len(prelude) < len(MAGIC3) + _FRAME_HDR.size \
                    or prelude[:len(MAGIC3)] != MAGIC3:
                raise MemoStoreError(
                    f"unreadable memo store file {path!r} (truncated or "
                    f"corrupt): bad format-3 prelude")
            magic, hlen, hcrc = _FRAME_HDR.unpack(prelude[len(MAGIC3):])
            header = f.read(hlen)
        if magic != _FRAME_MAGIC or len(header) != hlen \
                or zlib.crc32(header) != hcrc:
            raise MemoStoreError(
                f"unreadable memo store file {path!r} (truncated or "
                f"corrupt): format-3 header checksum mismatch")
        doc = json.loads(header.decode())
    except MemoStoreError:
        raise
    except Exception as e:
        raise MemoStoreError(
            f"unreadable memo store file {path!r} (truncated or "
            f"corrupt): {type(e).__name__}: {e}") from e
    arrays: Dict[str, np.ndarray] = {}
    bad: List[str] = []
    for k, ent in (doc.get("arrays") or {}).items():
        shape = tuple(int(s) for s in ent["shape"])
        dtype = np.dtype(ent["dtype"])
        off = int(ent["offset"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes and off + nbytes > size:
            raise MemoStoreError(
                f"unreadable memo store file {path!r} (truncated or "
                f"corrupt): array {k!r} runs past end of file")
        if mmap:
            a = (np.memmap(path, dtype=dtype, mode="c", offset=off,
                           shape=shape) if nbytes
                 else np.zeros(shape, dtype))
        else:
            with open(path, "rb") as f:
                f.seek(off)
                buf = f.read(nbytes)
            if len(buf) != nbytes:
                raise MemoStoreError(
                    f"unreadable memo store file {path!r} (truncated or "
                    f"corrupt): short read of array {k!r}")
            a = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
        if verify and not mmap \
                and zlib.crc32(np.ascontiguousarray(a).tobytes()) \
                != int(ent["crc32"]):
            bad.append(k)
        arrays[k] = a
    if bad:
        raise MemoStoreError(
            f"checksum mismatch in memo store file {path!r} for "
            f"{sorted(bad)} — the file is corrupt (bit flips or a "
            f"partial write); rebuild or restore from a good copy")
    return dict(doc.get("meta") or {}), arrays


# ---------------------------------------------------------------- journal
def _pack_record(kind: str, arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, __kind__=np.asarray(kind), **arrays)
    return buf.getvalue()


def _unpack_record(payload: bytes) -> Tuple[str, Dict[str, np.ndarray]]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files if k != "__kind__"}
        return str(data["__kind__"]), arrays


def replay_journal(path: str
                   ) -> Tuple[List[Tuple[str, Dict[str, np.ndarray]]], bool]:
    """Read a journal file without opening it for append: all intact
    records since the last truncate → ``(records, torn_tail)``. Never
    raises on framing damage — a bad frame ends the replay (everything
    after it is unreachable by design) — and never touches the
    directory, so a read-only opener can replay a LIVE writer's WAL."""
    try:
        with open(str(path), "rb") as f:
            blob = f.read()
    except OSError:
        return [], False
    records, off = [], 0
    while True:
        if off == len(blob):
            return records, False
        hdr = blob[off: off + _FRAME_HDR.size]
        if len(hdr) < _FRAME_HDR.size:
            return records, True
        magic, plen, pcrc = _FRAME_HDR.unpack(hdr)
        payload = blob[off + _FRAME_HDR.size:
                       off + _FRAME_HDR.size + plen]
        if magic != _FRAME_MAGIC or len(payload) != plen \
                or zlib.crc32(payload) != pcrc:
            return records, True
        try:
            records.append(_unpack_record(payload))
        except Exception:
            return records, True
        off += _FRAME_HDR.size + plen


class Journal:
    """Append-only CRC-framed redo log. ``append`` fsyncs before
    returning (the WAL ordering contract: a record is durable before the
    arena bytes it describes are written); ``replay`` yields records in
    order and stops — without raising — at the first torn or corrupt
    frame, reporting the torn tail."""

    def __init__(self, path: str, *, fsync: bool = True,
                 faults: Optional[FaultInjector] = None):
        self.path = str(path)
        self._fsync = fsync
        self._faults = faults
        self._f = open(self.path, "ab")
        self.n_appends = 0

    @property
    def nbytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def append(self, kind: str, arrays: Dict[str, np.ndarray]) -> None:
        payload = _pack_record(kind, arrays)
        frame = _FRAME_HDR.pack(_FRAME_MAGIC, len(payload),
                                zlib.crc32(payload)) + payload
        torn = fire(self._faults, "capacity.journal_torn")
        if torn is not None:
            # a crash mid-append: only a prefix of the frame reaches the
            # disk. Write the torn prefix durably, then fail the append —
            # in-process the caller degrades; on reopen, replay stops
            # cleanly at this frame (the un-journaled tail is lost).
            frac = float(torn.get("frac", 0.5))
            cut = max(_FRAME_HDR.size, int(len(frame) * frac))
            self._f.write(frame[:cut])
            self._f.flush()
            os.fsync(self._f.fileno())
            raise OSError("injected torn journal frame "
                          f"({cut}/{len(frame)} bytes hit the disk)")
        self._f.write(frame)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
        self.n_appends += 1

    def replay(self) -> Tuple[List[Tuple[str, Dict[str, np.ndarray]]], bool]:
        """All intact records since the last truncate → ``(records,
        torn_tail)``. Never raises on framing damage: a bad frame ends
        the replay (everything after it is unreachable by design)."""
        self._f.flush()
        return replay_journal(self.path)

    def truncate(self) -> None:
        """Drop every record (checkpoint absorbed them)."""
        self._f.truncate(0)
        self._f.seek(0)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


# ----------------------------------------------------------- capacity tier
class CapacityTier:
    """The durable disk tier: one mmap arena file per codec part plus an
    embedding arena, bookkeeping in a shadow-checkpointed manifest, and
    the WAL in front of every mutation.

    Layout of ``root``::

        MANIFEST.m3      format-3 bookkeeping (shadow-replaced)
        journal.wal      CRC-framed redo log since the last checkpoint
        LOCK             single-writer pidfile (O_EXCL; stale locks of
                         dead pids are reclaimed, live ones refused)
        part_<name>.dat  raw codec-part arena (mmap, grown by ftruncate)
        embs.dat         f32 embedding arena (mmap)

    Arena files carry an *epoch*: epoch 0 keeps the bare names above,
    epoch ``e`` > 0 uses ``part_<name>.e<e>.dat`` / ``embs.e<e>.dat``.
    ``compact`` rewrites the live rows densely into the next epoch's
    files and publishes the switch through the manifest (the usual
    shadow-checkpoint commit point), returning the retired slots' bytes
    to the filesystem; a crash at any instant leaves either the old
    epoch (plus stray new-epoch files, GC'd on reopen) or the new one.

    Opening a directory that already has a manifest *recovers* it:
    replay the journal (stopping at a torn tail), CRC-sweep every live
    row, retire mismatches, then checkpoint — so the post-recovery tier
    always verifies clean. The recovery report lands in
    ``self.recovery``.

    ``read_only=True`` (or ``CapacityTier.open(..., read_only=True)``)
    is the cross-process read-sharing leg: it BYPASSES
    the ``LOCK`` pidfile — a live writer may keep journaling — maps the
    arenas ``mode='r'`` (shared pages, zero-copy), and replays the WAL
    into an in-memory overlay instead of the arenas, so un-checkpointed
    appends are visible without writing a byte anywhere: no lock, no
    journal handle, no checkpoint, no arena growth. Every mutator
    raises ``MemoStoreError``.
    """

    MANIFEST = "MANIFEST.m3"
    JOURNAL = "journal.wal"
    LOCKFILE = "LOCK"

    def __init__(self, root: str, *, codec, embed_dim: int,
                 capacity: int = 64,
                 budget_bytes: Optional[int] = None,
                 faults: Optional[FaultInjector] = None,
                 fsync: bool = True, read_only: bool = False):
        self.root = str(root)
        self.codec = codec
        self.embed_dim = int(embed_dim)
        self.budget_bytes = budget_bytes
        self._faults = faults
        self._fsync = fsync
        self.read_only = bool(read_only)
        if not self.read_only:
            os.makedirs(self.root, exist_ok=True)
        self._lock_path = os.path.join(self.root, self.LOCKFILE)
        self._lock_held = False
        if not self.read_only:
            self._acquire_lock()
        self.recovery: Optional[dict] = None
        self.n_appended = 0
        self.n_retired = 0
        self.n_checkpoints = 0
        self.n_compactions = 0
        self._parts: List[np.memmap] = []
        self._embs: Optional[np.memmap] = None
        # read-only WAL overlay: slot → (part rows, emb row); empty (and
        # never consulted past a dict probe) in writer mode
        self._overlay: Dict[int, Tuple[Tuple[np.ndarray, ...],
                                       np.ndarray]] = {}
        self.journal: Optional[Journal] = None
        try:
            manifest = os.path.join(self.root, self.MANIFEST)
            if self.read_only:
                if not os.path.exists(manifest):
                    raise MemoStoreError(
                        f"cannot open capacity tier {self.root!r} "
                        f"read-only: no manifest (the tier was never "
                        f"checkpointed, or the path is wrong)")
                self._open_read_only(manifest)
            elif os.path.exists(manifest):
                self._recover(manifest)
            else:
                self._init_state(max(1, int(capacity)))
                self._map_arenas(self.capacity)
                self.journal = Journal(
                    os.path.join(self.root, self.JOURNAL),
                    fsync=fsync, faults=faults)
                self.checkpoint()
        except BaseException:
            self._release_lock()
            raise

    @classmethod
    def open(cls, root: str, *, codec, embed_dim: int,
             read_only: bool = False, **kw) -> "CapacityTier":
        """Open an existing tier directory. ``read_only=True`` shares it
        with a live writer (see the class docstring); ``False`` is the
        normal single-writer recovery path."""
        return cls(root, codec=codec, embed_dim=embed_dim,
                   read_only=read_only, **kw)

    def _require_writable(self, op: str) -> None:
        if self.read_only:
            raise MemoStoreError(
                f"capacity tier {self.root!r} was opened read_only: "
                f"{op} would mutate it (open a writer instance instead)")

    # ----------------------------------------------------- single-writer
    def _acquire_lock(self) -> None:
        """O_EXCL pidfile: exactly one process may journal this dir.
        A lock naming a dead pid (SIGKILL'd writer) or our own pid (a
        same-process reopen) is reclaimed; a different *live* pid is an
        actionable conflict — two writers interleaving one WAL would
        corrupt it silently."""
        for _ in range(16):
            try:
                fd = os.open(self._lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            except FileExistsError:
                try:
                    with open(self._lock_path, "r") as f:
                        owner = int(f.read().strip() or "0")
                except (OSError, ValueError):
                    owner = 0           # unreadable/empty: treat as stale
                if owner != os.getpid() and _pid_alive(owner):
                    raise MemoStoreError(
                        f"capacity tier dir {self.root!r} is locked by "
                        f"live process {owner} ({self._lock_path!r}); a "
                        f"second writer would corrupt the journal — "
                        f"close that process, or delete the lockfile if "
                        f"it is wrong")
                try:                    # stale or our own: reclaim
                    os.unlink(self._lock_path)
                except OSError:
                    pass
                continue
            with os.fdopen(fd, "w") as f:
                f.write(f"{os.getpid()}\n")
            self._lock_held = True
            return
        raise MemoStoreError(
            f"could not acquire capacity-tier lock {self._lock_path!r} "
            f"(another process kept re-creating it)")

    def _release_lock(self) -> None:
        if not self._lock_held:
            return
        self._lock_held = False
        try:
            os.unlink(self._lock_path)
        except OSError:
            pass

    # ------------------------------------------------------------- state
    def _init_state(self, capacity: int) -> None:
        self.capacity = capacity
        self.epoch = 0
        self._n = 0
        self._live = np.zeros(capacity, bool)
        self._lens = np.full(capacity, -1, np.int32)
        self._reuse = np.zeros(capacity, np.int64)
        self._free: List[int] = []
        self._csums = [np.zeros(capacity, np.uint32)
                       for _ in self.codec.parts]
        self.extra_meta: dict = {}

    @property
    def entry_nbytes(self) -> int:
        return self.codec.entry_nbytes + self.embed_dim * 4

    @property
    def live_count(self) -> int:
        return int(np.count_nonzero(self._live[: self._n]))

    @property
    def nbytes(self) -> int:
        return self.live_count * self.entry_nbytes

    @property
    def live_slots(self) -> np.ndarray:
        return np.flatnonzero(self._live[: self._n])

    @property
    def retired_fraction(self) -> float:
        """Fraction of the allocated slot prefix that is a retired hole
        (reclaimable by ``compact``)."""
        return len(self._free) / max(1, int(self._n))

    # ------------------------------------------------------------- mmaps
    def _epoch_suffix(self, epoch: Optional[int] = None) -> str:
        e = self.epoch if epoch is None else int(epoch)
        return ".dat" if e == 0 else f".e{e}.dat"

    def _part_path(self, spec, epoch: Optional[int] = None) -> str:
        return os.path.join(
            self.root, f"part_{spec.name}{self._epoch_suffix(epoch)}")

    def _embs_path(self, epoch: Optional[int] = None) -> str:
        return os.path.join(self.root, f"embs{self._epoch_suffix(epoch)}")

    def _arena_paths(self, epoch: Optional[int] = None) -> List[str]:
        return [self._part_path(p, epoch) for p in self.codec.parts] \
            + [self._embs_path(epoch)]

    def _map_file(self, path: str, shape: Tuple[int, ...], dtype) -> np.memmap:
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        nbytes = max(1, nbytes)
        if not os.path.exists(path):
            open(path, "ab").close()
        if os.path.getsize(path) < nbytes:
            os.truncate(path, nbytes)
        return np.memmap(path, dtype=dtype, mode="r+", shape=shape)

    def _map_arenas(self, capacity: int) -> None:
        self._parts = [
            self._map_file(self._part_path(p), (capacity,) + p.shape,
                           p.dtype)
            for p in self.codec.parts]
        self._embs = self._map_file(self._embs_path(),
                                    (capacity, self.embed_dim), np.float32)

    def _map_file_ro(self, path: str, shape: Tuple[int, ...], dtype
                     ) -> np.memmap:
        """Read-only arena map: never creates or grows the file — a
        short/missing arena is the writer's bug (or the wrong dir), not
        something a reader may repair."""
        nbytes = max(1, int(np.prod(shape, dtype=np.int64))
                     * np.dtype(dtype).itemsize)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = -1
        if size < nbytes:
            raise MemoStoreError(
                f"capacity arena {path!r} is missing or shorter than its "
                f"manifest says ({size} < {nbytes} bytes)")
        return np.memmap(path, dtype=dtype, mode="r", shape=shape)

    def _map_arenas_ro(self, capacity: int) -> None:
        self._parts = [
            self._map_file_ro(self._part_path(p), (capacity,) + p.shape,
                              p.dtype)
            for p in self.codec.parts]
        self._embs = self._map_file_ro(
            self._embs_path(), (capacity, self.embed_dim), np.float32)

    def _flush_arenas(self) -> None:
        if self.read_only:      # nothing dirty; 'r'-mode flush may raise
            return
        for m in self._parts:
            m.flush()
        if self._embs is not None:
            self._embs.flush()

    def _grow_to(self, need: int) -> None:
        if need <= self.capacity:
            return
        new_cap = max(2 * self.capacity, int(need))
        self._flush_arenas()
        self._parts, self._embs = [], None
        self._map_arenas(new_cap)
        for name in ("_live", "_lens", "_reuse"):
            old = getattr(self, name)
            fresh = np.full(new_cap, (-1 if name == "_lens" else 0),
                            old.dtype)
            fresh[: self._n] = old[: self._n]
            setattr(self, name, fresh)
        self._live = self._live.astype(bool)
        csums = []
        for c in self._csums:
            fresh = np.zeros(new_cap, np.uint32)
            fresh[: self._n] = c[: self._n]
            csums.append(fresh)
        self._csums = csums
        self.capacity = new_cap

    # ---------------------------------------------------------- mutation
    @staticmethod
    def _crc_rows(rows: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(rows)
        return np.asarray([zlib.crc32(rows[i].tobytes())
                           for i in range(rows.shape[0])], np.uint32)

    def _alloc(self, b: int) -> np.ndarray:
        n_reuse = min(b, len(self._free))
        slots = [self._free.pop() for _ in range(n_reuse)]
        if b > n_reuse:
            tail = b - n_reuse
            self._grow_to(self._n + tail)
            slots.extend(range(self._n, self._n + tail))
            self._n += tail
        return np.asarray(slots, np.int64)

    def append(self, parts: Sequence[np.ndarray], embs: np.ndarray,
               lens: np.ndarray,
               csums: Optional[Sequence[np.ndarray]] = None) -> np.ndarray:
        """Durably admit ``B`` encoded rows (WAL first, arenas second).
        Returns the assigned disk slots. The ``capacity.disk_write_io``
        fault fires here: with a ``stall_s`` rider it sleeps (the
        promotion-stall failure mode), without one it raises OSError
        before any state mutates."""
        self._require_writable("append")
        hit = fire(self._faults, "capacity.disk_write_io")
        if hit is not None:
            if "stall_s" in hit:
                time.sleep(float(hit["stall_s"]))
            else:
                raise OSError("injected capacity-tier disk write failure")
        parts = tuple(np.ascontiguousarray(p) for p in parts)
        embs = np.ascontiguousarray(np.asarray(embs, np.float32))
        lens = np.asarray(lens, np.int32).reshape(-1)
        b = int(embs.shape[0])
        if b == 0:
            return np.zeros(0, np.int64)
        if csums is None:
            csums = [self._crc_rows(p) for p in parts]
        csums = [np.asarray(c, np.uint32) for c in csums]
        slots = self._alloc(b)
        rec = {"slots": slots, "embs": embs, "lens": lens}
        for spec, p, c in zip(self.codec.parts, parts, csums):
            rec[f"part_{spec.name}"] = p
            rec[f"csum_{spec.name}"] = c
        self.journal.append("append", rec)
        for arena, p in zip(self._parts, parts):
            arena[slots] = p
        self._embs[slots] = embs
        if fire(self._faults, "capacity.mmap_bitflip") is not None:
            # flip one byte of the newest row's primary part WITHOUT
            # refreshing its checksum: verify()/promotion must catch it
            row = np.asarray(self._parts[0][int(slots[-1])])
            flipped = row.copy()
            flipped.view(np.uint8).reshape(-1)[0] ^= 0xFF
            self._parts[0][int(slots[-1])] = flipped
        self._lens[slots] = lens
        self._live[slots] = True
        self._reuse[slots] = 0
        for c, fresh in zip(self._csums, csums):
            c[slots] = fresh
        self.n_appended += b
        self._enforce_budget(exclude=slots)
        return slots

    def retire(self, slots: Sequence[int]) -> None:
        """Durably drop rows (quarantine or disk-budget eviction)."""
        self._require_writable("retire")
        slots = np.asarray(slots, np.int64).reshape(-1)
        slots = slots[(slots >= 0) & (slots < self._n)]
        slots = slots[self._live[slots]]
        if slots.size == 0:
            return
        self.journal.append("retire", {"slots": slots})
        self._apply_retire(slots)
        self.n_retired += int(slots.size)
        cb = getattr(self, "on_retire", None)
        if cb is not None:      # owner unlinks its slot maps before the
            cb(slots)           # freed disk slots can be recycled


    def _apply_retire(self, slots: np.ndarray) -> None:
        for s in slots:
            s = int(s)
            if 0 <= s < self._n and self._live[s]:
                self._live[s] = False
                self._lens[s] = -1
                self._reuse[s] = 0
                self._free.append(s)

    def _enforce_budget(self, exclude: Optional[np.ndarray] = None) -> None:
        if self.budget_bytes is None:
            return
        cap = max(1, int(self.budget_bytes) // self.entry_nbytes)
        over = self.live_count - cap
        if over <= 0:
            return
        live = self.live_slots
        if exclude is not None and live.size > over:
            keep_new = live[~np.isin(live, exclude)]
            if keep_new.size >= over:
                live = keep_new
        order = live[np.argsort(self._reuse[live], kind="stable")]
        self.retire(order[:over])

    def note_reuse(self, slots: Sequence[int]) -> None:
        slots = np.asarray(slots, np.int64).reshape(-1)
        if slots.size:
            np.add.at(self._reuse, slots, 1)

    # -------------------------------------------------------- compaction
    def compact(self) -> dict:
        """Rewrite the live rows densely into the next epoch's arena
        files and return the retired holes' bytes to the filesystem.

        Commit protocol: stage the new epoch's files (dense copies,
        flushed), then publish the switch by checkpointing a manifest
        that names the new epoch — the same shadow-replace that commits
        every other mutation. ``capacity.compact_crash`` fires after the
        staging, before the publish: recovery then reopens the OLD epoch
        (manifest + journal untouched) and GC's the stray new-epoch
        files. Old slot ``live_slots[i]`` becomes new slot ``i``; the
        ``on_compact(old_slots, new_slots)`` callback (fired after the
        publish) lets the owner remap its host↔disk slot tables."""
        self._require_writable("compact")
        old_epoch = self.epoch
        old_paths = self._arena_paths(old_epoch)
        old_bytes = sum(os.path.getsize(p) for p in old_paths
                        if os.path.exists(p))
        live = self.live_slots
        nl = int(live.size)
        new_cap = max(1, nl)
        self._flush_arenas()
        self.epoch = old_epoch + 1
        try:
            new_parts = [
                self._map_file(self._part_path(p), (new_cap,) + p.shape,
                               p.dtype)
                for p in self.codec.parts]
            new_embs = self._map_file(self._embs_path(),
                                      (new_cap, self.embed_dim),
                                      np.float32)
            for dst, src in zip(new_parts, self._parts):
                dst[:nl] = src[live]
            new_embs[:nl] = self._embs[live]
            for m in new_parts:
                m.flush()
            new_embs.flush()
            if fire(self._faults, "capacity.compact_crash") is not None:
                raise OSError(
                    f"injected crash mid-compaction (epoch "
                    f"{self.epoch} staged, manifest still at epoch "
                    f"{old_epoch})")
        except BaseException:
            # nothing published: the manifest still names the old epoch
            # and its arenas were never written — roll the in-memory
            # epoch back (stray new-epoch files are GC'd on reopen)
            self.epoch = old_epoch
            raise
        self._parts, self._embs = new_parts, new_embs
        reclaimed = int(self._n) - nl
        for name, fill in (("_live", True), ("_lens", -1), ("_reuse", 0)):
            old = getattr(self, name)
            fresh = np.full(new_cap, fill, old.dtype)
            fresh[:nl] = old[live]
            setattr(self, name, fresh)
        self._live[nl:] = False
        self._csums = [np.concatenate(
            [c[live], np.zeros(new_cap - nl, np.uint32)]).astype(np.uint32)
            for c in self._csums]
        self._n = nl
        self.capacity = new_cap
        self._free = []
        self.checkpoint()               # the commit point (new epoch)
        cb = getattr(self, "on_compact", None)
        if cb is not None:
            cb(live, np.arange(nl, dtype=np.int64))
        for p in old_paths:             # best-effort: reopen GC's strays
            try:
                os.remove(p)
            except OSError:
                pass
        self.n_compactions += 1
        new_bytes = sum(os.path.getsize(p)
                        for p in self._arena_paths(self.epoch)
                        if os.path.exists(p))
        return {"epoch": int(self.epoch), "live": nl,
                "slots_reclaimed": reclaimed,
                "bytes_returned": max(0, old_bytes - new_bytes)}

    def _gc_stray_epochs(self) -> None:
        """Remove arena files from any epoch other than the current one
        — the debris of a compaction that crashed before (stray new
        epoch) or after (undeleted old epoch) its manifest publish."""
        keep = {os.path.basename(p) for p in self._arena_paths()}
        pat = re.compile(r"^(?:part_.+?|embs)(?:\.e\d+)?\.dat$")
        for f in os.listdir(self.root):
            if f not in keep and pat.match(f):
                try:
                    os.remove(os.path.join(self.root, f))
                except OSError:
                    pass

    # ------------------------------------------------------------- reads
    def rows_at(self, slots: Sequence[int]) -> Tuple[
            Tuple[np.ndarray, ...], np.ndarray, np.ndarray,
            Tuple[np.ndarray, ...]]:
        """Raw encoded rows → ``(parts, embs, lens, csums)`` (copies —
        the caller re-verifies the CRCs before promoting). Read-only
        instances serve WAL-overlay rows over the mapped arena bytes
        (a live writer's un-checkpointed appends; possibly past the
        arena's mapped capacity)."""
        slots = np.asarray(slots, np.int64).reshape(-1)
        # overlay slots may exceed the mapped capacity — clamp the arena
        # gather (those rows are overwritten from the overlay below)
        safe = np.clip(slots, 0, self.capacity - 1)
        parts = [np.asarray(a[safe]).copy() for a in self._parts]
        embs = np.asarray(self._embs[safe]).copy()
        if self._overlay:
            for j, s in enumerate(slots):
                row = self._overlay.get(int(s))
                if row is not None:
                    for p, pr in zip(parts, row[0]):
                        p[j] = pr
                    embs[j] = row[1]
        return (tuple(parts), embs, self._lens[slots].copy(),
                tuple(c[slots].copy() for c in self._csums))

    def verify(self, slots: Optional[Sequence[int]] = None) -> np.ndarray:
        """Recompute per-part row CRCs (default: every live row) →
        slot ids whose bytes drifted since they were journaled."""
        if slots is None:
            slots = self.live_slots
        else:
            slots = np.asarray(slots, np.int64).reshape(-1)
            slots = slots[(slots >= 0) & (slots < self._n)]
            slots = slots[self._live[slots]]
        if slots.size == 0:
            return np.zeros(0, np.int64)
        # rows_at (not a raw arena gather) so overlay rows verify against
        # their journaled bytes rather than the writer's arena state
        parts, _, _, csums = self.rows_at(slots)
        bad = np.zeros(slots.shape[0], bool)
        for rows, csum in zip(parts, csums):
            bad |= self._crc_rows(rows) != csum
        return slots[bad].astype(np.int64)

    def search(self, queries: np.ndarray, k: int = 1
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact L2 over the live embedding rows → ``(sq_dists (B,k),
        slots (B,k))``; dead rows can never win. The disk tier is
        searched only at promotion time (maintenance cadence), so a
        plain numpy matmul over the mmap is the right cost model — the
        OS page cache is the 'big memory' here."""
        q = np.asarray(queries, np.float32)
        live = self.live_slots
        if live.size == 0:
            return (np.full((q.shape[0], k), np.inf, np.float32),
                    np.full((q.shape[0], k), -1, np.int64))
        embs = np.asarray(self._embs[np.clip(live, 0,
                                             self.capacity - 1)]).copy()
        if self._overlay:
            for j, s in enumerate(live):
                row = self._overlay.get(int(s))
                if row is not None:
                    embs[j] = row[1]
        d2 = (np.sum(q * q, -1, keepdims=True)
              - 2.0 * q @ embs.T + np.sum(embs * embs, -1)[None, :])
        k = min(k, live.size)
        idx = np.argsort(d2, axis=-1, kind="stable")[:, :k]
        rows = np.take_along_axis(d2, idx, -1)
        pad = np.full((q.shape[0], max(0, k - idx.shape[1])), np.inf)
        return (np.concatenate([rows, pad], -1).astype(np.float32),
                np.concatenate(
                    [live[idx],
                     np.full((q.shape[0], pad.shape[1]), -1, np.int64)],
                    -1))

    # -------------------------------------------------------- durability
    def checkpoint(self, extra_meta: Optional[dict] = None) -> None:
        """Flush the arenas, shadow-replace the manifest, truncate the
        journal — the WAL absorb point. ``capacity.checkpoint_crash``
        fires between the manifest temp write and its publish, leaving
        the OLD manifest + the intact journal (still recoverable)."""
        self._require_writable("checkpoint")
        if extra_meta is not None:
            self.extra_meta = dict(extra_meta)
        self._flush_arenas()
        n = self._n
        arrays = {
            "n": np.asarray(n, np.int64),
            "live": self._live[:n].copy(),
            "lens": self._lens[:n].copy(),
            "reuse": self._reuse[:n].copy(),
            "free": np.asarray(self._free, np.int64),
        }
        for spec, c in zip(self.codec.parts, self._csums):
            arrays[f"csum_{spec.name}"] = c[:n].copy()
        meta = {"capacity": int(self.capacity),
                "embed_dim": self.embed_dim,
                "codec": self.codec.name,
                "epoch": int(self.epoch),
                "extra": self.extra_meta}
        write_format3(os.path.join(self.root, self.MANIFEST), meta, arrays,
                      fsync=self._fsync, faults=self._faults,
                      fault_point="capacity.checkpoint_crash",
                      fault_raises=True)
        self.journal.truncate()
        self.n_checkpoints += 1

    def _recover(self, manifest: str) -> None:
        meta, arrays = read_format3(manifest, verify=True)
        n = int(arrays["n"])
        cap = max(1, int(meta.get("capacity", n or 1)), n)
        self._init_state(cap)
        self.epoch = int(meta.get("epoch", 0))
        self._n = n
        self._live[:n] = arrays["live"]
        self._lens[:n] = arrays["lens"]
        self._reuse[:n] = arrays["reuse"]
        self._free = [int(s) for s in arrays["free"]]
        for i, spec in enumerate(self.codec.parts):
            saved = arrays.get(f"csum_{spec.name}")
            if saved is None:
                raise MemoStoreError(
                    f"capacity manifest {manifest!r} was written for a "
                    f"different codec (missing csum_{spec.name})")
            self._csums[i][:n] = saved
        self.extra_meta = dict(meta.get("extra") or {})
        self._map_arenas(self.capacity)
        # redo the journal in order; a torn tail ends the replay cleanly
        self.journal = Journal(os.path.join(self.root, self.JOURNAL),
                               fsync=self._fsync, faults=self._faults)
        records, torn = self.journal.replay()
        for kind, rec in records:
            slots = np.asarray(rec["slots"], np.int64).reshape(-1)
            if kind == "retire":
                self._apply_retire(slots)
                continue
            self._grow_to(int(slots.max()) + 1 if slots.size else 0)
            self._n = max(self._n, int(slots.max()) + 1 if slots.size else 0)
            taken = set(int(s) for s in slots)
            self._free = [s for s in self._free if s not in taken]
            for arena, spec in zip(self._parts, self.codec.parts):
                arena[slots] = rec[f"part_{spec.name}"]
            for c, spec in zip(self._csums, self.codec.parts):
                c[slots] = np.asarray(rec[f"csum_{spec.name}"], np.uint32)
            self._embs[slots] = np.asarray(rec["embs"], np.float32)
            self._lens[slots] = np.asarray(rec["lens"], np.int32)
            self._live[slots] = True
            self._reuse[slots] = 0
        # every surviving live row must verify — rows torn mid-arena-write
        # (journaled but the mmap bytes never hit the disk) were just
        # rewritten by the replay above; anything still mismatching is
        # real corruption and gets retired (quarantine-through-retire)
        bad = self.verify()
        if bad.size:
            self._apply_retire(bad)
        self.recovery = {"n_replayed": len(records),
                         "torn_tail": bool(torn),
                         "n_quarantined": int(bad.size),
                         "live_after": self.live_count}
        self.checkpoint()
        self._gc_stray_epochs()

    def _grow_state_to(self, need: int) -> None:
        """Read-only bookkeeping growth: a live writer's WAL can name
        slots past the manifest's capacity (it grew its arenas after the
        last checkpoint). Those rows live in the overlay, so only the
        in-memory bookkeeping arrays grow — the mapped arenas (and
        ``self.capacity``, which describes them) stay untouched."""
        if need <= self._live.shape[0]:
            return
        new_cap = max(2 * self._live.shape[0], int(need))
        for name, fill in (("_live", 0), ("_lens", -1), ("_reuse", 0)):
            old = getattr(self, name)
            fresh = np.full(new_cap, fill, old.dtype)
            fresh[: self._n] = old[: self._n]
            setattr(self, name, fresh)
        self._live = self._live.astype(bool)
        self._csums = [
            np.concatenate([c, np.zeros(new_cap - c.shape[0], np.uint32)])
            for c in self._csums]

    def _open_read_only(self, manifest: str) -> None:
        """Recovery's read-only twin: manifest + journal replay, but the
        replayed rows land in ``self._overlay`` (the arenas belong to
        the writer) and nothing is swept, retired or checkpointed — a
        reader reports what it sees, it never repairs."""
        meta, arrays = read_format3(manifest, verify=True)
        n = int(arrays["n"])
        cap = max(1, int(meta.get("capacity", n or 1)), n)
        self._init_state(cap)
        self.epoch = int(meta.get("epoch", 0))
        self._n = n
        self._live[:n] = arrays["live"]
        self._lens[:n] = arrays["lens"]
        self._reuse[:n] = arrays["reuse"]
        self._free = [int(s) for s in arrays["free"]]
        for i, spec in enumerate(self.codec.parts):
            saved = arrays.get(f"csum_{spec.name}")
            if saved is None:
                raise MemoStoreError(
                    f"capacity manifest {manifest!r} was written for a "
                    f"different codec (missing csum_{spec.name})")
            self._csums[i][:n] = saved
        self.extra_meta = dict(meta.get("extra") or {})
        self._map_arenas_ro(self.capacity)
        records, torn = replay_journal(
            os.path.join(self.root, self.JOURNAL))
        for kind, rec in records:
            slots = np.asarray(rec["slots"], np.int64).reshape(-1)
            if kind == "retire":
                self._apply_retire(slots)
                for s in slots:
                    self._overlay.pop(int(s), None)
                continue
            top = int(slots.max()) + 1 if slots.size else 0
            self._grow_state_to(top)
            self._n = max(self._n, top)
            taken = set(int(s) for s in slots)
            self._free = [s for s in self._free if s not in taken]
            for j, s in enumerate(slots):
                self._overlay[int(s)] = (
                    tuple(np.asarray(rec[f"part_{spec.name}"][j])
                          for spec in self.codec.parts),
                    np.asarray(rec["embs"][j], np.float32))
            for c, spec in zip(self._csums, self.codec.parts):
                c[slots] = np.asarray(rec[f"csum_{spec.name}"], np.uint32)
            self._lens[slots] = np.asarray(rec["lens"], np.int32)
            self._live[slots] = True
            self._reuse[slots] = 0
        self.recovery = {"n_replayed": len(records),
                         "torn_tail": bool(torn),
                         "read_only": True,
                         "overlay_rows": len(self._overlay),
                         "live_after": self.live_count}

    def flush(self) -> None:
        self._flush_arenas()

    def close(self) -> None:
        try:
            self._flush_arenas()
        except (OSError, ValueError):
            pass
        try:
            if self.journal is not None:
                self.journal.close()
        finally:
            self._release_lock()

    def stats(self) -> dict:
        return {"live": self.live_count,
                "bytes": self.nbytes,
                "capacity": int(self.capacity),
                "epoch": int(self.epoch),
                "appended": self.n_appended,
                "retired": self.n_retired,
                "retired_fraction": self.retired_fraction,
                "checkpoints": self.n_checkpoints,
                "compactions": self.n_compactions,
                "journal_bytes": self.journal.nbytes,
                "recovery": self.recovery}
