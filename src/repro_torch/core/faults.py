"""Fault injection + the store error type (DESIGN.md §2.9).

AttMemo's contract is acceleration "with negligible loss in inference
accuracy" — which obligates the serving stack to a stronger one: a memo
fault may cost hit rate, never correctness or availability. This module
is the *testable* half of that contract: a registry of named fault
points threaded through the store (``core/store.py``), the capacity
tier (``core/capacity.py``), the serving runtime (``core/runtime.py``)
and session persistence (``memo/session.py``), so the chaos classes of
``repro_torch.launch.server --fault`` and the tests drive every failure
mode deterministically. This is a copy of the reference's
``core/faults.py``.

Zero cost in production: faults are enabled through
``RuntimeSpec(faults={...})``. When that field is ``None`` (the
default) no ``FaultInjector`` is ever constructed and every fault site
compiles down to one ``x is None`` check — no RNG, no dict lookups, no
locks. ``faults={}`` builds an (idle) injector so harness code can
``arm()`` points after construction.

Trigger semantics (per armed point; each probe counts one activation):

* ``p=0.3``            — fire independently with probability 0.3
* ``at=5``             — fire from the 5th activation onward
* ``every=3``          — fire on every 3rd activation
* ``count=2``          — cap: at most 2 total fires (combines with all)
* extra kwargs (e.g. ``stall_s``) ride along and are returned to the
  fault site when the point fires.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


class MemoStoreError(ValueError):
    """Corrupt or incompatible memo-store state: a failed arena/save-file
    checksum, a truncated or unreadable save file, a spec that does not
    match the persisted arrays, or an injected store fault. Subclasses
    ``ValueError`` so pre-v2 callers catching the old save-format error
    keep working."""


# every fault point the stack knows, with where it fires — arming an
# unknown name fails fast against this table (the "registry")
FAULT_POINTS: Dict[str, str] = {
    "store.corrupt_row":    "MemoStore.admit: flip the freshly admitted "
                            "arena row's bytes (checksum left stale)",
    "store.sync_fail":      "MemoStore.sync: raise MemoStoreError before "
                            "any device mutation (delta-sync failure)",
    "store.evict_bogus":    "MemoStore.evict: policy returns dead / "
                            "duplicate / out-of-range slots (bookkeeping "
                            "fault)",
    "server.maint_crash":   "MemoServer worker: apply_maintenance raises",
    "server.maint_stall":   "MemoServer worker: sleep ``stall_s`` before "
                            "applying (staleness-watchdog food)",
    "server.queue_overflow": "MemoServer: treat the maintenance queue as "
                             "full (payload must be shed, not the batch)",
    "session.save_truncate": "MemoSession.save: crash between the temp "
                             "write and os.replace (torn temp, target "
                             "untouched)",
    "session.load_bitflip":  "MemoSession.load: flip one byte of a store "
                             "array before checksum verification",
    # capacity tier (DESIGN.md §2.11)
    "capacity.disk_write_io":   "CapacityTier.append: raise OSError before "
                                "any mutation — or, with a ``stall_s`` "
                                "rider, sleep (promotion stall)",
    "capacity.journal_torn":    "Journal.append: only a prefix of the "
                                "frame hits the disk, then the append "
                                "raises (crash mid-WAL-write)",
    "capacity.checkpoint_crash": "CapacityTier.checkpoint: die after the "
                                 "manifest temp write, before os.replace "
                                 "(old manifest + journal survive)",
    "capacity.mmap_bitflip":    "CapacityTier.append: flip one arena byte "
                                "after its row checksum was recorded",
    "capacity.compact_crash":   "CapacityTier.compact: die after the new "
                                "epoch's dense arenas are staged, before "
                                "the manifest publishes (old epoch + "
                                "journal survive; strays GC'd on reopen)",
}


@dataclass
class _Armed:
    p: float = 0.0
    at: Optional[int] = None
    every: Optional[int] = None
    count: Optional[int] = None
    args: Dict[str, object] = field(default_factory=dict)


class FaultInjector:
    """Thread-safe named fault points with deterministic + probabilistic
    triggering. One injector per engine (shared by its store, server and
    session); the serving thread and the maintenance worker probe it
    concurrently."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._armed: Dict[str, _Armed] = {}
        self.activations: Dict[str, int] = {}   # probes per point
        self.fired: Dict[str, int] = {}         # fires per point

    # ------------------------------------------------------------- config
    @classmethod
    def from_spec(cls, spec: Optional[Dict[str, Dict]], seed: int = 0
                  ) -> Optional["FaultInjector"]:
        """``RuntimeSpec.faults`` → injector. ``None`` → ``None`` (the
        production zero-cost path); a dict (possibly empty) → an
        injector with those points armed."""
        if spec is None:
            return None
        inj = cls(seed=seed)
        for point, kw in spec.items():
            inj.arm(point, **dict(kw or {}))
        return inj

    def arm(self, point: str, *, p: float = 0.0, at: Optional[int] = None,
            every: Optional[int] = None, count: Optional[int] = None,
            **args) -> None:
        """Arm one fault point. With no trigger kwargs at all the point
        fires on every activation (``p``/``at``/``every`` all unset)."""
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; registered: "
                f"{sorted(FAULT_POINTS)}")
        if p == 0.0 and at is None and every is None:
            at = 1                                # unconditional
        with self._lock:
            self._armed[point] = _Armed(p=float(p), at=at, every=every,
                                        count=count, args=dict(args))

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._armed.clear()
            else:
                self._armed.pop(point, None)

    def armed(self, point: str) -> bool:
        with self._lock:
            return point in self._armed

    # ------------------------------------------------------------- firing
    def fire(self, point: str) -> Optional[Dict[str, object]]:
        """Probe one fault point. Returns the armed extra-args dict when
        the point fires (possibly empty — test ``is not None``), else
        ``None``. Every probe counts one activation, fired or not."""
        with self._lock:
            self.activations[point] = k = self.activations.get(point, 0) + 1
            spec = self._armed.get(point)
            if spec is None:
                return None
            if spec.count is not None \
                    and self.fired.get(point, 0) >= spec.count:
                return None
            hit = False
            if spec.p > 0.0:
                hit = bool(self._rng.random() < spec.p)
            elif spec.every is not None:
                hit = k % max(1, int(spec.every)) == 0
            elif spec.at is not None:
                hit = k >= int(spec.at)
            if not hit:
                return None
            self.fired[point] = self.fired.get(point, 0) + 1
            return dict(spec.args)

    def reset(self) -> None:
        """Clear counters (armed points stay armed)."""
        with self._lock:
            self.activations.clear()
            self.fired.clear()


def fire(injector: Optional[FaultInjector], point: str
         ) -> Optional[Dict[str, object]]:
    """The one-liner fault sites use: ``None`` injector (production)
    short-circuits before any lookup."""
    if injector is None:
        return None
    return injector.fire(point)


# chaos-class presets: fault-point arming per failure scenario
CHAOS_PRESETS: Dict[str, Dict[str, Dict]] = {
    "corrupt_row":    {"store.corrupt_row": {"every": 2}},
    "sync_fail":      {"store.sync_fail": {"p": 0.5}},
    "evict_bogus":    {"store.evict_bogus": {}},
    "maint_crash":    {"server.maint_crash": {"p": 1.0}},
    "maint_stall":    {"server.maint_stall": {"p": 0.4, "stall_s": 0.05}},
    "queue_overflow": {"server.queue_overflow": {"p": 1.0}},
    # disk-fault classes (capacity tier, DESIGN.md §2.11): serving must
    # ride each out at RAM speed (DISK_DEGRADED, never unavailable)
    "disk_write_io":    {"capacity.disk_write_io": {"p": 1.0}},
    "journal_torn":     {"capacity.journal_torn": {"p": 1.0}},
    "checkpoint_crash": {"capacity.checkpoint_crash": {"p": 1.0}},
    "mmap_bitflip":     {"capacity.mmap_bitflip": {"every": 2}},
    "compact_crash":    {"capacity.compact_crash": {"p": 1.0}},
}
