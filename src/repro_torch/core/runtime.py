"""MemoServer — asynchronous continuous-batching serving runtime, the
counterpart of the reference's ``core/runtime.py`` (DESIGN.md §2.7).

The engine serves *batches*; production traffic is *requests*: individual
variable-length sequences arriving open-loop. MemoServer owns the gap:

* **length-bucketed continuous batching** — each request lands in the
  smallest length bucket that fits it; a batch launches when a bucket
  fills ``max_batch`` or its head request has waited ``max_delay``.
  Tokens are padded to the bucket length and the batch row count is
  padded to a power of two (filler rows replay row 0 and are dropped at
  ``n_valid``), so the set of served (bucket, rows) shapes is bounded by
  ``len(buckets) * log2(max_batch)``. The reference bounds its jit
  compiles that way; eager PyTorch compiles nothing, but the same bound
  keeps the kernels' shapes and the allocator's pools few.
* **step-wise engine execution** — the runtime calls the engine's
  ``prepare_batch → run_layers → finalize`` split directly, keeping the
  zero-per-layer-host-sync invariant (one barrier per batch).
* **off-thread store maintenance** — ``finalize`` returns a
  ``MaintenancePayload`` (device-tier reuse, captured misses); in async
  mode a single background worker applies it (admission under budget,
  CLOCK eviction, delta sync, recalibration) while the serving thread
  drives batch t+1. The worker finishes each payload by publishing a
  fresh ``StoreSnapshot``; the serving thread reads exactly one snapshot
  per batch, and a delta sync is copy-on-write (``core/store.py``), so a
  batch never sees a half-applied sync or a later generation's rows. In
  sync mode the same payload is applied inline at the batch boundary —
  the head-of-line-latency baseline the launcher A/Bs against.
* **supervised maintenance + graceful degradation** (DESIGN.md §2.9) —
  the worker retries failed payloads with exponential backoff; a payload
  that exhausts its retries is SHED (dropped), never re-raised into a
  request. Health walks the ladder HEALTHY → DEGRADED → MEMO_DISABLED:
  DEGRADED keeps serving the last published snapshot while maintenance
  sheds; ``disable_after`` consecutive payload failures escalate to
  MEMO_DISABLED, which serves every batch through exact attention, the
  logits bit-identical to ``engine.infer(use_memo=False)``. A staleness
  watchdog flags a stalled worker, ``drain_maintenance`` takes a
  ``timeout`` and checks worker liveness, and ``recover()``
  re-materializes the device tier from the host mirrors (quarantining
  entries that fail their checksums).
* **the capacity tier** (``MemoSpec(capacity_dir=...)``) — the
  maintenance actor checkpoints the disk tier every ``checkpoint_every``
  applied payloads (and re-compacts it past ``compact_ratio``), and once
  more on ``close()``. A detached tier (disk I/O error, stalled
  promotion, failed checkpoint) walks HEALTHY to DISK_DEGRADED: serving
  goes on RAM-only and nothing heals it but ``recover()``, which
  reattaches the tier (journal replay + CRC sweep) and re-checkpoints.

On a CUDA device the worker runs under ``torch.no_grad()`` on the device
and stream the server was made on (grad mode, the current device and
the current stream are per thread), so its copies and the serving
thread's kernels are ordered by one stream: an old generation's memory
is reused only after the kernels queued before its release.
``finalize``'s barrier synchronizes the whole device, so it also waits
for the worker's queued copies, promotions' delta syncs among them.
Prefill requests (``submit(prefill=True)``, on an engine built with
``prefill_enabled``) queue apart from the others — queues are keyed by
(bucket, prefill) — and run the engine's memoized-prefill leg: each
completion's ``logits`` is the last-token row and its ``caches`` this
request's decode caches. Under MEMO_DISABLED they serve through
``prefill_exact``.
"""
from __future__ import annotations

import contextlib
import enum
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import MemoEngine, MemoStats
from repro_torch.core.faults import fire


def _tree_rows(tree, i: int):
    """Batch row ``i`` (kept as a batch of one) of every tensor in a
    nested dict."""
    if isinstance(tree, dict):
        return {k: _tree_rows(v, i) for k, v in tree.items()}
    return tree[i: i + 1]


class Health(enum.Enum):
    """The serving-health ladder (DESIGN.md §2.9). Order matters: each
    step gives up store durability, then freshness, then the memo path,
    never the request."""
    HEALTHY = "healthy"
    DISK_DEGRADED = "disk_degraded"  # capacity tier detached: serve
    #                                  RAM-only until recover()
    DEGRADED = "degraded"            # serve last snapshot; shed maintenance
    MEMO_DISABLED = "memo_disabled"  # exact attention; no maintenance


class MemoMaintenanceError(RuntimeError):
    """A maintenance payload failed after every retry. Chained
    (``__cause__``) to the original worker exception, with the store
    generation the payload was drained against in the message."""


@dataclass
class Request:
    rid: int
    tokens: np.ndarray          # (length,) int32
    arrival: float              # runtime-clock seconds (scheduled arrival)
    enqueue: float              # when it actually entered its bucket queue
    prefill: bool = False       # memoized-prefill request (DESIGN.md §2.13)


@dataclass
class Completion:
    rid: int
    logits: np.ndarray          # unpadded: (n_classes,) or (length, vocab);
    #                             prefill requests: (vocab,) last-token row
    latency: float              # completion − arrival (queue + compute)
    length: int
    bucket: int
    batch_rows: int             # real rows in the batch that served it
    caches: Optional[dict] = None   # prefill only: this request's decode
    #                                 caches (batch row i as a batch of
    #                                 one), ready for model.decode_step


def pow2_buckets(max_len: int, n: int = 3, min_len: int = 8
                 ) -> Tuple[int, ...]:
    """Halving length buckets ending at ``max_len`` (the arena length):
    e.g. 64 → (16, 32, 64)."""
    out = [int(max_len)]
    while len(out) < n and out[-1] // 2 >= min_len:
        out.append(out[-1] // 2)
    return tuple(sorted(out))


class MemoServer:
    """Open-loop serving runtime over a built (fast-path) MemoEngine.

    ``async_maintenance=True`` moves ALL host-tier store work onto the
    background worker; ``False`` applies it inline at each batch boundary
    (the synchronous baseline). Everything else is identical, so the A/B
    isolates the overlap.
    """

    def __init__(self, engine: MemoEngine, *,
                 buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 16, max_delay: float = 2e-3,
                 batch_quantum: int = 4, async_maintenance: bool = True,
                 maint_queue_depth: int = 4, maint_retries: int = 2,
                 maint_backoff_s: float = 0.02, watchdog_s: float = 30.0,
                 disable_after: int = 3, maint_put_timeout: float = 0.25,
                 health_log_cap: int = 64,
                 checkpoint_every: Optional[int] = None):
        if engine.store is None:
            raise RuntimeError("build() the engine before serving")
        if not engine._use_fast_path():
            raise RuntimeError("MemoServer drives the device fast path; "
                               "use RuntimeSpec(mode='bucket')")
        if engine.mc.mode == "kernel":
            raise RuntimeError("variable-length serving supports bucket "
                               "mode (the kernel path is fixed-length)")
        self.engine = engine
        s_max = engine.store.apm_shape[-1]
        self.buckets = tuple(sorted(int(b) for b in (
            buckets if buckets is not None else pow2_buckets(s_max))))
        if self.buckets[-1] > s_max:
            raise ValueError(f"bucket {self.buckets[-1]} exceeds the "
                             f"arena length {s_max}")
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay)
        self.batch_quantum = max(1, int(batch_quantum))
        self.async_maintenance = bool(async_maintenance)
        # queues are keyed (bucket, prefill-kind): a batch is homogeneous
        self._queues: Dict[Tuple[int, bool], deque] = {
            (b, pf): deque() for b in self.buckets for pf in (False, True)}
        self._rid = 0
        self._t0 = time.perf_counter()
        # global stats: per-batch MemoStats are merged in (serving thread)
        # and the maintenance worker bumps admission counters — both via
        # the lock-guarded MemoStats/SimReservoir paths
        self.stats = MemoStats()
        self.n_batches = 0
        self.n_filler_rows = 0          # pow2 batch-padding overhead
        self.maintenance_errors: List[BaseException] = []
        # supervision (DESIGN.md §2.9)
        self.faults = engine.faults       # None in production
        self.maint_retries = max(0, int(maint_retries))
        self.maint_backoff_s = float(maint_backoff_s)
        self.watchdog_s = float(watchdog_s)
        self.disable_after = max(1, int(disable_after))
        self.maint_put_timeout = float(maint_put_timeout)
        self.health = Health.HEALTHY
        # BOUNDED transition history; n_health_transitions keeps the
        # total count past the ring's horizon
        self.health_log: deque = deque(maxlen=max(1, int(health_log_cap)))
        self.n_health_transitions = 0
        # capacity-tier checkpoint cadence: fold the WAL into a fresh
        # shadow manifest every N applied payloads
        self.checkpoint_every = int(
            engine.mc.capacity.checkpoint_every if checkpoint_every is None
            else checkpoint_every)
        self._applies_since_ckpt = 0
        self.n_checkpoints = 0
        # re-compaction: past this retired-hole fraction the maintenance
        # actor rewrites the tier densely right after a checkpoint
        self.compact_ratio = engine.mc.capacity.compact_ratio
        self.n_compactions = 0
        self.n_maint_shed = 0             # payloads dropped, never requests
        self.n_maint_retries = 0
        self.n_exact_batches = 0          # batches served in MEMO_DISABLED
        self._consec_failures = 0
        self._health_lock = threading.Lock()
        self._maint_busy_since: Optional[float] = None
        self._maint_q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        dev = engine.device
        # the worker issues its device work on the stream the server was
        # made on (see the module docstring)
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        if self.async_maintenance:
            # BOUNDED: each payload pins full captured-miss APM blocks;
            # past ``maint_queue_depth`` batches behind, put() blocks up to
            # ``maint_put_timeout`` and then SHEDS the payload — store
            # freshness is sacrificed before request latency
            self._maint_q = queue.Queue(maxsize=max(1, maint_queue_depth))
            self._worker = self._start_worker()

    def _start_worker(self) -> threading.Thread:
        w = threading.Thread(target=self._maintenance_loop,
                             name="memo-maintenance", daemon=True)
        w.start()
        return w

    # ------------------------------------------------------------- clock
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # --------------------------------------------------------- queueing
    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(f"request length {length} exceeds the largest "
                         f"bucket {self.buckets[-1]}")

    def submit(self, tokens, arrival: Optional[float] = None,
               prefill: bool = False) -> int:
        """Enqueue one request; returns its id. ``arrival`` defaults to
        now — open-loop callers pass the scheduled arrival time so queue
        delay is charged to the server, not the generator."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError("empty request")
        if prefill and not self.engine.mc.prefill.enabled:
            raise RuntimeError("prefill request on a server whose engine "
                               "has prefill disabled (set prefill_enabled "
                               "in the MemoSpec)")
        now = self._now()
        rid, self._rid = self._rid, self._rid + 1
        req = Request(rid=rid, tokens=tokens,
                      arrival=now if arrival is None else float(arrival),
                      enqueue=now, prefill=bool(prefill))
        self._queues[(self.bucket_for(tokens.size), bool(prefill))
                     ].append(req)
        return rid

    def _ready_bucket(self, now: float, flush: bool
                      ) -> Optional[Tuple[int, bool]]:
        """Batching policy: a bucket is ready when full or when its head
        request has waited past ``max_delay``; among ready buckets the
        oldest head wins (head-of-line fairness across buckets)."""
        best, best_t = None, None
        for key, q in self._queues.items():
            if not q:
                continue
            head_wait = now - q[0].enqueue
            if flush or len(q) >= self.max_batch \
                    or head_wait >= self.max_delay:
                if best is None or q[0].enqueue < best_t:
                    best, best_t = key, q[0].enqueue
        return best

    def _pad_rows(self, n: int) -> int:
        """Pow2 row padding from the bounded set {quantum, 2·quantum, …,
        max_batch}."""
        p = self.batch_quantum
        while p < n:
            p *= 2
        return min(p, self.max_batch)

    # ---------------------------------------------------------- serving
    def step(self, flush: bool = False) -> List[Completion]:
        """Assemble and serve at most one batch. Returns completions
        (empty when no bucket is ready)."""
        now = self._now()
        key = self._ready_bucket(now, flush)
        if key is None:
            return []
        q = self._queues[key]
        reqs = [q.popleft() for _ in range(min(len(q), self.max_batch))]
        return self._execute(key[0], reqs, prefill=key[1])

    def _execute(self, bucket: int, reqs: List[Request],
                 prefill: bool = False) -> List[Completion]:
        eng = self.engine
        n = len(reqs)
        rows = self._pad_rows(n)
        toks = np.zeros((rows, bucket), np.int32)
        lens = np.empty((rows,), np.int32)
        for i, r in enumerate(reqs):
            toks[i, : r.tokens.size] = r.tokens
            lens[i] = r.tokens.size
        if rows > n:                    # filler rows replay row 0
            toks[n:] = toks[0]
            lens[n:] = lens[0]
            self.n_filler_rows += rows - n
        batch = {"tokens": toks, "lengths": lens, "n_valid": n}
        st = MemoStats()
        if self.async_maintenance:
            self._check_worker()
        if self.health is Health.MEMO_DISABLED:
            # the bottom of the ladder: exact attention through the
            # engine's no-memo path (``prefill_exact`` for prefill), no
            # store reads, no maintenance
            if prefill:
                out = eng.prefill_exact(batch)
            else:
                out, st = eng.infer(batch, stats=st, use_memo=False)
            self.n_exact_batches += 1
        else:
            prep = eng.prepare_batch(batch, prefill=prefill,
                                     sync_store=not self.async_maintenance)
            eng.run_layers(prep)
            out, st, payload = eng.finalize(prep, stats=st)
            if self.async_maintenance:
                if self._worker is None:   # closed: nobody drains the
                    raise RuntimeError(    # queue — fail loudly instead
                        "MemoServer is closed")  # of blocking on put()
                self._enqueue_payload(payload)
            else:
                eng.apply_maintenance(payload, stats=self.stats)
                self._after_apply()
        self.stats.merge(st)
        self.n_batches += 1
        done = self._now()
        comps = []
        if prefill:
            logits_all, caches = out
            out_np = logits_all.cpu().numpy()           # (rows, vocab)
            by_li = eng._split_caches(caches)
            for i, r in enumerate(reqs):
                # per-request decode caches: slice batch row i out of
                # every layer's cache, then re-merge into the segment
                # tree model.decode_step consumes (slicing the merged tree
                # would cut a scan segment's repeats axis instead)
                c_i = eng._merge_caches({
                    li: _tree_rows(c, i) for li, c in by_li.items()})
                comps.append(Completion(
                    rid=r.rid, logits=out_np[i], latency=done - r.arrival,
                    length=int(r.tokens.size), bucket=bucket,
                    batch_rows=n, caches=c_i))
            return comps
        out_np = out.cpu().numpy()
        for i, r in enumerate(reqs):
            logits = (out_np[i] if out_np.ndim == 2
                      else out_np[i, : r.tokens.size])
            comps.append(Completion(
                rid=r.rid, logits=logits, latency=done - r.arrival,
                length=int(r.tokens.size), bucket=bucket, batch_rows=n))
        return comps

    # ----------------------------------------------------------- health
    def _set_health(self, health: Health, reason: str) -> None:
        with self._health_lock:
            if self.health is health:
                return
            self.health = health
            self.n_health_transitions += 1
            self.health_log.append((self._now(), health.value, reason))

    def _note_disk(self) -> None:
        """Walk HEALTHY down to DISK_DEGRADED when the capacity tier has
        detached. Never touches DEGRADED/MEMO_DISABLED and never
        auto-heals."""
        store = self.engine.store
        if store.capacity_error is not None \
                and self.health is Health.HEALTHY:
            self._set_health(
                Health.DISK_DEGRADED,
                f"capacity tier detached ({store.capacity_error}); "
                f"serving RAM-only (recover() to reattach)")

    def _after_apply(self) -> None:
        """Post-payload bookkeeping on the maintenance actor: the
        capacity checkpoint cadence and the disk-health probe. A failed
        checkpoint detaches the tier inside ``store.checkpoint`` (never
        raises)."""
        store = self.engine.store
        if store.capacity_ok:
            self._applies_since_ckpt += 1
            if self._applies_since_ckpt >= max(1, self.checkpoint_every):
                self._applies_since_ckpt = 0
                if store.checkpoint():
                    self.n_checkpoints += 1
                if self.compact_ratio is not None \
                        and store.compact_capacity(
                            self.compact_ratio) is not None:
                    self.n_compactions += 1
        self._note_disk()

    def _check_worker(self) -> None:
        """Serving-thread supervision, once per batch: restart a dead
        worker (DEGRADED until a payload applies cleanly again) and run
        the staleness watchdog. Neither path ever blocks or fails the
        batch."""
        w = self._worker
        if w is not None and not w.is_alive():
            self._set_health(Health.DEGRADED,
                             "maintenance worker died; restarted")
            self._worker = self._start_worker()
        busy = self._maint_busy_since
        if busy is not None \
                and time.monotonic() - busy > self.watchdog_s:
            self._set_health(
                Health.DEGRADED,
                f"maintenance stalled > {self.watchdog_s:.3g}s "
                f"(staleness watchdog)")
        self._note_disk()

    def _enqueue_payload(self, payload) -> None:
        """Hand one payload to the worker, shedding — never blocking the
        serving thread past ``maint_put_timeout`` — when the bounded
        queue stays full (shed maintenance, not requests)."""
        forced = fire(self.faults, "server.queue_overflow") is not None
        if not forced:
            try:
                self._maint_q.put_nowait(payload)
                return
            except queue.Full:
                try:          # transient backpressure before giving up
                    self._maint_q.put(payload,
                                      timeout=self.maint_put_timeout)
                    return
                except queue.Full:
                    pass
        self.n_maint_shed += 1
        self._set_health(Health.DEGRADED,
                         "maintenance queue overflow; shedding payloads")

    # ------------------------------------------------------ maintenance
    def _maintenance_loop(self):
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(torch.no_grad())
            if self._stream is not None:    # the serving thread's device
                ctx.enter_context(torch.cuda.device(self._stream.device))
                ctx.enter_context(torch.cuda.stream(self._stream))
            while True:
                item = self._maint_q.get()
                try:
                    if item is None:
                        return
                    self._apply_supervised(item)
                finally:
                    self._maint_busy_since = None
                    self._maint_q.task_done()

    def _apply_supervised(self, payload) -> None:
        """Apply one payload with bounded retry + exponential backoff.
        ``apply_maintenance`` is retry-safe (fields are consumed on first
        touch), so a retry after a mid-sync failure re-converges the
        store instead of double-admitting. A payload that exhausts its
        retries is recorded (traceback + generation preserved) and shed;
        ``disable_after`` consecutive shed payloads walk health down to
        MEMO_DISABLED."""
        self._maint_busy_since = time.monotonic()
        gen = getattr(payload, "generation", -1)
        delay = self.maint_backoff_s
        for attempt in range(self.maint_retries + 1):
            stall = fire(self.faults, "server.maint_stall")
            if stall is not None:
                time.sleep(float(stall.get("stall_s", 0.5)))
            try:
                if fire(self.faults, "server.maint_crash") is not None:
                    raise RuntimeError(
                        "injected maintenance-worker crash")
                self.engine.apply_maintenance(payload, stats=self.stats)
            except Exception as e:  # noqa: BLE001 — supervised: recorded
                if attempt < self.maint_retries:
                    self.n_maint_retries += 1
                    time.sleep(delay)
                    delay *= 2
                    continue
                try:
                    raise MemoMaintenanceError(
                        f"maintenance failed after {attempt + 1} "
                        f"attempt(s) applying the payload drained at "
                        f"store generation {gen}: "
                        f"{type(e).__name__}: {e}") from e
                except MemoMaintenanceError as wrapped:
                    self.maintenance_errors.append(wrapped)
                self._note_failure()
                return
            self._note_success()
            self._after_apply()
            return

    def _note_failure(self) -> None:
        with self._health_lock:
            self._consec_failures += 1
            n = self._consec_failures
        if n >= self.disable_after:
            self._set_health(
                Health.MEMO_DISABLED,
                f"{n} consecutive maintenance failures; serving exact "
                f"attention (recover() to re-arm the memo path)")
            self._purge_queue()
        else:
            self._set_health(Health.DEGRADED,
                             "maintenance payload shed after retries")

    def _note_success(self) -> None:
        with self._health_lock:
            self._consec_failures = 0
            back = self.health is Health.DEGRADED
        if back:
            # DEGRADED heals itself the moment maintenance flows again;
            # MEMO_DISABLED stays down until an explicit recover()
            self._set_health(Health.HEALTHY, "maintenance applied cleanly")

    def _purge_queue(self) -> None:
        """Drop every queued payload without applying it (entering
        MEMO_DISABLED: nothing will read the store)."""
        if self._maint_q is None:
            return
        while True:
            try:
                item = self._maint_q.get_nowait()
            except queue.Empty:
                return
            if item is None:      # keep the shutdown sentinel's contract
                self._maint_q.task_done()
                self._maint_q.put(None)
                return
            self.n_maint_shed += 1
            self._maint_q.task_done()

    def drain_maintenance(self, timeout: Optional[float] = None,
                          raise_errors: bool = True):
        """Block until every queued payload has been applied (and its
        snapshot published) — the quiesce point for tests and
        benchmarks. Raises (and clears) the first worker error since the
        last drain unless ``raise_errors=False``.

        ``timeout`` bounds the wait (``TimeoutError``); a worker that is
        no longer alive with payloads still queued raises immediately
        instead of blocking forever."""
        q = self._maint_q
        if q is not None:
            deadline = (None if timeout is None
                        else time.monotonic() + float(timeout))
            with q.all_tasks_done:
                while q.unfinished_tasks:
                    w = self._worker
                    if w is None or not w.is_alive():
                        raise MemoMaintenanceError(
                            f"maintenance worker is not alive with "
                            f"{q.unfinished_tasks} payload(s) pending")
                    if deadline is not None \
                            and time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"drain_maintenance timed out after "
                            f"{timeout}s with {q.unfinished_tasks} "
                            f"payload(s) pending")
                    q.all_tasks_done.wait(0.05)
        if self.maintenance_errors:
            errs, self.maintenance_errors = self.maintenance_errors, []
            if raise_errors:
                raise errs[0]

    # ----------------------------------------------------------- recover
    def recover(self) -> Dict[str, object]:
        """Re-arm the memo path after faults (DESIGN.md §2.9): verify
        every live entry's checksums (quarantining and tombstoning the
        corrupt ones), re-materialize the device tier from the host
        mirrors with a forced full sync, restart the worker if it died,
        and reset health to HEALTHY. The host tier survives worker
        crashes and shed payloads untouched, so the hit rate returns to
        the fault-free level (minus quarantined entries). A detached
        capacity tier is re-opened (journal replay + CRC sweep) and
        re-checkpointed; if the disk stays broken it stays detached and
        serving goes on RAM-only (DISK_DEGRADED again at once)."""
        store = self.engine.store
        if store.capacity_error is not None:
            if store.reattach_capacity():
                store.checkpoint()
        quarantined = store.verify_integrity(quarantine=True)
        store.sync(force_full=True)
        if self.async_maintenance and self._maint_q is not None \
                and (self._worker is None or not self._worker.is_alive()):
            self._worker = self._start_worker()
        with self._health_lock:
            self._consec_failures = 0
        # recovery acknowledges the fault window: the shed-payload
        # errors are part of what was recovered from
        self.maintenance_errors = []
        self._set_health(Health.HEALTHY, "recovered: device tier "
                         "re-materialized from host mirrors")
        self._note_disk()
        return {"quarantined": len(quarantined),
                "live_entries": store.live_count,
                "generation": store.generation,
                # None when no capacity dir is configured
                "capacity_ok": (store.capacity_ok
                                if store._capacity_dir else None)}

    def close(self):
        if self._worker is not None:
            w = self._worker
            while w.is_alive():
                try:
                    self._maint_q.put(None, timeout=0.1)
                    break
                except queue.Full:    # stalled worker: wait for space
                    continue
            w.join(timeout=30)
            self._worker = None
        # parting durability: fold the WAL tail into a clean manifest so
        # a reopen replays nothing (failures just detach the tier)
        store = self.engine.store
        if store is not None and store.capacity_ok:
            store.checkpoint()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.drain_maintenance()
        finally:
            self.close()

    # ---------------------------------------------------------- warm-up
    def warmup(self, batch_sizes: Optional[Sequence[int]] = None):
        """Take first-call costs outside the measured window: build the
        CUDA kernels (``kernels/build.py``) and run one dummy batch per
        (bucket, padded-row-count, capture-variant) combination, so the
        cuBLAS handles, kernel shapes and allocator pools of the bounded
        shape set exist before serving. Maintenance payloads are dropped
        and the admission counter restored, so warm-up leaves the store
        untouched."""
        sizes = list(batch_sizes) if batch_sizes is not None else None
        if sizes is None:
            sizes, p = [], self.batch_quantum
            while p < self.max_batch:
                sizes.append(p)
                p *= 2
            sizes.append(self.max_batch)
        eng = self.engine
        if eng.device.type == "cuda":
            from repro_torch.kernels import build
            build.library()
        serve_counter = eng._serve_batches
        # _capture_now keys off _serve_batches % admit_every: batch
        # parity 0 captures (when admission is on), parity 1 does not
        parities = ([0, 1] if eng.mc.admit and eng.mc.admit_every > 1
                    else [0])
        kinds = [False] + ([True] if eng.mc.prefill.enabled else [])
        try:
            for b in self.buckets:
                for rows in sizes:
                    for parity in parities:
                        for pf in kinds:
                            eng._serve_batches = parity
                            batch = {"tokens": np.zeros((rows, b),
                                                        np.int32),
                                     "lengths": np.full(
                                         (rows,), max(1, b // 2), np.int32),
                                     "n_valid": rows}
                            prep = eng.prepare_batch(batch, prefill=pf,
                                                     sync_store=False)
                            eng.run_layers(prep)
                            eng.finalize(prep, stats=MemoStats())
        finally:
            eng._serve_batches = serve_counter

    # --------------------------------------------------------- open loop
    def run(self, workload: Sequence[Tuple]) -> List[Completion]:
        """Serve an open-loop trace: ``workload`` is [(arrival_s, tokens)]
        (or [(arrival_s, tokens, prefill)]) on the runtime clock starting
        now. Arrivals are injected by schedule regardless of server
        progress (queueing delay is the server's problem — that is the
        open-loop point); returns one Completion per request with
        end-to-end latency."""
        wl = sorted(workload, key=lambda a: a[0])
        base = self._now()
        i, comps = 0, []
        while i < len(wl) or self.queued:
            now = self._now() - base
            while i < len(wl) and wl[i][0] <= now:
                item = wl[i]
                self.submit(item[1], arrival=base + item[0],
                            prefill=bool(item[2]) if len(item) > 2
                            else False)
                i += 1
            got = self.step(flush=i >= len(wl))
            if got:
                comps.extend(got)
                continue
            if i < len(wl):
                time.sleep(min(max(wl[i][0] - (self._now() - base), 0.0),
                               self.max_delay))
        return comps
