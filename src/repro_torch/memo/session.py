"""MemoSession — the facade over the memoization stack, the counterpart
of the reference's ``memo/session.py``::

    from repro_torch.memo import MemoSession, MemoSpec

    sess = MemoSession.build(model, params, spec, batches=calib)
    logits, stats = sess.infer({"tokens": toks})
    with sess.serve(buckets=(64, 128), max_batch=32) as server:
        completions = server.run(workload)
    sess.save("memo_store.m3")                   # offline-built database
    warm = MemoSession.load("memo_store.m3", model, params, mmap=True)

``save``/``load`` persist the populated store — codec-part arenas, index
state, ``sim_cal``, per-entry lengths, the trained embedder and the full
spec — in the reference's formats (3: page-aligned, mmap-able; 2:
compressed npz) and key layout, so a file saved by either package loads
in the other. A loaded session's host tier is bit-identical to the saved
one; the device tier is re-materialized by the first sync. A capacity
tier directory (``MemoSpec(capacity_dir=...)``) carries a ``session.m3``
descriptor, so the directory alone reopens as a session after a crash.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.capacity import (_fsync_dir, is_format3, read_format3,
                                       write_format3)
from repro_torch.core.embedding import Embedder
from repro_torch.core.engine import LEVELS, MemoEngine, MemoStats
from repro_torch.core.faults import MemoStoreError, fire
from repro_torch.core.runtime import MemoServer
from repro_torch.device import resolve_device
from repro_torch.memo.specs import FLAT_FIELDS, MemoSpec

# format 2: compressed npz with a checksummed JSON header; format 3: the
# same header and arrays uncompressed and page-aligned, so
# ``load(..., mmap=True)`` maps the arenas copy-on-write. Both load;
# ``save`` writes format 3 unless asked for 2.
SAVE_FORMAT = 3
READ_FORMATS = (2, 3)

# the per-directory session descriptor a capacity tier carries, so
# ``MemoSession.load(<capacity dir>)`` can rebuild the session (spec +
# embedder) from the durable tier alone
SESSION_META = "session.m3"


def _check_device(model, device) -> torch.device:
    """The session's device (the card unless ``device="cpu"``), which
    must be the one the model lives on."""
    device = resolve_device(device)
    md = model.device
    if md.type != device.type or (md.index is not None and device.index
                                  is not None and md.index != device.index):
        raise ValueError(f"the model lives on {md}, the session was "
                         f"asked for {device}")
    return device


def _embedder_arrays(embedder: Embedder) -> Dict[str, np.ndarray]:
    return {f"emb_param_{k}": v.detach().cpu().numpy()
            for k, v in embedder.params.items()}


def _embedder_from_arrays(meta: dict, arrays, device) -> Embedder:
    emb_meta = meta["embedder"]
    return Embedder(
        {k[len("emb_param_"):]: torch.from_numpy(np.array(v)).to(device)
         for k, v in arrays.items() if k.startswith("emb_param_")},
        int(emb_meta["pool"]), str(emb_meta["act"]))


class MemoSession:
    """A built, servable memoization session (``session.engine`` stays
    reachable for advanced use). Construct it with ``build`` or
    ``load``."""

    def __init__(self, engine: MemoEngine):
        if engine.store is None:
            raise ValueError("MemoSession wraps a BUILT engine; use "
                             "MemoSession.build(...) or .load(...)")
        self.engine = engine
        self._stats = MemoStats()     # session-cumulative serving stats
        # a capacity tier makes the session self-describing: the spec and
        # embedder go next to the arenas, so the DIRECTORY alone reopens
        # through MemoSession.load (crash recovery has no save file)
        store = engine.store
        if store.capacity_ok:
            sess_path = os.path.join(store.capacity.root, SESSION_META)
            if not os.path.exists(sess_path):
                try:
                    self._write_session_meta(sess_path)
                except OSError as e:
                    store._capacity_fail(e)

    @property
    def spec(self) -> MemoSpec:
        return self.engine.mc

    @property
    def store(self):
        return self.engine.store

    @property
    def model(self):
        return self.engine.model

    @property
    def params(self):
        return self.engine.params

    @classmethod
    def build(cls, model, params, spec: Optional[MemoSpec] = None, *,
              batches: Sequence[dict], seed: int = 0, train_pairs: int = 512,
              verbose: bool = False, device=None) -> "MemoSession":
        """Calibrate a session on ``device`` (the card unless
        ``device="cpu"``; the model and params must live there): run
        ``batches`` with APM capture, train the Siamese embedder,
        populate both store tiers."""
        _check_device(model, device)
        eng = MemoEngine(model, params, spec)
        eng.build(batches, seed=seed, train_pairs=train_pairs,
                  verbose=verbose)
        return cls(eng)

    def infer(self, batch: dict, **kwargs):
        """Memoized forward; returns ``(logits, MemoStats)``. Per-call
        stats also accumulate into the session summary (``stats()``)
        unless the caller threads their own ``stats=`` object."""
        out, st = self.engine.infer(batch, **kwargs)
        if kwargs.get("stats") is None:
            self._stats.merge(st)
        return out, st

    def serve(self, **kwargs) -> MemoServer:
        """An open-loop continuous-batching server over this session —
        the raw ``MemoServer``; use it as a context manager. Serving
        stats live on ``server.stats``; store-lifecycle effects
        (admissions, evictions, sync bytes) land on the shared store and
        show up in ``session.stats()['store']``."""
        return MemoServer(self.engine, **kwargs)

    def suggest_levels(self, batches) -> Dict[str, float]:
        return self.engine.suggest_levels(batches)

    def autotune(self, batches, level: str = "moderate"
                 ) -> Dict[str, float]:
        """Set ``spec.runtime.threshold`` to the chosen level's
        percentile and return all levels."""
        if level not in LEVELS:
            raise ValueError(f"level must be one of {sorted(LEVELS)}: "
                             f"{level!r}")
        levels = self.suggest_levels(batches)
        self.spec.runtime.threshold = float(levels[level])
        return levels

    def profile(self, batch, **kwargs):
        """Selective-memoization profiler (paper §5.4) → ``PerfModel``."""
        return self.engine.profile(batch, **kwargs)

    def stats(self) -> Dict[str, object]:
        """One summary dict across serving and store lifecycle."""
        st, store = self._stats, self.store
        ss = store.stats
        return {
            "n_inputs": st.n_inputs,
            "n_layer_attempts": st.n_layer_attempts,
            "n_hits": st.n_hits,
            "hit_rate": st.memo_rate,
            "n_admitted": st.n_admitted,
            "threshold": float(self.spec.runtime.threshold),
            "store": {
                "live_entries": store.live_count,
                "entry_nbytes": store.entry_nbytes,
                "live_mb": store.live_count * store.entry_nbytes / 1e6,
                "codec": store.codec.name,
                "admitted": ss.n_admitted,
                "evicted": ss.n_evicted,
                "delta_syncs": ss.n_delta_syncs,
                "full_syncs": ss.n_full_syncs,
                "sync_mb": ss.bytes_total / 1e6,
            },
        }

    # ------------------------------------------------------- persistence
    def _session_meta(self, arrays: Dict[str, np.ndarray],
                      save_format: int) -> dict:
        eng = self.engine
        return {
            "format": int(save_format),
            "spec": self.spec.to_dict(),
            "embedder": {"pool": eng.embedder.pool,
                         "act": eng.embedder.act},
            "apm_shape": list(self.store.apm_shape),
            # the ivf host index's list count, read back by load (None
            # for the exact index)
            "n_lists": getattr(self.store.index, "n_lists", None),
            # per-array CRC32 of the exact bytes being written: load's
            # integrity gate
            "checksums": {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                          for k, v in arrays.items()},
        }

    def _write_session_meta(self, path: str) -> None:
        """Drop the session descriptor (spec + embedder, no store arrays)
        next to the capacity arenas."""
        arrays = _embedder_arrays(self.engine.embedder)
        write_format3(path, self._session_meta(arrays, 3), arrays)

    def save(self, path: str, *, save_format: int = SAVE_FORMAT) -> None:
        """Persist the populated store to one file: spec, trained
        embedder, codec-part arenas, slot mirrors (embeddings, entry
        lengths, liveness, reuse counters, free-list), ``sim_cal``.

        ``save_format=3`` (default) writes the page-aligned uncompressed
        layout that ``load(..., mmap=True)`` maps; ``save_format=2`` the
        compressed ``.npz``. Both writes are atomic (temp file in the
        target directory, fsync, ``os.replace``), so a crash — or the
        ``session.save_truncate`` fault — mid-save leaves an existing
        good file untouched."""
        if save_format not in READ_FORMATS:
            raise ValueError(f"save_format must be one of "
                             f"{list(READ_FORMATS)}: {save_format!r}")
        eng = self.engine
        arrays = _embedder_arrays(eng.embedder)
        for k, v in self.store.state_dict().items():
            arrays[f"store_{k}"] = np.asarray(v)
        meta = self._session_meta(arrays, save_format)
        if save_format == 3:
            write_format3(str(path), meta, arrays, faults=eng.faults,
                          fault_point="session.save_truncate")
            return
        tmp = str(path) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, meta=json.dumps(meta), **arrays)
            f.flush()
            os.fsync(f.fileno())
        if fire(eng.faults, "session.save_truncate") is not None:
            # a crash between the temp write and the rename: the temp is
            # torn, the target (if any) still holds the previous save
            size = os.path.getsize(tmp)
            with open(tmp, "rb+") as f:
                f.truncate(max(1, int(size * 0.6)))
            return
        os.replace(tmp, str(path))
        _fsync_dir(os.path.dirname(os.path.abspath(str(path))))

    @staticmethod
    def _spec_from_meta(path: str, meta: dict,
                        overrides: Optional[Dict[str, object]]) -> MemoSpec:
        try:
            spec = MemoSpec.from_dict(meta["spec"])
            for k, v in (overrides or {}).items():
                if k not in FLAT_FIELDS:
                    raise ValueError(
                        f"unknown override field {k!r}; valid flat "
                        f"fields: {sorted(FLAT_FIELDS)}")
                setattr(spec, k, v)     # flat property → re-validates
        except MemoStoreError:
            raise
        except Exception as e:
            raise MemoStoreError(
                f"invalid memo spec in {path!r}: "
                f"{type(e).__name__}: {e}") from e
        return spec

    @classmethod
    def load(cls, path: str, model, params, *, faults=None,
             mmap: bool = False,
             overrides: Optional[Dict[str, object]] = None,
             device=None) -> "MemoSession":
        """Warm-start a session from ``save`` output (either package's)
        — or from a capacity-tier DIRECTORY (crash recovery: the
        journaled arenas plus ``session.m3`` are the save). ``model`` /
        ``params`` must be the network the store was built against, on
        ``device`` (the card unless ``device="cpu"``); the embedder's
        params come back as tensors there.

        Every failure mode — unreadable or truncated file, bad format,
        per-array checksum mismatch, a spec that does not describe the
        persisted arrays — raises a ``MemoStoreError`` naming the
        problem.

        ``mmap=True`` (format-3 files only) adopts the codec-part arenas
        as copy-on-write memory maps instead of reading them: the open is
        zero-copy, and the whole-file checksum sweep is left to the
        store's per-row checksums (``store.verify_integrity()``).
        ``overrides`` remaps flat spec fields (``{"capacity_dir": ...}``)
        before the store is made. ``faults`` replaces the injector the
        file's spec would make (chaos harnesses arm
        ``session.load_bitflip`` on it)."""
        device = _check_device(model, device)
        if os.path.isdir(str(path)):
            return cls._load_capacity_dir(str(path), model, params,
                                          faults=faults,
                                          overrides=overrides, device=device)
        if is_format3(str(path)):
            meta, arrays = read_format3(str(path), mmap=mmap,
                                        verify=False)
        else:
            if mmap:
                raise MemoStoreError(
                    f"memo store file {path!r} is not format 3 — "
                    f"mmap=True needs the page-aligned layout; re-save "
                    f"with save_format=3")
            try:
                with np.load(str(path), allow_pickle=False) as data:
                    meta = json.loads(str(data["meta"]))
                    arrays = {k: data[k] for k in data.files
                              if k != "meta"}
            except MemoStoreError:
                raise
            except Exception as e:      # zipfile/zlib/json/KeyError...
                raise MemoStoreError(
                    f"unreadable memo store file {path!r} (truncated or "
                    f"corrupt): {type(e).__name__}: {e}") from e
        if meta.get("format") not in READ_FORMATS:
            raise MemoStoreError(
                f"unsupported memo save format {meta.get('format')!r} "
                f"(this build reads formats {list(READ_FORMATS)})")
        spec = cls._spec_from_meta(path, meta, overrides)
        eng = MemoEngine(model, params, spec)
        if faults is not None:
            eng.faults = faults      # threads into the store via _make_store
        if fire(eng.faults, "session.load_bitflip") is not None:
            # flip one byte of the first store array IN MEMORY: the
            # checksum gate below must refuse it
            for k in sorted(arrays):
                if k.startswith("store_part_"):
                    arr = np.array(arrays[k])
                    arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
                    arrays[k] = arr
                    break
        cls._verify_arrays(path, meta, arrays, check_crc=not mmap)
        eng.embedder = _embedder_from_arrays(meta, arrays, device)
        state = {k[len("store_"):]: v for k, v in arrays.items()
                 if k.startswith("store_")}
        n = int(state["n"])
        eng.store = eng._make_store(meta["apm_shape"], capacity=max(1, n),
                                    n_lists=meta.get("n_lists"))
        try:
            eng.store.load_state_dict(state, adopt_arenas=mmap)
        except MemoStoreError:
            raise
        except Exception as e:
            raise MemoStoreError(
                f"memo store state in {path!r} does not fit the spec it "
                f"declares: {type(e).__name__}: {e}") from e
        # as build(): materialize the serving tier only when the fast
        # path can reach it
        if spec.runtime.store == "device" and spec.runtime.mode in (
                "bucket", "kernel"):
            eng.store.sync()
        return cls(eng)

    @classmethod
    def _load_capacity_dir(cls, path: str, model, params, *, faults=None,
                           overrides=None, device=None) -> "MemoSession":
        """Reopen a session from its capacity-tier directory: recover the
        journaled arenas (WAL replay + CRC sweep, ``CapacityTier``),
        rebuild the session from ``session.m3`` and warm the host tier
        from the hottest disk rows. A process killed at any instant
        reopens here with at most the un-journaled tail lost."""
        sess_path = os.path.join(path, SESSION_META)
        if not os.path.exists(sess_path):
            raise MemoStoreError(
                f"capacity dir {path!r} has no {SESSION_META} — not a "
                f"memo capacity tier (or the session descriptor was "
                f"never written)")
        meta, arrays = read_format3(sess_path)
        spec = cls._spec_from_meta(sess_path, meta, overrides)
        spec.capacity.dir = path        # the directory may have moved
        eng = MemoEngine(model, params, spec)
        if faults is not None:
            eng.faults = faults
        eng.embedder = _embedder_from_arrays(meta, arrays, device)
        eng.store = eng._make_store(meta["apm_shape"], capacity=1,
                                    n_lists=meta.get("n_lists"))
        if not eng.store.capacity_ok:
            raise MemoStoreError(
                f"capacity dir {path!r} failed recovery: "
                f"{eng.store.capacity_error}")
        eng.store.adopt_capacity()
        if spec.runtime.store == "device" and spec.runtime.mode in (
                "bucket", "kernel"):
            eng.store.sync()
        return cls(eng)

    @staticmethod
    def _verify_arrays(path: str, meta: dict,
                       arrays: Dict[str, np.ndarray], *,
                       check_crc: bool = True) -> None:
        """The load-time integrity and spec-compatibility gate: every
        array's CRC32 must match the header, the required store arrays
        must exist, and their shapes must fit the spec. ``check_crc=False``
        (the mmap path) skips the byte sweep, which would fault every
        page in; per-row arena checksums still guard what is served."""
        csums = meta.get("checksums")
        if not isinstance(csums, dict):
            raise MemoStoreError(
                f"memo store file {path!r} has no checksummed header "
                f"(formats {list(READ_FORMATS)} require one)")
        missing = sorted(set(csums) - set(arrays))
        if missing:
            raise MemoStoreError(
                f"memo store file {path!r} is missing arrays the header "
                f"promises: {missing}")
        bad = [] if not check_crc else [
            k for k in sorted(arrays)
            if zlib.crc32(np.ascontiguousarray(arrays[k]).tobytes())
            != csums.get(k)]
        if bad:
            raise MemoStoreError(
                f"checksum mismatch in memo store file {path!r} for "
                f"{bad} — the file is corrupt (bit flips or a partial "
                f"write); rebuild or restore from a good copy")
        for req in ("store_n", "store_embs", "store_lens", "store_live"):
            if req not in arrays:
                raise MemoStoreError(
                    f"memo store file {path!r} is missing required "
                    f"array {req!r}")
        spec_d = meta.get("spec") or {}
        embed_dim = int((spec_d.get("embed") or {}).get("dim", -1))
        embs = arrays["store_embs"]
        if embs.ndim != 2 or (embed_dim > 0
                              and embs.shape[1] != embed_dim):
            raise MemoStoreError(
                f"memo store file {path!r} embedding mirror has shape "
                f"{embs.shape} but the spec declares embed dim "
                f"{embed_dim} — the file was saved under a different "
                f"spec")
        n = int(arrays["store_n"])
        rows = {k: arrays[k].shape[0] for k in arrays
                if k.startswith("store_part_")}
        wrong = sorted(k for k, r in rows.items() if r != n)
        if wrong or embs.shape[0] != n:
            raise MemoStoreError(
                f"memo store file {path!r} declares {n} entries but "
                f"arrays {wrong or ['store_embs']} disagree — the file "
                f"is inconsistent")
