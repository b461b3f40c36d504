"""MemoSession — the facade over the memoization stack, the counterpart
of the reference's ``memo/session.py`` (build / infer / serve / stats /
suggest_levels / autotune / profile; ``save``/``load`` wait for the
save/load slice)::

    from repro_torch.memo import MemoSession, MemoSpec

    sess = MemoSession.build(model, params, spec, batches=calib)
    logits, stats = sess.infer({"tokens": toks})
    with sess.serve(buckets=(64, 128), max_batch=32) as server:
        completions = server.run(workload)
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.core.engine import LEVELS, MemoEngine, MemoStats
from repro_torch.core.runtime import MemoServer
from repro_torch.device import resolve_device
from repro_torch.memo.specs import MemoSpec


class MemoSession:
    """A built, servable memoization session (``session.engine`` stays
    reachable for advanced use)."""

    def __init__(self, engine: MemoEngine):
        if engine.store is None:
            raise ValueError("MemoSession wraps a BUILT engine; use "
                             "MemoSession.build(...)")
        self.engine = engine
        self._stats = MemoStats()     # session-cumulative serving stats

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
        device = resolve_device(device)
        md = model.device
        if md.type != device.type or (md.index is not None and device.index
                                      is not None and md.index
                                      != device.index):
            raise ValueError(f"the model lives on {md}, the session was "
                             f"asked for {device}")
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
