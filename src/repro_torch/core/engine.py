"""AttMemo online inference engine (paper §5.1 Fig. 5), the counterpart
of the reference's ``core/engine.py``: the device fast path of
``bucket`` and ``kernel`` mode, the memo-free plain loop, build and
calibration.

Per memoizable layer the fast path runs, on device and with no host
synchronization: norm → embedding → top-1 search over the device table
→ calibrated similarity threshold and length gate → memoized attention →
output projection → residual → MLP.

* ``kernel`` — q/k/v projections feed the ``memo_attention`` kernel,
  which gathers its own APM tiles from the device DB by hit index (int8
  codes + scales, or f16); the search is the one-matmul form with the
  snapshot's cached row norms (the reference's ``fused=True``).
* ``bucket`` — the search goes through the ``nn_search`` kernel; the
  batch's APM rows are gathered and decoded (through f16, like the host
  decode) and attention runs the mixed formulation (``gqa_apply`` with a
  ``Memo`` override) for every row. The reference picks all-hit /
  all-miss / mixed with ``lax.cond`` on a device scalar; eager PyTorch
  would need a host read for that branch, so the port computes the
  mixed form unconditionally — the same values within f32
  reassociation, without the hit-skip.

Not ported yet (each raises ``NotImplementedError`` naming its slice):
``select`` mode's host lookup, ``device_quanta > 1``, miss capture and
online admission, prefill, the capacity tier and the sharded store.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.database import AttentionDB
from repro_torch.core.embedding import Embedder, embed_apply, train_embedder
from repro_torch.core.faults import FaultInjector
from repro_torch.core.similarity import similarity_score
from repro_torch.core.store import MemoStore, StoreSnapshot
from repro_torch.device import synchronize
from repro_torch.kernels.memo_attention.ops import memo_attention
from repro_torch.memo.specs import MemoSpec
from repro_torch.models import attention as attn_mod
from repro_torch.models import backbone as bb
from repro_torch.models.layers import mlp_apply, norm_apply

# paper Table 2 — per-model threshold levels
LEVELS = {"conservative": 0.98, "moderate": 0.97, "aggressive": 0.96}


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} waits for the {slice_name} slice "
                               f"of the port")


class SimReservoir:
    """Bounded reservoir sample (Algorithm R) of predicted similarities,
    lock-guarded (see the reference)."""

    def __init__(self, cap: int = 4096, seed: int = 0):
        self.cap = cap
        self.seen = 0                 # total values offered
        self._vals: List[float] = []
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def _append_locked(self, v: float) -> None:
        self.seen += 1
        if len(self._vals) < self.cap:
            self._vals.append(float(v))
        else:
            j = int(self._rng.integers(0, self.seen))
            if j < self.cap:
                self._vals[j] = float(v)

    def append(self, v: float) -> None:
        with self._lock:
            self._append_locked(v)

    def extend(self, values) -> None:
        values = list(values)
        with self._lock:
            if len(self._vals) + len(values) <= self.cap:
                self.seen += len(values)
                self._vals.extend(float(v) for v in values)
                return
            for v in values:
                self._append_locked(v)

    def percentile(self, q) -> float:
        with self._lock:
            if not self._vals:
                return float("nan")
            return float(np.percentile(self._vals, q))

    def __len__(self):
        return len(self._vals)

    def __iter__(self):
        return iter(list(self._vals))


@dataclass
class MemoStats:
    n_inputs: int = 0
    n_layer_attempts: int = 0
    n_hits: int = 0
    sims: SimReservoir = field(default_factory=SimReservoir)
    t_attn: float = 0.0
    t_total: float = 0.0            # whole-batch wall time (fast path)
    per_layer_hits: Dict[int, int] = field(default_factory=dict)
    n_admitted: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @property
    def memo_rate(self) -> float:
        return self.n_hits / max(1, self.n_layer_attempts)

    def merge(self, other: "MemoStats") -> "MemoStats":
        with self._lock:
            self.n_inputs += other.n_inputs
            self.n_layer_attempts += other.n_layer_attempts
            self.n_hits += other.n_hits
            self.t_attn += other.t_attn
            self.t_total += other.t_total
            self.n_admitted += other.n_admitted
            for li, nh in other.per_layer_hits.items():
                self.per_layer_hits[li] = self.per_layer_hits.get(li, 0) + nh
        self.sims.extend(other.sims)
        return self


@dataclass
class PreparedBatch:
    """Everything ``run_layers``/``finalize`` need for one device-resident
    batch — produced by ``prepare_batch``."""
    h: torch.Tensor
    positions: torch.Tensor
    kpad: Optional[torch.Tensor]          # (B, S) bool key-validity mask
    lengths_dev: Optional[torch.Tensor]   # (B,) int32 true lengths
    n_valid: int                          # real rows; the rest are padding
    thr: float
    active: set
    view: StoreSnapshot                   # the store generation served
    t0: float = 0.0
    pend: list = field(default_factory=list)


@dataclass
class MaintenancePayload:
    """Host-tier store work drained from one finished batch."""
    reuse_slots: Optional[np.ndarray] = None
    generation: int = -1


class MemoEngine:
    def __init__(self, model, params, memo_cfg: Optional[MemoSpec] = None):
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.device = model.device
        self.mc = MemoSpec() if memo_cfg is None else memo_cfg
        self.layers = list(self.cfg.memoizable_layers())
        if self.mc.max_layers:
            self.layers = self.layers[: self.mc.max_layers]
        self.store: Optional[MemoStore] = None
        self.embedder: Optional[Embedder] = None
        self._layers_cache = None
        self.faults = FaultInjector.from_spec(self.mc.runtime.faults)
        self._check_ported()

    def _check_ported(self):
        mc = self.mc
        if mc.shard.shards:
            raise _later("the sharded store (shards > 0)", "sharded-store")
        if mc.prefill.enabled:
            raise _later("prefill memoization", "prefill")
        if mc.capacity.dir is not None:
            raise _later("the capacity tier", "capacity-tier")

    # --- store delegation ------------------------------------------------
    @property
    def db(self) -> Optional[AttentionDB]:
        return self.store.db if self.store is not None else None

    @property
    def index(self):
        return self.store.index if self.store is not None else None

    @property
    def sim_cal(self):
        return self.store.sim_cal if self.store is not None else (-1.0, 1.0)

    @sim_cal.setter
    def sim_cal(self, value):
        if self.store is None:
            raise AttributeError("sim_cal lives on the MemoStore; "
                                 "build() the engine first")
        self.store.sim_cal = tuple(value)

    def _iter_layers(self):
        """Per-layer param views, sliced once per engine."""
        if self._layers_cache is None:
            self._layers_cache = list(bb.iter_layers(self.params, self.cfg))
        return self._layers_cache

    def _make_store(self, apm_shape, *, capacity: int) -> MemoStore:
        """Construct the MemoStore exactly as the spec describes."""
        mc = self.mc
        budget = (None if mc.budget_mb is None
                  else int(mc.budget_mb * 1e6))
        return MemoStore(
            tuple(apm_shape), mc.embed_dim, index_kind=mc.index_kind,
            budget_bytes=budget, capacity=capacity, device=self.device,
            device_slack=mc.device_slack, codec=mc.apm_codec, apm_rank=mc.apm_rank,
            device_index_kind=mc.device_index,
            cluster_crossover=mc.cluster_crossover,
            eviction=mc.eviction.kind, faults=self.faults,
            capacity_dir=mc.capacity.dir)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ build
    @torch.no_grad()
    def _capture(self, batches):
        hiddens, apms = [], []
        for batch in batches:
            if self.cfg.n_classes:
                _, caps = self.model.classify(self.params, batch,
                                              capture=True)
            else:
                caps = self.model.forward(self.params, batch,
                                          capture=True)[1]
            for li in self.layers:
                if li in caps:
                    hiddens.append(caps[li]["hidden"])
                    apms.append(caps[li]["apm"].half())
        return torch.cat(hiddens, 0), torch.cat(apms, 0)

    def build(self, batches: Sequence[dict], *, seed: int = 0,
              train_pairs: int = 512, verbose: bool = False):
        """Populate the attention + index databases from a calibration
        corpus and train the embedding model. ``seed`` drives the
        embedder's init and its pair sampling."""
        hiddens, apms = self._capture(batches)    # on device
        n, L, H = hiddens.shape
        self.store = self._make_store(apms.shape[1:], capacity=n)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        emb = Embedder.init(gen, L, H, dim=self.mc.embed_dim,
                            pool=self.mc.embed_pool, act=self.mc.embed_act,
                            device=self.device)
        sub = min(n, max(64, train_pairs))
        self.embedder, hist = train_embedder(
            seed + 1, emb, hiddens[:sub], apms[:sub],
            steps=self.mc.embed_steps)
        if verbose and hist:
            print(f"embedder loss {hist[0]:.4f} -> {hist[-1]:.4f}")
        with torch.no_grad():
            embs = self._embed(hiddens)
        self.store.admit(apms.cpu().numpy(), embs.cpu().numpy())
        self._calibrate(hiddens, apms)
        if self.mc.store == "device" and self.mc.mode in ("bucket",
                                                          "kernel"):
            self.store.sync()
        return self

    def _use_fast_path(self) -> bool:
        if self.store is None or self.db is None:
            return False
        if self.mc.mode not in ("bucket", "kernel"):
            return False
        if self.mc.device_fast_path is not None:
            return self.mc.device_fast_path
        return self.mc.store == "device"

    def _embed(self, hiddens, lengths=None):
        e = self.embedder
        if lengths is None:
            return embed_apply(e.params, hiddens, e.pool, e.act)
        return embed_apply(e.params, hiddens, e.pool, e.act,
                           lengths=lengths,
                           full_len=self.store.apm_shape[-1])

    @torch.no_grad()
    def _calibrate(self, hiddens, apms, n_pairs=256):
        """Fit sim ≈ a·dist + b so search distances predict similarity."""
        rng = np.random.default_rng(0)
        n = hiddens.shape[0]
        ia = self._tensor(rng.integers(0, n, n_pairs))
        ib = self._tensor(rng.integers(0, n, n_pairs))
        ea = self._embed(hiddens[ia]).cpu().numpy()
        eb = self._embed(hiddens[ib]).cpu().numpy()
        dist = np.linalg.norm(ea - eb, axis=-1)
        sim = similarity_score(apms[ia], apms[ib]).cpu().numpy()
        if np.std(dist) < 1e-9:
            self.sim_cal = (0.0, float(np.mean(sim)))
        else:
            a, b = np.polyfit(dist, sim, 1)
            self.sim_cal = (float(a), float(b))

    def predict_sim(self, dist: np.ndarray) -> np.ndarray:
        a, b = self.sim_cal
        return a * dist + b

    @torch.no_grad()
    def suggest_levels(self, batches) -> Dict[str, float]:
        """Per-model threshold levels: percentiles of the top-1 predicted
        similarity on the given queries (see the reference)."""
        sims = []
        for batch in batches:
            tokens = self._tensor(batch["tokens"])
            h = bb.embed_tokens(self.params, tokens, self.cfg)
            positions = self._positions(h.shape[0], h.shape[1])
            for li, kind, lp in self._iter_layers():
                if li in self.layers and kind in ("attn", "mla"):
                    x = norm_apply(lp["norm1"], h, self.cfg.norm)
                    emb = self._embed(x)
                    dist, _ = self.index.search(emb.cpu().numpy(), 1)
                    sims.extend(self.predict_sim(dist[:, 0]).tolist())
                h = self._layer_plain(lp, h, kind, li, None, positions)
        sims = np.asarray(sims)
        return {"conservative": float(np.percentile(sims, 75)),
                "moderate": float(np.percentile(sims, 50)),
                "aggressive": float(np.percentile(sims, 25))}

    def _positions(self, B: int, S: int):
        return torch.arange(S, dtype=torch.int32,
                            device=self.device).expand(B, S)

    # ------------------------------------------------------------------ infer
    @torch.no_grad()
    def infer(self, batch, *, threshold: Optional[float] = None,
              active_layers: Optional[Sequence[int]] = None,
              stats: Optional[MemoStats] = None, use_memo: bool = True):
        """Memoized forward. Returns (logits, stats). ``batch`` may carry
        ``lengths`` (B,) for padded variable-length inputs and
        ``n_valid`` (trailing rows are shape filler)."""
        thr = self.mc.threshold if threshold is None else threshold
        active = set(self.layers if active_layers is None else active_layers)
        st = stats or MemoStats()
        cfg = self.cfg
        if use_memo and self._use_fast_path():
            prep = self.prepare_batch(batch, threshold=thr,
                                      active_layers=active)
            self.run_layers(prep)
            out, st, payload = self.finalize(prep, stats=st)
            self.apply_maintenance(payload, stats=st)
            return out, st
        if use_memo and self.db is not None:
            raise _later(f"the host-synchronous lookup path (mode "
                         f"{self.mc.mode!r}, store {self.mc.store!r})",
                         "select-mode")
        tokens = self._tensor(batch["tokens"])
        lengths = batch.get("lengths")
        B, S = tokens.shape[0], tokens.shape[1]
        st.n_inputs += int(batch.get("n_valid", B))
        h = bb.embed_tokens(self.params, tokens, cfg)
        positions = self._positions(B, S)
        kpad = None
        if lengths is not None:
            kpad = (torch.arange(S, dtype=torch.int32, device=self.device)
                    [None, :] < self._tensor(lengths, torch.int32)[:, None])
        t0 = time.perf_counter()
        for li, kind, lp in self._iter_layers():
            h = self._layer_plain(lp, h, kind, li, None, positions,
                                  kpad=kpad)
        synchronize(self.device)
        st.t_attn += time.perf_counter() - t0
        if cfg.n_classes:
            return bb.classify_from_hidden(self.params, h, cfg,
                                           kpad=kpad), st
        return bb.logits_from_hidden(self.params, h, cfg), st

    # ------------------------------------- step-wise fast-path executor
    @torch.no_grad()
    def prepare_batch(self, batch, *, threshold: Optional[float] = None,
                      active_layers: Optional[Sequence[int]] = None
                      ) -> PreparedBatch:
        """Stage one device-resident batch: freeze the policy inputs,
        read the store snapshot the whole batch serves against, and move
        every host input to the device. ``run_layers`` then issues no
        host↔device copy at all."""
        if not self._use_fast_path():
            raise RuntimeError(
                "prepare_batch drives the device fast path; build() the "
                "engine in bucket/kernel mode")
        if self.mc.admit:
            raise _later("miss capture and online admission", "admission")
        if self.mc.device_quanta > 1:
            raise _later("device_quanta > 1", "select-mode")
        cfg = self.cfg
        tokens = self._tensor(batch["tokens"])
        lengths = batch.get("lengths")
        thr = self.mc.threshold if threshold is None else float(threshold)
        active = set(self.layers if active_layers is None
                     else active_layers)
        self.store.sync()         # generation-counted: no-op unless stale
        view = self.store.snapshot
        B, S = tokens.shape[0], tokens.shape[1]
        n_valid = int(batch.get("n_valid", B))
        t0 = time.perf_counter()
        h = bb.embed_tokens(self.params, tokens, cfg)
        positions = self._positions(B, S)
        len_dev, kpad = None, None
        if lengths is not None:
            len_dev = self._tensor(np.asarray(lengths), torch.int32)
            kpad = (torch.arange(S, dtype=torch.int32, device=self.device)
                    [None, :] < len_dev[:, None])
        return PreparedBatch(
            h=h, positions=positions, kpad=kpad,
            lengths_dev=len_dev, n_valid=n_valid, thr=thr,
            active=active, view=view, t0=t0)

    @torch.no_grad()
    def run_layers(self, prep: PreparedBatch) -> PreparedBatch:
        """The device-resident serving loop: every layer is device work
        only — no host synchronization, no host↔device copy (the one
        barrier lives in ``finalize``). Hit masks, predicted sims and
        matched slots accumulate as device tensors in ``prep.pend``."""
        h = prep.h
        for li, kind, lp in self._iter_layers():
            if li in prep.active and kind in ("attn", "mla"):
                h, *rest = self._layer_fused(
                    lp, h, kind, li, prep.thr, prep.positions,
                    view=prep.view, kpad=prep.kpad, qlen=prep.lengths_dev)
                prep.pend.append((li, *rest))
            else:
                h = self._layer_plain(lp, h, kind, li, None, prep.positions,
                                      kpad=prep.kpad)
        prep.h = h
        return prep

    @torch.no_grad()
    def finalize(self, prep: PreparedBatch,
                 stats: Optional[MemoStats] = None):
        """Head + the ONE trailing barrier, then the stats drain. Returns
        ``(outputs, stats, payload)``."""
        st = stats or MemoStats()
        cfg = self.cfg
        out = (bb.classify_from_hidden(self.params, prep.h, cfg,
                                       kpad=prep.kpad)
               if cfg.n_classes
               else bb.logits_from_hidden(self.params, prep.h, cfg))
        synchronize(self.device)                           # ONE barrier
        dt = time.perf_counter() - prep.t0
        st.n_inputs += prep.n_valid
        st.t_total += dt
        st.t_attn += dt
        payload = self._drain_stats(prep, st)
        return out, st, payload

    def _layer_fused(self, lp, h, kind, li, thr: float, positions, view,
                     kpad=None, qlen=None):
        """The serving layer (see the module docstring). Returns
        (h', sims, hits, slots), all device tensors."""
        cfg = self.cfg
        if kind != "attn":
            raise bb._not_ported(kind)
        kernel_path = self.mc.mode == "kernel"
        varlen = qlen is not None
        e = self.embedder
        x = norm_apply(lp["norm1"], h, cfg.norm)
        emb = embed_apply(e.params, x, e.pool, e.act, lengths=qlen,
                          full_len=self.store.apm_shape[-1])
        d2, idx = view.index.search_device(emb, args=view.search_args,
                                           fused=kernel_path)
        dist = torch.sqrt(torch.clamp(d2[:, 0], min=0.0))
        sim = view.sim_a * dist + view.sim_b
        hit = sim > thr
        idx0 = idx[:, 0].to(torch.int32)
        S = x.shape[1]
        # the length gate — ALWAYS on: a hit may only reuse an APM
        # captured at the query's own true length (S when fixed-length)
        ent_len = view.lengths.index_select(0, idx0)
        hit = hit & (ent_len == (qlen if varlen else S))
        codec = self.store.codec
        if kernel_path:
            qq, kk, vv = attn_mod._qkv(lp["mix"], x, cfg, positions)
            kw = dict(causal=cfg.causal, window=cfg.sliding_window,
                      lengths=qlen if varlen else None)
            if codec.name == "int8":
                out = memo_attention(qq, kk, vv, view.db_parts[0], idx0,
                                     hit.to(torch.int32),
                                     db_scales=view.db_parts[1], **kw)
            elif codec.name == "f16":
                out = memo_attention(qq, kk, vv, view.db_parts[0], idx0,
                                     hit.to(torch.int32), **kw)
            else:
                raise _later(f"kernel mode over the {codec.name!r} codec",
                             "lowrank-codec")
            y = torch.einsum("bshe,hed->bsd", out, lp["mix"]["wo"])
        else:
            # compressed gather + decode through f16 (host-decode parity)
            rows = tuple(p.index_select(0, idx0) for p in view.db_parts)
            apm = codec.decode_rows(rows).float()
            if apm.shape[-1] != S:
                apm = apm[..., :S, :S]
            y, _ = attn_mod.gqa_apply(
                lp["mix"], x, cfg, positions=positions,
                mask_kind="causal" if cfg.causal else "bidir",
                window=cfg.sliding_window, kpad=kpad,
                memo=attn_mod.Memo(apm=apm, hit=hit))
        return self._chan_tail(lp, h + y, li), sim, hit, idx0

    def _drain_stats(self, prep: PreparedBatch,
                     st: MemoStats) -> MaintenancePayload:
        """Materialize the per-layer device counters in two stacked
        transfers per batch (sims+hits as one f32 block, slots as one
        i32 block), after the trailing barrier."""
        pend = prep.pend
        out = MaintenancePayload(
            generation=getattr(prep.view, "generation", -1))
        if not pend:
            return out
        nv = prep.n_valid
        payload = torch.stack(
            [torch.stack([p[1], p[2].float()]) for p in pend]).cpu().numpy()
        slots = torch.stack([p[3] for p in pend]).cpu().numpy()[:, :nv]
        hits = payload[:, 1, :nv] > 0.5                          # (L, nv)
        sims = payload[:, 0, :nv]
        for p, s_row, h_row in zip(pend, sims, hits):
            li = p[0]
            st.n_layer_attempts += int(s_row.shape[0])
            nh = int(h_row.sum())
            st.n_hits += nh
            st.per_layer_hits[li] = st.per_layer_hits.get(li, 0) + nh
            st.sims.extend(s_row.tolist())
        if hits.any():
            out.reuse_slots = slots[hits]
        return out

    def apply_maintenance(self, payload: Optional[MaintenancePayload],
                          stats: Optional[MemoStats] = None) -> None:
        """Run one batch's host-tier store work (reuse-clock feeding and
        a generation-counted sync when the tiers diverged). Payload
        fields are consumed as they land, so a retry cannot double-count."""
        if payload is None or self.store is None:
            return
        if payload.reuse_slots is not None and payload.reuse_slots.size:
            slots, payload.reuse_slots = payload.reuse_slots, None
            self.store.note_reuse(slots)
        if self.store.device_stale:
            self.store.sync()

    # -- layer application --------------------------------------------------
    def _chan_tail(self, lp, h, li):
        """norm2 + MLP tail shared by the fused and plain layers."""
        cfg = self.cfg
        if bb._chan_kind(cfg, li) != "mlp":
            raise bb._not_ported(bb._chan_kind(cfg, li))
        x = norm_apply(lp["norm2"], h, cfg.norm)
        return h + mlp_apply(lp["chan"], x, cfg.act, cfg.glu)

    def _layer_plain(self, lp, h, kind, li, memo, positions, kpad=None):
        out, _ = bb._layer_apply(lp, h, self.cfg, kind, li, mode="full",
                                 positions=positions, memo=memo, kpad=kpad)
        return out
