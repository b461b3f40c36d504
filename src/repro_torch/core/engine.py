"""AttMemo online inference engine (paper §5.1 Fig. 5), the counterpart
of the reference's ``core/engine.py``: every serving mode and policy a
decoder, encoder-only, hybrid or encoder-decoder model uses, build and
calibration.

Per memoizable layer the engine runs: norm → embedding → top-1 search →
calibrated similarity threshold and length gate → memoized attention →
output projection → residual → MLP. Two executors do it.

**The device fast path** (``bucket`` and ``kernel`` with the device
store; ``prepare_batch`` → ``run_layers`` → ``finalize``) is device work
only: no host synchronization inside ``run_layers``, one barrier in
``finalize``, then the stats drain. The one exception is a MoE channel
block (``models/moe.py::moe_apply``), which reads its per-expert slice
sizes on the host: one sync per MoE layer.

* ``kernel`` — q/k/v projections feed the ``memo_attention`` kernel,
  which gathers its own APM tiles from the device DB by hit index (int8
  codes + scales, or f16); the flat search is the one-matmul form with
  the snapshot's cached row norms (the reference's ``fused=True``). A
  factorized codec (``lowrank``) is decoded for the batch's B matched
  rows first, and the kernel runs over that B-row f16 DB. An MLA layer
  (``kind == "mla"``) takes the ``bucket`` form in kernel mode too, as
  in the reference: ``memo_attention`` serves GQA layers only.
* ``bucket`` — the search goes through the ``nn_search`` kernel; the
  batch's APM rows are gathered and decoded (through f16, like the host
  decode). Then, as the reference's ``bucketed``, the rows are sorted
  hit-first (``device_quanta > 1``) and cut into quanta, and each
  quantum takes one of three branches on its hit count: ``all_hit``
  runs the memo-only attention (V and APM·V: no Q/K projection, QKᵀ or
  softmax), ``all_miss`` plain attention (no memo combine), ``mixed``
  both, picked per row (``gqa_apply`` with a ``Memo`` override). The
  branch is ``core/cond.py``'s: on the card, CUDA-graph conditional
  nodes over captured bodies, with no host read (the reference's
  ``lax.cond`` on a device scalar); on the CPU a Python ``if``. The
  every-row mixed form stays as the plain version
  (``prepare_batch(mixed_form=True)``), for tests and chip_smoke.

**The host-synchronous path** (``select``, and ``bucket``/``kernel``
with ``device_fast_path=False`` or the host store): per layer, embed on
the device, search the host index, gate on the host and gather the APM
batch from the host arena (``_lookup``). ``select`` combines both
attention branches per row; ``bucket`` splits the batch into hit and
miss rows, so hit rows skip QKᵀ and softmax (``_layer_bucket``);
``kernel`` runs ``memo_attention`` over the device DB
(``_layer_kernel``). Variable-length batches are served everywhere but
on the host bucket path.

Every codec (``f16``, ``int8``, ``lowrank``) and index (host ``exact``,
``ivf``, ``device``; device ``flat``, ``clustered``, ``auto``) serves on
every path: the device search is the snapshot index's ``search_device``
and the host paths decode through ``codec.decode``.

**Online admission** (``admit=True``): misses of every ``admit_every``-th
served batch are captured (their true APM and embedding; on the fast
path staged on the device, drained in ``finalize``), admitted under the
byte budget at the batch boundary and delta-synced, and every
``recal_every`` flushes ``sim_cal`` is refit from recent captures. The
delta sync is copy-on-write (``core/store.py``): a published snapshot
never changes, so a ``PreparedBatch`` keeps serving its generation while
``apply_maintenance`` runs inline after ``finalize`` (``infer``) or on
``MemoServer``'s worker thread (``core/runtime.py``).

With a capacity tier (``MemoSpec(capacity_dir=...)``) the flush first
asks the disk tier for the captured misses (``MemoStore.promote_for``):
a miss whose nearest disk row clears the threshold is satisfied by
promoting that row bit-identically, and only the rest are admitted. The
promoted rows ride the same delta sync as the admissions.

**Selective memoization** (``profile``): per-layer attention time,
lookup overhead and memo rate feed ``PerfModel``; serve its
``active_layers()`` through ``infer(active_layers=...)``.

**Memoized causal prefill** (``prefill_enabled``; AttnCache, DESIGN.md
§2.13): every entry also carries the layer's post-RoPE K/V
(``core/prefill.py``), captured at build by ``_kv_probe`` and at
admission by prefill batches only. ``prefill`` runs the fast path with
``prepare_batch(prefill=True)``: memoized layers (``_layer_fused_prefill``)
search through ``nn_search``, decode the matched row's APM and K/V, and
take the bucket path's per-quantum branch: an all-hit quantum replays
the stored APM and takes its decode cache straight from the stored K/V,
an all-miss quantum runs exact attention and caches its fresh K/V, a
mixed quantum does both and picks per row with ``torch.where``.
Kernel-mode engines take this form too: ``memo_attention`` hands back
no K/V, as in the reference. Other layers build their caches exactly
(``_layer_plain_prefill``); ``finalize`` returns the last-token logits
and the caches ``Model.decode_step`` consumes. ``prefill_exact`` is
``Model.prefill``, the memo-free leg.

**Hybrid models** (recurrentgemma's (rglru, rglru, attn) pattern): the
attention layers are memoized on every path; the RG-LRU layers run
``_layer_plain`` (and ``_layer_plain_prefill`` with their state).

**Encoder-decoder models** (whisper, ``_infer_encdec``): the encoder's
self-attention is memoized on the host-synchronous path through
``_lookup`` (fixed frame count, bidirectional APMs), then the decoder
runs plain; the fast path, admission and prefill memoization do not
apply, as in the reference.

**The sharded store** (``MemoSpec(shard=ShardSpec(shards=N))``,
``core/shard.py``): the device tier is split over a ``StoreMesh``, and
its arenas are indexed by device position, not slot. The three device
paths (``_layer_fused``, ``_layer_fused_prefill``, ``_fused_lookup_probe``)
take the winner's codec rows from the index's one combine
(``search_fetch``), never by slot from the arenas; kernel mode decodes
those B rows and runs ``memo_attention`` over them as a B-row f16 DB
(for every codec, as the reference's sharded branch does). The host
kernel path takes the rows from the host arena by slot.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.cond import GraphCache, n_quanta, run_quanta, site_key
from repro_torch.core.database import AttentionDB
from repro_torch.core.embedding import Embedder, embed_apply, train_embedder
from repro_torch.core.faults import FaultInjector
from repro_torch.core.prefill import PrefillCodec, stack_kv, unstack_kv_rows
from repro_torch.core.selective import LayerProfile, PerfModel, timeit_median
from repro_torch.core.similarity import pair_similarity, similarity_score
from repro_torch.core.store import MemoStore, StoreSnapshot
from repro_torch.device import synchronize
from repro_torch.kernels.memo_attention.ops import memo_attention
# MemoConfig lives in repro_torch.memo.specs; re-exported here as the
# reference's core/engine.py re-exports it
from repro_torch.memo.specs import MemoConfig, MemoSpec  # noqa: F401
from repro_torch.models import attention as attn_mod
from repro_torch.models import backbone as bb
from repro_torch.models import encdec as ed
from repro_torch.models.layers import mlp_apply, norm_apply
from repro_torch.models.moe import moe_apply

# paper Table 2 — per-model threshold levels
LEVELS = {"conservative": 0.98, "moderate": 0.97, "aggressive": 0.96}


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
    t_embed: float = 0.0
    t_search: float = 0.0
    t_fetch: float = 0.0
    t_attn: float = 0.0
    t_other: float = 0.0
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
            self.t_embed += other.t_embed
            self.t_search += other.t_search
            self.t_fetch += other.t_fetch
            self.t_attn += other.t_attn
            self.t_other += other.t_other
            self.t_total += other.t_total
            self.n_admitted += other.n_admitted
            for li, nh in other.per_layer_hits.items():
                self.per_layer_hits[li] = self.per_layer_hits.get(li, 0) + nh
        self.sims.extend(other.sims)
        return self

    def add_admitted(self, n: int) -> None:
        """Maintenance-side counter bump, guarded like ``merge``."""
        with self._lock:
            self.n_admitted += int(n)


@dataclass
class PreparedBatch:
    """Everything ``run_layers``/``finalize`` need for one device-resident
    batch — produced by ``prepare_batch``."""
    tokens: torch.Tensor
    h: torch.Tensor
    positions: torch.Tensor
    kpad: Optional[torch.Tensor]          # (B, S) bool key-validity mask
    lengths_dev: Optional[torch.Tensor]   # (B,) int32 true lengths
    lengths: Optional[np.ndarray]         # host copy (drain/admission)
    n_valid: int                          # real rows; the rest are padding
    thr: float
    active: set
    capture: bool                         # stage misses for admission
    view: StoreSnapshot                   # the store generation served
    t0: float = 0.0
    pend: list = field(default_factory=list)
    # prefill serving: per-layer decode-cache templates split from
    # model.init_caches, and the caches each layer produced
    prefill: bool = False
    cache_len: int = 0
    cache_tpls: Optional[dict] = None
    caches_by_li: dict = field(default_factory=dict)
    # the plain version of the device branch (every row mixed)
    mixed_form: bool = False


@dataclass
class MaintenancePayload:
    """Host-tier store work drained from one finished batch."""
    reuse_slots: Optional[np.ndarray] = None         # device-tier hits
    admissions: List[Tuple] = field(default_factory=list)
    #   (apms, embs, lens, kv) blocks — kv is the stacked (B, 2, S, D) K/V
    #   plane under prefill capture, None for APM-only admissions
    generation: int = -1

    @property
    def empty(self) -> bool:
        return not self.admissions and (
            self.reuse_slots is None or self.reuse_slots.size == 0)


class MemoEngine:
    def __init__(self, model, params, memo_cfg: Optional[MemoSpec] = None):
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.device = model.device
        self.mc = MemoSpec() if memo_cfg is None else memo_cfg
        self.is_encdec = getattr(model, "is_encdec", False)
        if self.is_encdec:
            # enc-dec (whisper): memoize the ENCODER self-attention
            self.layers = list(range(self.cfg.encoder.n_layers))
        else:
            self.layers = list(self.cfg.memoizable_layers())
        if self.mc.max_layers:
            self.layers = self.layers[: self.mc.max_layers]
        self.store: Optional[MemoStore] = None
        self.embedder: Optional[Embedder] = None
        self.perf: Optional[PerfModel] = None
        self._layers_cache = None
        self._serve_batches = 0          # admission-sampling counter
        self._pending_admissions: List = []   # host-path capture staging
        self._recal_buf: List = []       # rolling (apms, embs) captures
        self._flush_count = 0
        self.faults = FaultInjector.from_spec(self.mc.runtime.faults)
        self.graphs = GraphCache()        # the device branch's sites

    # --- store delegation ------------------------------------------------
    @property
    def db(self) -> Optional[AttentionDB]:
        return self.store.db if self.store is not None else None

    @property
    def index(self):
        return self.store.index if self.store is not None else None

    @property
    def device_db(self):
        return self.store.device_db if self.store is not None else None

    @property
    def device_index(self):
        return self.store.device_index if self.store is not None else None

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

    def _make_store(self, apm_shape, *, capacity: int,
                    n_lists: Optional[int] = None) -> MemoStore:
        """Construct the MemoStore exactly as the spec describes — the
        one construction path of ``build()`` and ``MemoSession.load``.
        ``n_lists`` (the ivf host index's list count, derived from the
        calibration size at build, which a grown store no longer knows)
        is what a load hands back."""
        mc = self.mc
        budget = (None if mc.budget_mb is None
                  else int(mc.budget_mb * 1e6))
        codec = mc.apm_codec
        if mc.prefill.enabled:
            # prefill memoization: wrap the APM codec so every entry
            # carries per-layer K/V parts — the same store, arenas, sync,
            # capacity tier and save format serve both
            from repro_torch.core.codec import get_codec
            base = get_codec(codec, tuple(apm_shape), rank=mc.apm_rank)
            codec = PrefillCodec(
                base, kv_dim=self.cfg.n_kv_heads * self.cfg.head_dim,
                kv_codec=mc.prefill.kv_codec, kv_rank=mc.prefill.kv_rank)
        kw = dict(
            index_kind=mc.index_kind, budget_bytes=budget,
            capacity=capacity, device=self.device,
            device_slack=mc.device_slack,
            n_lists=(n_lists if n_lists is not None
                     else max(4, int(np.sqrt(max(1, capacity))))),
            codec=codec, apm_rank=mc.apm_rank,
            cluster_crossover=mc.cluster_crossover,
            nprobe=mc.nprobe, n_clusters=mc.n_clusters,
            eviction=mc.eviction.kind, faults=self.faults,
            capacity_dir=mc.capacity.dir,
            capacity_budget_mb=mc.capacity.budget_mb,
            capacity_fsync=mc.capacity.fsync,
            capacity_stall_s=mc.capacity.stall_s)
        sh = mc.shard
        if sh.shards:
            from repro_torch.core import shard
            return shard.ShardedMemoStore(
                tuple(apm_shape), mc.embed_dim, n_shards=sh.shards,
                shard_axis=sh.axis, hot_k=sh.hot,
                route_nprobe=sh.route_nprobe,
                refresh_spills=sh.refresh_spills,
                mesh=shard.make_store_mesh(sh.shards, sh.axis,
                                           device=self.device),
                **kw)
        return MemoStore(tuple(apm_shape), mc.embed_dim,
                         device_index_kind=mc.device_index, **kw)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ build
    @torch.no_grad()
    def _capture(self, batches):
        """Run the calibration batches with APM capture. Returns the
        memoized layers' attention inputs and f16 APMs, and under prefill
        memoization their post-RoPE K/V planes (recomputed from the
        captured input, which is the normed x that ``_qkv`` reads), else
        None."""
        prefill = self.mc.prefill.enabled
        lps = ({li: lp for li, _, lp in self._iter_layers()}
               if prefill else None)
        hiddens, apms, kvs = [], [], []
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
                    if prefill:
                        kvs.append(self._kv_probe(lps[li],
                                                  caps[li]["hidden"]))
        return (torch.cat(hiddens, 0), torch.cat(apms, 0),
                torch.cat(kvs, 0) if prefill else None)

    def build(self, batches: Sequence[dict], *, seed: int = 0,
              train_pairs: int = 512, verbose: bool = False):
        """Populate the attention + index databases from a calibration
        corpus and train the embedding model. ``seed`` drives the
        embedder's init and its pair sampling. With prefill memoization
        every calibration entry also stores the layer's post-RoPE K/V, so
        the first epoch serves prefill at once."""
        if self.mc.prefill.enabled:
            self._check_prefill_supported()
        hiddens, apms, kv = self._capture(batches)    # on device
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
        self.store.admit(apms.cpu().numpy(), embs.cpu().numpy(),
                         kv=None if kv is None else kv.cpu().numpy())
        self._calibrate(hiddens, apms)
        if self.mc.store == "device" and self.mc.mode in ("bucket",
                                                          "kernel"):
            self.store.sync()
        return self

    def _use_fast_path(self) -> bool:
        if self.is_encdec or self.store is None or self.db is None:
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
        sim = pair_similarity(apms, ia, ib).cpu().numpy()
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
        ``n_valid`` (trailing rows are shape filler, excluded from stats
        and admission). Variable length is served by every path but the
        host-synchronous bucket path."""
        thr = self.mc.threshold if threshold is None else threshold
        active = set(self.layers if active_layers is None else active_layers)
        st = stats or MemoStats()
        cfg = self.cfg
        if self.is_encdec:
            return self._infer_encdec(batch, thr, active, st, use_memo)
        if use_memo and self._use_fast_path():
            # inline maintenance at the batch boundary
            prep = self.prepare_batch(batch, threshold=thr,
                                      active_layers=active)
            self.run_layers(prep)
            out, st, payload = self.finalize(prep, stats=st)
            self.apply_maintenance(payload, stats=st)
            return out, st
        capture = self._capture_now(use_memo)
        if use_memo:
            self._serve_batches += 1
        tokens = self._tensor(batch["tokens"])
        lengths = batch.get("lengths")
        if lengths is not None and use_memo and self.mc.mode == "bucket":
            raise ValueError(
                "variable-length batches are served by the device fast "
                "path, the select reference, or kernel mode (the "
                "memo_attention lengths operand); the host-synchronous "
                "bucket path is fixed-length")
        B, S = tokens.shape[0], tokens.shape[1]
        n_valid = int(batch.get("n_valid", B))
        st.n_inputs += n_valid
        h = bb.embed_tokens(self.params, tokens, cfg)
        positions = self._positions(B, S)
        kpad = None
        if lengths is not None:
            lengths = np.asarray(lengths, np.int32)
            kpad = (torch.arange(S, dtype=torch.int32, device=self.device)
                    [None, :] < self._tensor(lengths)[:, None])
        memoize = use_memo and self.db is not None
        t_loop = time.perf_counter()
        for li, kind, lp in self._iter_layers():
            memo = None
            if memoize and li in active and kind in ("attn", "mla"):
                memo = self._lookup(lp, h, kind, thr, st, li,
                                    positions=positions, capture=capture,
                                    lengths=lengths, kpad=kpad,
                                    n_valid=n_valid)
            t0 = time.perf_counter()
            if memo is not None and self.mc.mode == "bucket":
                h = self._layer_bucket(lp, h, kind, li, memo, positions)
            elif memo is not None and self.mc.mode == "kernel" \
                    and kind == "attn":
                h = self._layer_kernel(lp, h, li, memo, positions,
                                       lengths=lengths)
            else:
                h = self._layer_plain(lp, h, kind, li,
                                      self._device_memo(memo), positions,
                                      kpad=kpad)
            if memoize:                   # per-layer time on the host path
                synchronize(self.device)
                st.t_attn += time.perf_counter() - t0
        if not memoize:                   # the memo-free loop: one barrier
            synchronize(self.device)
            st.t_attn += time.perf_counter() - t_loop
        self._flush_admissions(st)        # batch boundary: admit + sync
        if cfg.n_classes:
            return bb.classify_from_hidden(self.params, h, cfg,
                                           kpad=kpad), st
        return bb.logits_from_hidden(self.params, h, cfg), st

    # ------------------------------------- step-wise fast-path executor
    @torch.no_grad()
    def prepare_batch(self, batch, *, threshold: Optional[float] = None,
                      active_layers: Optional[Sequence[int]] = None,
                      sync_store: bool = True,
                      prefill: bool = False,
                      mixed_form: bool = False) -> PreparedBatch:
        """Stage one device-resident batch: freeze the policy inputs
        (threshold, active layers, admission sampling), read the store
        snapshot the whole batch serves against, and move every host
        input to the device. ``run_layers`` then issues no host↔device
        copy at all.

        ``sync_store=False`` is the async-maintenance contract: the
        serving thread never mutates the store; it reads the latest
        published snapshot and leaves sync to the worker (a store with
        no snapshot yet is synced once).

        ``prefill=True`` stages a memoized causal prefill: the batch also
        carries per-layer decode-cache templates, memoized layers run
        ``_layer_fused_prefill`` and ``finalize`` returns
        ``(last_logits, caches)``.

        ``mixed_form=True`` runs the plain version of the device branch:
        every row of a bucketed layer takes the mixed form, with no
        per-quantum branch. Tests and chip_smoke hold the branch against
        it; serving never asks for it."""
        if not self._use_fast_path():
            raise RuntimeError(
                "prepare_batch drives the device fast path; build() the "
                "engine in bucket/kernel mode (select and host paths go "
                "through infer())")
        cfg = self.cfg
        tokens = self._tensor(batch["tokens"])
        lengths = batch.get("lengths")
        thr = self.mc.threshold if threshold is None else float(threshold)
        active = set(self.layers if active_layers is None
                     else active_layers)
        capture = self._capture_now(True, prefill=prefill)
        self._serve_batches += 1
        if sync_store:
            self.store.sync()     # generation-counted: no-op unless stale
        view = self.store.snapshot
        if view is None:          # bootstrap: materialize + publish once
            self.store.sync()
            view = self.store.snapshot
        B, S = tokens.shape[0], tokens.shape[1]
        n_valid = int(batch.get("n_valid", B))
        cache_len, cache_tpls = 0, None
        if prefill:
            if not self.mc.prefill.enabled:
                raise RuntimeError(
                    "prefill serving needs PrefillSpec(enabled=True) at "
                    "build time — the store must carry KV-bearing entries")
            if not isinstance(self.store.codec, PrefillCodec):
                raise RuntimeError(
                    "this store's entries carry no KV parts; rebuild (or "
                    "re-save) it with prefill_enabled=True")
            self._check_prefill_supported()
            cache_len = self._prefill_cache_len(S)
            cache_tpls = self._split_caches(
                self.model.init_caches(B, cache_len))
            for li in sorted(set(self.layers) & active):
                cl = bb.cache_len_from(cache_tpls[li])
                if cl < S:
                    raise ValueError(
                        f"layer {li} decode cache holds {cl} slots < "
                        f"prompt length {S} (sliding windows shorter "
                        f"than the prompt cannot replay a stored "
                        f"prefix)")
        t0 = time.perf_counter()
        h = bb.embed_tokens(self.params, tokens, cfg)
        positions = self._positions(B, S)
        len_dev, kpad = None, None
        if lengths is not None:
            lengths = np.asarray(lengths)
            len_dev = self._tensor(lengths, torch.int32)
            kpad = (torch.arange(S, dtype=torch.int32, device=self.device)
                    [None, :] < len_dev[:, None])
        return PreparedBatch(
            tokens=tokens, h=h, positions=positions, kpad=kpad,
            lengths_dev=len_dev, lengths=lengths, n_valid=n_valid, thr=thr,
            active=active, capture=capture, view=view, t0=t0,
            prefill=prefill, cache_len=cache_len, cache_tpls=cache_tpls,
            mixed_form=mixed_form)

    @torch.no_grad()
    def run_layers(self, prep: PreparedBatch) -> PreparedBatch:
        """The device-resident serving loop: every layer is device work
        only — no host synchronization, no host↔device copy (the one
        barrier lives in ``finalize``) but a MoE layer's read of its
        expert offsets. Hit masks, predicted sims and
        matched slots accumulate as device tensors in ``prep.pend``; under
        ``prep.capture`` so do the embeddings and true APMs (and K/V).

        A prefill batch's memoized layers hand back the layer's decode
        cache beside h (hits from the stored K/V, misses from the fresh
        K/V); every other layer runs the backbone's exact prefill step."""
        h = prep.h
        if prep.prefill:
            for li, kind, lp in self._iter_layers():
                if li in prep.active and kind == "attn":
                    h, ck, cv, *rest = self._layer_fused_prefill(
                        lp, h, li, prep.thr, prep.positions,
                        view=prep.view, cache_tpl=prep.cache_tpls[li],
                        kpad=prep.kpad, qlen=prep.lengths_dev,
                        capture=prep.capture, mixed_form=prep.mixed_form)
                    prep.caches_by_li[li] = {"k": ck, "v": cv}
                    prep.pend.append((li, *rest))
                else:
                    h, c = self._layer_plain_prefill(
                        lp, h, kind, li, prep.positions,
                        prep.cache_tpls[li], kpad=prep.kpad)
                    prep.caches_by_li[li] = c
            prep.h = h
            return prep
        for li, kind, lp in self._iter_layers():
            if li in prep.active and kind in ("attn", "mla"):
                h, *rest = self._layer_fused(
                    lp, h, kind, li, prep.thr, prep.positions,
                    view=prep.view, kpad=prep.kpad, qlen=prep.lengths_dev,
                    capture=prep.capture, mixed_form=prep.mixed_form)
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
        ``(outputs, stats, payload)``; a prefill batch's outputs are
        ``(last_logits, caches)``, its head that of ``Model.prefill``."""
        st = stats or MemoStats()
        cfg = self.cfg
        if prep.prefill:
            logits = bb.logits_from_hidden(self.params, prep.h[:, -1:],
                                           cfg)[:, 0]
            out = (logits, self._merge_caches(prep.caches_by_li))
        elif cfg.n_classes:
            out = bb.classify_from_hidden(self.params, prep.h, cfg,
                                          kpad=prep.kpad)
        else:
            out = bb.logits_from_hidden(self.params, prep.h, cfg)
        synchronize(self.device)                           # ONE barrier
        dt = time.perf_counter() - prep.t0
        st.n_inputs += prep.n_valid
        st.t_total += dt
        st.t_attn += dt
        payload = self._drain_stats(prep, st)
        return out, st, payload

    def _layer_fused(self, lp, h, kind, li, thr: float, positions, view,
                     kpad=None, qlen=None, capture: bool = False,
                     mixed_form: bool = False):
        """The serving layer (see the module docstring). Returns
        (h', sims, hits, slots) — plus (embs, apms_f16) under ``capture``
        — all device tensors."""
        cfg = self.cfg
        # an MLA layer takes the bucketed form in kernel mode too, as in
        # the reference: memo_attention serves GQA layers only
        kernel_path = self.mc.mode == "kernel" and kind == "attn"
        varlen = qlen is not None
        e = self.embedder
        x = norm_apply(lp["norm1"], h, cfg.norm)
        emb = embed_apply(e.params, x, e.pool, e.act, lengths=qlen,
                          full_len=self.store.apm_shape[-1])
        idx0, hit, sim, rows = self._search(view, emb, thr,
                                            fused=kernel_path)
        S = x.shape[1]
        # the length gate — ALWAYS on: a hit may only reuse an APM
        # captured at the query's own true length (S when fixed-length)
        hit = hit & (self._entry_lengths(view, idx0)
                     == (qlen if varlen else S))
        if kernel_path:
            qq, kk, vv = attn_mod._qkv(lp["mix"], x, cfg, positions)
            out = self._memo_attention(qq, kk, vv, view.db_parts, idx0, hit,
                                       lengths=qlen, rows=rows)
            y = torch.einsum("bshe,hed->bsd", out, lp["mix"]["wo"])
        else:
            # compressed gather + decode through f16 (host-decode parity)
            if rows is None:
                rows = tuple(p.index_select(0, idx0) for p in view.db_parts)
            apm = self.store.codec.decode_rows(rows).float()
            if apm.shape[-1] != S:
                apm = apm[..., :S, :S]
            branches = self._bucket_branches(lp, kind)
            ops = (x, apm, hit, positions, kpad)
            if mixed_form:
                y = branches[2](*ops)
            else:
                spec = ("bucket", kind, tuple(x.shape), tuple(apm.shape),
                        varlen, view.codec_key)
                (y,) = self._run_quanta(lp, li, spec, branches, ops)
        out = (self._chan_tail(lp, h + y, li), sim, hit, idx0)
        if capture:
            # miss capture for online admission: the TRUE APM of this
            # input, computed exactly like the miss path, staged on the
            # device in the arena dtype beside its embedding
            out = out + (emb, self._apm_probe(lp, x, kind, positions,
                                              kpad=kpad))
        return out

    def _search(self, view, emb, thr, fused: bool = False):
        """The device lookup of a fast-path layer: (slots i32, hits
        before the length gate, predicted sims, the matched codec rows
        or None). A sharded index hands the rows back from its one
        combine (its arenas are indexed by position, not slot); the
        other indexes leave the gather to the caller."""
        index = view.index
        rows = None
        if getattr(index, "is_sharded", False):
            d2, idx, rows = index.search_fetch(emb, args=view.search_args,
                                               parts=view.db_parts)
        else:
            d2, idx = index.search_device(emb, args=view.search_args,
                                          fused=fused)
        dist = torch.sqrt(torch.clamp(d2[:, 0], min=0.0))
        sim = view.sim_a * dist + view.sim_b
        return idx[:, 0].to(torch.int32), sim > thr, sim, rows

    @staticmethod
    def _entry_lengths(view, idx0):
        """Device entry lengths of the matched slots. A sharded combine
        can return slot −1 (an empty winning shard): its length reads as
        −1, so the gate refuses it, as the reference's gather does."""
        if getattr(view.index, "is_sharded", False):
            return torch.where(
                idx0 >= 0, view.lengths.index_select(0, idx0.clamp(min=0)),
                -1)
        return view.lengths.index_select(0, idx0)

    def _memo_attention(self, q, k, v, parts, idx, hit, lengths=None,
                        rows=None):
        """``memo_attention`` over the device DB's codec parts: int8
        codes + f16 row scales (dequantized in the kernel) or f16. A
        factorized codec — or any codec when the matched rows come
        gathered already (``rows``: a sharded store's combine, whose
        arenas are indexed by position) — decodes the B matched rows (not
        the DB) and feeds them as a B-row f16 DB with ``hit_idx =
        arange(B)``: the reference casts the same f16 decode to f32
        first, so the kernel sees the same values."""
        codec = self.store.codec
        kw = dict(causal=self.cfg.causal, window=self.cfg.sliding_window,
                  lengths=lengths)
        hit = hit.to(torch.int32)
        if rows is None and codec.name == "int8":
            return memo_attention(q, k, v, parts[0], idx, hit,
                                  db_scales=parts[1], **kw)
        if rows is None and codec.name == "f16":
            return memo_attention(q, k, v, parts[0], idx, hit, **kw)
        B, S = q.shape[:2]
        if rows is None:
            rows = tuple(p.index_select(0, idx) for p in parts)
        apm = codec.decode_rows(rows)
        if apm.shape[-1] != S:
            apm = apm[..., :S, :S]
        return memo_attention(q, k, v, apm.contiguous(),
                              torch.arange(B, dtype=torch.int32,
                                           device=q.device), hit, **kw)

    def _capture_now(self, use_memo: bool, prefill: bool = False) -> bool:
        """Admission sampling: capture misses on every Nth served batch
        (``admit_every``) when online admission is enabled. With prefill
        memoization on, ONLY prefill batches capture — an APM-only
        admission would store zero K/V and a later prefill hit would
        replay an empty decode cache."""
        if self.mc.prefill.enabled and not prefill:
            return False
        return (use_memo and self.mc.admit and self.store is not None
                and not self.is_encdec
                and self._serve_batches % max(1, self.mc.admit_every) == 0)

    # ------------------------------------------------------ prefill layers
    def _layer_fused_prefill(self, lp, h, li, thr: float, positions, view,
                             cache_tpl, kpad=None, qlen=None,
                             capture: bool = False,
                             mixed_form: bool = False):
        """The memoized-prefill layer: ``_layer_fused``'s lookup (the
        search through ``nn_search``, the threshold and the length gate,
        which a replayed K/V prefix doubly needs) plus the K/V leg. The
        gather decodes the entry's K/V next to its APM; each quantum
        takes its branch (``_prefill_branches``): an all-hit quantum
        skips Q/K, QKᵀ and softmax and takes its decode cache straight
        from the stored K/V, an all-miss quantum runs exact attention and
        caches its fresh K/V, a mixed one does both and picks per row.
        Both are zero-padded to the template's length, as
        ``gqa_prefill_cache`` pads, so a hit's cache and the exact cache
        differ only by the K/V codec's quantization. Returns
        (h', k_cache, v_cache, sims, hits, slots[, embs, apms, kvs])."""
        cfg = self.cfg
        varlen = qlen is not None
        Sc = bb.cache_len_from(cache_tpl)
        cdt = cache_tpl["k"].dtype
        codec = self.store.codec
        e = self.embedder
        x = norm_apply(lp["norm1"], h, cfg.norm)
        emb = embed_apply(e.params, x, e.pool, e.act, lengths=qlen,
                          full_len=self.store.apm_shape[-1])
        idx0, hit, sim, rows = self._search(view, emb, thr)
        S = x.shape[1]
        hit = hit & (self._entry_lengths(view, idx0)
                     == (qlen if varlen else S))
        if rows is None:        # a sharded store's rows ride its combine
            rows = tuple(p.index_select(0, idx0) for p in view.db_parts)
        apm = codec.decode_rows(rows).float()
        if apm.shape[-1] != S:
            apm = apm[..., :S, :S]
        kv = codec.decode_kv_rows(rows).float()
        mk, mv = unstack_kv_rows(kv[:, :, :S], cfg.n_kv_heads, cfg.head_dim)
        branches = self._prefill_branches(lp)
        ops = (x, apm, mk, mv, hit, positions, kpad)
        if mixed_form:
            y, k_new, v_new = branches[2](*ops)
        else:
            spec = ("prefill", tuple(x.shape), tuple(apm.shape), varlen,
                    Sc, cdt, view.codec_key)
            y, k_new, v_new = self._run_quanta(lp, li, spec, branches, ops)
        pad = (0, 0, 0, 0, 0, Sc - S)
        ck = F.pad(k_new, pad).to(cdt)
        cv = F.pad(v_new, pad).to(cdt)
        out = (self._chan_tail(lp, h + y, li), ck, cv, sim, hit, idx0)
        if capture:
            # miss capture: the true APM and K/V, computed exactly like
            # the miss path (an admitted entry replays bit for bit)
            k, v = self._true_kv(lp, x, positions, kpad)
            out = out + (emb, self._apm_probe(lp, x, "attn", positions,
                                              kpad=kpad),
                         stack_kv(k, v).half())
        return out

    # --------------------------------------------------- the device branch
    def _run_quanta(self, lp, li, spec, branches, ops):
        """The reference's ``bucketed`` over ``nq`` quanta: sort the rows
        hit-first (stable, as ``jnp.argsort``), run each quantum's branch
        (``core/cond.py``: a Python ``if`` on the CPU, conditional graph
        nodes on the card) and unsort. ``ops`` ends with
        ``(hit, positions, kpad)``."""
        hit = ops[-3]
        nq = n_quanta(self.mc.device_quanta, hit.shape[0])
        order = None
        if nq > 1:
            order = torch.argsort(~hit, stable=True)
            ops = tuple(None if o is None else o.index_select(0, order)
                        for o in ops)
        key = (site_key((li, spec[0]), (nq,) + spec[1:],
                        list(lp["mix"].values()))
               if hit.device.type == "cuda" else None)
        outs = run_quanta(ops[-3], nq, branches, ops, cache=self.graphs,
                          key=key)
        if order is not None:
            inv = torch.argsort(order)
            outs = tuple(o.index_select(0, inv) for o in outs)
        return outs

    def _bucket_branches(self, lp, kind):
        """(all_hit, all_miss, mixed) of a bucketed layer, over
        (x, apm, hit, positions, kpad): the reference's ``bucketed``."""
        def all_hit(xs, apm, hit, pos, kp):
            return self._memo_only(lp, xs, kind, apm)

        def all_miss(xs, apm, hit, pos, kp):
            return self._attend(lp, xs, kind, pos, kpad=kp)[0]

        def mixed(xs, apm, hit, pos, kp):
            return self._attend(lp, xs, kind, pos, kpad=kp,
                                memo=attn_mod.Memo(apm=apm, hit=hit))[0]
        return all_hit, all_miss, mixed

    def _prefill_branches(self, lp):
        """(all_hit, all_miss, mixed) of a memoized-prefill layer, over
        (x, apm, mk, mv, hit, positions, kpad), each returning
        (y, k, v): the stored K/V, the exact K/V, or per row."""
        def all_hit(xs, apm, mk, mv, hit, pos, kp):
            return self._memo_only(lp, xs, "attn", apm), mk, mv

        def all_miss(xs, apm, mk, mv, hit, pos, kp):
            y = self._attend(lp, xs, "attn", pos, kpad=kp)[0]
            return (y,) + self._true_kv(lp, xs, pos, kp)

        def mixed(xs, apm, mk, mv, hit, pos, kp):
            y = self._attend(lp, xs, "attn", pos, kpad=kp,
                             memo=attn_mod.Memo(apm=apm, hit=hit))[0]
            k, v = self._true_kv(lp, xs, pos, kp)
            m = hit[:, None, None, None]
            return y, torch.where(m, mk, k), torch.where(m, mv, v)
        return all_hit, all_miss, mixed

    def _true_kv(self, lp, x, positions, kpad=None):
        """Exact post-RoPE K/V of a batch in f32, padded rows zeroed (the
        stored-K/V convention: zeros past the true length)."""
        _, k, v = attn_mod._qkv(lp["mix"], x, self.cfg, positions)
        if kpad is not None:
            m = kpad[:, :, None, None].to(k.dtype)
            k, v = k * m, v * m
        return k.float(), v.float()

    def _layer_plain_prefill(self, lp, h, kind, li, positions, cache,
                             kpad=None):
        """Non-memoized layers of a prefill batch: the backbone's exact
        prefill step (attention and its cache, or a recurrent state)."""
        out, c, _, _ = bb._layer_apply(lp, h, self.cfg, kind, li,
                                       mode="prefill", positions=positions,
                                       cache=cache, kpad=kpad)
        return out, c

    # ------------------------------------------------------- prefill API
    @torch.no_grad()
    def prefill(self, batch, *, threshold: Optional[float] = None,
                active_layers: Optional[Sequence[int]] = None,
                stats: Optional[MemoStats] = None):
        """Memoized causal prefill. Returns (last-token logits (B, V),
        decode caches, stats): a hit skips the layer's attention and
        takes that layer's decode cache from the stored K/V entry; a miss
        runs exact prefill and (under admission sampling) captures APM +
        K/V. Decode goes on with ``self.model.decode_step``."""
        st = stats or MemoStats()
        prep = self.prepare_batch(batch, threshold=threshold,
                                  active_layers=active_layers,
                                  prefill=True)
        self.run_layers(prep)
        (logits, caches), st, payload = self.finalize(prep, stats=st)
        self.apply_maintenance(payload, stats=st)
        return logits, caches, st

    @torch.no_grad()
    def prefill_exact(self, batch, *, cache_len: Optional[int] = None):
        """Exact (memo-free) prefill — ``Model.prefill``: the leg
        ``MemoServer`` falls back to, and the parity reference. Returns
        (logits (B, V), caches)."""
        tokens = self._tensor(batch["tokens"])
        Sc = (int(cache_len) if cache_len
              else self._prefill_cache_len(int(tokens.shape[1])))
        return self.model.prefill(self.params, {"tokens": tokens},
                                  cache_len=Sc)

    # --------------------------------------------------- prefill support
    def _check_prefill_supported(self):
        """Prefill memoization's preconditions. The causal requirement IS
        the mask-kind gate: every stored entry was captured under the
        causal prefill mask and may only be replayed under it."""
        if self.is_encdec:
            raise ValueError(
                "prefill memoization needs a decoder-only model (enc-dec "
                "hands no decode cache back from its encoder)")
        if not self.cfg.causal:
            raise ValueError(
                "prefill memoization requires a causal model: stored "
                "entries are causal-prefill states and may only be "
                "replayed under the same mask kind")
        bad = sorted(li for li, kind, _ in self._iter_layers()
                     if li in self.layers and kind != "attn")
        if bad:
            raise ValueError(
                f"prefill memoization serves GQA 'attn' layers only "
                f"(MLA caches latents, not K/V); memoized layers {bad} "
                f"are a different mixer kind")

    def _prefill_cache_len(self, S: int) -> int:
        """Decode-cache length for a prompt of length ``S``:
        ``prefill_cache_len`` if set, else 2·S headroom."""
        cl = self.mc.prefill.cache_len
        Sc = int(cl) if cl else 2 * S
        if Sc < S:
            raise ValueError(
                f"prefill_cache_len={Sc} is shorter than the prompt "
                f"({S}): the decode cache must hold the whole prefix")
        return Sc

    def _kv_probe(self, lp, x):
        """Post-RoPE K/V of one captured block, stacked into the stored
        (B, 2, S, D) f16 plane. Positions run from 0 (prefill is
        absolute), so the stored K drops into a decode cache as is."""
        k, v = self._true_kv(lp, x, self._positions(x.shape[0], x.shape[1]))
        return stack_kv(k, v).half()

    def _split_caches(self, caches) -> dict:
        """A ``model.init_caches`` tree → {layer_idx: cache}. A scan
        segment's leading repeats axis is sliced off here and restacked
        by ``_merge_caches``."""
        out = {}
        for si, seg in enumerate(bb.scan_plan(self.cfg)):
            grp = caches[f"seg{si}"]
            n = len(seg.unit)
            for r in range(seg.reps):
                rep = grp if seg.kind == "single" else bb._tree_index(grp, r)
                for u in range(n):
                    out[seg.start + r * n + u] = rep[f"l{u}"]
        return out

    def _merge_caches(self, by_li: dict):
        """Inverse of ``_split_caches``: {layer_idx: cache} → the segment
        tree ``model.decode_step`` consumes."""
        caches = {}
        for si, seg in enumerate(bb.scan_plan(self.cfg)):
            n = len(seg.unit)
            groups = [{f"l{u}": by_li[seg.start + r * n + u]
                       for u in range(n)} for r in range(seg.reps)]
            caches[f"seg{si}"] = (groups[0] if seg.kind == "single"
                                  else bb._tree_stack(groups))
        return caches

    def _drain_stats(self, prep: PreparedBatch,
                     st: MemoStats) -> MaintenancePayload:
        """Materialize the per-layer device counters after the trailing
        barrier in stacked transfers: sims+hits as one f32 block, slots
        as one i32 block, and under capture the embeddings, the f16 APMs
        and (prefill) the f16 K/V planes. Rows past ``n_valid`` are
        dropped. Returns the payload without touching the store."""
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
        if prep.capture and len(pend[0]) > 4:
            embs = torch.stack([p[4] for p in pend]).cpu().numpy()[:, :nv]
            apms = torch.stack([p[5] for p in pend]).cpu().numpy()[:, :nv]
            # prefill capture stages the K/V plane at pend[6]
            kvs = (torch.stack([p[6] for p in pend]).cpu().numpy()[:, :nv]
                   if len(pend[0]) > 6 else None)
            lens = None if prep.lengths is None else prep.lengths[:nv]
            for l in range(embs.shape[0]):
                miss = ~hits[l]
                if miss.any():
                    out.admissions.append(self._stage_capture(
                        apms[l][miss], embs[l][miss],
                        None if lens is None else lens[miss],
                        None if kvs is None else kvs[l][miss]))
        return out

    def _stage_capture(self, apms, embs, lens, kv=None):
        """Normalize one captured miss block for admission: pad the APMs
        (and the K/V plane, under prefill capture) to the arena
        (calibration) length and zero the pad-query rows, so a stored
        entry is the same whichever bucket captured it; only its true
        length matters (the length gate replays it only there)."""
        S_max = self.store.apm_shape[-1]
        B, H, S = apms.shape[:3]
        lens = (np.full(B, S, np.int32) if lens is None
                else np.asarray(lens).astype(np.int32, copy=False))
        if S < S_max:
            padded = np.zeros((B, H, S_max, S_max), apms.dtype)
            padded[:, :, :S, :S] = apms
            apms = padded
            if kv is not None:
                pk = np.zeros(kv.shape[:2] + (S_max, kv.shape[-1]),
                              kv.dtype)
                pk[:, :, :S] = kv
                kv = pk
        if (lens < S_max).any():
            row_ok = np.arange(S_max)[None, :] < lens[:, None]
            apms = apms * row_ok[:, None, :, None].astype(apms.dtype)
            if kv is not None:
                kv = kv * row_ok[:, None, :, None].astype(kv.dtype)
        return apms, embs, lens, kv

    def apply_maintenance(self, payload: Optional[MaintenancePayload],
                          stats: Optional[MemoStats] = None) -> None:
        """Run one batch's host-tier store work: reuse-clock feeding,
        budgeted admission + eviction, the generation-counted delta sync
        and periodic recalibration. Payload fields are consumed as they
        land, so a retry cannot double-count or double-admit."""
        if payload is None or self.store is None:
            return
        st = stats or MemoStats()
        if payload.reuse_slots is not None and payload.reuse_slots.size:
            slots, payload.reuse_slots = payload.reuse_slots, None
            self.store.note_reuse(slots)
        if payload.admissions:
            adds, payload.admissions = payload.admissions, []
            self._pending_admissions.extend(adds)
        self._flush_admissions(st)
        if self.store.device_stale:
            self.store.sync()

    def _flush_admissions(self, st: MemoStats):
        """Batch-boundary admission: promote the captured misses the disk
        tier can satisfy, push the rest into the host tier under the byte
        budget, then delta-sync the device tier."""
        if not self._pending_admissions:
            return
        pend, self._pending_admissions = self._pending_admissions, []
        apms = np.concatenate([p[0] for p in pend], 0)
        embs = np.concatenate([p[1] for p in pend], 0)
        lens = np.concatenate([p[2] for p in pend], 0)
        # K/V planes ride along iff every staged block carries one (APM-
        # only and prefill captures never mix: _capture_now gates them)
        kv = (np.concatenate([p[3] for p in pend], 0)
              if all(p[3] is not None for p in pend) else None)
        cspec = self.mc.capacity
        if (apms.shape[0] and cspec.promote
                and self.store.capacity is not None):
            # misses the disk tier can satisfy are re-admitted
            # bit-identically from their durable copies instead of
            # re-encoded from the fresh capture; the promoted rows ride
            # the same delta sync as the admissions
            promoted = self.store.promote_for(
                embs, lens, threshold=float(self.mc.threshold),
                max_promote=int(cspec.promote_max))
            if promoted.any():
                keep = ~promoted
                apms, embs, lens = apms[keep], embs[keep], lens[keep]
                kv = kv[keep] if kv is not None else None
        if apms.shape[0]:
            slots = self.store.admit(apms, embs, lens, kv=kv)
            st.add_admitted(int(slots.size))
            self.store.sync()
            self._flush_count += 1
            if self.mc.recal_every:
                self._recal_buf.append((apms, embs))
                self._recal_buf = self._recal_buf[-16:]   # rolling window
                if self._flush_count % self.mc.recal_every == 0:
                    self._recalibrate_online()
                    # re-publish so the next batch serves the new sim_cal
                    self.store.publish()

    def _recalibrate_online(self, n_pairs: int = 192, blend: float = 0.5):
        """Refit sim ≈ a·dist + b from recently captured misses (each
        carries its embedding and its true APM, the data build-time
        ``_calibrate`` uses), blended with the old fit (EMA)."""
        apms = np.concatenate([a for a, _ in self._recal_buf], 0)
        embs = np.concatenate([e for _, e in self._recal_buf], 0)
        n = apms.shape[0]
        if n < 8:
            return
        rng = np.random.default_rng(self._serve_batches)
        ia, ib = rng.integers(0, n, n_pairs), rng.integers(0, n, n_pairs)
        dist = np.linalg.norm(embs[ia] - embs[ib], axis=-1)
        if np.std(dist) < 1e-9:
            return
        sim = similarity_score(self._tensor(apms[ia]).float(),
                               self._tensor(apms[ib]).float()).cpu().numpy()
        a, b = np.polyfit(dist, sim, 1)
        a0, b0 = self.sim_cal
        self.sim_cal = (blend * float(a) + (1 - blend) * a0,
                        blend * float(b) + (1 - blend) * b0)

    # ------------------------------------------------ encoder-decoder
    def _infer_encdec(self, batch, thr, active, st: MemoStats, use_memo):
        """Whisper path: the memoized encoder on the host-synchronous path
        (``_lookup`` per layer; a hit replays the stored APM through the
        select form), then the plain decoder. Returns (logits, stats)."""
        cfg, params = self.cfg, self.params
        frames = self._tensor(batch["frames"])
        tokens = self._tensor(batch["tokens"])
        st.n_inputs += frames.shape[0]
        h = ed.enc_embed(params, frames)
        positions = self._positions(h.shape[0], h.shape[1])
        memoize = use_memo and self.db is not None
        t_loop = time.perf_counter()
        for li in range(cfg.encoder.n_layers):
            lp = bb._tree_index(params["enc_layers"], li)
            memo = None
            if memoize and li in active:
                memo = self._lookup(lp, h, "attn", thr, st, li)
            t0 = time.perf_counter()
            h, _ = ed.enc_layer_apply(lp, h, cfg, self.model._ecfg,
                                      positions,
                                      memo=self._device_memo(memo))
            if memoize:                   # per-layer time on the host path
                synchronize(self.device)
                st.t_attn += time.perf_counter() - t0
        enc_h = norm_apply(params["enc_norm"], h, cfg.norm)
        hd, _ = ed.decode_tokens(params, tokens, enc_h, cfg, mode="full")
        hd = norm_apply(params["final_norm"], hd, cfg.norm)
        logits = hd @ params["embed"].T
        if not memoize:
            synchronize(self.device)
            st.t_attn += time.perf_counter() - t_loop
        return logits, st

    # ----------------------------------------- host-synchronous lookup
    def _lookup(self, lp, h, kind, thr, st: MemoStats, li, positions=None,
                capture: bool = False, lengths=None, kpad=None,
                n_valid: Optional[int] = None) -> attn_mod.Memo:
        """Embed on the device, search the host index, apply the
        threshold and the length gate on the host, gather the APM batch
        from the host arena. Returns a ``Memo`` of HOST arrays (the f16
        APM batch, hits, slots); each layer form copies what it needs."""
        cfg = self.cfg
        S = h.shape[1]
        nv = h.shape[0] if n_valid is None else n_valid
        t0 = time.perf_counter()
        x = norm_apply(lp["norm1"], h, cfg.norm)
        emb = self._embed(x, lengths=None if lengths is None
                          else self._tensor(lengths, torch.int32))
        synchronize(self.device)
        t1 = time.perf_counter()
        emb_np = emb.cpu().numpy()
        dist, idx = self.store.lookup(emb_np, 1)
        sim_est = self.predict_sim(dist[:, 0])
        hit = sim_est > thr
        # length gate (host leg), ALWAYS on — a fixed-length batch's true
        # length is S
        ent = self.store.entry_lengths(idx[:, 0])
        hit = hit & (ent == (lengths if lengths is not None else S))
        t2 = time.perf_counter()
        apm = self.db.get(idx[:, 0])                     # host arena gather
        if apm.shape[-1] != S:
            apm = apm[:, :, :S, :S]      # arena rows sliced to the bucket
        t3 = time.perf_counter()
        st.t_embed += t1 - t0
        st.t_search += t2 - t1
        st.t_fetch += t3 - t2
        st.n_layer_attempts += nv
        nh = int(hit[:nv].sum())
        st.n_hits += nh
        st.per_layer_hits[li] = st.per_layer_hits.get(li, 0) + nh
        st.sims.extend(sim_est[:nv].tolist())
        if capture and positions is not None and (~hit[:nv]).any():
            apm_true = self._apm_probe(lp, x, kind, positions,
                                       kpad=kpad).cpu().numpy()
            miss = ~hit[:nv]
            self._pending_admissions.append(self._stage_capture(
                apm_true[:nv][miss], emb_np[:nv][miss],
                None if lengths is None else lengths[:nv][miss]))
        return attn_mod.Memo(apm=apm, hit=hit, idx=idx[:, 0])

    def _device_memo(self, memo: Optional[attn_mod.Memo]):
        """A host ``Memo`` on the device for the select layer: the f16
        APM batch is copied once (``_sdpa`` casts it there)."""
        if memo is None:
            return None
        return attn_mod.Memo(apm=self._tensor(memo.apm),
                             hit=self._tensor(memo.hit))

    def _apm_probe(self, lp, x, kind, positions, kpad=None):
        """The true APM of the normed input with the exact miss-path
        semantics, in the arena dtype (f16): the capture of admission."""
        return self._attend(lp, x, kind, positions, kpad=kpad,
                            return_apm=True)[1].half()

    # -- layer application --------------------------------------------------
    def _chan_tail(self, lp, h, li):
        """norm2 + channel mixer (MoE or MLP) tail shared by every layer
        form (the reference's ``_chan_only`` too). A MoE layer reads its
        expert offsets on the host: one sync a layer (``moe_apply``)."""
        cfg = self.cfg
        x = norm_apply(lp["norm2"], h, cfg.norm)
        if bb._chan_kind(cfg, li) == "moe":
            return h + moe_apply(lp["chan"], x, cfg)[0]
        return h + mlp_apply(lp["chan"], x, cfg.act, cfg.glu)

    def _layer_plain(self, lp, h, kind, li, memo, positions, kpad=None):
        out, _, _, _ = bb._layer_apply(lp, h, self.cfg, kind, li,
                                       mode="full", positions=positions,
                                       memo=memo, kpad=kpad)
        return out

    def _layer_bucket(self, lp, h, kind, li, memo, positions):
        """Split rows into hit and miss buckets: hits run the memo-only
        attention (no Q/K projection, QKᵀ or softmax), misses run
        normally; only the hit rows' APMs are copied to the device.
        Buckets are exact-size: the reference pads them to powers of two
        of ``bucket_quantum`` to bound its compiled shapes, which eager
        PyTorch does not have. Fixed-length only."""
        cfg = self.cfg
        hit = np.asarray(memo.hit)
        hit_idx = np.nonzero(hit)[0]
        miss_idx = np.nonzero(~hit)[0]
        if hit_idx.size == 0:
            return self._layer_plain(lp, h, kind, li, None, positions)
        x = norm_apply(lp["norm1"], h, cfg.norm)
        y = torch.empty_like(h)
        sel_h = self._tensor(hit_idx)
        # ship only the hit APMs, in the arena dtype (f16); cast there
        apm_hit = self._tensor(memo.apm[hit_idx]).float()
        y.index_copy_(0, sel_h, self._memo_only(
            lp, x.index_select(0, sel_h), kind, apm_hit))
        if miss_idx.size:
            sel_m = self._tensor(miss_idx)
            y.index_copy_(0, sel_m, self._attn_only(
                lp, x.index_select(0, sel_m), kind,
                positions.index_select(0, sel_m)))
        return self._chan_tail(lp, h + y, li)

    def _layer_kernel(self, lp, h, li, memo, positions, lengths=None):
        """The host-synchronous kernel-mode layer: ``memo_attention`` over
        the device DB by the host lookup's slots and hits; ``lengths``
        (host, (B,)) masks padded keys per sequence. A sharded store's
        arenas are indexed by position, not slot: its rows come from the
        host arena by slot instead."""
        cfg = self.cfg
        self.store.sync()        # generation-counted: no-op unless stale
        x = norm_apply(lp["norm1"], h, cfg.norm)
        q, k, v = attn_mod._qkv(lp["mix"], x, cfg, positions)
        rows = None
        if getattr(self.device_index, "is_sharded", False):
            rows = tuple(self._tensor(p) for p in self.db.parts_at(
                np.asarray(memo.idx).reshape(-1)))
        out = self._memo_attention(
            q, k, v, self.device_db.parts,
            self._tensor(memo.idx, torch.int32), self._tensor(memo.hit),
            lengths=None if lengths is None
            else self._tensor(lengths, torch.int32), rows=rows)
        y = torch.einsum("bshe,hed->bsd", out, lp["mix"]["wo"])
        return self._chan_tail(lp, h + y, li)

    def _attend(self, lp, x, kind, positions, *, kpad=None, memo=None,
                return_apm=False):
        """``gqa_apply`` or ``mla_apply`` (by the layer's ``kind``) with
        the model's mask kind and window: every full attention the engine
        runs beside the memoized forms. Returns (y, apm or None)."""
        cfg = self.cfg
        f = attn_mod.gqa_apply if kind == "attn" else attn_mod.mla_apply
        return f(lp["mix"], x, cfg, positions=positions,
                 mask_kind="causal" if cfg.causal else "bidir",
                 window=cfg.sliding_window, kpad=kpad, memo=memo,
                 return_apm=return_apm)

    def _memo_only(self, lp, x, kind, apm):
        """Memo-only attention (V and APM·V): the hit branch's cost."""
        f = (attn_mod.gqa_apply_memo if kind == "attn"
             else attn_mod.mla_apply_memo)
        return f(lp["mix"], x, self.cfg, apm)

    def _attn_only(self, lp, x, kind, positions):
        """Full attention with projections: the miss branch's cost."""
        return self._attend(lp, x, kind, positions)[0]

    # ------------------------------------------------------------- selective
    def _fused_lookup_probe(self, x):
        """The memo overhead the fast path pays, minus the attention both
        branches share: embed → device search (``nn_search``) →
        compressed gather → decode. Returns (sims, f32 APM rows)."""
        store, e = self.store, self.embedder
        emb = embed_apply(e.params, x, e.pool, e.act)
        di = store.device_index
        if getattr(di, "is_sharded", False):   # rows ride the combine
            d2, _, rows = di.search_fetch(emb, args=di.search_args,
                                          parts=store.device_db.parts)
        else:
            d2, idx = di.search_device(emb, args=di.search_args)
            idx0 = idx[:, 0].to(torch.int32)
            rows = tuple(p.index_select(0, idx0)
                         for p in store.device_db.parts)
        a, b = self.sim_cal
        dist = torch.sqrt(torch.clamp(d2[:, 0], min=0.0))
        return a * dist + b, store.codec.decode_rows(rows).float()

    @torch.no_grad()
    def profile(self, batch, *, alpha_from: Optional[MemoStats] = None
                ) -> PerfModel:
        """Offline profiler (paper §5.4): per-layer attention time and
        memo overhead on a calibration batch; α from ``alpha_from`` or a
        dry ``infer``. The overhead is measured on the path that will
        serve: the device lookup when the fast path is active, the host
        chain otherwise."""
        cfg = self.cfg
        fast = self._use_fast_path()
        if fast:
            self.store.sync()      # materialize the tier the probe times
        tokens = self._tensor(batch["tokens"])
        h = bb.embed_tokens(self.params, tokens, cfg)
        positions = self._positions(tokens.shape[0], tokens.shape[1])
        if alpha_from is None:
            st = MemoStats()
            self.infer(batch, stats=st)
            alpha_from = st
        dev = self.device
        profiles = {}
        for li, kind, lp in self._iter_layers():
            if li not in self.layers:
                h = self._layer_plain(lp, h, kind, li, None, positions)
                continue
            t_attn = timeit_median(
                lambda lp=lp, h=h, k=kind: self._attn_only(lp, h, k,
                                                           positions),
                reps=3, device=dev)
            if fast:
                t_over = timeit_median(
                    lambda h=h: self._fused_lookup_probe(h), reps=3,
                    device=dev)
            else:
                t_over = timeit_median(lambda h=h: self._embed(h), reps=3,
                                       device=dev)
                emb = self._embed(h).cpu().numpy()
                t0 = time.perf_counter()
                dist, idx = self.index.search(emb, 1)
                self.db.get(idx[:, 0], count_reuse=False)
                t_over += time.perf_counter() - t0
            alpha = (alpha_from.per_layer_hits.get(li, 0)
                     / max(1, alpha_from.n_inputs))
            profiles[li] = LayerProfile(t_attn=t_attn, t_overhead=t_over,
                                        alpha=min(1.0, alpha))
            h = self._layer_plain(lp, h, kind, li, None, positions)
        self.perf = PerfModel(profiles)
        return self.perf
