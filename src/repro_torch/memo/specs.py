"""Composable memoization specs — the reference's ``memo/specs.py``.

``MemoSpec`` composes small policy objects, each validated at
construction: ``EmbedSpec``, ``IndexSpec``, ``CodecSpec``,
``AdmissionPolicy``, ``EvictionPolicy``, ``RuntimeSpec``,
``CapacitySpec``, ``ShardSpec`` and ``PrefillSpec``. The old flat field
names stay available as write-through, re-validating properties
(``spec.threshold`` ↔ ``spec.runtime.threshold``), and
``MemoSpec.flat(**kwargs)`` builds a spec from them. ``to_dict`` /
``from_dict`` use the reference's layout, so a reference spec crosses
over as ``MemoSpec.from_dict(ref_spec.to_dict())`` (fields this package
has no use for are dropped).

``MemoConfig`` is the reference's deprecated flat-kwargs shim. Not
carried over: the fields that select JAX implementations
(``RuntimeSpec.interpret``, ``RuntimeSpec.kernel_impl`` — a kernel
wrapper here picks its path from the tensor's device). String-keyed
fields validate against this package's registries. ``IndexSpec``, ``CapacitySpec`` and
``PrefillSpec`` and ``ShardSpec`` have every field of the reference's.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import asdict, dataclass, field, fields, replace
from typing import Dict, Optional, Tuple


def _registries():
    from repro_torch.core import registry
    return registry

__all__ = [
    "EmbedSpec", "IndexSpec", "CodecSpec", "AdmissionPolicy",
    "EvictionPolicy", "RuntimeSpec", "CapacitySpec", "ShardSpec",
    "PrefillSpec", "MemoSpec", "MemoConfig", "FLAT_FIELDS",
]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclass
class EmbedSpec:
    """The hidden-state embedding model (paper §5.2)."""
    dim: int = 128            # embedding width (the index vector size)
    pool: int = 8             # token-pool stride before the MLP
    act: str = "linear"       # linear | tanh
    steps: int = 300          # Siamese training steps at build()

    def __post_init__(self):
        _require(int(self.dim) >= 1, f"embed dim must be >= 1: {self.dim}")
        _require(int(self.pool) >= 1,
                 f"embed pool must be >= 1: {self.pool}")
        _require(self.act in ("linear", "tanh"),
                 f"embed act must be 'linear' or 'tanh': {self.act!r}")
        _require(int(self.steps) >= 0,
                 f"embed steps must be >= 0: {self.steps}")


@dataclass
class IndexSpec:
    """Index layouts for both tiers, resolved via the index registries."""
    host: str = "exact"       # calibration/lookup tier (registry: host)
    device: str = "auto"      # serving tier: auto | flat | clustered | …
    cluster_crossover: int = 4096   # auto: clustered when n >= this
    nprobe: int = 16
    n_clusters: Optional[int] = None   # clustered: None = sqrt(N)

    def __post_init__(self):
        reg = _registries()
        if self.host not in reg.HOST_INDEXES:
            raise ValueError(
                f"unknown host index {self.host!r}; registered: "
                f"{list(reg.HOST_INDEXES.choices())}")
        if self.device != "auto" and self.device not in reg.DEVICE_INDEXES:
            raise ValueError(
                f"unknown device index {self.device!r}; registered: "
                f"{['auto'] + list(reg.DEVICE_INDEXES.choices())}")
        _require(int(self.cluster_crossover) >= 1,
                 f"cluster_crossover must be >= 1: {self.cluster_crossover}")
        _require(int(self.nprobe) >= 1,
                 f"nprobe must be >= 1: {self.nprobe}")
        _require(self.n_clusters is None or int(self.n_clusters) >= 1,
                 f"n_clusters must be None or >= 1: {self.n_clusters}")


@dataclass
class CodecSpec:
    """APM storage format for BOTH memo tiers (DESIGN.md §2.6)."""
    name: str = "int8"        # registry: codec (f16 | int8 | lowrank | …)
    rank: Optional[int] = None     # lowrank rank (None = L//8)

    def __post_init__(self):
        reg = _registries()
        if self.name not in reg.CODECS:
            raise ValueError(
                f"unknown APM codec {self.name!r}; registered: "
                f"{list(reg.CODECS.choices())}")
        _require(self.rank is None or int(self.rank) >= 1,
                 f"codec rank must be None or >= 1: {self.rank}")


@dataclass
class AdmissionPolicy:
    """Online miss capture → admission under a byte budget (§2.5)."""
    enabled: bool = False
    budget_mb: Optional[float] = None   # store byte budget (None = ∞)
    every: int = 1                      # capture every Nth served batch
    recal_every: Optional[int] = None   # refit sim_cal every N flushes

    def __post_init__(self):
        _require(int(self.every) >= 1,
                 f"admission every must be >= 1: {self.every}")
        _require(self.budget_mb is None or float(self.budget_mb) > 0,
                 f"budget_mb must be None or > 0: {self.budget_mb}")
        _require(self.recal_every is None or int(self.recal_every) >= 1,
                 f"recal_every must be None or >= 1: {self.recal_every}")


@dataclass
class EvictionPolicy:
    """Which entries go when the budget binds (registry: eviction)."""
    kind: str = "clock"       # clock | coldest | …

    def __post_init__(self):
        reg = _registries()
        if self.kind not in reg.EVICTIONS:
            raise ValueError(
                f"unknown eviction policy {self.kind!r}; registered: "
                f"{list(reg.EVICTIONS.choices())}")


@dataclass
class RuntimeSpec:
    """Serving execution: threshold, mode, fast path, sync slack."""
    threshold: float = 0.97
    mode: str = "select"            # select | bucket | kernel
    store: str = "device"           # serving store: device | host
    device_fast_path: Optional[bool] = None   # None → auto by mode/store
    device_quanta: int = 1          # fused-path bucket granularity: rows
    #                                 sorted hit-first into this many
    #                                 quanta, each all-hit/all-miss/mixed
    bucket_quantum: int = 4         # host-path hit-bucket padding quantum
    #                                 (the port's buckets are exact-size)
    max_layers: Optional[int] = None
    device_slack: float = 1.0       # device-arena slack for delta sync
    # fault injection (DESIGN.md §2.9): None = production (no injector is
    # ever constructed — zero cost); {} = injector enabled for post-build
    # arm(); {"store.sync_fail": {"p": 0.5}, ...} arms points up front
    faults: Optional[Dict[str, Dict]] = None

    def __post_init__(self):
        _require(math.isfinite(float(self.threshold)),
                 f"threshold must be finite: {self.threshold}")
        _require(self.mode in ("select", "bucket", "kernel"),
                 f"mode must be select|bucket|kernel: {self.mode!r}")
        _require(self.store in ("device", "host"),
                 f"store must be device|host: {self.store!r}")
        _require(int(self.device_quanta) >= 1,
                 f"device_quanta must be >= 1: {self.device_quanta}")
        _require(int(self.bucket_quantum) >= 1,
                 f"bucket_quantum must be >= 1: {self.bucket_quantum}")
        _require(self.max_layers is None or int(self.max_layers) >= 1,
                 f"max_layers must be None or >= 1: {self.max_layers}")
        _require(float(self.device_slack) >= 0,
                 f"device_slack must be >= 0: {self.device_slack}")
        if self.faults is not None:
            from repro_torch.core.faults import FAULT_POINTS
            _require(isinstance(self.faults, dict),
                     f"faults must be None or a dict: {self.faults!r}")
            for point in self.faults:
                _require(point in FAULT_POINTS,
                         f"unknown fault point {point!r}; registered: "
                         f"{sorted(FAULT_POINTS)}")


@dataclass
class CapacitySpec:
    """The big-memory capacity tier (DESIGN.md §2.11): an mmap-backed,
    crash-consistent third storage tier under the host arena
    (``core/capacity.py``). ``dir`` is the opt-in — ``None`` (the
    default) attaches no disk tier and every other field is inert."""
    dir: Optional[str] = None       # tier directory (None = no disk tier)
    budget_mb: Optional[float] = None   # disk byte budget (None = ∞)
    promote: bool = True            # serve misses from disk when similar
    promote_max: int = 64           # promotions per maintenance flush
    checkpoint_every: int = 8       # WAL→manifest every N applied payloads
    stall_s: float = 5.0            # disk-op watchdog → DISK_DEGRADED
    fsync: bool = True              # fsync WAL frames + checkpoints (off:
    #                                 survive crashes, not power loss)
    # re-compaction: past this retired fraction of the arenas the
    # maintenance actor rewrites them dense. None = never compact.
    compact_ratio: Optional[float] = None

    def __post_init__(self):
        _require(self.budget_mb is None or float(self.budget_mb) > 0,
                 f"capacity budget_mb must be None or > 0: {self.budget_mb}")
        _require(int(self.promote_max) >= 1,
                 f"capacity promote_max must be >= 1: {self.promote_max}")
        _require(int(self.checkpoint_every) >= 1,
                 f"capacity checkpoint_every must be >= 1: "
                 f"{self.checkpoint_every}")
        _require(float(self.stall_s) > 0,
                 f"capacity stall_s must be > 0: {self.stall_s}")
        _require(self.compact_ratio is None
                 or 0 < float(self.compact_ratio) <= 1,
                 f"capacity compact_ratio must be None or in (0, 1]: "
                 f"{self.compact_ratio}")


@dataclass
class ShardSpec:
    """The sharded device tier (DESIGN.md §2.12): partition the memo
    store's device arenas + index rows over an ordered list of devices
    (``core/shard.py``'s ``StoreMesh``), routed by nearest centroid.
    ``shards=0`` (the default) keeps the single-device store and every
    other field inert; ``shards=N`` requests N shards over the local
    devices (clamped to ``torch.cuda.device_count()``, 1 on the CPU)."""
    shards: int = 0                 # 0 = single-device store (no mesh)
    axis: str = "store"             # the store mesh's axis name
    hot: int = 32                   # replicated hot-set size (rows)
    route_nprobe: Optional[int] = None  # centroids probed per query
    #                                     (None = IndexSpec.nprobe)
    # drift repair between full syncs: when a delta sync has spilled
    # this many rows off their routed shard since the last centroid
    # (re)fit, the centroids are refit from the resident embeddings
    # (rows do not move). 0 = wait for the next full sync.
    refresh_spills: int = 0

    def __post_init__(self):
        _require(int(self.shards) >= 0,
                 f"shards must be >= 0: {self.shards}")
        _require(bool(self.axis), "shard axis must be a non-empty name")
        _require(int(self.hot) >= 0,
                 f"shard hot-set size must be >= 0: {self.hot}")
        _require(self.route_nprobe is None or int(self.route_nprobe) >= 1,
                 f"route_nprobe must be None or >= 1: {self.route_nprobe}")
        _require(int(self.refresh_spills) >= 0,
                 f"refresh_spills must be >= 0: {self.refresh_spills}")


@dataclass
class PrefillSpec:
    """Memoized causal prefill (AttnCache; DESIGN.md §2.13): extend each
    memo entry from "APM only" to "APM + per-layer K/V", so a prefill
    hit skips the layer's attention AND materializes that layer's decode
    cache from the stored entry. ``enabled=False`` (the default) keeps
    the APM-only entry layout and every other field inert."""
    enabled: bool = False
    # decode-cache length handed back by a memoized prefill (None = 2x
    # the prompt length)
    cache_len: Optional[int] = None
    # stored-KV format: "auto" follows the APM codec (f16 → f16,
    # int8/lowrank → int8), or force f16|int8|lowrank
    kv_codec: str = "auto"
    # lowrank KV rank (None = max(4, S//8), as the APM codec)
    kv_rank: Optional[int] = None

    def __post_init__(self):
        _require(self.cache_len is None or int(self.cache_len) >= 1,
                 f"prefill cache_len must be None or >= 1: {self.cache_len}")
        _require(self.kv_codec in ("auto", "f16", "int8", "lowrank"),
                 f"prefill kv_codec must be auto|f16|int8|lowrank: "
                 f"{self.kv_codec!r}")
        _require(self.kv_rank is None or int(self.kv_rank) >= 1,
                 f"prefill kv_rank must be None or >= 1: {self.kv_rank}")


# old flat MemoConfig field → (component, field) — the single source of
# truth for the flat view
FLAT_FIELDS: Dict[str, Tuple[str, str]] = {
    "threshold": ("runtime", "threshold"),
    "mode": ("runtime", "mode"),
    "store": ("runtime", "store"),
    "device_fast_path": ("runtime", "device_fast_path"),
    "device_quanta": ("runtime", "device_quanta"),
    "bucket_quantum": ("runtime", "bucket_quantum"),
    "max_layers": ("runtime", "max_layers"),
    "device_slack": ("runtime", "device_slack"),
    "index_kind": ("index", "host"),
    "device_index": ("index", "device"),
    "cluster_crossover": ("index", "cluster_crossover"),
    "nprobe": ("index", "nprobe"),
    "n_clusters": ("index", "n_clusters"),
    "apm_codec": ("codec", "name"),
    "apm_rank": ("codec", "rank"),
    "embed_dim": ("embed", "dim"),
    "embed_pool": ("embed", "pool"),
    "embed_act": ("embed", "act"),
    "embed_steps": ("embed", "steps"),
    "admit": ("admission", "enabled"),
    "budget_mb": ("admission", "budget_mb"),
    "admit_every": ("admission", "every"),
    "recal_every": ("admission", "recal_every"),
    # new in v1 (no legacy MemoConfig field); named *_kind so the flat
    # property cannot shadow the ``eviction`` component attribute
    "eviction_kind": ("eviction", "kind"),
    # new in the fault-tolerance layer (DESIGN.md §2.9)
    "faults": ("runtime", "faults"),
    # the capacity tier (DESIGN.md §2.11)
    "capacity_dir": ("capacity", "dir"),
    "capacity_budget_mb": ("capacity", "budget_mb"),
    "capacity_promote": ("capacity", "promote"),
    "capacity_promote_max": ("capacity", "promote_max"),
    "capacity_checkpoint_every": ("capacity", "checkpoint_every"),
    "capacity_stall_s": ("capacity", "stall_s"),
    "capacity_fsync": ("capacity", "fsync"),
    "capacity_compact_ratio": ("capacity", "compact_ratio"),
    # the sharded store (DESIGN.md §2.12)
    "shards": ("shard", "shards"),
    "shard_axis": ("shard", "axis"),
    "shard_hot": ("shard", "hot"),
    "shard_route_nprobe": ("shard", "route_nprobe"),
    "shard_refresh_spills": ("shard", "refresh_spills"),
    # prefill memoization (DESIGN.md §2.13)
    "prefill_enabled": ("prefill", "enabled"),
    "prefill_cache_len": ("prefill", "cache_len"),
    "prefill_kv_codec": ("prefill", "kv_codec"),
    "prefill_kv_rank": ("prefill", "kv_rank"),
}


@dataclass(eq=False)
class MemoSpec:
    """The composed memoization spec: six policy objects, one view.

    Component access (``spec.runtime.mode``) is the canonical API; the
    old flat names remain available as properties (``spec.mode``) with
    write-through + re-validation, so incremental call sites (threshold
    autotuning, A/B mode flips) stay one-liners."""
    embed: EmbedSpec = field(default_factory=EmbedSpec)
    index: IndexSpec = field(default_factory=IndexSpec)
    codec: CodecSpec = field(default_factory=CodecSpec)
    admission: AdmissionPolicy = field(default_factory=AdmissionPolicy)
    eviction: EvictionPolicy = field(default_factory=EvictionPolicy)
    runtime: RuntimeSpec = field(default_factory=RuntimeSpec)
    capacity: CapacitySpec = field(default_factory=CapacitySpec)
    shard: ShardSpec = field(default_factory=ShardSpec)
    prefill: PrefillSpec = field(default_factory=PrefillSpec)

    _COMPONENTS = ("embed", "index", "codec", "admission", "eviction",
                   "runtime", "capacity", "shard", "prefill")
    _COMPONENT_TYPES = {"embed": EmbedSpec, "index": IndexSpec,
                        "codec": CodecSpec, "admission": AdmissionPolicy,
                        "eviction": EvictionPolicy, "runtime": RuntimeSpec,
                        "capacity": CapacitySpec, "shard": ShardSpec,
                        "prefill": PrefillSpec}

    def __post_init__(self):
        # fail-fast on the likeliest migration mistake: passing a string
        # (or any non-spec) where a component belongs —
        # MemoSpec(codec="int8") would otherwise construct silently and
        # crash much later as `'str' object has no attribute 'name'`
        for c, t in self._COMPONENT_TYPES.items():
            v = getattr(self, c)
            if not isinstance(v, t):
                flat = [n for n, (comp, _) in FLAT_FIELDS.items()
                        if comp == c]
                raise TypeError(
                    f"MemoSpec.{c} must be a {t.__name__}, got "
                    f"{type(v).__name__}: {v!r} — construct the "
                    f"component (e.g. {t.__name__}(...)) or use the "
                    f"flat field names {flat} via MemoSpec.flat()")

    def __eq__(self, other) -> bool:
        # component-wise
        if not isinstance(other, MemoSpec):
            return NotImplemented
        return all(getattr(self, c) == getattr(other, c)
                   for c in self._COMPONENTS)

    __hash__ = None     # mutable

    # ------------------------------------------------- flat construction
    @classmethod
    def flat(cls, **kwargs) -> "MemoSpec":
        """Build a composed spec from old flat ``MemoConfig`` field names
        (``MemoSpec.flat(threshold=0.9, mode="bucket")``). The sanctioned
        kwargs bridge — no deprecation warning; unknown names raise."""
        per_comp: Dict[str, Dict] = {c: {} for c in cls._COMPONENTS}
        for name, value in kwargs.items():
            try:
                comp, attr = FLAT_FIELDS[name]
            except KeyError:
                raise TypeError(
                    f"unknown memo config field {name!r}; valid flat "
                    f"fields: {sorted(FLAT_FIELDS)}") from None
            per_comp[comp][attr] = value
        return cls(**{c: cls._COMPONENT_TYPES[c](**kw)
                      for c, kw in per_comp.items()})

    def to_flat(self) -> Dict[str, object]:
        """The spec as a flat old-name dict (MIGRATION.md helper)."""
        return {name: getattr(getattr(self, comp), attr)
                for name, (comp, attr) in FLAT_FIELDS.items()}

    def copy(self) -> "MemoSpec":
        """Deep-enough copy: fresh component instances, shared nothing."""
        return MemoSpec(**{c: replace(getattr(self, c))
                           for c in self._COMPONENTS})

    # ------------------------------------------------------ serialization
    def to_dict(self) -> Dict[str, Dict]:
        return {c: asdict(getattr(self, c)) for c in self._COMPONENTS}

    @classmethod
    def from_dict(cls, d: Dict[str, Dict]) -> "MemoSpec":
        out = {}
        for c in cls._COMPONENTS:
            comp_cls = cls._COMPONENT_TYPES[c]
            known = {f.name for f in fields(comp_cls)}
            kw = {k: v for k, v in (d.get(c) or {}).items() if k in known}
            out[c] = comp_cls(**kw)
        return cls(**out)


def _flat_property(comp: str, attr: str) -> property:
    def getter(self):
        return getattr(getattr(self, comp), attr)

    def setter(self, value):
        component = getattr(self, comp)
        old = getattr(component, attr)
        setattr(component, attr, value)
        try:
            if hasattr(component, "__post_init__"):
                component.__post_init__()     # writes re-validate
        except Exception:
            setattr(component, attr, old)    # reject atomically
            raise
    return property(getter, setter)


for _name, (_comp, _attr) in FLAT_FIELDS.items():
    setattr(MemoSpec, _name, _flat_property(_comp, _attr))
del _name, _comp, _attr


_flat_config_warned = False


def _reset_flat_config_warning() -> None:
    """Test hook: re-arm the once-per-process deprecation warning."""
    global _flat_config_warned
    _flat_config_warned = False


class MemoConfig(MemoSpec):
    """Deprecated flat-kwargs shim: ``MemoConfig(threshold=0.9, ...)``
    maps the old flat surface onto the composed ``MemoSpec`` (the result
    compares equal to ``MemoSpec.flat(**same_kwargs)``) and emits a
    ``DeprecationWarning`` once per process. New code: compose specs,
    or use ``MemoSpec.flat`` for the kwargs convenience."""

    def __init__(self, **kwargs):
        # component-kwargs form: how dataclasses.replace() and the
        # inherited flat()/from_dict() classmethods construct; passes
        # straight through (no warning: the caller already has a spec)
        if kwargs and all(k in self._COMPONENTS for k in kwargs):
            super().__init__(**kwargs)
            return
        global _flat_config_warned
        if not _flat_config_warned:
            _flat_config_warned = True
            warnings.warn(
                "MemoConfig(flat kwargs) is deprecated: compose "
                "repro_torch.memo specs (EmbedSpec/IndexSpec/CodecSpec/"
                "AdmissionPolicy/EvictionPolicy/RuntimeSpec) or use "
                "MemoSpec.flat(**kwargs); see MIGRATION.md",
                DeprecationWarning, stacklevel=2)
        spec = MemoSpec.flat(**kwargs)
        super().__init__(**{c: getattr(spec, c)
                            for c in self._COMPONENTS})
