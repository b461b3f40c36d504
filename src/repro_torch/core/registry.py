"""String-keyed extension registries — a copy of the reference's
``core/registry.py`` holding only what this package implements.

The memo subsystem resolves its pluggable pieces (APM storage codecs,
host/device index layouts, eviction policies) through these registries.
Unknown keys fail fast with the registered choices listed, at spec
construction (``repro_torch.memo.specs``) and again at resolution.
Default implementations register themselves when their defining module
imports; ``autoload`` imports those modules on first use.

Factory contracts (keyword-only context; factories must tolerate extra
context via ``**_``):

* codec:        ``factory(apm_shape, *, rank=None, dtype=np.float16)``
                → ``ApmCodec``
* host index:   ``factory(embed_dim, *, n_lists=None, device=None,
                mesh=None)`` → object with the ``search/assign/remove``
                host-index API
* device index: ``factory(embed_dim, *, capacity=0, nprobe=16,
                n_clusters=None, device=None, mesh=None)`` →
                ``DeviceIndex``-API object (``sharded``: the sharded
                store's layout, ``core/shard.py``)
* eviction:     ``policy(store, n)`` → sequence of arena slots to evict;
                called under the store lock, selection only (the store
                does the release/tombstone/dirty bookkeeping)
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Optional, Tuple


class Registry:
    """A named string → factory map with fail-fast resolution."""

    def __init__(self, kind: str, autoload: Tuple[str, ...] = ()):
        self.kind = kind
        self._autoload = tuple(autoload)
        self._loaded = False
        self._entries: Dict[str, Callable] = {}

    def _ensure(self) -> None:
        """Import the modules whose defaults self-register (idempotent).
        ``_loaded`` flips only after every import succeeds: a failed
        autoload must re-raise its real error on the next call, not
        decay into a misleading \"unknown key; registered: []\"."""
        if not self._loaded:
            for mod in self._autoload:
                importlib.import_module(mod)
            self._loaded = True

    def register(self, name: str, obj: Optional[Callable] = None):
        """``register("x", factory)`` or ``@register("x")`` decorator.
        Re-registering a name overwrites it (latest wins) — that is what
        lets a user shadow a built-in implementation."""
        if obj is None:
            return lambda fn: self.register(name, fn)
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} key must be a non-empty string, "
                             f"got {name!r}")
        self._entries[name] = obj
        return obj

    def choices(self) -> Tuple[str, ...]:
        self._ensure()
        return tuple(sorted(self._entries))

    def __contains__(self, name) -> bool:
        self._ensure()
        return name in self._entries

    def resolve(self, name: str) -> Callable:
        self._ensure()
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{list(self.choices())}") from None


CODECS = Registry("APM codec", autoload=("repro_torch.core.codec",))
HOST_INDEXES = Registry("host index", autoload=("repro_torch.core.index",))
DEVICE_INDEXES = Registry("device index", autoload=(
    "repro_torch.core.index", "repro_torch.core.shard"))
EVICTIONS = Registry("eviction policy", autoload=("repro_torch.core.store",))


def register_codec(name: str, factory: Optional[Callable] = None):
    """Register an APM storage codec under ``name`` (usable as
    ``CodecSpec(name=...)`` / ``MemoConfig(apm_codec=...)``)."""
    return CODECS.register(name, factory)


def register_index(name: str, factory: Optional[Callable] = None, *,
                   tier: str = "host"):
    """Register an index implementation. ``tier="host"`` keys are valid
    for ``IndexSpec.host`` (the calibration/lookup index);
    ``tier="device"`` keys for ``IndexSpec.device`` (the serving-tier
    search traced inside the fused jit)."""
    if tier not in ("host", "device"):
        raise ValueError(f"tier must be 'host' or 'device', got {tier!r}")
    reg = HOST_INDEXES if tier == "host" else DEVICE_INDEXES
    return reg.register(name, factory)


def register_eviction(name: str, policy: Optional[Callable] = None):
    """Register an eviction policy: ``policy(store, n) -> slots``."""
    return EVICTIONS.register(name, policy)
