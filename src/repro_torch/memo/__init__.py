"""``repro_torch.memo`` — the public memoization API: the composable
specs, the extension registries and ``MemoSession`` (build → infer →
serve → stats), with the serving runtime's and failure model's names.

The names are those of the reference's ``repro.memo``, the deprecated
``MemoConfig`` shim included.
Attributes resolve lazily (PEP 562) so ``repro_torch.memo.specs`` and
the registries are importable by core modules without a circular import
through the session layer.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    # facade
    "MemoSession": ("repro_torch.memo.session", "MemoSession"),
    # specs
    "MemoSpec": ("repro_torch.memo.specs", "MemoSpec"),
    "MemoConfig": ("repro_torch.memo.specs", "MemoConfig"),
    "EmbedSpec": ("repro_torch.memo.specs", "EmbedSpec"),
    "IndexSpec": ("repro_torch.memo.specs", "IndexSpec"),
    "CodecSpec": ("repro_torch.memo.specs", "CodecSpec"),
    "AdmissionPolicy": ("repro_torch.memo.specs", "AdmissionPolicy"),
    "EvictionPolicy": ("repro_torch.memo.specs", "EvictionPolicy"),
    "RuntimeSpec": ("repro_torch.memo.specs", "RuntimeSpec"),
    "CapacitySpec": ("repro_torch.memo.specs", "CapacitySpec"),
    "ShardSpec": ("repro_torch.memo.specs", "ShardSpec"),
    "PrefillSpec": ("repro_torch.memo.specs", "PrefillSpec"),
    "FLAT_FIELDS": ("repro_torch.memo.specs", "FLAT_FIELDS"),
    # registries
    "register_codec": ("repro_torch.core.registry", "register_codec"),
    "register_index": ("repro_torch.core.registry", "register_index"),
    "register_eviction": ("repro_torch.core.registry", "register_eviction"),
    # serving-surface re-exports (returned/consumed by the facade)
    "MemoServer": ("repro_torch.core.runtime", "MemoServer"),
    "MemoStats": ("repro_torch.core.engine", "MemoStats"),
    "LEVELS": ("repro_torch.core.engine", "LEVELS"),
    # failure model (DESIGN.md §2.9)
    "MemoStoreError": ("repro_torch.core.faults", "MemoStoreError"),
    "FaultInjector": ("repro_torch.core.faults", "FaultInjector"),
    "FAULT_POINTS": ("repro_torch.core.faults", "FAULT_POINTS"),
    "CHAOS_PRESETS": ("repro_torch.core.faults", "CHAOS_PRESETS"),
    "Health": ("repro_torch.core.runtime", "Health"),
    "MemoMaintenanceError": ("repro_torch.core.runtime",
                             "MemoMaintenanceError"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.memo' has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value         # cache for subsequent lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
