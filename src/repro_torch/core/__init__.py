"""AttMemo core on PyTorch: the reference's ``repro.core`` names.

Attributes resolve lazily (PEP 562), as ``repro_torch.memo``'s do, so
``import repro_torch.core`` stays light: ``repro_torch.core.engine``
pulls in the whole serving stack only when one of its names is read.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "memo_rate": ("repro_torch.core.similarity", "memo_rate"),
    "pairwise_similarity": ("repro_torch.core.similarity",
                            "pairwise_similarity"),
    "similarity_score": ("repro_torch.core.similarity", "similarity_score"),
    "Embedder": ("repro_torch.core.embedding", "Embedder"),
    "train_embedder": ("repro_torch.core.embedding", "train_embedder"),
    "ExactIndex": ("repro_torch.core.index", "ExactIndex"),
    "IVFIndex": ("repro_torch.core.index", "IVFIndex"),
    "recall_at_1": ("repro_torch.core.index", "recall_at_1"),
    "AttentionDB": ("repro_torch.core.database", "AttentionDB"),
    "DeviceDB": ("repro_torch.core.database", "DeviceDB"),
    "LayerProfile": ("repro_torch.core.selective", "LayerProfile"),
    "PerfModel": ("repro_torch.core.selective", "PerfModel"),
    "MemoStore": ("repro_torch.core.store", "MemoStore"),
    "StoreStats": ("repro_torch.core.store", "StoreStats"),
    "ShardedDeviceIndex": ("repro_torch.core.shard", "ShardedDeviceIndex"),
    "ShardedMemoStore": ("repro_torch.core.shard", "ShardedMemoStore"),
    "make_store_mesh": ("repro_torch.core.shard", "make_store_mesh"),
    "mesh_search": ("repro_torch.core.shard", "mesh_search"),
    "CHAOS_PRESETS": ("repro_torch.core.faults", "CHAOS_PRESETS"),
    "FAULT_POINTS": ("repro_torch.core.faults", "FAULT_POINTS"),
    "FaultInjector": ("repro_torch.core.faults", "FaultInjector"),
    "MemoStoreError": ("repro_torch.core.faults", "MemoStoreError"),
    "register_codec": ("repro_torch.core.registry", "register_codec"),
    "register_eviction": ("repro_torch.core.registry", "register_eviction"),
    "register_index": ("repro_torch.core.registry", "register_index"),
    "LEVELS": ("repro_torch.core.engine", "LEVELS"),
    "MemoConfig": ("repro_torch.core.engine", "MemoConfig"),
    "MemoEngine": ("repro_torch.core.engine", "MemoEngine"),
    "MemoStats": ("repro_torch.core.engine", "MemoStats"),
    "SimReservoir": ("repro_torch.core.engine", "SimReservoir"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value         # cache for subsequent lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
