"""Public re-export of the extension registries, the counterpart of the
reference's ``memo/registry.py``.

The implementation lives in ``repro_torch.core.registry`` (a leaf module
the core imports without cycling through the session layer); this
module is the documented import location::

    from repro_torch.memo.registry import register_codec, CODECS

See ``repro_torch.core.registry`` for the factory contracts.
"""
from repro_torch.core.registry import (  # noqa: F401
    CODECS, DEVICE_INDEXES, EVICTIONS, HOST_INDEXES, Registry,
    register_codec, register_eviction, register_index)
