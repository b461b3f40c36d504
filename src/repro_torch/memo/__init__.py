"""``repro_torch.memo`` — the public memoization API (specs + session)."""
from repro_torch.memo.specs import (  # noqa: F401
    FLAT_FIELDS, AdmissionPolicy, CapacitySpec, CodecSpec, EmbedSpec,
    EvictionPolicy, IndexSpec, MemoSpec, PrefillSpec, RuntimeSpec, ShardSpec,
)
