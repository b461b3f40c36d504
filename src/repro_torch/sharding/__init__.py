from repro_torch.sharding.rules import (  # noqa: F401
    make_rules, logical_to_shardings, batch_shardings, cache_shardings,
)
