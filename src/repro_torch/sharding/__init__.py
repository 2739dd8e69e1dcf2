from repro_torch.sharding.rules import (  # noqa: F401
    batch_spec,
    cache_specs,
    distribute,
    logical_to_spec,
    param_specs,
    shardings,
)
