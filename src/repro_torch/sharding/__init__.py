from repro_torch.sharding.partition import (  # noqa: F401
    LOGICAL_RULES, P, logical_to_pspec, shardings_for, batch_pspec,
    batch_sharding, param_shardings, activation_rules,
)
