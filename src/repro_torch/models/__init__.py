from repro_torch.models.model import (
    analytic_param_count,
    cast_params,
    decode_step,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "analytic_param_count",
    "cast_params",
    "decode_step",
    "init_cache",
    "init_params",
    "prefill",
]
