from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    global_norm,
    optimizer_logical_axes,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_lr",
    "global_norm",
    "optimizer_logical_axes",
]
