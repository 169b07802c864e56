from repro_torch.distribution.step import (
    init_train_state,
    make_grad_fn,
    make_train_step,
    make_update_fn,
)

__all__ = ["init_train_state", "make_grad_fn", "make_train_step", "make_update_fn"]
