from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer,
    RankCheckpointer,
    latest_step,
    load_checkpoint,
    load_rank_checkpoint,
    save_checkpoint,
    save_rank_checkpoint,
)

__all__ = ["save_checkpoint", "load_checkpoint", "AsyncCheckpointer", "latest_step", "RankCheckpointer",
           "load_rank_checkpoint", "save_rank_checkpoint"]
