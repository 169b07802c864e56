from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "AsyncCheckpointer", "latest_step"]
