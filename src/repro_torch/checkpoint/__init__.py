from .ckpt import latest_step, load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint", "latest_step"]
