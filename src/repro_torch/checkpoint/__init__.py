from repro_torch.checkpoint.checkpoint import save_checkpoint, load_checkpoint, latest_step

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]
