"""Checkpoints in the reference's on-disk layout (``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import all_steps, latest_step, restore, save

__all__ = ["all_steps", "latest_step", "restore", "save"]
