"""Optimizers for the LM testbed (``repro.optim``)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compress import compressed_psum, dequantize, ef_compress_update, quantize
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "wsd_schedule",
    "clip_by_global_norm",
    "global_norm",
    "compressed_psum",
    "dequantize",
    "ef_compress_update",
    "quantize",
]
