"""whisper-medium [audio] — enc-dec, conv frontend stub (arXiv:2212.04356)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    is_encdec=True,
    encoder_layers=24,
    encoder_seq=1500,          # 30s of audio at 50 frames/s (conv stub output)
    frontend="audio_stub",
    block_pattern=("attn_cross_mlp",),
)
