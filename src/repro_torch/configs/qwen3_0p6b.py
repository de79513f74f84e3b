"""qwen3-0.6b [dense] — qk_norm, GQA, tied embeddings (hf:Qwen/Qwen3)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
