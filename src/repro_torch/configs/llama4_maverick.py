"""llama4-maverick-400b-a17b [moe] — 128e top-1, shared expert, interleaved
MoE layers, early fusion (hf:meta-llama/Llama-4 family)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    experts_per_token=1,
    shared_expert=True,
    block_pattern=("attn_mlp", "attn_moe"),   # interleaved dense/MoE
)
