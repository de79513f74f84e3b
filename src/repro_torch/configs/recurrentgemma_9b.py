"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2 (arXiv:2402.19427)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "attn_local"),
    local_window=2048,
    rglru_width=4096,
)
