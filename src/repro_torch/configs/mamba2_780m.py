"""mamba2-780m [ssm] — SSD / state-space duality, attention-free
(arXiv:2405.21060). d_inner = 2*d_model = 3072, 48 heads of 64."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,          # SSD heads (d_inner / ssm_head_dim)
    n_kv_heads=1,
    d_ff=0,              # attention-free: no separate MLP
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
)
