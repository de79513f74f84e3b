"""pixtral-12b [vlm] — pixtral-ViT frontend stub + mistral-nemo backbone
(hf:mistralai/Pixtral-12B-2409). Patch embeddings arrive precomputed."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    frontend="patch_stub",
    n_prefix_embeds=256,       # one 1024x1024 image at 64px patches (stub)
)
