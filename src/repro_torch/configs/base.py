"""Architecture + shape configuration system.

Every assigned architecture is an :class:`ArchConfig` in its own module under
``repro_torch/configs`` (a copy of the reference's ``repro/configs``); the
registry in ``__init__`` resolves ``--arch <id>``.
Shapes are global-batch x sequence cells from the assignment; ``kind``
distinguishes train vs. inference-prefill vs. decode lowering.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # defaults to d_model // n_heads
    qk_norm: bool = False
    act: str = "swiglu"              # swiglu | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    shared_expert: bool = False      # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4
    # --- hybrid (recurrentgemma / Griffin) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "attn")
    local_window: int = 0                 # sliding-window size for local attn
    rglru_width: int = 0                  # RG-LRU recurrence width (d_model scale)
    # --- enc-dec (whisper) ---
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame count (conv frontend stub)
    # --- modality stub ---
    frontend: str = ""               # "" | "audio_stub" | "patch_stub"
    n_prefix_embeds: int = 0         # vlm: patch embeddings prepended to text
    # --- numerics / training ---
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"   # "nothing" | "save_block_outputs"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token contexts? (SSM / hybrid-local-attn)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (reported in the roofline table)."""
        d, f, vocab = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.n_experts:
            mlp_total = self.n_experts * mlp + d * self.n_experts
            if self.shared_expert:
                mlp_total += mlp
        else:
            mlp_total = mlp
        per_layer = attn + mlp_total + 2 * d
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            per_layer = (d * (2 * d_in + 2 * self.ssm_state + nheads)
                         + d_in * self.conv_width + d_in * d + 2 * d)
        if self.family == "hybrid" and self.block_pattern:
            w = self.rglru_width or d
            rg = d * w * 3 + w * d + 2 * w  # gates + projections (approx)
            n_attn = sum(1 for i in range(self.n_layers)
                         if self.block_pattern[i % len(self.block_pattern)] == "attn")
            n_rg = self.n_layers - n_attn
            per_layer = 0  # handled below
            total_layers = n_attn * (attn + mlp + 2 * d) + n_rg * (rg + mlp + 2 * d)
            emb = vocab * d * (1 if self.tie_embeddings else 2)
            return total_layers + emb
        n_layers = self.n_layers + self.encoder_layers
        emb = vocab * d * (1 if self.tie_embeddings else 2)
        total = n_layers * per_layer + emb
        if self.is_encdec:
            total += self.n_layers * attn  # cross-attention
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        inactive = (self.n_experts - self.experts_per_token) * mlp
        return self.param_count() - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        dtype="float32",
        remat=False,
    )
    if cfg.n_experts:
        base.update(n_experts=4, experts_per_token=min(2, cfg.experts_per_token))
    if cfg.family == "ssm":
        base.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        base.update(local_window=16, rglru_width=64, n_layers=3)
    if cfg.is_encdec:
        base.update(encoder_layers=2, encoder_seq=16)
    if cfg.n_prefix_embeds:
        base.update(n_prefix_embeds=4)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
