"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

# 54 mamba2 layers; a single *shared* GQA attention block is interleaved every
# `hybrid_attn_every` mamba blocks (weights shared across applications, distinct
# KV caches per application site), per the Zamba2 design.
CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,        # shared attn block's MLP width
    vocab=32000,
    ssm_state=64,
    ssm_heads=80,      # d_inner=5120, head_dim 64
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
    tie_embeddings=True,
    citation="arXiv:2411.15242 (Zamba2)",
)
