"""granite-moe-3b-a800m [moe] — top-8 MoE [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,          # per-expert FFN width
    expert_d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
