"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

Transformer backbone only; the VQ-VAE image tokenizer is a stub, as in the
reference: the batch carries precomputed patch-token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,       # unified text + VQ image-token vocabulary
    n_image_tokens=1024,
    tie_embeddings=False,
    act="swiglu",
    citation="arXiv:2405.09818 (Chameleon)",
)
