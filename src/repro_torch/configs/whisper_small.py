"""whisper-small [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

Transformer backbone only; the mel-spectrogram + conv feature extractor is a
stub, as in the reference: the batch carries precomputed frame embeddings
(B, 1500, d).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,       # decoder layers
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    n_audio_frames=1500,
    tie_embeddings=True,
    act="gelu",
    norm="layernorm",
    rope_theta=0.0,    # sinusoidal positions, not RoPE
    citation="arXiv:2212.04356 (Whisper)",
)
