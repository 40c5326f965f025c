"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

# d_inner = expand * d_model = 2048; SSD head_dim 64 → 32 SSD heads.
CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,        # unused by SSD path (attn-free); kept for layout parity
    n_kv_heads=16,
    d_ff=0,            # attn-free, no separate MLP: Mamba2 block is the mixer+channel mix
    vocab=50280,
    ssm_state=128,
    ssm_heads=32,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=True,
    norm="rmsnorm",
    citation="arXiv:2405.21060 (Mamba-2, SSD)",
)
