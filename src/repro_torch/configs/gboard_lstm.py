"""The paper's own production NWP model: 1-layer CIFG-LSTM, tied embeddings,
~1.3M parameters, 10k word vocabulary [this paper §III-A; SSB14].
"""
from repro_torch.configs.base import ModelConfig

# Embedding dim 96 (tied in/out projection), CIFG hidden 256:
#   embed 10k×96 = 0.96M; CIFG gates 3·(96+256+1)·256 ≈ 0.27M; proj 256→96 ≈ 25k
#   total ≈ 1.26M ≈ the paper's 1.3M.
CONFIG = ModelConfig(
    name="gboard-cifg-lstm",
    family="lstm",
    n_layers=1,
    d_model=96,        # embedding dim (tied input embedding / output projection)
    n_heads=1,
    n_kv_heads=1,
    d_ff=256,          # CIFG-LSTM hidden size
    vocab=10_000,
    tie_embeddings=True,
    citation="this paper §III-A; arXiv:1402.1128 (CIFG-LSTM)",
)
