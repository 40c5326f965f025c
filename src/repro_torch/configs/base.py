"""Configuration: the port's own copies of the reference's ``ModelConfig``,
``InputShape`` (and its four shapes), ``DPConfig``, ``ClientConfig`` and
``MeshConfig``.

Field names, defaults and the ``with_`` / ``reduced`` helpers are those of the
JAX package's config, so a configuration means the same model in both
packages (the tests compare the two field by field).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config. ``family`` selects the model implementation
    (``dense``, ``moe``, ``ssm``, ``hybrid``, ``encdec``, ``vlm``,
    ``lstm``)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    hybrid_attn_every: int = 6
    # enc-dec
    n_enc_layers: int = 0
    n_audio_frames: int = 1500
    # vlm
    n_image_tokens: int = 1024
    # attention behaviour
    rope_theta: float = 10_000.0
    attn_window: int = 0
    tie_embeddings: bool = True
    act: str = "swiglu"
    norm: str = "rmsnorm"
    # lstm: recurrence implementation — "fused" = the hand-written CUDA
    # cell kernel per step, "seq" / "ref" = the plain PyTorch cell,
    # "auto" = fused for CUDA tensors, seq on the CPU
    cell_path: str = "auto"
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    citation: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: 2 layers, d_model<=512,
        <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
        )
        if self.family == "moe":
            kw.update(n_experts=min(self.n_experts, 4),
                      top_k=min(self.top_k, 2),
                      expert_d_ff=min(self.expert_d_ff, 256))
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=min(self.ssm_state, 16),
                      ssm_heads=max(1, d_model * self.ssm_expand // 64),
                      hybrid_attn_every=2)
        if self.family == "encdec":
            kw.update(n_enc_layers=2, n_audio_frames=16)
        if self.family == "vlm":
            kw.update(n_image_tokens=8)
        return self.with_(**kw)


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes (the reference's
    ``InputShape``): a train step's clients, a prefill's prompts or a
    decode step's rows (``global_batch``) at ``seq_len`` tokens."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                    LONG_500K)}


@dataclass(frozen=True)
class DPConfig:
    """Algorithm 1 parameters (paper §II-A, Table 1); field for field the
    reference's ``DPConfig``."""

    clip_norm: float = 0.8          # S
    noise_multiplier: float = 0.8   # z  (σ = z·S/(qN); paper: σ=3.2e-5, qN=20000 → z=0.8)
    clients_per_round: int = 20_000  # qN
    # round composition: "fixed" = exactly qN users WOR (Algorithm 1);
    # "poisson" = each user i.i.d. Bernoulli(q) per round, Δ̄ and σ still
    # divided by the expected round size qN
    sampling: str = "fixed"         # "fixed" | "poisson"
    population: int = 4_000_000     # N
    total_rounds: int = 2_000       # T
    server_opt: str = "momentum"    # sgd | momentum | adam  (Table 6)
    server_lr: float = 1.0          # η_s
    server_momentum: float = 0.99   # μ  (Nesterov)
    nesterov: bool = True
    adam_eps: float = 1e-7

    @property
    def noise_std(self) -> float:
        """σ on the averaged update (paper: 3.2e-5 at defaults)."""
        return self.noise_multiplier * self.clip_norm / self.clients_per_round


@dataclass(frozen=True)
class ClientConfig:
    """UserUpdate parameters (Algorithm 1, Table 1/7)."""

    local_epochs: int = 1       # E
    batch_size: int = 50        # B
    lr: float = 0.5             # η_c
    max_examples_per_user: int = 200  # paper §I: per-user data caps


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names (the reference's
    ``MeshConfig``): ``data`` and ``model`` on one pod, ``pod`` in front
    across pods."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))
