"""Chameleon-style early-fusion VLM [arXiv:2405.09818] — chameleon-34b: the
port of ``repro.models.vlm``.

Early fusion means the backbone is a plain dense decoder over a unified
text and VQ-image-token vocabulary. The VQ-VAE image tokenizer is a stub:
the batch carries precomputed image-patch embeddings (B, n_image_tokens, d)
that replace the embeddings of the leading positions
(`transformer._embed_batch`). Everything else, the flash kernel in the
prefill and the training forward included, is the dense path's, and so is
the chunk of clients trained as one program (`layers.chunk_loss` of
`transformer.forward`, each client's patch embeddings leading its own
rows).
"""
from __future__ import annotations

from functools import partial

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import Model


def build(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=partial(T.init, cfg=cfg),
        forward=partial(T.forward, cfg=cfg),
        loss_fn=partial(T.loss_fn, cfg=cfg),
        init_cache=partial(T.init_cache, cfg),
        prefill=partial(T.prefill, cfg=cfg),
        decode_step=partial(T.decode_step, cfg=cfg),
        compute_copies=T.compute_copies,
        client_loss_fn=partial(L.chunk_loss, T.forward, cfg=cfg),
    )
