"""PyTorch/CUDA port of the DP-FedAvg production-LM system.

The JAX package ``repro`` is the reference; this package imports nothing of
it and never imports ``jax``. Every entry point runs on ``"cuda"`` unless the
caller passes ``device="cpu"``; asking for CUDA on a host without a GPU
raises (`repro_torch.utils.device`). Kernels written by hand for Hopper live
under ``repro_torch.kernels`` and are built from their sources at first use.

Ported so far: the serving path of the paper's CIFG-LSTM
(``repro_torch.serve``, ``repro_torch.launch.serve``) and the forward CIFG
cell kernel it runs on.
"""
from repro_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
