"""PyTorch/CUDA port of the DP-FedAvg production-LM system.

The JAX package ``repro`` is the reference; this package imports nothing of
it and never imports ``jax``. Every entry point runs on ``"cuda"`` unless the
caller passes ``device="cpu"``; asking for CUDA on a host without a GPU
raises (`repro_torch.utils.device`). Kernels written by hand for Hopper live
under ``repro_torch.kernels`` and are built from their sources at first use.

Ported so far: the serving path of the paper's CIFG-LSTM
(``repro_torch.serve``, ``repro_torch.launch.serve``) and DP-FedAvg training
of it on the host backend (``repro_torch.fl.round.FederatedTrainer``,
``repro_torch.launch.train``), with the CIFG cell forward and backward and
the per-client clip kernels written for Hopper; and the batch serving path
(``launch.serve.generate``) of Mamba-2 (``mamba2-370m``) and the Zamba2
hybrid (``zamba2-2.7b``), whose prefill runs the SSD scan and flash
attention kernels written for Hopper.
"""
from repro_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
