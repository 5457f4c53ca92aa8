"""rl_tpu_torch — the PyTorch/CUDA port of :mod:`rl_tpu`.

The JAX package stays the reference; every module here keeps its
counterpart's name so a reader finds one from the other, and every Pallas
kernel on a ported path is a CUDA kernel written for Hopper (``sm_90a``)
under :mod:`rl_tpu_torch.kernels`.

Entry points take an explicit ``device``. It defaults to the CUDA card;
the CPU is used only when the caller asks for it (``device="cpu"``), and
then every kernel wrapper runs its plain PyTorch version. With no card and
no explicit CPU request the port raises instead of picking the CPU.

Importing this package imports ``torch`` and nothing else: no JAX, nothing
of :mod:`rl_tpu`, and no CUDA initialisation.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """The CUDA card, or a clear error. Never the CPU by itself."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "rl_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; an explicit device is checked
    (a CUDA device without a card raises)."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
