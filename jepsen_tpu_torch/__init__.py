"""PyTorch/CUDA port of ``jepsen_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package runs the same
linearizability check with PyTorch on the card and imports nothing of
``jepsen_tpu`` (or of JAX). This slice covers the offline single-key
Wing-Gong-Lowe check for the register, cas-register and mutex models;
its greedy rollout is a hand-written CUDA kernel
(``checker/csrc/rollout.cu``).

Entry points take ``device=None``, which means CUDA: without a card they
raise, and only an explicit ``device="cpu"`` runs on the CPU (what the
tests pass). Nothing heavy happens at import: kernels build at first use.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """The torch.device an entry point runs on. ``None`` means CUDA and
    raises when no card is present; the CPU is used only when asked for
    explicitly."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "jepsen_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
