"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.  The port targets an NVIDIA
    GPU: a CUDA device on a machine without CUDA raises instead of quietly
    running on the CPU.  Only an explicit ``"cpu"`` selects the plain
    PyTorch versions of the kernels."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run the plain PyTorch versions "
            "of its kernels on the CPU"
        )
    return dev
