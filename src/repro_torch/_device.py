"""Device choice for every port entry point."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA request without a card raises.
    There is no silent CPU fallback: the CPU runs only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
