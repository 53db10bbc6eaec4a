"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA request without a card raises rather
    than carrying on on the CPU; the CPU runs only when asked for
    (``device="cpu"``), and then every kernel wrapper takes its plain
    version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "amgcl_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev
