"""Device selection for the port's entry points, and host arrays cast
to a device dtype."""

from __future__ import annotations

import numpy as np
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


def np_dtype(dtype) -> np.dtype:
    """The numpy dtype a host array of a device ``dtype`` is built in: its
    own, and float32 for bfloat16, which numpy lacks (the tensor is then
    cast with ``.to``; torch's casts to bfloat16 from float64 and from
    float32 and the JAX package's round alike, through float32)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


def host_tensor(a, dtype, device) -> torch.Tensor:
    """The numpy array ``a`` as a ``dtype`` tensor on ``device``, built in
    :func:`np_dtype` and cast on the device."""
    return torch.as_tensor(np.ascontiguousarray(a, np_dtype(dtype)),
                           device=device).to(dtype)
