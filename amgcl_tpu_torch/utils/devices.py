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


def held_tensors(*objs):
    """Every tensor the port's objects ``objs`` hold, found through their
    attributes, lists, tuples and dicts (objects of other packages, numpy
    arrays and functions are not entered); each object is visited once."""
    seen, out, stack = set(), [], list(objs)
    while stack:
        obj = stack.pop()
        if obj is None or isinstance(obj, (str, bytes, int, float, bool,
                                           np.ndarray)):
            continue
        if torch.is_tensor(obj):
            out.append(obj)
            continue
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, (list, tuple, set, frozenset)):
            stack.extend(obj)
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif type(obj).__module__.startswith("amgcl_tpu_torch"):
            stack.extend(getattr(obj, "__dict__", {}).values())
    return out


def storage_bytes(tensors, device) -> int:
    """Bytes of the distinct storages under ``tensors`` on ``device``'s
    type: a storage shared by several tensors (views, an operator held
    twice) counts once, and a view counts its whole storage, which is
    what freeing it returns."""
    dev = torch.device(device)
    seen = {}
    for t in tensors:
        if t.device.type != dev.type:
            continue
        st = t.untyped_storage()
        seen[(t.device, st.data_ptr())] = st.nbytes()
    return sum(seen.values())
