"""The shard mesh: one process drives every shard.

Counterpart of ``amgcl_tpu/parallel/mesh.py``. The JAX package runs a
sharded program with ``shard_map`` over a ``jax.sharding.Mesh``, one
controller driving every shard. The port keeps that model: a
:class:`Mesh` is a list of shard devices over one logical axis,
``rows`` (the domain decomposition, the reference's MPI ranks), and a
distributed array is a list of per-shard tensors, each on its shard's
device. The per-shard program is a loop over the shards; the collectives
become copies between shard tensors (``parallel/dist_matrix.py``). A
device may hold several shards, so a mesh of four shards runs on one
card as well as on four.
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.utils.devices import resolve_device

ROWS_AXIS = "rows"


class Mesh:
    """A 1-D mesh of shard devices over :data:`ROWS_AXIS`."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return "Mesh(%d shards over %s)" % (
            self.size, ", ".join(sorted({str(d) for d in self.devices})))


def make_mesh(n_shards=None, device=None, devices=None) -> Mesh:
    """A mesh of ``n_shards`` shards. ``devices`` lists the shard devices
    outright. Otherwise the shards go round-robin over the visible CUDA
    devices (``device=None``, which raises without a card, or a CUDA
    device without an index), over one given device, or over the CPU
    (``device="cpu"``); ``n_shards=None`` means one shard per device."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if n_shards is not None:
            devs = devs[:n_shards]
        return Mesh(devs)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        pool = [dev]
    n = len(pool) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError("a mesh needs at least one shard, got %d" % n)
    return Mesh([pool[i % len(pool)] for i in range(n)])


def _split(t, n_shards, axis):
    if t.shape[axis] % n_shards:
        raise ValueError("%d rows do not split over %d shards"
                         % (t.shape[axis], n_shards))
    return torch.tensor_split(t, n_shards, dim=axis)


def put_sharded(a, mesh: Mesh, dtype=None, axis: int = 0):
    """A host array or a tensor split along ``axis`` into equal per-shard
    slabs, contiguous, each on its shard's device, sharing no memory with
    ``a``. When every shard lies on one device, the array crosses to it
    in one copy."""
    t = a.detach() if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    if len(set(mesh.devices)) == 1:
        t = t.to(mesh.devices[0], dtype, copy=True)
        return [p.contiguous() for p in _split(t, mesh.size, axis)]
    return [p.to(d, dtype, copy=True).contiguous()
            for p, d in zip(_split(t, mesh.size, axis), mesh.devices)]


def host_full(slabs, axis: int = 0) -> np.ndarray:
    """The per-shard slabs of a distributed array, concatenated along
    ``axis`` on the host."""
    return np.concatenate([s.detach().cpu().numpy() for s in slabs],
                          axis=axis)
