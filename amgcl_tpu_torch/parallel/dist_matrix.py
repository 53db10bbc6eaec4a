"""Row-block distributed DIA operators: the halo-exchange SpMV and the
distributed inner product.

Counterpart of the DIA half of ``amgcl_tpu/parallel/dist_matrix.py``
(reference: amgcl/mpi/distributed_matrix.hpp:316-557,
amgcl/mpi/inner_product.hpp:45-67). A distributed vector is a list of
per-shard slabs, a distributed DIA operator the list of its per-shard
``(ndiag, nl)`` diagonal slabs with flat offsets shared by all shards
(``parallel/mesh.py``). One process runs every shard, so the JAX
package's collectives become copies between shard tensors: ``ppermute``
of the slab edges is :func:`_ring_exchange`, ``psum`` a sum of the
per-shard partials in shard order, ``all_gather`` a ``torch.cat``.
"""

from __future__ import annotations

import torch

from amgcl_tpu_torch.ops import dia_kernels as dk


def _ring_exchange(slabs, w):
    """Per shard, ``(prev_tail, next_head)``: the last ``w`` entries (along
    the last axis) of the previous shard's slab and the first ``w`` of the
    next one's, on this shard's device; the boundary shards get zeros
    (the global zero fill). ``w`` must not exceed the slab."""
    nd = len(slabs)
    if w > slabs[0].shape[-1]:
        raise ValueError("a halo of %d rows reaches past the neighbour "
                         "slab of %d rows" % (w, slabs[0].shape[-1]))
    out = []
    for i, x in enumerate(slabs):
        zeros = x.new_zeros(x.shape[:-1] + (w,))
        prev = slabs[i - 1][..., -w:].to(x.device) if i > 0 else zeros
        nxt = slabs[i + 1][..., :w].to(x.device) if i < nd - 1 else zeros
        out.append((prev, nxt))
    return out


def _gather(slabs, device):
    """The whole vector on ``device``: the all-gather."""
    return torch.cat([s.to(device) for s in slabs])


def _shifted_sum(data, flat_offs, xe, start, n):
    """Σ_k data[k] ∘ xe[start + s_k : start + s_k + n] in diagonal order."""
    y = torch.zeros(n, dtype=torch.promote_types(data.dtype, xe.dtype),
                    device=xe.device)
    for k, s in enumerate(flat_offs):
        y += data[k] * xe[start + s:start + s + n]
    return y


def dia_halo_mv(data_slabs, flat_offs, x_slabs):
    """y = A x over the shards, with the reference's three regimes for a
    halo of ``w = max |offset|`` rows against the slab's ``nl``:

    - ``w > nl`` (more than one neighbour slab): the whole vector is
      gathered and each shard reads its rows at its global offset;
    - ``2w ≥ nl``: the product over the slab framed by the exchanged
      halo;
    - otherwise the interior is the DIA SpMV kernel on the local slab
      (zero-filled shifts, wrong only in the first and last ``w`` rows),
      and those ``2w`` edge rows are recomputed from the halo.

    On one shard the halo is the global zero fill, so the product is the
    DIA SpMV kernel on the slab alone."""
    flat_offs = [int(s) for s in flat_offs]
    w = max((abs(s) for s in flat_offs), default=0)
    nd, nl = len(x_slabs), x_slabs[0].shape[0]
    if nd == 1:
        return [dk.dia_spmv(dk.offsets_on(flat_offs, x_slabs[0].device),
                            data_slabs[0], x_slabs[0])]
    if w == 0:
        return [_shifted_sum(d, flat_offs, x, 0, nl)
                for d, x in zip(data_slabs, x_slabs)]
    if w > nl:
        out = []
        for i, (d, x) in enumerate(zip(data_slabs, x_slabs)):
            xe = torch.nn.functional.pad(_gather(x_slabs, x.device), (w, w))
            out.append(_shifted_sum(d, flat_offs, xe, w + i * nl, nl))
        return out
    if 2 * w >= nl:
        return [_shifted_sum(d, flat_offs, torch.cat([p, x, q]), w, nl)
                for d, x, (p, q) in zip(data_slabs, x_slabs,
                                        _ring_exchange(x_slabs, w))]
    halos = _ring_exchange(x_slabs, w)
    out = []
    for d, x, (p, q) in zip(data_slabs, x_slabs, halos):
        y0 = dk.dia_spmv(dk.offsets_on(flat_offs, x.device), d, x)
        xe = torch.cat([p, x, q])
        lo = _shifted_sum(d[:, :w], flat_offs, xe, w, w)
        hi = _shifted_sum(d[:, nl - w:], flat_offs, xe, nl, w)
        out.append(torch.cat([lo, y0[w:nl - w], hi]))
    return out


def dist_inner_product(x_slabs, y_slabs):
    """⟨x, y⟩ over the shards: each shard's partial dot, summed in shard
    order on the first shard's device (a 0-d tensor there; no host
    sync)."""
    dev = x_slabs[0].device
    acc = None
    for x, y in zip(x_slabs, y_slabs):
        p = torch.dot(x, y).to(dev)
        acc = p if acc is None else acc + p
    return acc
