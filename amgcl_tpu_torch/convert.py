"""Build the port's :class:`~amgcl_tpu_torch.models.amg.Hierarchy` from
plain numpy arrays.

The solver has no weights: its state is the hierarchy. Handing the arrays
of a hierarchy built elsewhere (the JAX package's ``AMG``, read out with
``np.asarray``) to :func:`hierarchy_from_arrays` lets the cycle and the
Krylov solve be held against that package on an identical hierarchy, so
solve differences are separated from setup differences.
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.models.amg import AMGParams, Hierarchy, Level
from amgcl_tpu_torch.ops.device import DenseMatrix, DiaMatrix
from amgcl_tpu_torch.ops.structured import (GridTentative,
                                            ImplicitSmoothedP,
                                            ImplicitSmoothedR)
from amgcl_tpu_torch.relaxation.base import ScaledResidualSmoother
from amgcl_tpu_torch.solver.direct import DenseDirectSolver
from amgcl_tpu_torch.utils.devices import resolve_device


def _dia(pair, dtype, device):
    offsets, data = pair
    data = torch.tensor(np.asarray(data), dtype=dtype, device=device)
    n = data.shape[1]
    return DiaMatrix([int(o) for o in offsets], data, (n, n))


def hierarchy_from_arrays(levels, coarse_inv, params: AMGParams = None,
                          device=None) -> Hierarchy:
    """``levels``: one dict per level, finest first. Every level has
    ``"A"``: the operator as a DIA pair ``(offsets, data)`` with
    ``data[k, i] = A[i, i + offsets[k]]``, or as a dense 2-D array. Every
    level but the last also has ``"M"`` and ``"Mt"`` (DIA pairs of the
    smoothed transfer's M = ω D⁻¹ A_f and its transpose), ``"fine"`` and
    ``"block"`` (grid dims and aggregation blocks of the tentative
    prolongation) and ``"scale"`` (the SPAI-0 diagonal). ``coarse_inv`` is
    the dense inverse of the last level's operator. ``params`` supplies
    the dtype and the cycle shape (npre, npost, ncycle, pre_cycles)."""
    prm = params or AMGParams()
    device = resolve_device(device)
    dtype = prm.dtype
    out = []
    for i, lv in enumerate(levels):
        A = lv["A"]
        if isinstance(A, tuple):
            A_dev = _dia(A, dtype, device)
        else:
            A_dev = DenseMatrix(torch.tensor(np.asarray(A), dtype=dtype,
                                             device=device))
        if i == len(levels) - 1:
            out.append(Level(A_dev, None))
            continue
        fine = tuple(int(d) for d in lv["fine"])
        block = tuple(int(b) for b in lv["block"])
        coarse = tuple(-(-d // b) for d, b in zip(fine, block))
        T = GridTentative(fine, block, coarse)
        scale = torch.tensor(np.asarray(lv["scale"]), dtype=dtype,
                             device=device)
        out.append(Level(
            A_dev, ScaledResidualSmoother(scale),
            ImplicitSmoothedP(T, _dia(lv["M"], dtype, device)),
            ImplicitSmoothedR(T, _dia(lv["Mt"], dtype, device))))
    inv = torch.tensor(np.asarray(coarse_inv), dtype=dtype, device=device)
    return Hierarchy(out, DenseDirectSolver(inv), prm.npre, prm.npost,
                     prm.ncycle, prm.pre_cycles)
