"""Build the port's :class:`~amgcl_tpu_torch.models.amg.Hierarchy` from
plain numpy arrays.

The solver has no weights: its state is the hierarchy. Handing the arrays
of a hierarchy built elsewhere (the JAX package's ``AMG``, read out with
``np.asarray``) to :func:`hierarchy_from_arrays` lets the cycle and the
Krylov solve be held against that package on an identical hierarchy, so
solve differences are separated from setup differences (bfloat16 arrays
too: they cross through float32, which holds them exactly); each level gets
the port's own fused V-cycle handles where it is eligible, so the fused
legs can be held against the reference's on the same operators.
:func:`idrs_with_shadow` does the same for the one piece of solver state
the packages draw differently: IDR(s)'s shadow space, and
:func:`fused_slab_from_arrays` for the framed operands of a sharded
stencil level (``parallel/dist_stencil.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from amgcl_tpu_torch.models.amg import AMGParams, Hierarchy, Level
from amgcl_tpu_torch.ops.densewin import DenseWindowMatrix
from amgcl_tpu_torch.ops.device import DenseMatrix, DiaMatrix
from amgcl_tpu_torch.ops.structured import (AggTentative, GridTentative,
                                            ImplicitSmoothedP,
                                            ImplicitSmoothedR, TentativeP,
                                            TentativeR)
from amgcl_tpu_torch.ops.unstructured import WindowedEllMatrix
from amgcl_tpu_torch.ops.vcycle import build_fused_down, build_fused_up
from amgcl_tpu_torch.parallel.dist_stencil import FusedSlab
from amgcl_tpu_torch.relaxation.base import ScaledResidualSmoother
from amgcl_tpu_torch.relaxation.chebyshev import ChebyshevState
from amgcl_tpu_torch.relaxation.gauss_seidel import MulticolorGS
from amgcl_tpu_torch.relaxation.ilu0 import ILU0State
from amgcl_tpu_torch.relaxation.spai1 import Spai1State
from amgcl_tpu_torch.solver.idrs import IDRs
from amgcl_tpu_torch.solver.direct import DenseDirectSolver
from amgcl_tpu_torch.utils.devices import resolve_device


def _tensor(a, dtype, device):
    """A copy of the array ``a`` as a ``dtype`` tensor on ``device``. A
    bfloat16 array (``np.asarray`` of a JAX bfloat16 array has
    ``ml_dtypes``' bfloat16 dtype, which torch does not take) goes through
    float32, which holds each bfloat16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def _dia(pair, dtype, device):
    offsets, data = pair
    data = _tensor(data, dtype, device)
    n = data.shape[1]
    return DiaMatrix([int(o) for o in offsets], data, (n, n))


def _operator(spec, dtype, device):
    """A device matrix from plain arrays: a DIA pair, a windowed-ELL dict,
    a dense-window dict or a dense 2-D array."""
    if isinstance(spec, tuple):
        return _dia(spec, dtype, device)
    if isinstance(spec, dict):
        idx = lambda k: torch.tensor(np.asarray(spec[k]), dtype=torch.int32,
                                     device=device)
        if "blocks" in spec:
            return DenseWindowMatrix(
                idx("window_starts"), _tensor(spec["blocks"], dtype, device),
                spec["shape"], spec["win"])
        return WindowedEllMatrix(
            idx("window_starts"), idx("cols_local"),
            _tensor(spec["vals"], dtype, device), spec["shape"],
            spec["win"], spec.get("block", (1, 1)))
    return DenseMatrix(_tensor(spec, dtype, device))


def _smoother(spec, dtype, device):
    """A smoother state from the arrays of a ``"relax"`` dict (see
    :func:`hierarchy_from_arrays`)."""
    vec = lambda a: None if a is None else _tensor(a, dtype, device)
    if "scale" in spec:
        return ScaledResidualSmoother(vec(spec["scale"]))
    if "chebyshev" in spec:
        dinv, degree, theta, delta, scale = spec["chebyshev"]
        return ChebyshevState(vec(dinv), degree, theta, delta, scale)
    if "M" in spec:
        return Spai1State(_operator(spec["M"], dtype, device))
    if "masks" in spec:
        return MulticolorGS(vec(spec["masks"]))
    return ILU0State(_operator(spec["L"], dtype, device),
                     _operator(spec["U"], dtype, device), vec(spec["uinv"]),
                     spec["iters"])


def level_from_arrays(lv, dtype, device) -> Level:
    """One level of a hierarchy from plain arrays (keys as in
    :func:`hierarchy_from_arrays`, all but the coarsest level's), with the
    port's own fused V-cycle handles attached where the level is
    eligible (``ops/vcycle.py``)."""
    A = _operator(lv["A"], dtype, device)
    relax = _smoother(lv["relax"] if "relax" in lv
                      else {"scale": lv["scale"]}, dtype, device)
    if "P" in lv:
        # stored transfers (block systems): no fused legs
        return Level(A, relax, _operator(lv["P"], dtype, device),
                     _operator(lv["R"], dtype, device))
    if "agg" in lv:
        T = AggTentative.build(np.asarray(lv["agg"]), int(lv["n_agg"]),
                               device)
    else:
        fine = tuple(int(d) for d in lv["fine"])
        block = tuple(int(b) for b in lv["block"])
        coarse = tuple(-(-d // b) for d, b in zip(fine, block))
        T = GridTentative(fine, block, coarse)
    if "M" not in lv:
        # plain aggregation: P = T
        return Level(A, relax, TentativeP(T), TentativeR(T))
    P = ImplicitSmoothedP(T, _operator(lv["M"], dtype, device))
    R = ImplicitSmoothedR(T, _operator(lv["Mt"], dtype, device))
    return Level(A, relax, P, R, build_fused_down(A, R, relax),
                 build_fused_up(A, P, relax))


def hierarchy_from_arrays(levels, coarse_inv, params: AMGParams = None,
                          device=None) -> Hierarchy:
    """``levels``: one dict per level, finest first. Every level has
    ``"A"``: the operator as a DIA pair ``(offsets, data)`` with
    ``data[k, i] = A[i, i + offsets[k]]``, as a windowed-ELL dict (keys
    ``window_starts``, ``cols_local``, ``vals``, ``shape``, ``win`` and,
    for block values, ``block``: the arrays of
    :class:`~amgcl_tpu_torch.ops.unstructured.WindowedEllMatrix`), as a
    dense-window dict (keys ``window_starts``, ``blocks``, ``shape``,
    ``win``: the arrays of
    :class:`~amgcl_tpu_torch.ops.densewin.DenseWindowMatrix`) or as a
    dense 2-D array. Every level but the last also has its smoother and
    its transfers. The smoother is ``"scale"`` (the SPAI-0 or damped
    Jacobi diagonal, or its (n, b, b) blocks) or a ``"relax"`` dict:
    ``{"scale": w}`` likewise; ``{"chebyshev": (dinv, degree, theta,
    delta, scale)}`` (dinv None unless scale); ``{"M": op}`` (SPAI-1);
    ``{"masks": (ncolors, n)}`` (multicolour Gauss–Seidel's pre-scaled
    masks); ``{"L": op, "U": op, "uinv": (n,), "iters": k}`` (the ILU
    family: strict factors, U's inverted diagonal, Jacobi iterations),
    each op in the forms of ``"A"``. The transfers are either stored, as
    ``"P"`` and ``"R"`` in the same forms, or matrix-free with the
    tentative prolongation as either ``"fine"`` and ``"block"`` (grid
    dims and aggregation blocks) or ``"agg"`` and ``"n_agg"`` (the
    aggregate id of each fine point, -1 for none, and the aggregate
    count): smoothed with ``"M"`` and ``"Mt"`` (M = ω D⁻¹ A_f and its
    transpose), plain (P = T) without them.
    ``coarse_inv`` is the dense inverse of the last level's operator.
    ``params`` supplies the dtype and the cycle shape (npre, npost,
    ncycle, pre_cycles)."""
    prm = params or AMGParams()
    device = resolve_device(device)
    dtype = prm.dtype
    out = [level_from_arrays(lv, dtype, device) for lv in levels[:-1]]
    out.append(Level(_operator(levels[-1]["A"], dtype, device), None))
    inv = _tensor(coarse_inv, dtype, device)
    return Hierarchy(out, DenseDirectSolver(inv), prm.npre, prm.npost,
                     prm.ncycle, prm.pre_cycles)


def idrs_with_shadow(solver: IDRs, P) -> IDRs:
    """A copy of ``solver`` that runs on the shadow space ``P``, an
    (s, n) array (the JAX package's orthonormalized block, read out of
    ``amgcl_tpu.solver.idrs._shadow_block`` with ``np.asarray``), instead
    of drawing its own. The block is kept in float64 and cast to the
    working dtype at each solve, which checks its shape."""
    return dataclasses.replace(
        solver, shadow=torch.tensor(np.asarray(P, dtype=np.float64)))


def fused_slab_from_arrays(slab, device=None) -> FusedSlab:
    """The framed operands of one sharded stencil level from plain arrays.
    ``slab`` maps ``"a_fr"``, ``"mt_fr"``, ``"w_fr"`` and ``"m_fr"`` to
    per-shard frames (a sequence of arrays, one per shard, or an array
    whose leading axis is the shard; None for a leg that is not built):
    A's and Mᵀ's diagonals ``(nA, L)`` and ``(nMt, L)`` and the smoother
    scale ``(L,)`` framed by ``H`` rows, M's diagonals ``(nM, Lm)``
    framed by ``hp`` coarse planes. It also maps ``"H"``, ``"hp"``,
    ``"ldims"`` and ``"lcoarse"``: the fields of the JAX package's
    ``FusedSlab``, whose frames read out shard by shard (one
    ``addressable_shards`` entry each, with ``np.asarray``) serve as
    they are. The frames are float32, as the framed kernels take them;
    the flat offsets stay with the caller, as they stay with the level."""
    device = resolve_device(device)

    def frames(key):
        parts = slab.get(key)
        if parts is None:
            return None
        return [torch.tensor(np.asarray(p), dtype=torch.float32,
                             device=device) for p in parts]

    return FusedSlab(frames("a_fr"), frames("mt_fr"), frames("w_fr"),
                     frames("m_fr"), slab["H"], slab["hp"], slab["ldims"],
                     slab["lcoarse"])
