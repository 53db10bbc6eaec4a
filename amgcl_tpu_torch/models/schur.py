"""Schur pressure correction for 2×2 block (u, p) systems (counterpart of
``amgcl_tpu/models/schur.py``; reference:
amgcl/preconditioner/schur_pressure_correction.hpp:58-635).

Given a saddle-point system

    [ Kuu  Kup ] [u]   [fu]
    [ Kpu  Kpp ] [p] = [fp]

the preconditioner applies

    p = Psolve( fp − Kpu · Usolve(fu) )
    u = Usolve( fu − Kup · p )

where Psolve solves with the Schur complement S = Kpp − Kpu Kuu⁻¹ Kup
applied matrix-free (schur_pressure_correction.hpp:258-283):

- ``approx_schur``: Kuu⁻¹ inside S·x is replaced by the diagonal
  approximation M = dia(Kuu)⁻¹;
- ``simplec_dia``: M uses the row sums of |Kuu| (SIMPLEC) instead of the
  diagonal (hpp:429-441);
- ``adjust_p``: the matrix the pressure AMG is built on (hpp:443-496):
  0 = Kpp, 1 = Kpp − dia(Kpu M Kup) (default), 2 = Kpp − Kpu M Kup.
  For 1 the subtracted diagonal Ld is added back in S·x; for 2 the S·x
  base is the unmodified Kpp (hpp:264-271).

Kup and Kpu move to the device as ELL, whose product is a plain gather in
both packages (the JAX one is XLA, not Pallas); every other product runs
through the level operators' kernels.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import scipy.sparse as sp
import torch

from amgcl_tpu_torch.models.amg import (AMG, AMGParams, apply_columns,
                                        check_dtype)
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.solver.preonly import PreOnly
from amgcl_tpu_torch.utils.devices import resolve_device


def kuu_dinv(Kuu: CSR, simplec_dia: bool) -> np.ndarray:
    """Inverted Kuu diagonal approximation M (hpp:429-441): SIMPLEC row
    |·| sums or the plain diagonal."""
    if simplec_dia:
        duu = np.asarray(abs(Kuu.to_scipy()).sum(axis=1)).ravel()
    else:
        duu = Kuu.diagonal().real
    return 1.0 / np.where(duu != 0, duu, 1.0)


def schur_pressure_build(Kpp_s, Kpu_s, Kup_s, dinv, adjust_p):
    """(p_build, Ld): the matrix the pressure hierarchy is built on and,
    for adjust_p=1, the subtracted diagonal (hpp:443-496);
    diag(Kpu M Kup)_i = Σ_k Kpu[i,k]·M[k]·Kup[k,i] without the SpGEMM."""
    if adjust_p == 1:
        Ldv = np.asarray(
            Kpu_s.multiply(dinv[None, :])
            .multiply(Kup_s.T.tocsr()).sum(axis=1)).ravel()
        return (Kpp_s - sp.diags(Ldv)).tocsr(), Ldv
    if adjust_p == 2:
        return (Kpp_s - (Kpu_s.multiply(dinv[None, :]) @ Kup_s)).tocsr(), \
            None
    return Kpp_s.tocsr(), None


def _in_dtype(hier):
    """``hier.apply`` taking and returning the caller's dtype: an inner
    hierarchy may hold another dtype than the Schur system."""
    dtype = hier.system_matrix.dtype

    def apply(v):
        return hier.apply(v.to(dtype)).to(v.dtype)
    return apply


def _usolve(usolver, u_hier, f):
    """Kuu⁻¹ f by ``usolver`` on the velocity hierarchy's own finest
    operator (Kuu on the device), in that hierarchy's dtype."""
    Kuu = u_hier.system_matrix
    return usolver.solve(Kuu, u_hier.apply, f.to(Kuu.dtype))[0].to(f.dtype)


class SchurOperator:
    """Matrix-free Schur complement y = S x, the operator the pressure
    solver iterates with (hpp:258-283). ``base`` is Kpp (adjusted for
    adjust_p=1), ``Ld`` restores the adjust_p=1 diagonal, ``M`` is the
    inverted (SIMPLEC) Kuu diagonal."""

    def __init__(self, base, Ld, Kup, Kpu, M, u_hier, usolver,
                 approx_schur):
        self.base = base
        self.Ld = Ld
        self.Kup = Kup
        self.Kpu = Kpu
        self.M = M
        self.u_hier = u_hier
        self.usolver = usolver
        self.approx_schur = bool(approx_schur)
        self.shape = base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def mv(self, x):
        y = self.base.mv(x)
        if self.Ld is not None:
            y = y + self.Ld * x
        t = dev.spmv(self.Kup, x)
        if self.approx_schur:
            u = self.M * t
        else:
            u = _usolve(self.usolver, self.u_hier, t)
        return y - dev.spmv(self.Kpu, u)

    def bytes(self):
        return 0


class SchurHierarchy:
    """The preconditioner state of the Schur correction. ``A`` is the
    full system on the host: its device copy (``system_matrix``) is made
    on first use, as only an enclosing nested preconditioner iterates on
    it (``make_solver`` converts A itself for a prebuilt
    preconditioner)."""

    def __init__(self, A, dtype, device, Kup, Kpu, S, u_hier, p_hier,
                 u_idx, p_idx, usolver, psolver):
        self.A_host = A
        self.dtype = dtype
        self.device = device
        self._A_dev = None
        self.Kup = Kup
        self.Kpu = Kpu
        self.S = S                  # SchurOperator (matrix-free)
        self.u_hier = u_hier
        self.p_hier = p_hier
        self.u_idx = u_idx
        self.p_idx = p_idx
        self.usolver = usolver
        self.psolver = psolver

    def _usolve(self, f):
        return _usolve(self.usolver, self.u_hier, f)

    def _psolve(self, f):
        return self.psolver.solve(self.S, _in_dtype(self.p_hier), f)[0]

    #: the velocity and pressure solves are Krylov loops
    host_sync = "the inner velocity and pressure solves sync with the " \
        "host each iteration"

    def apply(self, r):
        if r.dim() == 2:
            return apply_columns(self.apply, r)
        fu = r[self.u_idx]
        fp = r[self.p_idx]
        u1 = self._usolve(fu)
        p = self._psolve(fp - dev.spmv(self.Kpu, u1))
        u = self._usolve(fu - dev.spmv(self.Kup, p))
        out = torch.zeros_like(r)
        out[self.u_idx] = u
        out[self.p_idx] = p
        return out

    @property
    def system_matrix(self):
        if self._A_dev is None:
            self._A_dev = dev.to_device(self.A_host, "auto", self.dtype,
                                        self.device)
        return self._A_dev


class SchurPressureCorrection:
    """Preconditioner object for ``make_solver(A, precond=...)``.

    ``pmask``: boolean array marking pressure rows. ``usolver_prm`` /
    ``psolver_prm``: AMGParams of the two inner hierarchies (default
    ``AMGParams(dtype=dtype)``). ``usolver``/``psolver``: inner Krylov
    objects, default one preconditioner application (PreOnly).
    ``simplec_dia``/``approx_schur``/``adjust_p`` follow the reference's
    params (module docstring). ``device``/``device_setup`` as for
    :class:`AMG`."""

    def __init__(self, A, pmask, usolver_prm: Optional[AMGParams] = None,
                 psolver_prm: Optional[AMGParams] = None,
                 usolver: Any = None, psolver: Any = None,
                 simplec_dia: bool = True, approx_schur: bool = False,
                 adjust_p: int = 1, dtype=torch.float32, device=None,
                 device_setup=None):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        if adjust_p not in (0, 1, 2):
            raise ValueError("adjust_p must be 0, 1 or 2 (got %r)"
                             % (adjust_p,))
        pmask = np.asarray(pmask, dtype=bool)
        if pmask.shape != (A.nrows,):
            raise ValueError("pmask must have one entry per row (%d), got %s"
                             % (A.nrows, pmask.shape))
        if not pmask.any() or pmask.all():
            raise ValueError(
                "pmask selects %d of %d rows as pressure — the Schur "
                "correction needs a proper 2x2 split"
                % (int(pmask.sum()), A.nrows))
        self.dtype = check_dtype(dtype)
        self.device = device = resolve_device(device)
        self.approx_schur = bool(approx_schur)
        self.adjust_p = int(adjust_p)
        m = A.to_scipy()
        ui = np.flatnonzero(~pmask)
        pi = np.flatnonzero(pmask)
        mu, mp = m[ui], m[pi]
        Kuu = CSR.from_scipy(mu[:, ui].tocsr())
        Kup = CSR.from_scipy(mu[:, pi].tocsr())
        Kpu = CSR.from_scipy(mp[:, ui].tocsr())
        Kpp_s = mp[:, pi].tocsr()
        dinv = kuu_dinv(Kuu, simplec_dia)
        p_build, Ldv = schur_pressure_build(
            Kpp_s, Kpu.to_scipy(), Kup.to_scipy(), dinv, adjust_p)
        # S·x base: the adjusted matrix for adjust_p=1 (Ld restores it),
        # the unmodified Kpp otherwise (hpp:264-271)
        Kpp_base = p_build if adjust_p == 1 else Kpp_s
        p_build.sort_indices()
        P_build = CSR.from_scipy(p_build)
        uprm = usolver_prm or AMGParams(dtype=dtype)
        pprm = psolver_prm or AMGParams(dtype=dtype)
        self.u_amg = AMG(Kuu, uprm, device, device_setup)
        self.p_amg = AMG(P_build, pprm, device, device_setup)
        usol = usolver or PreOnly()
        psol = psolver or PreOnly()

        def put(a):
            return torch.as_tensor(a, device=device).to(dtype)

        Kup_dev = dev.to_device(Kup, "ell", dtype, device)
        Kpu_dev = dev.to_device(Kpu, "ell", dtype, device)
        Kpp_base.sort_indices()
        S_base = dev.to_device(CSR.from_scipy(Kpp_base), "auto", dtype,
                               device)
        S_op = SchurOperator(
            S_base, None if Ldv is None else put(Ldv), Kup_dev, Kpu_dev, put(dinv),
            self.u_amg.hierarchy, usol, approx_schur)
        self.hierarchy = SchurHierarchy(
            A, dtype, device, Kup_dev, Kpu_dev, S_op,
            self.u_amg.hierarchy, self.p_amg.hierarchy,
            torch.as_tensor(ui, device=device),
            torch.as_tensor(pi, device=device),
            usol, psol)

    def __repr__(self):
        return ("schur_pressure_correction\n[ U ]\n%r\n[ P ]\n%r"
                % (self.u_amg, self.p_amg))
