"""``make_solver`` — bundle an AMG preconditioner with a Krylov solver
behind one call (counterpart of ``amgcl_tpu/models/make_solver.py``;
reference: amgcl/make_solver.hpp:41-231), with float64 iterative
refinement.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from amgcl_tpu_torch.models.amg import AMG, AMGParams
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.solver.cg import CG
from amgcl_tpu_torch.telemetry.report import SolveReport


class make_solver:
    """P+S bundle: ``solve = make_solver(A, AMGParams(), CG())`` then
    ``x, info = solve(rhs)``; ``x`` is a tensor on the solver's device.

    The Krylov loop runs in the hierarchy's dtype on the hierarchy's own
    finest-level operator. ``refine > 0`` adds correction-form iterative
    refinement: the outer residual b − A x is evaluated in float64 through
    a float64 copy of the operator on the device (``A_dev64``), and up to
    ``refine`` correction solves run in the working precision.
    ``device=None`` means CUDA (see :class:`AMG`)."""

    def __init__(self, A, precond: AMGParams = None, solver: Any = None,
                 refine: int = 0, device=None):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        self.A_host = A
        precond = precond if precond is not None else AMGParams()
        if not isinstance(precond, AMGParams):
            raise TypeError("precond must be AMGParams, got %r"
                            % type(precond))
        self.precond = AMG(A, precond, device)
        self.device = self.precond.device
        self.dtype = self.precond.dtype
        self.solver = solver or CG()
        self.refine = int(refine)
        self.A_dev = self.precond.hierarchy.system_matrix
        self.A_dev64 = dev.to_device(A, "auto", torch.float64, self.device) \
            if self.refine > 0 else None

    def _vector(self, v, what):
        n = self.A_host.nrows
        t = torch.as_tensor(v).to(device=self.device, dtype=self.dtype)
        if tuple(t.shape) != (n,):
            raise ValueError("%s has shape %s but the system has %d "
                             "unknowns" % (what, tuple(t.shape), n))
        return t

    def __call__(self, rhs, x0=None):
        rhs = self._vector(rhs, "rhs")
        x0 = torch.zeros_like(rhs) if x0 is None else self._vector(x0, "x0")
        t0 = time.perf_counter()
        hier = self.precond.hierarchy

        def apply_precond(r):
            return hier.apply(r.to(self.dtype)).to(rhs.dtype)

        x, iters, resid, hs = self.solver.solve(self.A_dev, apply_precond,
                                                rhs, x0)
        if self.refine > 0:
            x, iters, resid = self._refine_loop(apply_precond, rhs, x,
                                                iters, hs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        report = SolveReport(
            int(iters), float(resid), wall_time_s=time.perf_counter() - t0,
            hierarchy=self.precond.hierarchy_stats(),
            health=None if hs is None else hs.names())
        return x, report

    def _refine_loop(self, apply_precond, rhs, x, iters, hs):
        """While the float64 relative residual exceeds tol (up to
        ``refine`` restarts), solve the correction in working precision
        and accumulate it in float64. A correction solve's guard flags
        merge into ``hs`` so a breakdown inside it reaches the report."""
        rhs64 = rhs.to(torch.float64)
        nb = float(dev.norm(rhs64))
        scale = nb if nb > 0 else 1.0
        tol = self.solver.tol
        state = x.to(torch.float64)
        r = dev.residual(rhs64, self.A_dev64, state)
        rt = float(dev.norm(r)) / scale
        k = 0
        while rt > tol and k < self.refine:
            dx, it2, _, ch = self.solver.solve(
                self.A_dev, apply_precond, r.to(rhs.dtype),
                torch.zeros_like(rhs), abstol=tol * scale)
            if hs is not None and ch is not None:
                hs.flags |= ch.flags
                hs.first_it = [a if a >= 0 else b
                               for a, b in zip(hs.first_it, ch.first_it)]
            state = state + dx.to(torch.float64)
            r = dev.residual(rhs64, self.A_dev64, state)
            rt = float(dev.norm(r)) / scale
            iters += it2
            k += 1
        return state, iters, rt

    def __repr__(self):
        return ("make_solver\n===========\nSolver: %s\n\nPreconditioner:\n%r"
                % (type(self.solver).__name__, self.precond))
