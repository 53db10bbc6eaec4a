"""``make_solver`` — bundle a preconditioner with a Krylov solver behind
one call (counterpart of ``amgcl_tpu/models/make_solver.py``; reference:
amgcl/make_solver.hpp:41-231), with iterative refinement.

Mixed precision comes at this seam: the preconditioner may live in a lower
precision than the Krylov iteration (reference:
amgcl/backend/detail/mixing.hpp:45-73, examples/mixed_precision.cpp:32-44);
the apply casts the residual down and the correction back up.
"""

from __future__ import annotations

import inspect
import time
import warnings
from typing import Any

import numpy as np
import torch

from amgcl_tpu_torch.models.amg import AMG, AMGParams, check_dtype
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.ops.dfloat import df_add_vec, dia_residual_df
from amgcl_tpu_torch.serve.batched import (CAPTURE_LOCK, StackedPrecond,
                                           decode_batched_health)
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.solver.cg import CG
from amgcl_tpu_torch.telemetry.report import SolveReport
from amgcl_tpu_torch.telemetry.structure import fingerprint
from amgcl_tpu_torch.utils.devices import resolve_device


class make_solver:
    """P+S bundle: ``solve = make_solver(A, AMGParams(), CG())`` then
    ``x, info = solve(rhs)``; ``x`` is a tensor on the solver's device.

    ``precond`` is an :class:`AMGParams` (the hierarchy is built here) or
    a prebuilt preconditioner: any object with ``.hierarchy`` (``apply``,
    ``system_matrix``), a ``dtype`` (or ``prm.dtype``) and a ``device``,
    which must be the one this bundle resolves. The Krylov loop runs in
    ``solver_dtype`` (default: the preconditioner's, so a bfloat16
    hierarchy runs a bfloat16 loop, as the JAX package's call does;
    ``solver_dtype=torch.float32`` keeps it in float32) on the hierarchy's own
    finest-level operator when the hierarchy was built here from A in that
    dtype and ``matrix_format`` is ``"auto"``, else on A converted to
    ``matrix_format``. ``refine > 0`` adds correction-form iterative
    refinement: the outer residual b − A x is evaluated beyond the working
    precision and up to ``refine`` correction solves run in it.
    ``refine_dtype`` picks the evaluation: ``"float64"`` (a float64 copy
    of the operator on the device), ``"df32"`` (compensated float32
    arithmetic on a float32 DIA operator, ``ops/dfloat.py``) or
    ``"auto"``, which is float64 here (the card has native float64, as the
    JAX package's choice off a TPU). ``recovery`` (A.13) is accepted only
    off. ``device=None`` means CUDA;
    ``device_setup``, ``reorder`` and ``device_inv`` go to the
    :class:`AMG` built here. When that hierarchy was reordered (or a
    prebuilt one was, for A's pattern; another pattern raises ValueError),
    every solver-side operator lives in its permuted frame: rhs and x0 are
    permuted in and x back out, so the caller never sees the permutation
    (amgcl_tpu/models/make_solver.py:75-97).

    A stacked (n, B) rhs solves its B columns together (A.11,
    ``serve/batched.py``): the report's ``iters`` and ``resid`` are the
    batch maxima and ``extra["per_rhs"]`` holds each column's; a stacked
    call with ``refine > 0`` raises ValueError, as the JAX package's
    does. ``batch`` is the declared bucket size B, which a
    :class:`~amgcl_tpu_torch.serve.SolverService` over this bundle takes
    by default."""

    def __init__(self, A, precond: Any = None, solver: Any = None,
                 solver_dtype=None, matrix_format: str = "auto",
                 refine: int = 0, refine_dtype: str = "auto",
                 batch: Any = None, recovery: Any = None, device=None,
                 device_setup=None, reorder="off", device_inv=False):
        # the setup moves host arrays to the device: never beside a
        # bucket capture in another thread (serve/batched.CAPTURE_LOCK)
        with CAPTURE_LOCK:
            self._setup(A, precond, solver, solver_dtype, matrix_format,
                        refine, refine_dtype, batch, recovery, device,
                        device_setup, reorder, device_inv)

    def _setup(self, A, precond, solver, solver_dtype, matrix_format, refine,
               refine_dtype, batch, recovery, device, device_setup, reorder,
               device_inv):
        self.batch = int(batch) if batch else None
        if self.batch is not None and self.batch < 1:
            raise ValueError("batch must be a positive bucket size, got %r"
                             % (batch,))
        if recovery:
            raise NotImplementedError(
                "recovery (the fault-tolerance ladder) is not ported yet "
                "(ROADMAP A.13)")
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        self.A_host = A
        precond = precond if precond is not None else AMGParams()
        if isinstance(precond, AMGParams):
            self.precond = AMG(A, precond, device, device_setup, reorder,
                               device_inv)
            self.precond_dtype = precond.dtype
            self._built_from_A = True
        elif hasattr(precond, "hierarchy"):
            # prebuilt preconditioner (AMG, AsPreconditioner, Schur, ...)
            self.precond = precond
            self.precond_dtype = getattr(precond, "dtype", None) \
                or precond.prm.dtype
            self._built_from_A = False
            own = resolve_device(device)
            if torch.device(precond.device) != own:
                raise ValueError(
                    "the prebuilt preconditioner lives on %s but this "
                    "solver runs on %s" % (precond.device, own))
        else:
            raise TypeError(
                "precond must be AMGParams or an object with .hierarchy, "
                "got %r" % type(precond))
        self.device = torch.device(self.precond.device)
        # the JAX package's default: the loop in the preconditioner's
        # dtype, bfloat16 for a bfloat16 hierarchy
        self.solver_dtype = check_dtype(solver_dtype or self.precond_dtype)
        self.solver = solver or CG()
        self.refine = int(refine)
        self.matrix_format = matrix_format
        if refine_dtype not in ("auto", "float64", "df32"):
            raise ValueError("refine_dtype must be 'auto', 'float64' or "
                             "'df32', got %r" % (refine_dtype,))
        Ah = self._frame(A)
        self._set_operator(Ah)
        self._stacked = None
        self.refine_mode = None
        self.A_dev64 = None
        self._df32_drift = None
        self._df32_checked = False
        if self.refine > 0:
            df32 = refine_dtype == "df32"
            if df32 and not (isinstance(self.A_dev, dev.DiaMatrix)
                             and self.solver_dtype == torch.float32):
                raise ValueError(
                    "refine_dtype='df32' needs a float32 DIA system "
                    "matrix; use refine_dtype='float64'")
            self.refine_mode = "df32" if df32 else "float64"
            self._set_wide_operator(Ah)
            if df32 and not self._df32_selfcheck(Ah):
                # the error-free transforms assume every float32 operation
                # rounds once; one check on the device against a host
                # float64 reference catches a backend that does not
                warnings.warn(
                    "df32 compensated residual failed its on-device "
                    "accuracy self-check; falling back to "
                    "refine_dtype='float64'")
                self.refine_mode = "float64"
                self._set_wide_operator(Ah)

    def _frame(self, A):
        """A in the preconditioner's frame: the hierarchy's permuted fine
        operator when the preconditioner was reordered (A's values taken
        through ``val_perm`` for a prebuilt one), else A; sets the
        permutation pair the solves use."""
        plan = getattr(self.precond, "reorder_plan", None)
        self._perm = None
        if plan is None:
            return A
        if fingerprint(A) != plan["fingerprint"]:
            raise ValueError(
                "the prebuilt preconditioner was reordered for another "
                "sparsity pattern than the system matrix's; build it from "
                "this matrix or with reorder='off'")
        self._perm = tuple(torch.as_tensor(p, device=self.device)
                           for p in (plan["perm"], plan["iperm"]))
        hl0 = self.precond.host_levels[0][0]
        if self._built_from_A:
            return hl0
        return CSR(hl0.ptr, hl0.col, np.asarray(A.val)[plan["val_perm"]],
                   A.ncols)

    def _set_operator(self, A):
        """The Krylov operator: the hierarchy's finest one when it is A
        in this dtype and format, else A converted, drawing on the
        hierarchy's dense-window budget where it has one."""
        hier_A = getattr(self.precond.hierarchy, "system_matrix", None) \
            if self._built_from_A else None
        if (hier_A is not None and self.solver_dtype == self.precond_dtype
                and self.matrix_format == "auto"):
            self.A_dev = hier_A
        else:
            self.A_dev = dev.to_device(
                A, self.matrix_format, self.solver_dtype, self.device,
                getattr(self.precond, "_dwin_budget", None))

    def _set_wide_operator(self, A):
        """The refinement's operator: the float32 remainders for df32,
        a float64 copy of A otherwise."""
        if self.refine_mode == "df32":
            self.A_dev64 = dev.csr_to_dia_remainder(A, self.A_dev)
        else:
            self.A_dev64 = dev.to_device(A, self.matrix_format,
                                         torch.float64, self.device)

    def _df32_selfcheck(self, A) -> bool:
        """One-shot device-against-host check of the compensated
        residual: ‖r_df − r64‖ must sit well below the plain float32
        evaluation's error on a probe where b = f32(A x), i.e. total
        cancellation (amgcl_tpu/models/make_solver.py:204-233)."""
        rng = np.random.RandomState(23)
        n = A.nrows
        x32 = rng.rand(n).astype(np.float32)
        ax64 = A.spmv(x32.astype(np.float64))
        b32 = ax64.astype(np.float32)
        r64 = b32.astype(np.float64) - ax64
        b = torch.as_tensor(b32, device=self.device)
        x = torch.as_tensor(x32, device=self.device)
        zeros = torch.zeros_like(b)
        r_df = dia_residual_df(self.A_dev.offsets, self.A_dev.data,
                               self.A_dev64.data, b, zeros, x, zeros)
        r_f32 = dev.residual(b, self.A_dev, x)
        err_df = float(np.linalg.norm(
            r_df.double().cpu().numpy() - r64))
        err_f32 = float(np.linalg.norm(
            r_f32.double().cpu().numpy() - r64))
        return err_df < 1e-2 * err_f32 + 1e-12 * n

    def rebuild(self, A):
        """Fast path for time-dependent problems: rebuild the
        preconditioner (reusing what its rebuild contract keeps) and
        refresh the solver-side operators — the Krylov operator, and the
        float64 or df32 refinement operator — so later calls solve the
        new system (amgcl_tpu/models/make_solver.py:235-288). Never
        beside a bucket capture in another thread (as the constructor)."""
        with CAPTURE_LOCK:
            self._rebuild(A)

    def _rebuild(self, A):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        if not hasattr(self.precond, "rebuild"):
            raise TypeError("preconditioner %r does not support rebuild"
                            % type(self.precond).__name__)
        self.precond.rebuild(A)
        self._stacked = None            # the buckets' graphs hold the old
        self.A_host = A                 # hierarchy's buffers
        Ah = self._frame(A)
        self._set_operator(Ah)
        if self.refine > 0:
            if self.refine_mode == "df32" \
                    and not isinstance(self.A_dev, dev.DiaMatrix):
                raise ValueError(
                    "rebuilt matrix is no longer DIA-eligible; df32 "
                    "refinement needs a DIA system matrix — construct a "
                    "new solver with refine_dtype='float64'")
            self._set_wide_operator(Ah)

    # -- eviction and readmission (serve/farm.py's admission) -------------

    def release_device(self):
        """Eviction (amgcl_tpu/models/make_solver.py:289-312): drop the
        bundle's device state — the Krylov and refinement operators, the
        reorder's device pair, the stacked preconditioner with its bucket
        graphs, their static buffers and private pools — and, through the
        preconditioner's own ``release_device``, its hierarchy. The host
        matrix, the parameters and the setup plans are kept, so that
        :meth:`readmit` is a rebuild."""
        self._stacked = None
        self.A_dev = None
        self.A_dev64 = None
        self._perm = None
        rel = getattr(self.precond, "release_device", None)
        if callable(rel):
            rel()

    def readmit(self):
        """The device state again after :meth:`release_device`: a
        rebuild against the kept host matrix (a no-op while resident)."""
        if self.A_dev is None:
            self.rebuild(self.A_host)

    @property
    def n(self):
        """Unknowns of the system (scalar-expanded)."""
        return self.A_host.nrows * self.A_host.block_size[0]

    def _vector(self, v, what):
        t = torch.as_tensor(v).to(device=self.device,
                                  dtype=self.solver_dtype)
        if tuple(t.shape) != (self.n,):
            raise ValueError("%s has shape %s but the system has %d "
                             "unknowns" % (what, tuple(t.shape), self.n))
        return t

    def _block(self, v, what, cols=None):
        """A stacked operand as the (n, B) view of a (B, n) block in the
        solver dtype on the device."""
        t = torch.as_tensor(v).to(device=self.device,
                                  dtype=self.solver_dtype)
        if t.dim() != 2 or t.shape[0] != self.n or t.shape[1] < 1 \
                or (cols is not None and t.shape[1] != cols):
            raise ValueError("%s has shape %s but the system has %d "
                             "unknowns (a stacked operand is (n, B)%s)"
                             % (what, tuple(t.shape), self.n,
                                "" if cols is None else ", B = %d" % cols))
        return S.block(t)

    def stacked_precond(self):
        """The preconditioner of stacked solves (its bucket graphs on the
        card), made on first use and dropped by :meth:`rebuild`."""
        if self._stacked is None:
            hier = self.precond.hierarchy
            pdtype = self.precond_dtype

            def apply(r):
                return hier.apply(r.to(pdtype)).to(r.dtype)

            self._stacked = StackedPrecond(apply, hier, self.device)
        return self._stacked

    def solve_stacked(self, rhs, x0):
        """One stacked solve of (n, B) device blocks ``rhs`` and ``x0``
        in the caller's frame: ``(x, iters, resid, health, histories,
        timing)`` with per-column lists, the solver's
        :class:`StackedHealth` (None with guards off), the histories
        (None unless recording) and ``timing`` = ``{t0, t_solved,
        capture_s}`` (perf_counter seconds: the start, the device done;
        the bucket-capture seconds inside)."""
        if self.refine > 0:
            raise ValueError(
                "stacked multi-RHS solves do not support iterative "
                "refinement; build the bundle with refine=0")
        pre = self.stacked_precond()
        c0 = pre.capture_total_s
        t0 = time.perf_counter()
        if self._perm is not None:
            rhs = rhs.T[:, self._perm[0]].T
            x0 = x0.T[:, self._perm[0]].T
        got = self.solver.solve(self.A_dev, pre, rhs, x0)
        x, iters, resid, hs = got[:4]
        hists = got[4] if len(got) > 4 else None
        if self._perm is not None:
            x = x.T[:, self._perm[1]].T
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timing = {"t0": t0, "t_solved": time.perf_counter(),
                  "capture_s": pre.capture_total_s - c0}
        return x, iters, resid, hs, hists, timing

    def _call_stacked(self, rhs, x0):
        rhs = self._block(rhs, "rhs")
        x0 = torch.zeros_like(rhs) if x0 is None \
            else self._block(x0, "x0", rhs.shape[1])
        x, iters, resid, hs, hists, timing = self.solve_stacked(rhs, x0)
        wall = time.perf_counter() - timing["t0"]
        B = rhs.shape[1]
        per_rhs = {"iters": [int(v) for v in iters],
                   "resid": [float(v) for v in resid]}
        hist = None
        if hists is not None:
            per_rhs["history"] = [h[:k] for h, k in zip(hists, iters)]
            hist = per_rhs["history"][int(np.argmax(iters))]
        stats = getattr(self.precond, "hierarchy_stats", None)
        report = SolveReport(
            max(per_rhs["iters"]), max(per_rhs["resid"]), wall_time_s=wall,
            hierarchy=stats() if callable(stats) else None,
            health=None if hs is None
            else decode_batched_health(hs.flags, hs.first_it),
            history=hist, solver=type(self.solver).__name__,
            extra={"batch": B, "per_rhs": per_rhs,
                   "lowering": self.stacked_precond().lowering},
            solves_per_sec=round(B / wall, 3) if wall > 0 else None)
        return x, report

    def __call__(self, rhs, x0=None):
        if np.ndim(rhs) == 2:
            return self._call_stacked(rhs, x0)
        rhs = self._vector(rhs, "rhs")
        x0 = torch.zeros_like(rhs) if x0 is None else self._vector(x0, "x0")
        t0 = time.perf_counter()
        hier = self.precond.hierarchy
        pdtype = self.precond_dtype

        def apply_precond(r):
            return hier.apply(r.to(pdtype)).to(r.dtype)

        # the solve runs in the preconditioner's frame; ``rhs`` stays in
        # the caller's for the df32 check against A_host below
        rhs_d, x0_d = rhs, x0
        if self._perm is not None:
            rhs_d, x0_d = rhs[self._perm[0]], x0[self._perm[0]]
        got = self.solver.solve(self.A_dev, apply_precond, rhs_d, x0_d)
        x, iters, resid, hs = got[:4]
        # the history covers the initial solve only, as in the reference
        hist = got[4][:iters] if len(got) > 4 else None
        if self.refine > 0:
            x, iters, resid = self._refine(apply_precond, rhs_d, x, iters,
                                           hs)
        if self._perm is not None:
            x = x[self._perm[1]]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if self.refine_mode == "df32" and not self._df32_checked:
            self._df32_checked = True
            self._check_df32_runtime(rhs, x, float(resid))
        stats = getattr(self.precond, "hierarchy_stats", None)
        report = SolveReport(
            int(iters), float(resid), wall_time_s=wall,
            hierarchy=stats() if callable(stats) else None,
            health=None if hs is None else hs.names(), history=hist,
            # sticky once the first df32 solve drifted
            extra={"df32_drift": self._df32_drift}
            if self._df32_drift else None)
        return x, report

    def _refine(self, apply_precond, rhs, x, iters, hs):
        """The refinement's two residual evaluators over one loop
        (amgcl_tpu/models/make_solver.py:352-418): float64, on the wide
        operator; df32, the compensated float32 residual on the (hi, lo)
        operator pair with the float32 rhs taken as exact and the iterate
        carried as a (hi, lo) pair, combined in float64 at the end."""
        if self.refine_mode == "df32":
            A_hi, A_lo = self.A_dev, self.A_dev64
            zeros = torch.zeros_like(rhs)

            def true_res(st):
                return dia_residual_df(A_hi.offsets, A_hi.data, A_lo.data,
                                       rhs, zeros, st[0], st[1])

            state, iters, rt = self._refine_loop(
                apply_precond, rhs, (x, zeros), iters, rhs, true_res,
                lambda st, dx: df_add_vec(st[0], st[1], dx), hs)
            return (state[0].to(torch.float64)
                    + state[1].to(torch.float64)), iters, rt
        rhs64 = rhs.to(torch.float64)
        return self._refine_loop(
            apply_precond, rhs, x.to(torch.float64), iters, rhs64,
            lambda st: dev.residual(rhs64, self.A_dev64, st),
            lambda st, dx: st + dx.to(torch.float64), hs)

    def _refine_loop(self, apply_precond, rhs, state, iters, norm_src,
                     true_res, accumulate, hs):
        """While the scaled residual norm of ``true_res(state)`` exceeds
        tol (up to ``refine`` restarts), solve the correction in working
        precision and ``accumulate`` it into the state. A solver that
        takes ``abstol`` (CG) stops each correction solve at the global
        absolute target; one that does not (BiCGStab) stops at its
        relative tol, as in the reference. A correction solve's guard
        flags merge into ``hs`` so a breakdown inside it reaches the
        report."""
        nb = float(dev.norm(norm_src))
        scale = nb if nb > 0 else 1.0
        tol = self.solver.tol
        kw = {"abstol": tol * scale} if "abstol" in inspect.signature(
            self.solver.solve).parameters else {}
        r = true_res(state)
        rt = float(dev.norm(r)) / scale
        k = 0
        while rt > tol and k < self.refine:
            dx, it2, _, ch = self.solver.solve(
                self.A_dev, apply_precond, r.to(rhs.dtype),
                torch.zeros_like(rhs), **kw)[:4]
            if hs is not None and ch is not None:
                hs.flags |= ch.flags
                hs.first_it = [a if a >= 0 else b
                               for a, b in zip(hs.first_it, ch.first_it)]
            state = accumulate(state, dx)
            r = true_res(state)
            rt = float(dev.norm(r)) / scale
            iters += it2
            k += 1
        return state, iters, rt

    def _check_df32_runtime(self, rhs, x, reported):
        """One-shot check of the first df32 solve: the reported relative
        residual must agree with the host float64 residual of the
        returned x (amgcl_tpu/models/make_solver.py:849-877). On drift it
        warns and records ``df32_drift``, which every later report
        carries in ``extra``; returns the host residual."""
        b64 = rhs.double().cpu().numpy()
        x64 = x.double().cpu().numpy()
        nb = float(np.linalg.norm(b64))
        if nb == 0 or not np.all(np.isfinite(x64)):
            return None
        actual = float(np.linalg.norm(b64 - self.A_host.spmv(x64)) / nb)
        tol = float(self.solver.tol)
        if actual > max(10.0 * reported, 2.0 * tol) \
                and actual > 1e-12 * len(b64):
            self._df32_drift = {"reported": reported, "actual": actual}
            warnings.warn(
                "df32 refinement drift: the solve reports a relative "
                "residual of %.3e but the host float64 residual of the "
                "returned solution is %.3e; use refine_dtype='float64'"
                % (reported, actual))
        return actual

    def __repr__(self):
        return ("make_solver\n===========\nSolver: %s\n\nPreconditioner:\n%r"
                % (type(self.solver).__name__, self.precond))
