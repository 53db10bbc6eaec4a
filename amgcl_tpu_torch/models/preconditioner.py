"""Single-level and nested preconditioners (counterpart of
``amgcl_tpu/models/preconditioner.py``; reference:
amgcl/relaxation/as_preconditioner.hpp:42-125,
amgcl/preconditioner/dummy.hpp:44-105,
amgcl/preconditioner/runtime.hpp:147-158): any smoother as a standalone
preconditioner, the identity, and a whole inner Krylov solve as the
preconditioner of an outer one. Each has the surface ``make_solver``
takes: ``.hierarchy`` (``apply``, ``system_matrix``), ``dtype`` and
``device``.
"""

from __future__ import annotations

import torch

from amgcl_tpu_torch.models.amg import apply_columns, check_dtype
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.utils.devices import resolve_device


class SingleLevelHierarchy:
    """The hierarchy surface over one operator and one smoother state
    (None: the identity)."""

    def __init__(self, A, state=None):
        self.A = A
        self.state = state

    def apply(self, r):
        if self.state is None:
            return r
        if r.dim() == 2:
            return apply_columns(self.apply, r)
        return self.state.apply(self.A, r)

    @property
    def system_matrix(self):
        return self.A


class AsPreconditioner:
    """A relaxation policy as a one-shot preconditioner."""

    def __init__(self, A, relax, dtype=torch.float32, matrix_format="auto",
                 device=None):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        self.A_host = A
        self.dtype = check_dtype(dtype)
        self.device = resolve_device(device)
        A_dev = dev.to_device(A, matrix_format, dtype, self.device)
        state = relax.build(A, dtype, self.device)
        self.hierarchy = SingleLevelHierarchy(A_dev, state)

    def __repr__(self):
        return "as_preconditioner(%s)" % type(self.hierarchy.state).__name__


class DummyPreconditioner:
    """The identity: a plain Krylov run through the same composition
    machinery (reference: amgcl/preconditioner/dummy.hpp)."""

    def __init__(self, A, dtype=torch.float32, matrix_format="auto",
                 device=None):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        self.A_host = A
        self.dtype = check_dtype(dtype)
        self.device = resolve_device(device)
        self.hierarchy = SingleLevelHierarchy(
            dev.to_device(A, matrix_format, dtype, self.device))

    def __repr__(self):
        return "dummy"


class NestedHierarchy:
    """A full inner Krylov solve (solver + inner preconditioner) as the
    preconditioner application: the runtime's ``class=nested``. Pair it
    with a flexible outer solver (FGMRES) when the inner solve is
    iterative: it is a nonstationary operator."""

    #: the inner Krylov loop fetches its scalars every iteration
    host_sync = "the inner Krylov solve syncs with the host each iteration"

    def __init__(self, A, inner, solver, inner_dtype):
        self.A = A                    # device matrix of the inner solve
        self.inner = inner            # inner preconditioner hierarchy
        self.solver = solver          # inner Krylov object
        self.inner_dtype = inner_dtype

    def apply(self, r):
        if r.dim() == 2:
            return apply_columns(self.apply, r)

        def prec(v):
            return self.inner.apply(
                v.to(self.inner_dtype)).to(v.dtype)

        return self.solver.solve(self.A, prec, r.to(self.A.dtype))[0] \
            .to(r.dtype)

    @property
    def system_matrix(self):
        return self.A


class NestedPreconditioner:
    """``precond.class=nested``: an inner preconditioner object (with
    ``.hierarchy``) and an inner solver as one preconditioner. The inner
    solve runs on the inner hierarchy's own operator."""

    def __init__(self, A, inner_precond, solver, dtype=None,
                 matrix_format="auto"):
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        self.A_host = A
        self.inner = inner_precond
        self.device = torch.device(inner_precond.device)
        inner_dtype = getattr(inner_precond, "dtype", None) \
            or inner_precond.prm.dtype
        # the inner Krylov loop runs on the hierarchy's own operator (a
        # bfloat16 hierarchy's: a bfloat16 loop, as in the JAX package)
        self.dtype = check_dtype(dtype or inner_dtype)
        hier_A = getattr(inner_precond.hierarchy, "system_matrix", None)
        A_dev = hier_A if hier_A is not None else dev.to_device(
            A, matrix_format, self.dtype, self.device)
        self.hierarchy = NestedHierarchy(
            A_dev, inner_precond.hierarchy, solver, inner_dtype)

    def __repr__(self):
        return "nested(%s over\n%r)" % (type(self.hierarchy.solver).__name__,
                                        self.inner)
