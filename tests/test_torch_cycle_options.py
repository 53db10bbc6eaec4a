"""The multigrid cycle's options against the JAX package: ``ncycle``,
``npre``/``npost``, ``pre_cycles``, ``coarse_enough``,
``direct_coarse=False`` and ``max_levels``, each through ``make_solver``
on poisson3d(24) in float64 with CG and BiCGStab at tol 1e-8, every
hierarchy built by each package itself. The iteration counts must be
identical and x within 1e-12 relative. (npre = 0 or npost = 0 makes the
preconditioner non-symmetric, and CG then runs to maxiter in both.)
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab
from amgcl_tpu.solver.cg import CG as RefCG

from amgcl_tpu_torch import AMGParams, BiCGStab, CG, make_solver, poisson3d

_OPTIONS = {
    "ncycle2": dict(ncycle=2),
    "npre2_npost2": dict(npre=2, npost=2),
    "npre0_npost1": dict(npre=0, npost=1),
    "npre1_npost0": dict(npre=1, npost=0),
    "pre_cycles2": dict(pre_cycles=2),
    "all_four": dict(ncycle=2, npre=2, npost=2, pre_cycles=2),
    "coarse_enough100": dict(coarse_enough=100),
    "iterative_coarse": dict(direct_coarse=False),
    "max_levels2": dict(max_levels=2),
}
_SOLVERS = {"CG": (CG, RefCG), "BiCGStab": (BiCGStab, RefBiCGStab)}
_PROBLEM = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS, OpenMP and torch thread while this module runs: its
    small problems gain nothing from threads, and the test suite's
    parallel workers would oversubscribe the cores (a dense coarse
    inverse or product in several workers at once then runs many times
    slower)."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


def _problem():
    if not _PROBLEM:
        A, rhs = poisson3d(24)
        _PROBLEM["p"] = A, RefCSR.from_scipy(A.to_scipy()), rhs
    return _PROBLEM["p"]


@pytest.mark.parametrize("solver", sorted(_SOLVERS))
@pytest.mark.parametrize("option", sorted(_OPTIONS))
def test_cycle_option_matches_jax(option, solver):
    A, A_ref, rhs = _problem()
    kw = _OPTIONS[option]
    port_cls, ref_cls = _SOLVERS[solver]
    x_r, info_r = ref_make_solver(A_ref, RefParams(dtype=jnp.float64, **kw),
                                  ref_cls(tol=1e-8))(rhs)
    solve = make_solver(A, AMGParams(dtype=torch.float64, **kw),
                        port_cls(tol=1e-8), device="cpu")
    x, info = solve(rhs)
    hier = solve.precond.hierarchy
    assert (hier.ncycle, hier.npre, hier.npost, hier.pre_cycles) == (
        kw.get("ncycle", 1), kw.get("npre", 1), kw.get("npost", 1),
        kw.get("pre_cycles", 1))
    x_r = np.asarray(x_r, np.float64)
    assert info.iters == info_r.iters
    assert np.linalg.norm(x.numpy() - x_r) <= 1e-12 * np.linalg.norm(x_r)
