"""BiCGStab iteration counts of the JAX package and of the port on the
CPU for the ILU smoothers on a scaled-down U1 system.

    JAX_PLATFORMS=cpu python reference_counts.py [ROWS]

``fe_like_problem(ROWS)`` (12,000 rows by default, U1's nonzeros a row)
with each of ILU(0), ILU(k=1) and ILU(p=1) under
``BiCGStab(maxiter=100, tol=1e-6)``, refine=3, as chip_smoke.py's paths
IL0, ILK and ILP call it, once with a float32 and once with a float64
hierarchy: one line per case with both packages' iterations (summed over
the refinement's restarts) and reported residuals. A full-size run (U1's
85,623 rows) is a chip-sized job this script is not meant for. It is the
source of chip_smoke.py's choice of float64 hierarchies for ILK and ILP.
"""

import sys

import torch
import jax
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.relaxation import ilu0 as ref_ilu
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab

import amgcl_tpu_torch as T

U1_NNZ_PER_ROW = 2634905 / 85623


def main(rows=12000):
    jax.config.update("jax_enable_x64", True)
    A, rhs = T.fe_like_problem(rows, nnz_target=int(U1_NNZ_PER_ROW * rows))
    A_ref = RefCSR(A.ptr, A.col, A.val, A.ncols)
    cases = [("ILU0", ref_ilu.ILU0(), T.ILU0()),
             ("ILUK(k=1)", ref_ilu.ILUK(k=1), T.ILUK(k=1)),
             ("ILUP(p=1)", ref_ilu.ILUP(), T.ILUP())]
    for name, ref_relax, relax in cases:
        for dt in ("float32", "float64"):
            _, info_r = ref_make_solver(
                A_ref, RefParams(dtype=getattr(jnp, dt), relax=ref_relax),
                RefBiCGStab(maxiter=100, tol=1e-6), refine=3)(rhs)
            solve = T.make_solver(
                A, T.AMGParams(dtype=getattr(torch, dt), relax=relax),
                T.BiCGStab(maxiter=100, tol=1e-6), refine=3, device="cpu")
            _, info = solve(rhs)
            print("%d rows %-9s %s: JAX %d iterations (resid %.2e), port %d "
                  "(resid %.2e)" % (rows, name, dt, info_r.iters,
                                    info_r.resid, info.iters, info.resid),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
