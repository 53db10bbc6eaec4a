"""The whole slice — poisson3d(32), SA + SPAI-0 + CG with float64
refinement — against the JAX package, plus the port's isolation from JAX
and its device rule."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.solver.cg import CG as RefCG
from amgcl_tpu.utils.sample_problem import poisson3d as ref_poisson3d

import amgcl_tpu_torch
from amgcl_tpu_torch import AMGParams, CG, make_solver, poisson3d
from amgcl_tpu_torch.convert import hierarchy_from_arrays

ROOT = pathlib.Path(__file__).resolve().parent.parent
_HEADLINE = dict(maxiter=100, tol=1e-6)


def _true_resid(A, rhs, x):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_headline_configuration_matches_jax(dtype):
    """make_solver(A, AMGParams(dtype), CG(maxiter=100, tol=1e-6),
    refine=3): float64 gives the same iterations and x within 1e-8;
    float32 comes within one iteration, with true residual <= 1e-6."""
    A_ref, rhs = ref_poisson3d(32)
    A, _ = poisson3d(32)
    x_r, info_r = ref_make_solver(
        A_ref, RefParams(dtype=getattr(jnp, dtype)), RefCG(**_HEADLINE),
        refine=3)(rhs)
    solve = make_solver(A, AMGParams(dtype=getattr(torch, dtype)),
                        CG(**_HEADLINE), refine=3, device="cpu")
    x, info = solve(rhs)
    iters, resid = info                     # the reference's pair unpack
    assert x.dtype == torch.float64 and x.shape == (A.nrows,)
    assert info.health == []
    assert [lv["rows"] for lv in info.hierarchy["levels"]] \
        == [32768, 4096, 512]
    x_r = np.asarray(x_r, np.float64)
    if dtype == "float64":
        assert iters == info_r.iters == 9
        assert np.linalg.norm(x.numpy() - x_r) <= 1e-8 * np.linalg.norm(x_r)
    else:
        assert info_r.iters == 11
        assert abs(iters - info_r.iters) <= 1
        assert _true_resid(A, rhs, x.numpy()) <= 1e-6
    assert resid <= 1e-6
    np.testing.assert_allclose(_true_resid(A, rhs, x.numpy()), resid,
                               rtol=1e-6)


@pytest.fixture(scope="module")
def jax_hierarchy():
    A_ref, rhs = ref_poisson3d(32)
    return A_ref, rhs, RefAMG(A_ref, RefParams(dtype=jnp.float64))


def _arrays(ref):
    """The JAX hierarchy as the plain arrays hierarchy_from_arrays takes."""
    levels = []
    for lv in ref.hierarchy.levels:
        A = lv.A
        row = {"A": (A.offsets, np.asarray(A.data)) if hasattr(A, "offsets")
               else np.asarray(A.a)}
        if lv.P is not None:
            row.update(M=(lv.P.M.offsets, np.asarray(lv.P.M.data)),
                       Mt=(lv.R.Mt.offsets, np.asarray(lv.R.Mt.data)),
                       fine=lv.P.T.fine, block=lv.P.T.block,
                       scale=np.asarray(lv.relax.scale))
        levels.append(row)
    return levels, np.asarray(ref.hierarchy.coarse.inv)


def test_hierarchy_from_arrays_apply_and_cg_match(jax_hierarchy):
    """On an identical hierarchy the cycle and CG agree with the JAX
    package: one preconditioner application, then the CG iteration
    count in float64."""
    A_ref, rhs, ref = jax_hierarchy
    levels, inv = _arrays(ref)
    hier = hierarchy_from_arrays(levels, inv,
                                 AMGParams(dtype=torch.float64), "cpu")
    r = np.random.RandomState(11).standard_normal(A_ref.nrows)
    z_ref = np.asarray(ref.hierarchy.apply(jnp.asarray(r)))
    z = hier.apply(torch.as_tensor(r)).numpy()
    assert np.max(np.abs(z - z_ref)) <= 1e-10 * np.abs(z_ref).max()

    _, info_r = ref_make_solver(A_ref, ref, RefCG(tol=1e-8))(rhs)
    x, iters, resid, hs = CG(tol=1e-8).solve(
        hier.system_matrix, hier.apply, torch.as_tensor(rhs))
    assert iters == info_r.iters
    assert hs.flags == 0
    np.testing.assert_allclose(resid, info_r.resid, rtol=1e-4)


def test_cg_zero_rhs_returns_zero():
    A, _ = poisson3d(16)
    solve = make_solver(A, AMGParams(dtype=torch.float64), CG(tol=1e-8),
                        device="cpu")
    x, info = solve(np.zeros(A.nrows))
    assert info.iters == 0 and not torch.any(x)
    with pytest.raises(ValueError, match="unknowns"):
        solve(np.ones(A.nrows + 1))


def test_package_imports_no_jax_in_a_fresh_process():
    code = (
        "import sys, numpy as np\n"
        "import amgcl_tpu_torch as T\n"
        "A, b = T.poisson3d(16)\n"
        "x, info = T.make_solver(A, T.AMGParams(), T.CG(tol=1e-6),\n"
        "                        refine=1, device='cpu')(b)\n"
        "assert info.iters > 0 and info.resid <= 1e-6, info\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'amgcl_tpu' or m.startswith('amgcl_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "amgcl_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "amgcl_tpu"), (path, mod)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, _ = poisson3d(8)
    for build in (lambda: make_solver(A),
                  lambda: amgcl_tpu_torch.AMG(A),
                  lambda: amgcl_tpu_torch.ops.device.to_device(A)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_unstructured_operator_takes_aggregate_route():
    """Without a detectable grid the setup aggregates greedily over the
    strength graph and the device applies the tentative prolongation by
    aggregate ids; the solve converges to the true residual."""
    import scipy.sparse as sp
    from amgcl_tpu_torch.ops.structured import AggTentative
    A, rhs = poisson3d(16)
    perm = np.random.RandomState(3).permutation(A.nrows)
    Ap = amgcl_tpu_torch.CSR.from_scipy(A.to_scipy()[perm][:, perm])
    solve = make_solver(Ap, AMGParams(dtype=torch.float64, coarse_enough=500),
                        CG(tol=1e-8), device="cpu")
    hier = solve.precond.hierarchy
    assert len(hier.levels) >= 2
    T = hier.levels[0].P.T
    assert isinstance(T, AggTentative)
    # the tentative operator is the 0/1 aggregate matrix, both directions
    agg = T.agg.numpy()
    P = sp.csr_matrix((np.ones(len(agg)), (np.arange(len(agg)), agg)),
                      shape=T.shape)
    v = np.random.RandomState(4).standard_normal(T.shape[1])
    w = np.random.RandomState(5).standard_normal(T.shape[0])
    np.testing.assert_allclose(T.mv(torch.as_tensor(v)).numpy(), P @ v)
    # segment sums as differences of one float64 prefix scan: the error
    # scales with the running prefix, not with each segment
    rw = T.rmv(torch.as_tensor(w)).numpy()
    assert np.max(np.abs(rw - P.T @ w)) <= 1e-12 * np.abs(w).sum()
    x, info = solve(rhs)
    assert info.iters < 40 and _true_resid(Ap, rhs, x.numpy()) <= 1e-8
