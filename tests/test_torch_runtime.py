"""The runtime configuration layer against the JAX package's
(amgcl_tpu/models/runtime.py): dotted, nested and JSON configurations
build the same solver and preconditioner parameters, unknown keys warn
and unknown types raise with the same messages, every precond.class
gives the JAX package's float64 count, and what the port has no kernels
for raises NotImplementedError."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from amgcl_tpu.models import runtime as R
from amgcl_tpu.ops.csr import CSR as RefCSR
from tests.test_coupled import drs_hard_reservoir

import amgcl_tpu_torch as T
from amgcl_tpu_torch.models import runtime as P


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS, OpenMP and torch thread while this module runs: its
    small problems gain nothing from threads, and the test suite's
    parallel workers would oversubscribe the cores."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


def _ref(A):
    return RefCSR(A.ptr, A.col, A.val, A.ncols)


def _fields(obj):
    """(class name, {field: value}) of a dataclass instance; dtypes by
    name, nested dataclasses likewise."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif f.name == "dtype":
            v = str(v).split(".")[-1].rstrip("'>")
        out[f.name] = v
    return type(obj).__name__, out


DOTTED = {
    "precond.coarsening.type": "smoothed_aggregation",
    "precond.coarsening.eps_strong": "0.04",
    "precond.relax.type": "damped_jacobi",
    "precond.relax.damping": "0.8",
    "precond.dtype": "float64",
    "precond.npre": "2",
    "precond.direct_coarse": "true",
    "solver.type": "cg",
    "solver.tol": "1e-8",
    "solver.maxiter": "100",
}


@pytest.mark.parametrize("form", ["dotted", "nested", "json", "overrides"])
def test_config_forms_build_what_the_jax_package_builds(form, tmp_path):
    """The same configuration as dotted keys, a nested dict, a JSON file
    or flat overrides: the port's solver and AMG parameters have the JAX
    package's classes and field values, and the solve its count."""
    A, rhs = T.poisson3d(8)
    cfg = P._nest(DOTTED)
    kw = {}
    if form == "dotted":
        prm = DOTTED
    elif form == "nested":
        prm = cfg
    elif form == "json":
        prm = str(tmp_path / "cfg.json")
        with open(prm, "w") as f:
            json.dump(cfg, f)
    else:
        prm, kw = None, DOTTED
    ref = R.make_solver_from_config(_ref(A), prm, **kw)
    got = P.make_solver_from_config(A, prm, device="cpu", **kw)
    assert _fields(got.solver) == _fields(ref.solver)
    ref_prm, prm_ = _fields(ref.precond.prm)[1], _fields(got.precond.prm)[1]
    assert prm_ == ref_prm
    _, info_r = ref(rhs)
    _, info = got(rhs)
    assert info.iters == info_r.iters and info.resid < 1e-8


def test_unknown_keys_warn_and_unknown_types_raise_as_in_jax():
    A, _ = T.poisson3d(6)
    for mod, AA, kw in ((R, _ref(A), {}), (P, A, dict(device="cpu"))):
        with pytest.warns(UserWarning, match=r"unknown parameter "
                          r"solver\.typo_field"):
            mod.make_solver_from_config(AA, {"solver.typo_field": 1,
                                             "precond.dtype": "float64"},
                                        **kw)
        with pytest.warns(UserWarning, match=r"unknown parameter "
                          r"precond\.nonsense"):
            mod.precond_params_from_dict({"nonsense": 1})
        for key, what in (("solver.type", "unknown solver"),
                          ("precond.relax.type", "unknown relaxation"),
                          ("precond.coarsening.type",
                           "unknown coarsening"),
                          ("precond.class", "unknown precond.class")):
            with pytest.raises(ValueError, match=what):
                mod.make_solver_from_config(AA, {key: "does_not_exist"},
                                            **kw)
    assert sorted(P.SOLVERS) == sorted(R.SOLVERS)
    assert sorted(P.RELAXATION) == sorted(R.RELAXATION)
    assert sorted(P.COARSENING) == sorted(R.COARSENING)
    assert sorted(P.DTYPES) == sorted(R.DTYPES)


def test_idrs_replacement_key_is_kept_as_in_jax():
    """``{"type": "idrs", "replacement": true}`` through the runtime
    configuration: no "unknown parameter" warning, the key kept on the
    solver, as the JAX package keeps it."""
    import warnings
    A, _ = T.poisson3d(6)
    cfg = {"solver": {"type": "idrs", "replacement": True}}
    ref = R.make_solver_from_config(_ref(A), cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = P.make_solver_from_config(A, cfg, device="cpu")
    assert got.solver.replacement is True
    assert ref.solver.replacement is True
    assert P.solver_from_params({"type": "idrs", "replacement": "true"}) \
        .replacement is True


@pytest.mark.parametrize("pattern,expected", [("%3:4", [3, 7]),
                                              (">5", [5, 6, 7]),
                                              ("<2", [0, 1])])
def test_parse_pmask_patterns(pattern, expected):
    m = P._parse_pmask({"pmask_pattern": pattern}, 8)
    assert list(np.flatnonzero(m)) == expected
    assert np.array_equal(m, R._parse_pmask({"pmask_pattern": pattern}, 8))


@pytest.mark.parametrize("what", ["dwin bfloat16", "complex64",
                                  "complex128", "AMG bfloat16"])
def test_what_is_not_ported_raises(what):
    """A request the port has no kernels for raises NotImplementedError
    naming its ROADMAP item; it does not run in another dtype or
    solver. The two bfloat16 requests that raised so before their
    kernels' bfloat16 modes were ported (ROADMAP B.20: a dense-window
    hierarchy; B.19: one on block values) now build in bfloat16, every
    level in its format."""
    A, _ = T.poisson3d(6)
    if what == "AMG bfloat16":
        amg = T.AMG(T.poisson3d_block(6, 3)[0],
                    T.AMGParams(dtype=torch.bfloat16), device="cpu")
        assert [(type(lv.A).__name__, lv.A.dtype, lv.A.block)
                for lv in amg.hierarchy.levels] \
            == [("WindowedEllMatrix", torch.bfloat16, (3, 3))]
    elif what == "dwin bfloat16":
        solve = P.make_solver_from_config(
            A, {"precond.dtype": "bfloat16",
                "precond.matrix_format": "dwin"}, device="cpu")
        assert [(type(lv.A).__name__, lv.A.dtype)
                for lv in solve.precond.hierarchy.levels] \
            == [("DenseWindowMatrix", torch.bfloat16)]
    else:
        with pytest.raises(NotImplementedError, match="complex"):
            P.make_solver_from_config(A, {"precond.dtype": what},
                                      device="cpu")


def test_blockcg_builds_from_config():
    """solver.type=blockcg (refused before the serving slice) builds the
    serving layer's block CG with the configured fields, as the JAX
    package's registry does, and solves a stacked rhs."""
    A, rhs = T.poisson3d(6)
    solve = P.make_solver_from_config(
        A, {"solver.type": "blockcg", "solver.maxiter": 60,
            "solver.tol": 1e-8, "precond.dtype": "float64"}, device="cpu")
    ref = R.solver_from_params({"type": "blockcg", "maxiter": 60,
                                "tol": 1e-8})
    assert _fields(solve.solver) == _fields(ref)
    x, info = solve(np.stack([rhs, 2 * rhs + 1], axis=1))
    assert info.solver == "BlockCG" and info.resid <= 1e-8


def _poisson(n):
    return lambda: T.poisson3d(n)


def _stokes():
    A, pmask = T.stokes_like(10)
    return A, np.ones(A.nrows), pmask


def _reservoir():
    return T.reservoir_like(6, 3)


def _drs():
    A, rhs = drs_hard_reservoir(6)
    return T.CSR(A.ptr, A.col, A.val, A.ncols), rhs


#: precond.class configurations of tests/test_runtime_io.py and
#: tests/test_coupled.py: name -> (system, config)
CLASSES = {
    "relaxation": (_poisson(10), {
        "precond.class": "relaxation", "precond.relax.type": "ilu0",
        "precond.dtype": "float64", "solver.type": "cg",
        "solver.maxiter": 500, "solver.tol": 1e-8}),
    "dummy": (_poisson(8), {
        "precond.class": "dummy", "precond.dtype": "float64",
        "solver.type": "cg", "solver.maxiter": 500, "solver.tol": 1e-8}),
    "nested": (_poisson(10), {
        "precond.class": "nested", "precond.solver.type": "cg",
        "precond.solver.maxiter": 4, "precond.solver.tol": 1e-2,
        "precond.precond.class": "amg", "precond.precond.dtype": "float64",
        "precond.precond.coarse_enough": 200, "solver.type": "fgmres",
        "solver.tol": 1e-8, "solver.maxiter": 100}),
    "doubly nested": (_poisson(8), {
        "precond.class": "nested", "precond.solver.type": "preonly",
        "precond.precond.class": "nested",
        "precond.precond.solver.type": "cg",
        "precond.precond.solver.maxiter": 3,
        "precond.precond.precond.class": "relaxation",
        "precond.precond.precond.relax.type": "spai0",
        "precond.precond.precond.dtype": "float64",
        "solver.type": "fgmres", "solver.tol": 1e-8}),
    "schur": (_stokes, {
        "precond.class": "schur", "precond.dtype": "float64",
        "precond.usolver.precond.dtype": "float64",
        "precond.usolver.precond.coarse_enough": 200,
        "precond.psolver.precond.dtype": "float64",
        "precond.psolver.solver.type": "cg",
        "precond.psolver.solver.maxiter": 4,
        "precond.psolver.solver.tol": 1e-2,
        "solver.type": "fgmres", "solver.tol": 1e-8,
        "solver.maxiter": 200}),
    "schur pattern": (_stokes, {
        "precond.class": "schur", "precond.approx_schur": "true",
        "precond.adjust_p": "0", "precond.simplec_dia": "false",
        "precond.dtype": "float64", "precond.pmask_pattern": ">200",
        "solver.type": "fgmres", "solver.maxiter": "300",
        "solver.tol": "1e-8"}),
    "cpr": (_reservoir, {
        "precond.class": "cpr", "precond.dtype": "float64",
        "precond.pressure.dtype": "float64",
        "precond.pressure.coarse_enough": 100, "solver.type": "bicgstab",
        "solver.tol": 1e-8, "solver.maxiter": 200}),
    "cpr drs": (_drs, {
        "precond.class": "cpr", "precond.weighting": "drs",
        "precond.eps_dd": "0.2", "precond.eps_ps": "0.02",
        "precond.dtype": "float64", "precond.pressure.coarse_enough": "100",
        "solver.type": "bicgstab", "solver.maxiter": "400",
        "solver.tol": "1e-8"}),
    "amg block_size": (_poisson(8), {
        "precond.dtype": "float64", "solver.type": "cg",
        "solver.maxiter": 200, "solver.tol": 1e-8}),
}


@pytest.mark.parametrize("name", list(CLASSES))
def test_precond_classes_match_jax(name):
    """Every precond.class (amg over 2x2 blocks, relaxation, dummy,
    nested, doubly nested, schur with a pmask and with a pattern, cpr
    with quasi-IMPES and DRS weights): the JAX package's float64 count
    and a true residual under 1e-6."""
    make, cfg = CLASSES[name]
    got = make()
    A, rhs = got[:2]
    cfg = dict(cfg)
    if len(got) == 3 and "precond.pmask_pattern" not in cfg:
        cfg["precond.pmask"] = got[2]
    kw = {"block_size": 2} if name == "amg block_size" else {}
    ref = R.make_solver_from_config(_ref(A), cfg, **kw)
    solve = P.make_solver_from_config(A, cfg, device="cpu", **kw)
    _, info_r = ref(rhs)
    x, info = solve(rhs)
    assert info.iters == info_r.iters
    x64 = x.double().numpy()
    assert np.linalg.norm(rhs - A.spmv(x64)) / np.linalg.norm(rhs) < 1e-6
    if name.startswith("nested"):
        assert "nested" in repr(solve)


def test_cpr_drs_keys_warn_under_quasi_impes():
    A, _ = _reservoir()
    with pytest.warns(UserWarning, match="only applies to weighting=drs"):
        pre = P.precond_from_config(A, {"class": "cpr", "eps_dd": 0.3,
                                        "dtype": "float64"}, device="cpu")
    assert type(pre) is T.CPR
    with pytest.raises(ValueError, match="weighting"):
        P.precond_from_config(A, {"class": "cpr", "weighting": "x"},
                              device="cpu")
