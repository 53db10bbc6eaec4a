"""The bfloat16 Krylov loop (the JAX package's default call for a bfloat16
hierarchy, ``make_solver(A, AMGParams(dtype=bfloat16), solver)`` with no
``solver_dtype``) and the bfloat16 gather SpMV against the JAX package on
the CPU:

- each new bfloat16 mode's plain version against the JAX kernel in
  interpret mode on the same bfloat16 inputs: the DIA SpMV + dots with
  and without w (B.3) and residual + norm (B.4), the three Krylov tails
  (B.5), the windowed-ELL SpMV + dots (B.10) and the gather SpMV (B.16);
  the vectors bit for bit and the dots within one bfloat16 ULP;
- B.3's y and B.4's r bit for bit with the port's bfloat16 B.1 and B.2;
- solves against the JAX package's same calls at reduced sizes of
  chip_smoke.py's phase 16 (BFK1, BFK2, BFG1), the nested preconditioner
  and the Schur pressure correction with inner bfloat16 CG, and a stacked
  (n, 4) bfloat16 CG solve against its single solves.

The JAX package's ``jnp.linalg.solve`` refuses bfloat16 on the CPU, so
its BiCGStab(L) runs here with the Gram system solved in float32 and
rounded once, the port's rule (``ops/device.small_solve``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.coarsening.ruge_stuben import RugeStuben as RefRS
from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.models.make_solver import make_solver as ref_make_solver
from amgcl_tpu.models import preconditioner as ref_pre
from amgcl_tpu.models import schur as ref_schur
from amgcl_tpu.ops import fused_vec as ref_fv
from amgcl_tpu.ops import pallas_gather as ref_gather
from amgcl_tpu.ops import pallas_spmv as ref_spmv
from amgcl_tpu.ops import unstructured as ref_un
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.solver.bicgstab import BiCGStab as RefBiCGStab
from amgcl_tpu.solver.bicgstabl import BiCGStabL as RefBiCGStabL
from amgcl_tpu.solver.cg import CG as RefCG
from amgcl_tpu.solver.gmres import FGMRES as RefFGMRES

import amgcl_tpu_torch as T
from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.ops import gather_kernels as gk
from amgcl_tpu_torch.ops import well_kernels as wk
from amgcl_tpu_torch.ops.unstructured import csr_to_windowed_ell

BF = torch.bfloat16
CPU = dict(device="cpu")
#: U1's nonzeros a row (fe_like_problem's default system)
U1_NNZ_PER_ROW = 2634905 / 85623


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


@pytest.fixture
def bf16_linalg(monkeypatch):
    """The JAX package's ``jnp.linalg.solve`` on bfloat16 systems in
    float32, the solution rounded once (module docstring)."""
    solve = jnp.linalg.solve

    def shim(a, b):
        if a.dtype == jnp.bfloat16:
            return solve(a.astype(jnp.float32),
                         b.astype(jnp.float32)).astype(jnp.bfloat16)
        return solve(a, b)
    monkeypatch.setattr(jnp.linalg, "solve", shim)


def _ref(A):
    return RefCSR(A.ptr, A.col, A.val, A.ncols)


def _f32(a):
    """A JAX or torch bfloat16 array as float32 numpy (exact)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _ulps(a, b):
    """The largest distance of two arrays of bfloat16 values in bfloat16
    ULPs (bit patterns mapped to integers in value order)."""
    def key(x):
        i = (np.atleast_1d(np.asarray(x, np.float32)).view(np.int32)
             >> 16).astype(np.int64)
        return np.where(i < 0, -32768 - i, i)
    return int(np.abs(key(a) - key(b)).max())


def _true(A, rhs, x):
    x = x.double().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float64)
    return np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs)


def _vecs(n, k, seed):
    rng = np.random.RandomState(seed)
    v = [rng.standard_normal(n).astype(np.float32) for _ in range(k)]
    return ([jnp.asarray(a, dtype=jnp.bfloat16) for a in v],
            [torch.as_tensor(a).to(BF) for a in v])


# -- the kernels' plain versions against the JAX kernels ---------------------

_DIA_OFFSETS = (-300, -17, -1, 0, 1, 17, 300)


def _dia_operands(n=3000, seed=9):
    rng = np.random.RandomState(seed)
    data = rng.standard_normal((len(_DIA_OFFSETS), n)).astype(np.float32)
    j, t = _vecs(n, 3, seed + 1)
    return ((jnp.asarray(data, dtype=jnp.bfloat16), *j),
            (torch.as_tensor(data).to(BF), *t))


def _fe_windowed(n=3000):
    """A narrow-K (K ≤ 16) fe-like operator in both packages' windowed
    ELL, bfloat16."""
    A, _ = T.fe_like_problem(n, nnz_target=8 * n)
    W = ref_un.csr_to_windowed_ell(_ref(A), jnp.bfloat16)
    M = csr_to_windowed_ell(A, BF)
    assert np.array_equal(_f32(M.vals), _f32(W.vals))
    return A, W, M


def _u1_windowed(n=2500):
    """A wide-K operator (U1's nonzeros a row) in both packages' windowed
    ELL, bfloat16."""
    A, _ = T.fe_like_problem(n, nnz_target=int(U1_NNZ_PER_ROW * n))
    W = ref_un.csr_to_windowed_ell(_ref(A), jnp.bfloat16)
    M = csr_to_windowed_ell(A, BF)
    assert M.K > 16
    return A, W, M


def _site(site):
    """(JAX results, port results, vector count) of one new bfloat16
    mode on the same bfloat16 inputs."""
    if site in ("B.3", "B.3 w", "B.4"):
        (jd, jx, jf, jw), (td, tx, tf, tw) = _dia_operands()
        off = torch.tensor(_DIA_OFFSETS, dtype=torch.int32)
        if site == "B.4":
            return (ref_spmv.dia_residual_dot(_DIA_OFFSETS, jd, jf, jx,
                                              interpret=True),
                    dk.dia_residual_dot_plain(off, td, tf, tx), 1)
        jw, tw = (jw, tw) if site == "B.3 w" else (None, None)
        want = ref_spmv.dia_spmv_dots(_DIA_OFFSETS, jd, jx, jw,
                                      interpret=True)
        got = dk.dia_spmv_dots_plain(off, td, tx, tw)
        return want[:3 + (jw is not None)], got[:3 + (tw is not None)], 1
    if site in ("xr", "bicg_tail", "axpby_dot"):
        j, t = _vecs(5000, 6, 11)
        ja, jw = (jnp.asarray(v, jnp.bfloat16) for v in (0.3711, -1.2345))
        ta, tw = (torch.tensor(v).to(BF) for v in (0.3711, -1.2345))
        if site == "xr":
            return (ref_fv._fused_pass("xr", (ja,), tuple(j[:4]),
                                       interpret=True),
                    fv.xr_update_plain(ta, *t[:4]), 2)
        if site == "bicg_tail":
            return (ref_fv._fused_pass("bicg_tail", (ja, jw), tuple(j),
                                       interpret=True),
                    fv.bicgstab_tail_plain(ta, t[0], tw, *t[1:]), 2)
        return (ref_fv._fused_pass("axpby_dot", (ja, jw), tuple(j[:2]),
                                   interpret=True),
                fv.axpby_dot_plain(ta, t[0], tw, t[1]), 1)
    if site == "B.16":
        A, W, M = _fe_windowed()
        assert M.K <= gk.AUTO_MAX_K
        (jx,), (tx,) = _vecs(A.ncols, 1, 13)
        return ((ref_gather.gather_spmv(W.window_starts, W.cols_local,
                                        W.vals, jx, W.win, W.shape[0],
                                        interpret=True),),
                (gk.gather_spmv_plain(M.window_starts, M.cols_local, M.vals,
                                      tx, M.shape[0]),), 1)
    raise AssertionError(site)


@pytest.mark.parametrize("site", ["B.3", "B.3 w", "B.4", "xr", "bicg_tail",
                                  "axpby_dot", "B.16"])
def test_modes_match_jax_kernels(site):
    """The plain versions against the JAX kernels in interpret mode: the
    JAX kernels' bfloat16 chains round after each operation there (the
    DIA accumulator, the tails' ``x + a·p``, the gather's running sum),
    as the port's rule does, so the vectors are equal bit for bit. The
    dots are float32 sums rounded once in both; their orders differ (the
    JAX kernels' tile partials, torch's dot), so a dot may differ by one
    bfloat16 ULP."""
    want, got, nvec = _site(site)
    assert len(want) == len(got)
    for w, g in zip(want[:nvec], got[:nvec]):
        assert g.dtype == BF
        assert np.array_equal(_f32(g), _f32(w))
    for w, g in zip(want[nvec:], got[nvec:]):
        assert g.dtype == BF and g.dim() == 0
        assert _ulps(_f32(g), _f32(w)) <= 1


@pytest.mark.parametrize("w", [False, True])
def test_windowed_ell_dots_match_jax_kernel(w):
    """B.10 in bfloat16 on a U1-like operator (K > 16). The JAX kernel's
    interpret mode keeps each product of two bfloat16 values in float32
    (exact there: XLA's excess precision on the CPU) and sums a row in
    float32 before rounding once; the port's rule is the same, so y is
    equal bit for bit (the float32 row sums run in other orders, which
    moved no rounding here), and y equals the port's bfloat16 B.8. The
    dots within one bfloat16 ULP."""
    A, W, M = _u1_windowed()
    (jx, jw), (tx, tw) = _vecs(A.ncols, 2, 17)
    jw, tw = (jw, tw) if w else (None, None)
    want = ref_un.windowed_ell_spmv_dots(W.window_starts, W.cols_local,
                                         W.vals, jx, jw, win=W.win,
                                         n_out=W.shape[0], interpret=True)
    got = wk.windowed_ell_spmv_dots_plain(M.window_starts, M.cols_local,
                                          M.vals, tx, tw, M.shape[0])
    assert got[0].dtype == BF
    assert np.array_equal(_f32(got[0]), _f32(want[0]))
    assert torch.equal(got[0], wk.windowed_ell_spmv_plain(
        M.window_starts, M.cols_local, M.vals, tx, M.shape[0]))
    for g, wv in zip(got[1:], want[1:]):
        assert (g is None) == (wv is None)
        if g is not None:
            assert g.dtype == BF and _ulps(_f32(g), _f32(wv)) <= 1


def test_dot_modes_equal_their_vector_modes():
    """B.3's y equals the port's bfloat16 B.1 (dia_spmv) and B.4's r its
    B.2 (dia_residual) bit for bit on the same operands: each rounds every
    product and sum in diagonal order."""
    _, (td, tx, tf, tw) = _dia_operands(seed=21)
    off = torch.tensor(_DIA_OFFSETS, dtype=torch.int32)
    y = dk.dia_spmv_plain(off, td, tx)
    for ww in (tw, None):
        assert torch.equal(dk.dia_spmv_dots_plain(off, td, tx, ww)[0], y)
    assert torch.equal(dk.dia_residual_dot_plain(off, td, tf, tx)[0],
                       dk.dia_residual_plain(off, td, tf, tx))


def test_inner_product_rounds_as_the_jax_package():
    """``inner_product`` of bfloat16 vectors: the float32 sum rounded once,
    as ``jnp.vdot`` of bfloat16 gives it on the CPU (bit for bit here)."""
    from amgcl_tpu.ops import device as ref_dev
    from amgcl_tpu_torch.ops import device as dev
    for n, seed in ((7, 1), (3000, 2), (40000, 3)):
        (ja, jb), (ta, tb) = _vecs(n, 2, seed)
        got = dev.inner_product(ta, tb)
        assert got.dtype == BF and got.dim() == 0
        assert _f32(got) == _f32(ref_dev.inner_product(ja, jb))


# -- solves --------------------------------------------------------------------

#: the window of the port's count around the JAX package's on the same
#: call: the port's vectors round as the JAX kernels' do and its dots
#: may differ by one bfloat16 ULP, its V-cycle legs by one ULP
#: (tests/test_torch_bf16.py), so a count moves with the last bits, as
#: the JAX package's own does under a 1e-6 perturbation of the rhs
#: (``reference_counts.py --b17``: BFK2's and BFG1's six counts spread
#: over several iterations at 12,000 rows)
COUNT_SLACK = {"BFK1": 2, "BFK2": 0.25, "BFG1": 0.25}


def _within(label, got, want):
    """``got`` within COUNT_SLACK[label] of ``want`` (an absolute count,
    or a fraction of ``want`` where below 1)."""
    slack = COUNT_SLACK[label]
    slack = slack * want if slack < 1 else slack
    return abs(got - want) <= max(slack, 1)


def _pair(label, A, ref_bundle, port_bundle, rhs):
    """Both packages' solves of ``rhs``: the port's count within the
    window of the JAX package's, and its true residual within 2x of the
    JAX package's."""
    x_r, info_r = ref_bundle(rhs)
    x, info = port_bundle(rhs)
    assert port_bundle.solver_dtype == BF
    assert _within(label, info.iters, info_r.iters), (info.iters,
                                                      info_r.iters)
    t_r, t = _true(A, rhs, np.asarray(x_r).astype(np.float64)), \
        _true(A, rhs, x)
    assert np.isfinite(t) and t <= 2 * t_r, (t, t_r)
    return info, info_r


@pytest.mark.parametrize("n", [16, 24])
def test_bfk1_default_dtype_matches_jax(n):
    """chip_smoke.py's BFK1 call on a cut poisson3d: make_solver with a
    bfloat16 hierarchy and no solver_dtype runs a bfloat16 CG on the
    hierarchy's own L0, as the JAX package's call does."""
    A, rhs = T.poisson3d(n)
    kw = dict(maxiter=100, tol=1e-6)
    ref = ref_make_solver(_ref(A), RefParams(dtype=jnp.bfloat16),
                          RefCG(**kw), refine=3)
    port = T.make_solver(A, T.AMGParams(dtype=BF), T.CG(**kw), refine=3,
                         **CPU)
    assert port.A_dev is port.precond.hierarchy.levels[0].A
    assert ref.solver_dtype == jnp.bfloat16
    _pair("BFK1", A, ref, port, rhs)


def _fe(n=6000):
    return T.fe_like_problem(n, nnz_target=int(U1_NNZ_PER_ROW * n))


def test_bfk2_bicgstabl_matches_jax(bf16_linalg):
    """BFK2's call (BiCGStab(L = 2), hierarchy and loop in bfloat16) on
    U1's system cut to 6,000 rows, without refinement: one bfloat16 solve
    in each package. (With refine=3 both packages' true residuals grow
    from one correction to the next on this system, to 0.76 and 110 here:
    the bfloat16 operator's rounding, 2⁻⁹ of each entry, times the
    system's condition is more than the refinement can correct, and how
    far each diverges turns on the last bits; PERF.md §6.)"""
    A, rhs = _fe()
    kw = dict(maxiter=100, tol=1e-6)
    ref = ref_make_solver(_ref(A), RefParams(dtype=jnp.bfloat16),
                          RefBiCGStabL(L=2, **kw))
    port = T.make_solver(A, T.AMGParams(dtype=BF), T.BiCGStabL(L=2, **kw),
                         **CPU)
    assert type(port.A_dev).__name__ == "WindowedEllMatrix"
    _pair("BFK2", A, ref, port, rhs)


#: The CPU half of chip_smoke.py's first-pass check (``P16_FIRST``, the
#: card against the port on the CPU at full size): at reduced sizes the
#: bfloat16 solve alone (refine 0), its first FIRST_ENTRIES[label]
#: residual-history entries each within FIRST_REL of the JAX package's
#: on the same call. The two packages' histories part only by their
#: dots' last bits and the quotient's rounding (at most 4.9e-2 over
#: BFK1's first 8 entries at 32³ and 48³, 3.0e-3 over BFK2's at 12,000
#: rows: ``reference_counts.py --b17 --first``); a wrong scalar or dot
#: moves them from the first entries.
FIRST_ENTRIES = {"BFK1": 6, "BFK2": 4}
FIRST_REL = 0.1


@pytest.mark.parametrize("label,n", [("BFK1", 16), ("BFK1", 24),
                                     ("BFK2", 6000)])
def test_first_pass_history_matches_jax(label, n, bf16_linalg):
    """BFK1's and BFK2's bfloat16 solve without refinement: its first
    residual-history entries against the JAX package's."""
    kw = dict(maxiter=100, tol=1e-6, record_history=True)
    if label == "BFK1":
        A, rhs = T.poisson3d(n)
        ref_solver, solver = RefCG(**kw), T.CG(**kw)
    else:
        A, rhs = _fe(n)
        ref_solver = RefBiCGStabL(L=2, **kw)
        solver = T.BiCGStabL(L=2, **kw)
    _, info_r = ref_make_solver(_ref(A), RefParams(dtype=jnp.bfloat16),
                                ref_solver)(rhs)
    port = T.make_solver(A, T.AMGParams(dtype=BF), solver, **CPU)
    _, info = port(rhs)
    assert port.solver_dtype == BF
    k = FIRST_ENTRIES[label]
    want = np.asarray(info_r.history[:k], np.float64)
    got = np.asarray(info.history[:k], np.float64)
    assert len(got) == len(want) == k
    assert np.all(np.abs(got / want - 1) <= FIRST_REL), (got, want)
    if label == "BFK1":
        assert _within(label, info.iters, info_r.iters), (info.iters,
                                                          info_r.iters)


def test_bfg1_ruge_stuben_takes_its_transfers_through_gather():
    """BFG1's call (Ruge–Stüben, left BiCGStab, refine=3, all bfloat16)
    on U1's system cut to 6,000 rows: the stored transfers are narrow
    windowed ELL, whose products run the gather SpMV's bfloat16 mode."""
    A, rhs = _fe()
    kw = dict(maxiter=100, tol=1e-6, precond_side="left")
    ref = ref_make_solver(_ref(A), RefParams(dtype=jnp.bfloat16,
                                             coarsening=RefRS()),
                          RefBiCGStab(**kw), refine=3)
    port = T.make_solver(A, T.AMGParams(dtype=BF,
                                        coarsening=T.RugeStuben()),
                         T.BiCGStab(**kw), refine=3, **CPU)
    P = port.precond.hierarchy.levels[0].P
    assert P.dtype == BF and P.K <= gk.AUTO_MAX_K
    calls = gk.gather_spmv_plain.calls
    _pair("BFG1", A, ref, port, rhs)
    assert gk.gather_spmv_plain.calls > calls


def test_nested_inner_bf16_cg_matches_jax():
    """A nested preconditioner over a bfloat16 hierarchy: its inner CG runs
    in bfloat16 on the hierarchy's own L0, under a bfloat16 FGMRES, as the
    JAX package's does."""
    A, rhs = T.poisson3d(12)
    inner = T.AMG(A, T.AMGParams(dtype=BF), **CPU)
    nested = T.NestedPreconditioner(A, inner, T.CG(maxiter=4))
    assert nested.dtype == BF and nested.hierarchy.A is \
        inner.hierarchy.levels[0].A
    ref_nested = ref_pre.NestedPreconditioner(
        _ref(A), RefAMG(_ref(A), RefParams(dtype=jnp.bfloat16)),
        RefCG(maxiter=4))
    kw = dict(maxiter=50, tol=1e-3)
    _, info_r = ref_make_solver(_ref(A), ref_nested, RefFGMRES(**kw))(rhs)
    x, info = T.make_solver(A, nested, T.FGMRES(**kw), **CPU)(rhs)
    assert x.dtype == BF
    assert abs(info.iters - info_r.iters) <= 1, (info.iters, info_r.iters)
    assert info.resid <= 1e-3


def test_schur_inner_bf16_cg_matches_jax():
    """The Schur pressure correction over bfloat16 hierarchies with an
    inner bfloat16 CG on the pressure, under a bfloat16 FGMRES: the JAX
    package's count within one."""
    A, pmask = T.stokes_like(10)
    rhs = np.ones(A.nrows)
    kw = dict(maxiter=100, tol=1e-2)
    ref = ref_schur.SchurPressureCorrection(
        _ref(A), pmask, usolver_prm=RefParams(dtype=jnp.bfloat16),
        psolver_prm=RefParams(dtype=jnp.bfloat16), psolver=RefCG(maxiter=4),
        dtype=jnp.bfloat16)
    _, info_r = ref_make_solver(_ref(A), ref, RefFGMRES(**kw))(rhs)
    pre = T.SchurPressureCorrection(A, pmask, dtype=BF,
                                    usolver_prm=T.AMGParams(dtype=BF),
                                    psolver_prm=T.AMGParams(dtype=BF),
                                    psolver=T.CG(maxiter=4), **CPU)
    x, info = T.make_solver(A, pre, T.FGMRES(**kw), **CPU)(rhs)
    assert x.dtype == BF
    assert abs(info.iters - info_r.iters) <= 1, (info.iters, info_r.iters)
    assert info.resid <= 1e-2


@pytest.mark.parametrize("name", ["BiCGStab", "GMRES", "FGMRES", "LGMRES",
                                  "IDRs", "Richardson"])
def test_solvers_in_bf16_match_jax(name, bf16_linalg):
    """The other solvers' bfloat16 loops over a bfloat16 hierarchy on
    poisson3d(10), every scalar in bfloat16 as the JAX solvers keep it
    (GMRES's least-squares factor solved in float32 and rounded once; IDR(s)
    on the JAX package's own shadow block): the JAX package's count
    within one, and its reported residual within 2x."""
    from amgcl_tpu import solver as ref_solver
    from amgcl_tpu.ops import device as ref_dev
    from amgcl_tpu.solver import idrs as ref_idrs
    from amgcl_tpu_torch.convert import idrs_with_shadow
    A, rhs = T.poisson3d(10)
    kw = dict(maxiter=60, tol=1e-4)
    _, info_r = ref_make_solver(_ref(A), RefParams(dtype=jnp.bfloat16),
                                getattr(ref_solver, name)(**kw))(rhs)
    sl = getattr(T, name)(**kw)
    if name == "IDRs":
        sl = idrs_with_shadow(sl, np.asarray(ref_idrs._shadow_block(
            sl.s, jnp.arange(A.nrows), None, jnp.bfloat16,
            ref_dev.inner_product)).astype(np.float32))
    x, info = T.make_solver(A, T.AMGParams(dtype=BF), sl, **CPU)(rhs)
    assert x.dtype == BF and torch.isfinite(x).all()
    assert abs(info.iters - info_r.iters) <= 1, (info.iters, info_r.iters)
    assert info.resid <= 2 * float(info_r.resid) + 1e-7


def test_stacked_bf16_cg_columns_equal_single_solves():
    """A stacked (n, 4) bfloat16 CG solve through make_solver: each
    column's x, count and residual equal its single solve's bit for
    bit."""
    A, _ = T.poisson3d(10)
    solve = T.make_solver(A, T.AMGParams(dtype=BF),
                          T.CG(maxiter=100, tol=1e-6), **CPU)
    R = np.random.RandomState(5).standard_normal((A.nrows, 4))
    X, info = solve(R)
    per = info.extra["per_rhs"]
    assert X.dtype == BF and X.shape == R.shape
    for b in range(4):
        x, one = solve(R[:, b].copy())
        assert torch.equal(X[:, b], x)
        assert per["iters"][b] == one.iters
        assert per["resid"][b] == one.resid
