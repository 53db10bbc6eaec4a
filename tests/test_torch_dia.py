"""The port's DIA kernels (plain versions, as the CPU runs them) against
the JAX package's Pallas DIA kernels in interpret mode, and the port's
device-format choice."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.ops import pallas_spmv as ref

from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops import device as tdev
from amgcl_tpu_torch.ops.csr import CSR


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


_L0_OFFSETS = (-256, -16, -1, 0, 1, 16, 256)       # 7-point, 16^3 grid


def _operator(kind, dtype, seed=0):
    """(offsets, data, n, m) of a random DIA operator."""
    rng = np.random.RandomState(seed)
    if kind == "l0":
        offsets, n, m = _L0_OFFSETS, 4096, 4096
    elif kind == "wide33":
        off = np.r_[-300:0, 1:301]
        offsets = tuple(sorted(rng.choice(off, 32, replace=False))) + (0,)
        offsets = tuple(sorted(offsets))
        n = m = 4096
    else:                                     # rectangular (restriction)
        offsets, n, m = (-8, -1, 0, 3, 40), 4096, 1000
    data = rng.standard_normal((len(offsets), n)).astype(dtype)
    return tuple(int(o) for o in offsets), data, n, m


def _vec(n, dtype, seed):
    return np.random.RandomState(seed).standard_normal(n).astype(dtype)


def _t(a):
    return torch.as_tensor(a)


def _close(got, want, dtype, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    # relative to the product's scale, |Δ| ≤ rtol · max(|A||x|): XLA may
    # contract a multiply-add into an FMA where the port rounds twice, so
    # an entry that cancels to near zero differs in its own last digits
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rtol * scale


def _absprod(offsets, data, x):
    """max_i (|A| |x|)_i on the host in float64."""
    y = np.zeros(data.shape[1])
    m = len(x)
    for k, d in enumerate(offsets):
        lo, hi = max(0, -d), min(data.shape[1], m - d)
        if hi > lo:
            y[lo:hi] += np.abs(data[k, lo:hi].astype(np.float64)) \
                * np.abs(x[lo + d:hi + d])
    return y.max()


CASES = [(k, dt) for k in ("l0", "wide33", "rect")
         for dt in (np.float32, np.float64)]


@pytest.mark.parametrize("kind,dtype", CASES)
def test_dia_spmv_and_residual_match_pallas(kind, dtype):
    offsets, data, n, m = _operator(kind, dtype)
    x, f = _vec(m, dtype, 1), _vec(n, dtype, 2)
    off_t = torch.tensor(offsets, dtype=torch.int32)
    scale = _absprod(offsets, data, x) + np.abs(f).max()
    y = dk.dia_spmv(off_t, _t(data), _t(x))
    y_ref = ref.dia_spmv(offsets, jnp.asarray(data), jnp.asarray(x),
                         interpret=True)
    _close(y.numpy(), y_ref, dtype, scale)
    r = dk.dia_residual(off_t, _t(data), _t(f), _t(x))
    r_ref = ref.dia_residual(offsets, jnp.asarray(data), jnp.asarray(f),
                             jnp.asarray(x), interpret=True)
    _close(r.numpy(), r_ref, dtype, scale)
    assert y.dtype == r.dtype == torch.as_tensor(data).dtype


@pytest.mark.parametrize("kind,dtype",
                         [c for c in CASES if c[0] != "rect"])
def test_dia_square_modes_match_pallas(kind, dtype):
    """scaled correction, spmv + dots, residual + norm."""
    offsets, data, n, _ = _operator(kind, dtype)
    x, f, w = _vec(n, dtype, 3), _vec(n, dtype, 4), _vec(n, dtype, 5)
    off_t = torch.tensor(offsets, dtype=torch.int32)
    jd, jx, jf, jw = (jnp.asarray(a) for a in (data, x, f, w))
    scale = _absprod(offsets, data, x) * (1 + np.abs(w).max()) \
        + np.abs(f).max() * np.abs(w).max() + np.abs(x).max()
    dot_rtol = 1e-12 if dtype == np.float64 else 1e-5

    u = dk.dia_scaled_correction(off_t, _t(data), _t(w), _t(f), _t(x))
    u_ref = ref.dia_scaled_correction(offsets, jd, jw, jf, jx,
                                      interpret=True)
    _close(u.numpy(), u_ref, dtype, scale)

    y, yy, yx, yw = dk.dia_spmv_dots(off_t, _t(data), _t(x), _t(w))
    y_ref, yy_r, yx_r, yw_r = ref.dia_spmv_dots(offsets, jd, jx, jw,
                                                interpret=True)
    _close(y.numpy(), y_ref, dtype, scale)
    for got, want in ((yy, yy_r), (yx, yx_r), (yw, yw_r)):
        assert got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=dot_rtol)
    q, qp = dk.dia_spmv_dot(off_t, _t(data), _t(x))
    np.testing.assert_allclose(float(qp), float(yx_r), rtol=dot_rtol)
    assert dk.dia_spmv_dots(off_t, _t(data), _t(x))[3] is None

    r, rr = dk.dia_residual_dot(off_t, _t(data), _t(f), _t(x))
    r_ref, rr_ref = ref.dia_residual_dot(offsets, jd, jf, jx,
                                         interpret=True)
    _close(r.numpy(), r_ref, dtype, scale)
    np.testing.assert_allclose(float(rr), float(rr_ref), rtol=dot_rtol)


def test_plain_versions_count_calls_and_kernels_reject_cpu_launch():
    """On CPU tensors each wrapper runs its plain version (the counters
    show it) and never reaches the launcher, which refuses CPU tensors."""
    offsets, data, n, _ = _operator("l0", np.float32)
    off_t = torch.tensor(offsets, dtype=torch.int32)
    x = _t(_vec(n, np.float32, 6))
    before = (dk.dia_spmv_plain.calls, dk.dia_spmv.launches)
    dk.dia_spmv(off_t, _t(data), x)
    assert (dk.dia_spmv_plain.calls, dk.dia_spmv.launches) \
        == (before[0] + 1, before[1])
    with pytest.raises(ValueError, match="CUDA"):
        dk._launch(dk._SPMV, off_t, _t(data), x)


def _random_sparse(n, per_row, seed, m=None):
    m = n if m is None else m
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.randint(0, m, n * per_row)
    M = sp.csr_matrix((rng.standard_normal(n * per_row), (rows, cols)),
                      shape=(n, m)) + sp.eye(n, m)
    return CSR.from_scipy(M)


@pytest.mark.parametrize("fixture,fmt", [
    ("small_dense", "DenseMatrix"),
    ("poisson16", "DiaMatrix"),
    ("banded_wide", "DiaMatrix"),
    ("unstructured_square", "WindowedEllMatrix"),
    ("unstructured", "EllMatrix"),
])
def test_to_device_auto_format(fixture, fmt):
    """'auto' with the accelerator thresholds on every device: dense for
    small dense-ish operators, DIA up to 512 diagonals and fill 16,
    windowed ELL while its widest window fits 4 MiB of float32 (any
    5,000-column matrix), ELL otherwise (here 1.2M columns, each row tile
    spanning nearly all of them). The product agrees with scipy's either
    way."""
    from amgcl_tpu_torch.utils.sample_problem import poisson3d
    if fixture == "small_dense":
        A = CSR.from_scipy(sp.random(100, 100, density=0.5,
                                     random_state=1, format="csr"))
    elif fixture == "poisson16":
        A, _ = poisson3d(16)
    elif fixture == "banded_wide":
        # 101 diagonals at fill ~1.5: DIA on the accelerator thresholds
        # (the JAX package's CPU cap of 40 diagonals would refuse it)
        rng = np.random.RandomState(2)
        n = 5000
        offs = np.arange(-50, 51)
        data = rng.standard_normal((len(offs), n)) \
            * (rng.rand(len(offs), n) < 0.7)
        A = CSR.from_scipy(sp.dia_matrix((data, offs), shape=(n, n))
                           .tocsr() + sp.identity(n))
    elif fixture == "unstructured_square":
        A = _random_sparse(5000, 5, 3)
    else:
        A = _random_sparse(5000, 5, 3, m=1_200_000)
    M = tdev.to_device(A, "auto", torch.float64, device="cpu")
    assert type(M).__name__ == fmt
    x = np.random.RandomState(4).standard_normal(A.ncols)
    np.testing.assert_allclose(M.mv(torch.as_tensor(x)).numpy(),
                               A.spmv(x), rtol=1e-12, atol=1e-12)
