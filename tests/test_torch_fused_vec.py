"""The port's CG tail (``xr_update``) and fused residual + norm
(``residual_dot``) against the JAX package's Pallas kernels in interpret
mode."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from amgcl_tpu.ops import fused_vec as ref_fv
from amgcl_tpu.ops import pallas_spmv as ref

from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.ops.device import DiaMatrix, EllMatrix, csr_to_ell
from amgcl_tpu_torch.utils.sample_problem import poisson3d

DTYPES = (np.float32, np.float64)


def _vecs(n, dtype, k, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(n).astype(dtype) for _ in range(k)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [5000, 20000])
def test_xr_update_matches_pallas(dtype, n):
    p, q, x, r = _vecs(n, dtype, 4, n)
    alpha = dtype(0.37)
    xn, rn, rr = fv.xr_update(torch.tensor(alpha), *map(torch.as_tensor,
                                                        (p, q, x, r)))
    xn_r, rn_r, rr_r = ref_fv._fused_pass(
        "xr", (alpha,), tuple(jnp.asarray(v) for v in (p, q, x, r)),
        interpret=True)
    # elementwise: two roundings either side (FMA contraction may differ)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    scale = np.abs(x).max() + abs(alpha) * max(np.abs(p).max(),
                                               np.abs(q).max())
    assert np.max(np.abs(xn.numpy() - np.asarray(xn_r))) <= tol * scale
    assert np.max(np.abs(rn.numpy() - np.asarray(rn_r))) <= tol * scale
    # the dot: summation order differs
    assert rr.dim() == 0 and rr.dtype == xn.dtype
    np.testing.assert_allclose(float(rr), float(rr_r), rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_xr_update_plain_counts_calls(dtype):
    p, q, x, r = map(torch.as_tensor, _vecs(100, dtype, 4, 1))
    before = fv.xr_update_plain.calls
    fv.xr_update(torch.tensor(dtype(0.5)), p, q, x, r)
    assert fv.xr_update_plain.calls == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_dot_matches_pallas(dtype):
    A, _ = poisson3d(12)
    from amgcl_tpu_torch.ops.device import csr_to_dia
    M = csr_to_dia(A, torch.float64 if dtype == np.float64
                   else torch.float32, "cpu")
    assert isinstance(M, DiaMatrix)
    f, x = _vecs(A.nrows, dtype, 2, 7)
    r, rr = fv.residual_dot(torch.as_tensor(f), M, torch.as_tensor(x))
    r_ref, rr_ref = ref.dia_residual_dot(
        M.offsets, jnp.asarray(M.data.numpy()), jnp.asarray(f),
        jnp.asarray(x), interpret=True)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    scale = np.abs(A.to_scipy()) @ np.abs(x.astype(np.float64))
    scale = scale.max() + np.abs(f).max()
    assert np.max(np.abs(r.numpy() - np.asarray(r_ref))) <= tol * scale
    np.testing.assert_allclose(float(rr), float(rr_ref), rtol=tol)
    # a format without a fused kernel composes residual + dot
    E = csr_to_ell(A, M.dtype, "cpu")
    assert isinstance(E, EllMatrix)
    r2, rr2 = fv.residual_dot(torch.as_tensor(f), E, torch.as_tensor(x))
    assert np.max(np.abs(r2.numpy() - np.asarray(r_ref))) <= tol * scale
    np.testing.assert_allclose(float(rr2), float(rr_ref), rtol=tol)
