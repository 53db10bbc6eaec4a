"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, at the edge shapes the main path does not reach:
row counts that are no multiple of the block, columns out of range on
both sides, rectangular operators, the 512-diagonal limit, an empty
operator, a grid-stride pass longer than its fixed grid. Also the
wrappers' refusals and a small solve on the card against the same solve
on the CPU.

Every test needs an NVIDIA card and skips without one. On the card, from
the repo root (the suite's conftest imports JAX, which the port's machine
lacks, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops import fused_vec as fv

pytestmark = pytest.mark.cuda

_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


def _dia(n, m, offsets, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    data = torch.as_tensor(rng.standard_normal((len(offsets), n)))
    x = torch.as_tensor(rng.standard_normal(m))
    f = torch.as_tensor(rng.standard_normal(n))
    w = torch.as_tensor(rng.rand(n))
    off = torch.tensor(offsets, dtype=torch.int32)
    return [t.to(device) if t is off else t.to(device=device, dtype=dtype)
            for t in (off, data, x, f, w)]


def _scale(off, data, x, f):
    """max_i (|A||x|)_i + max|f|: the size of the terms a row sums."""
    absA = dk.dia_spmv_plain(off, data.abs(), x.abs())
    return float(absA.max()) + float(f.abs().max())


def _close(got, want, scale, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got - want).abs().max()) <= _RTOL[dtype] * scale


def _dot_close(got, want, a, b, dtype):
    """|Δ| ≤ rtol · Σ|a_i b_i|: the summation order differs."""
    mag = float((a.double() * b.double()).abs().sum())
    assert abs(float(got) - float(want)) <= _RTOL[dtype] * max(mag, 1e-300)


_SQUARE = [
    # (n, offsets): a ragged last block, out-of-range columns both sides
    (1000, (-300, -17, -1, 0, 1, 17, 300)),
    (1, (-2, 0, 3)),
    (257, tuple(range(-255, 257))),          # the 512-diagonal limit
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offsets", _SQUARE)
def test_square_modes_match_plain(cuda, n, offsets, dtype):
    off, data, x, f, w = _dia(n, n, offsets, dtype, cuda)
    scale = _scale(off, data, x, f)
    plains = (dk.dia_spmv_plain, dk.dia_residual_plain,
              dk.dia_scaled_correction_plain, dk.dia_spmv_dots_plain,
              dk.dia_residual_dot_plain)
    calls = [fn.calls for fn in plains]

    _close(dk.dia_spmv(off, data, x), dk.dia_spmv_plain(off, data, x),
           scale, dtype)
    _close(dk.dia_residual(off, data, f, x),
           dk.dia_residual_plain(off, data, f, x), scale, dtype)
    _close(dk.dia_scaled_correction(off, data, w, f, x),
           dk.dia_scaled_correction_plain(off, data, w, f, x),
           scale * 2 + float(x.abs().max()), dtype)

    for ww in (w, None):
        got = dk.dia_spmv_dots(off, data, x, ww)
        want = dk.dia_spmv_dots_plain(off, data, x, ww)
        y = want[0]
        _close(got[0], y, scale, dtype)
        _dot_close(got[1], want[1], y, y, dtype)
        _dot_close(got[2], want[2], y, x, dtype)
        if ww is None:
            assert got[3] is None
        else:
            _dot_close(got[3], want[3], y, ww, dtype)

    r, rr = dk.dia_residual_dot(off, data, f, x)
    r_p, rr_p = dk.dia_residual_dot_plain(off, data, f, x)
    _close(r, r_p, scale, dtype)
    _dot_close(rr, rr_p, r_p, r_p, dtype)
    assert rr.dim() == 0 and rr.device.type == "cuda"
    # the plain versions ran only where called by name above
    assert [fn.calls - c for fn, c in zip(plains, calls)] == [1, 1, 1, 2, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(4096, 1000), (1000, 4096)])
def test_rectangular_spmv_and_residual_match_plain(cuda, n, m, dtype):
    off, data, x, f, _ = _dia(n, m, (-40, -8, -1, 0, 3, 40, 900), dtype,
                              cuda, seed=1)
    scale = _scale(off, data, x, f)
    _close(dk.dia_spmv(off, data, x), dk.dia_spmv_plain(off, data, x),
           scale, dtype)
    _close(dk.dia_residual(off, data, f, x),
           dk.dia_residual_plain(off, data, f, x), scale, dtype)


def test_dots_are_bit_identical_from_run_to_run(cuda):
    off, data, x, f, w = _dia(300_000, 300_000, (-4096, -64, -1, 0, 1, 64,
                                                 4096), torch.float32, cuda)
    first = dk.dia_spmv_dots(off, data, x, w)[1:]
    again = dk.dia_spmv_dots(off, data, x, w)[1:]
    assert [float(v) for v in first] == [float(v) for v in again]
    a = dk.dia_residual_dot(off, data, f, x)[1]
    assert float(a) == float(dk.dia_residual_dot(off, data, f, x)[1])


def test_launch_counters_count_kernel_launches(cuda):
    off, data, x, f, w = _dia(500, 500, (-1, 0, 1), torch.float32, cuda)
    before = (dk.dia_residual.launches, dk.dia_residual_plain.calls)
    dk.dia_residual(off, data, f, x)
    assert (dk.dia_residual.launches, dk.dia_residual_plain.calls) \
        == (before[0] + 1, before[1])


def test_empty_operator(cuda):
    off, data, x, f, w = _dia(0, 0, (-1, 0, 1), torch.float32, cuda)
    assert dk.dia_spmv(off, data, x).shape == (0,)
    assert float(dk.dia_residual_dot(off, data, f, x)[1]) == 0.0
    xn, rn, rr = fv.xr_update(0.5, x, x, x, x)
    assert xn.shape == rn.shape == (0,) and float(rr) == 0.0


@pytest.mark.parametrize("bad", ["noncontiguous", "dtype", "offsets_dtype",
                                 "too_many_diagonals", "rect_dots",
                                 "f_shape"])
def test_wrappers_refuse_malformed_operands(cuda, bad):
    n = 64
    offsets = (-1, 0, 1)
    if bad == "too_many_diagonals":
        offsets = tuple(range(-256, 257))
    off, data, x, f, w = _dia(n, n if bad != "rect_dots" else n + 1,
                              offsets, torch.float32, cuda)
    if bad == "noncontiguous":
        x = torch.stack([x, x], 1)[:, 0]
    elif bad == "dtype":
        f = f.double()
    elif bad == "offsets_dtype":
        off = off.long()
    elif bad == "f_shape":
        f = f[:-1]
    launches = (dk.dia_residual.launches, dk.dia_residual_dot.launches)
    with pytest.raises(ValueError):
        if bad == "rect_dots":
            dk.dia_residual_dot(off, data, f, x)
        else:
            dk.dia_residual(off, data, f, x)
    assert (dk.dia_residual.launches, dk.dia_residual_dot.launches) \
        == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 1000, 1056 * 256 * 3 + 7])
def test_xr_update_matches_plain(cuda, n, dtype):
    """n above 1056 blocks of 256 runs the grid-stride loop more than
    once per thread."""
    rng = np.random.RandomState(n)
    p, q, x, r = (torch.as_tensor(rng.standard_normal(n)).to(
        device=cuda, dtype=dtype) for _ in range(4))
    launches = fv.xr_update.launches
    for alpha in (torch.tensor(0.37, dtype=dtype, device=cuda), -1.25):
        got = fv.xr_update(alpha, p, q, x, r)
        want = fv.xr_update_plain(alpha, p, q, x, r)
        scale = float(x.abs().max() + r.abs().max()
                      + 1.25 * (p.abs().max() + q.abs().max()))
        _close(got[0], want[0], scale, dtype)
        _close(got[1], want[1], scale, dtype)
        _dot_close(got[2], want[2], want[1], want[1], dtype)
    assert fv.xr_update.launches == launches + 2
    with pytest.raises(ValueError):
        fv.xr_update(torch.tensor(0.37, dtype=dtype), p, q, x, r)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_small_solve_on_card_matches_cpu(cuda, dtype):
    """poisson3d(24) through the main path's entry points: the card and
    the CPU agree on the iterations (float32: within one) and, in
    float64, on the solution; both meet the tolerance."""
    from amgcl_tpu_torch import AMGParams, CG, make_solver, poisson3d
    A, rhs = poisson3d(24)
    runs = {}
    for device in ("cpu", cuda):
        solve = make_solver(A, AMGParams(dtype=dtype),
                            CG(maxiter=100, tol=1e-6), refine=3,
                            device=device)
        x, info = solve(rhs)
        assert x.device.type == torch.device(device).type
        runs[torch.device(device).type] = (info.iters,
                                           x.double().cpu().numpy())
    (it_cpu, x_cpu), (it_gpu, x_gpu) = runs["cpu"], runs["cuda"]
    if dtype == torch.float64:
        assert it_gpu == it_cpu
        assert np.linalg.norm(x_gpu - x_cpu) <= 1e-8 * np.linalg.norm(x_cpu)
    else:
        assert abs(it_gpu - it_cpu) <= 1
    true_res = np.linalg.norm(rhs - A.spmv(x_gpu)) / np.linalg.norm(rhs)
    assert true_res <= 1e-6
