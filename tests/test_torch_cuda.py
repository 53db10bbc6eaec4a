"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, at the edge shapes the main path does not reach:
row counts that are no multiple of the block, columns out of range on
both sides, rectangular operators, the 512-diagonal limit, an empty
operator, a grid-stride pass longer than its fixed grid; for the fused
V-cycle legs odd and small grids, f0 that does not divide 128, a halo of
two coarse planes and asymmetric offsets, every tile of the down and up
legs (the down leg's alone and in clusters) bit for bit, a frame whose H
cuts a grid row, and the down leg's skip of an Inf entry whose
neighbour lies outside the frame; for the windowed-ELL kernels K
from 4 to 100 (no multiple of 4 x the scalar kernel's lanes among them),
window starts that differ from tile to tile, a tile without entries (its
padding addresses one past x), a ragged last tile, slots past the end of
x, row counts that are no multiple of a block's rows, with every row
checked as written, rectangular operators, and rows off a 16-byte
boundary refused; the block windowed-ELL kernels at block sizes 2,
3 and 4 with the same edges; the BiCGStab tail and axpby_dot at
grid-stride lengths; the dense-window kernels with window starts that
differ from tile to tile, windows past the last column, empty tiles, row
counts that are no multiple of 64, rectangular operators, blocks packed
on the card, and the staged x window in one chunk, in several with a
ragged last one and as wide as the reference's 10 MiB rule admits in
both dtypes.
The DIA dot kernels' dots bit for bit with the first design's summation
order (``dia_kernels.ordered_dot``) on their own output, from 1 to
300,000 rows and at 512 diagonals, with and without interior groups; two
streams at once; a call after a refused launch; one device kernel a call.
The same for the Krylov tails' dots (``fused_vec.ordered_tail_dots``,
one launch for bicgstab_tail and axpby_dot) from 1 to 270,336 elements.
Also the wrappers' refusals, bit-identical results from run to run, and
small solves on the card against the same solves on the CPU. The gather
kernel (csrc/gather.cu) at K = 4, 8, 12 and 16 with window starts that
differ from tile to tile, an empty tile, a ragged last tile and
rectangular operators, bit for bit under every block size it takes,
rows off a 16-byte boundary refused; GMRES through it, and a cycle with npre = 2 and
npost = 0 on a hierarchy built on the card. The framed fused legs on
frames whose halos hold values on both sides, a halo wider than the
operators reach, a halo of two coarse planes and one-sided offsets,
bit-identical to the base legs on a zero frame, their refusals, and a
solve over four shards of one card against the same on the CPU. The
bfloat16 modes of the DIA, fused-leg, scalar windowed-ELL and gather
kernels and of the Krylov tails bit for bit with their plain versions at
the same edges (the dots of the dot modes within one bfloat16 ULP, and
bit for bit with the float32 sums of the kernels' order), the leg tiles
planned in bfloat16 bytes, the refusals of the kernels without one, and
bfloat16 hierarchies' solves, under a float32 and under a bfloat16 loop,
on the card against the CPU. The serving
slice: each bucket's CUDA graph replay equal bit for bit to the eager
per-column apply, the dot kernels' ticket of the capture stream made once
outside the capture and reused, a capture refused by name on a
preconditioner that syncs with the host, and a stacked solve through the
graphs against the same solve on the CPU. The stencil Galerkin plan's
device route on the card bit for bit with its host route.

Every test needs an NVIDIA card and skips without one. On the card, from
the repo root (the suite's conftest imports JAX, which the port's machine
lacks, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from amgcl_tpu_torch.ops import densewin_kernels as dwk
from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.ops import gather_kernels as gk
from amgcl_tpu_torch.ops import vcycle_kernels as vk
from amgcl_tpu_torch.ops import well_block_kernels as wbk
from amgcl_tpu_torch.ops import well_kernels as wk

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


def _bits(t):
    return t.detach().cpu().contiguous().numpy().tobytes()


def _ordered(a, b):
    return dk.ordered_dot(a.cpu().numpy(), b.cpu().numpy()).tobytes()


#: (n, offsets) of the dot kernels' order tests: group tails past n, the
#: 7-diagonal instantiation with interior blocks, 8 diagonals (the batched
#: one) and the 512-diagonal limit with interior blocks
_DOTS_CASES = [(n, (-300, -17, -1, 0, 1, 17, 300))
               for n in (1, 255, 256, 257, 70_000, 300_000)] + [
    (70_000, (-4096, -64, -3, -1, 0, 2, 64, 4096)),
    (70_000, tuple(range(-256, 256))),
    (257, tuple(range(-255, 257)))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offsets", _DOTS_CASES)
def test_dia_dots_follow_the_first_designs_order(cuda, monkeypatch, n,
                                                 offsets, dtype):
    """The dots of dia_spmv_dots (with and without w) and
    dia_residual_dot equal, bit for bit, the first design's order
    (dia_kernels.ordered_dot) applied to the kernel's own y (r) and x,
    and the same calls with every block testing its terms (no interior
    range) give the same bits."""
    off, data, x, f, w = _dia(n, n, offsets, dtype, cuda, seed=n)
    host = tuple(offsets)
    launches = (dk.dia_spmv_dots.launches, dk.dia_residual_dot.launches)

    def calls():
        return [dk.dia_spmv_dots(host, data, x, w),
                dk.dia_spmv_dots(host, data, x),
                dk.dia_residual_dot(host, data, f, x)]
    got = calls()
    for (y, yy, yx, yw), ww in zip(got[:2], (w, None)):
        assert _bits(yy) == _ordered(y, y)
        assert _bits(yx) == _ordered(y, x)
        if ww is None:
            assert yw is None
        else:
            assert _bits(yw) == _ordered(y, ww)
        assert all(d.dim() == 0 and d.device.type == "cuda"
                   for d in (yy, yx) + (() if yw is None else (yw,)))
        _close(y, dk.dia_spmv_plain(off, data, x), _scale(off, data, x, f),
               dtype)
    r, rr = got[2]
    assert _bits(rr) == _ordered(r, r)
    # a tensor of offsets (copied to the host) gives the same bits
    assert _bits(dk.dia_residual_dot(off, data, f, x)[1]) == _bits(rr)
    assert (dk.dia_spmv_dots.launches, dk.dia_residual_dot.launches) \
        == (launches[0] + 2, launches[1] + 2)
    geometry = dk.launch_geometry
    monkeypatch.setattr(dk, "launch_geometry", lambda *args: geometry(
        *args)._replace(lo=0, hi=0))
    checked = calls()
    assert [[_bits(t) for t in out if t is not None] for out in checked] \
        == [[_bits(t) for t in out if t is not None] for out in got]


def test_dia_dots_on_two_streams_at_once(cuda):
    """Two streams run dia_spmv_dots (and dia_residual_dot) at the main
    path's L0 shape at once, each several times: every call gets the bits
    of the same call made alone (each stream has its own ticket)."""
    n, offsets = 1 << 21, (-16384, -128, -1, 0, 1, 128, 16384)
    ops = [_dia(n, n, offsets, torch.float32, cuda, seed=s) for s in (1, 2)]
    alone = []
    for off, data, x, f, w in ops:
        alone.append([_bits(t) for t in dk.dia_spmv_dots(offsets, data, x, w)]
                     + [_bits(t) for t in dk.dia_residual_dot(offsets, data,
                                                               f, x)])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(4):
        for k, (s, (off, data, x, f, w)) in enumerate(zip(streams, ops)):
            with torch.cuda.stream(s):
                outs[k].append(dk.dia_spmv_dots(offsets, data, x, w)
                               + dk.dia_residual_dot(offsets, data, f, x))
    torch.cuda.synchronize()
    for k in (0, 1):
        for got in outs[k]:
            assert [_bits(t) for t in got] == alone[k]


@pytest.mark.parametrize("fault", ["short_groups", "wide_interior"])
def test_dia_dots_after_a_refused_launch(cuda, monkeypatch, fault):
    """The C entry refuses a group count one short of n, or an interior
    range one group too wide: the wrapper raises and counts no launch,
    and the next call gives the bits of a call made before."""
    n, offsets = 70_000, (-300, -17, -1, 0, 1, 17, 300)
    off, data, x, f, w = _dia(n, n, offsets, torch.float32, cuda, seed=5)
    before = [_bits(t) for t in dk.dia_spmv_dots(offsets, data, x, w)]
    geometry = dk.launch_geometry

    def faulty(*args, **kwargs):
        geo = geometry(*args, **kwargs)
        if fault == "short_groups":
            return geo._replace(groups=geo.groups - 1)
        return geo._replace(hi=geo.hi + 1)
    monkeypatch.setattr(dk, "launch_geometry", faulty)
    launches = dk.dia_spmv_dots.launches
    with pytest.raises(RuntimeError):
        dk.dia_spmv_dots(offsets, data, x, w)
    assert dk.dia_spmv_dots.launches == launches
    monkeypatch.setattr(dk, "launch_geometry", geometry)
    assert [_bits(t) for t in dk.dia_spmv_dots(offsets, data, x, w)] \
        == before


def test_dia_dots_are_one_kernel_a_call(cuda):
    """A call of dia_spmv_dots and one of dia_residual_dot under one
    torch.profiler: two device kernels in all, each a dots kernel (the
    partials' sum runs in the grid's last block, not in a second
    kernel), and one launch counted each."""
    from torch.profiler import ProfilerActivity, profile
    n, offsets = 1 << 20, (-16384, -128, -1, 0, 1, 128, 16384)
    off, data, x, f, w = _dia(n, n, offsets, torch.float32, cuda)
    calls = (lambda: dk.dia_spmv_dots(offsets, data, x, w),
             lambda: dk.dia_residual_dot(offsets, data, f, x))
    for fn in calls:            # the stream's ticket is made once, here
        fn()
    torch.cuda.synchronize()
    launches = (dk.dia_spmv_dots.launches, dk.dia_residual_dot.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2 and all("dots_kernel" in k for k in kernels), \
        kernels
    assert (dk.dia_spmv_dots.launches, dk.dia_residual_dot.launches) \
        == (launches[0] + 1, launches[1] + 1)


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
                            device=device,
                            device_setup=True)
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


# -- the fused V-cycle legs (csrc/vcycle.cu) ----------------------------------

def _leg(dims, offs_a, offs_m, device, seed=0):
    """Random DIA operators A and M (or Mᵀ) on a grid and the vectors of
    one leg, float32 on ``device``."""
    n = int(np.prod(dims))
    nc = int(np.prod(vk.coarse_dims(dims)))
    rng = np.random.RandomState(seed)
    cast = lambda a: torch.as_tensor(a).to(device=device,
                                           dtype=torch.float32)
    off = lambda o: torch.tensor(o, dtype=torch.int32, device=device)
    return (off(offs_a), cast(rng.standard_normal((len(offs_a), n))),
            off(offs_m), cast(rng.standard_normal((len(offs_m), n))),
            cast(rng.rand(n)), cast(rng.standard_normal(n)),
            cast(rng.standard_normal(n)), cast(rng.standard_normal(nc)))


def _down_terms(oa, a, om, mt, f, u, dims, zero_guess=False):
    """Σ|terms| of each output entry of the down leg: the plain version on
    |operands| with the operators negated, so every subtraction adds."""
    got = vk.fused_down_sweep_plain(oa, -a.abs(), om, -mt.abs(), f.abs(),
                                    u.abs(), dims, zero_guess)
    return got[1] if zero_guess else got


def _up_terms(oa, a, om, m, w, f, u, uc, dims):
    return vk.fused_up_sweep_plain(oa, -a.abs(), om, -m.abs(), w.abs(),
                                   f.abs(), u.abs(), uc.abs(), dims)


def _within(got, want, terms, rtol=1e-5):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(((got - want).abs() <= rtol * terms).all()), \
        float(((got - want).abs() / terms.clamp_min(1e-30)).max())


def _plane_offsets(dims):
    _, f1, f0 = dims
    s = f1 * f0
    return (-s, -f0, -1, 0, 1, f0, s)


_LEG_CASES = {
    # name: (dims, A offsets, M offsets)
    "odd_f2": ((5, 8, 16), None, None),
    "odd_all": ((3, 5, 7), None, None),
    "f0_96": ((4, 8, 96), None, None),
    "f0_20": ((4, 6, 20), None, None),
    "smallest": ((2, 2, 2), None, None),
    "f2_2": ((2, 4, 6), None, None),
    # hA + hM = 3 planes: the up leg reads 2 coarse planes each side
    "two_plane_halo": ((8, 8, 16), (-256, -129, -1, 0, 1, 129, 256),
                       (-128, -1, 0, 1, 128)),
    "one_sided": ((4, 8, 128), (-1024, -128, -1, 0), (-1024, 0, 1, 128)),
    "opposite_skews": ((4, 8, 128), (0, 1, 128, 1024),
                       (-1024, -128, -1, 0, 1)),
    "dz_2": ((4, 8, 128), (-2048, 0, 2048), (-1024, 0, 1024)),
}


def _case(name, device):
    dims, oa, om = _LEG_CASES[name]
    oa = oa or _plane_offsets(dims)
    om = om or _plane_offsets(dims)
    return dims, _leg(dims, oa, om, device, seed=len(name))


@pytest.mark.parametrize("name", sorted(_LEG_CASES))
def test_fused_down_matches_plain(cuda, name):
    dims, (oa, a, om, mt, w, f, u, _) = _case(name, cuda)
    launches = vk.fused_down_sweep.launches
    got = vk.fused_down_sweep(oa, a, om, mt, f, u, dims)
    want = vk.fused_down_sweep_plain(oa, a, om, mt, f, u, dims)
    _within(got, want, _down_terms(oa, a, om, mt, f, u, dims))
    u_z, rc_z = vk.fused_down_sweep(oa, a, om, mt, f, w, dims,
                                    zero_guess=True)
    u_p, rc_p = vk.fused_down_sweep_plain(oa, a, om, mt, f, w, dims,
                                          zero_guess=True)
    assert torch.equal(u_z, u_p)              # one product per entry
    _within(rc_z, rc_p, _down_terms(oa, a, om, mt, f, w, dims, True))
    assert vk.fused_down_sweep.launches == launches + 2


@pytest.mark.parametrize("name", sorted(n for n in _LEG_CASES
                                        if _LEG_CASES[n][0][0] % 2 == 0))
def test_fused_up_matches_plain(cuda, name):
    dims, (oa, a, om, m, w, f, u, uc) = _case(name, cuda)
    launches = vk.fused_up_sweep.launches
    got = vk.fused_up_sweep(oa, a, om, m, w, f, u, uc, dims)
    want = vk.fused_up_sweep_plain(oa, a, om, m, w, f, u, uc, dims)
    _within(got, want, _up_terms(oa, a, om, m, w, f, u, uc, dims))
    assert vk.fused_up_sweep.launches == launches + 1


def test_fused_legs_are_bit_identical_from_run_to_run(cuda):
    dims = (16, 32, 64)
    oa, a, om, m, w, f, u, uc = _leg(dims, _plane_offsets(dims),
                                     _plane_offsets(dims), cuda)

    def run():
        return [vk.fused_down_sweep(oa, a, om, m, f, u, dims),
                *vk.fused_down_sweep(oa, a, om, m, f, w, dims, True),
                vk.fused_up_sweep(oa, a, om, m, w, f, u, uc, dims)]

    first, again = run(), run()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


_UP_TILE_CASES = {
    # name: (dims, A offsets, M offsets, zoff, frame planes); the tiles
    # below leave f2 and f1 no multiple of tz and ty
    "ragged": ((6, 10, 12), None, None, 0, None),
    "f0_100": ((4, 6, 100), None, None, 0, None),
    "small_f0": ((6, 9, 2), None, None, 0, None),
    "f0_1": ((4, 7, 1), None, None, 0, None),
    "wide_reach": ((8, 6, 5), None, None, 0, None),
    "framed": ((6, 10, 12), None, None, 2, 10),
    "framed_two_planes": ((4, 8, 16), (-256, -129, -1, 0, 1, 129, 256),
                          (-128, -1, 0, 1, 128), 4, 12),
}


def _up_tile_case(name, device):
    dims, oa, om, zoff, fz = _UP_TILE_CASES[name]
    f2, f1, f0 = dims
    s = f1 * f0
    oa = list(oa or _plane_offsets(dims))
    om = list(om or _plane_offsets(dims))
    if name == "wide_reach":
        # the 27-point steps and two-step ones along each axis, as L1's
        r = (-1, 0, 1)
        oa = om = sorted({(dz * f1 + dy) * f0 + dx for dz in r for dy in r
                          for dx in r} | {2, -2, 2 * f0, -2 * f0, 2 * s,
                                          -2 * s})
    fz = f2 if fz is None else fz
    n, Lm = f2 * s, fz * s
    rng = np.random.RandomState(len(name))
    cast = lambda a: torch.as_tensor(a).to(device=device,
                                           dtype=torch.float32)
    c2, c1, c0 = vk.coarse_dims((fz, f1, f0))
    return dims, oa, om, zoff, fz, (
        cast(rng.standard_normal((len(oa), n))),
        cast(rng.standard_normal((len(om), Lm))), cast(rng.rand(n)),
        cast(rng.standard_normal(n)), cast(rng.standard_normal(Lm)),
        cast(rng.standard_normal(c2 * c1 * c0)))


@pytest.mark.parametrize("name", sorted(_UP_TILE_CASES))
def test_up_tiles_agree_bit_for_bit(cuda, name):
    """The up leg over every tile shape from one plane by one row to
    4 × 5, f2 and f1 no multiple of the tile, f0 = 100 (no multiple of a
    warp), small f0, and framed (tile plane z at frame plane z + zoff, the box's halo
    planes from the frame): every tile gives the same bits, which agree
    with the plain version."""
    dims, oa, om, zoff, fz, (a, m, w, f, u, uc) = _up_tile_case(name, cuda)
    ot, mt = (torch.tensor(o, dtype=torch.int32, device=cuda)
              for o in (oa, om))
    hp = zoff // 2
    if zoff:
        want = vk.fused_up_sweep_framed_plain(oa, a, om, m, w, f, u, uc,
                                              dims, hp)
        got = vk.fused_up_sweep_framed(oa, a, om, m, w, f, u, uc, dims, hp)
        terms = vk.fused_up_sweep_framed_plain(
            oa, -a.abs(), om, -m.abs(), w.abs(), f.abs(), u.abs(),
            uc.abs(), dims, hp)
    else:
        want = vk.fused_up_sweep_plain(ot, a, mt, m, w, f, u, uc, dims)
        got = vk.fused_up_sweep(oa, a, mt, m, w, f, u, uc, dims)
        terms = _up_terms(ot, a, mt, m, w, f, u, uc, dims)
    _within(got, want, terms)
    tile = vk.up_tile(oa, om, dims)
    for tz in (1, 2, 4):
        for ty in (1, 3, 5):
            t = tile._replace(tz=tz, ty=ty)
            other = vk._launch_up(oa, om, ot, a, mt, m, w, f, u, uc, dims,
                                  zoff, fz, t, "up")
            assert torch.equal(other, got), (tz, ty)


def test_up_entry_refuses_a_short_halo(cuda):
    """The C entry checks the tile against A's and M's offsets: a halo of
    either box one row or plane short on any side is refused."""
    dims, oa, om, zoff, fz, (a, m, w, f, u, uc) = _up_tile_case(
        "wide_reach", cuda)
    ot, mt = (torch.tensor(o, dtype=torch.int32, device=cuda)
              for o in (oa, om))
    tile = vk.up_tile(oa, om, dims)
    assert all(tile.halo) and all(tile.mhalo)
    for field in ("halo", "mhalo"):
        for k in range(4):
            halo = list(getattr(tile, field))
            halo[k] -= 1
            with pytest.raises(RuntimeError, match="invalid argument"):
                vk._launch_up(oa, om, ot, a, mt, m, w, f, u, uc, dims, zoff,
                              fz, tile._replace(**{field: tuple(halo)}),
                              "up")


def test_up_wrapper_refuses_a_box_past_shared_memory(cuda):
    """A grid row of 2,048 points with a row and a plane of halo on each
    side cannot be staged: the wrapper raises, with no fallback."""
    dims = (4, 4, 2048)
    oa, a, om, m, w, f, u, uc = _leg(dims, _plane_offsets(dims),
                                     _plane_offsets(dims), cuda)
    launches = vk.fused_up_sweep.launches
    with pytest.raises(ValueError, match="shared memory"):
        vk.fused_up_sweep(oa, a, om, m, w, f, u, uc, dims)
    assert vk.fused_up_sweep.launches == launches


_DOWN_TILE_CASES = {
    # name: (dims, A offsets, Mᵀ offsets, H, or None for the base mode);
    # the tiles below leave f2 and f1 no multiple of tz and ty
    "ragged": ((6, 10, 12), None, None, None),
    "odd_all": ((5, 7, 9), None, None, None),
    "f0_100": ((4, 6, 100), None, None, None),
    "small_f0": ((6, 9, 2), None, None, None),
    "f0_1": ((5, 7, 1), None, None, None),
    "wide_reach": ((8, 6, 5), None, None, None),
    "one_sided": ((6, 5, 8), (0, 1, 9, 40, 81), (-81, -40, -8, 0), None),
    # H cuts a grid row: the frame's first and last rows end mid-row
    "framed_cut_row": ((6, 10, 12), None, None, 2 * 120 + 5),
    "framed_two_planes": ((4, 8, 16), (-256, -129, -1, 0, 1, 129, 256),
                          (-128, -1, 0, 1, 128), 384),
}


def _down_tile_case(name, device):
    """A down-leg case on ``device``: dims, offsets, H, L and the frames
    (the tile's own rows in the base mode, H = 0) a, mt, f, u, w."""
    dims, oa, om, H = _DOWN_TILE_CASES[name]
    f2, f1, f0 = dims
    s = f1 * f0
    oa = list(oa or _plane_offsets(dims))
    om = list(om or _plane_offsets(dims))
    if name == "wide_reach":
        # the 27-point steps and two-step ones along each axis, as L1's
        r = (-1, 0, 1)
        oa = om = sorted({(dz * f1 + dy) * f0 + dx for dz in r for dy in r
                          for dx in r} | {2, -2, 2 * f0, -2 * f0, 2 * s,
                                          -2 * s})
    H = H or 0
    L = f2 * s + 2 * H
    rng = np.random.RandomState(len(name))
    cast = lambda a: torch.as_tensor(a).to(device=device,
                                           dtype=torch.float32)
    return dims, oa, om, H, L, (
        cast(rng.standard_normal((len(oa), L))),
        cast(rng.standard_normal((len(om), L))),
        cast(rng.standard_normal(L)), cast(rng.standard_normal(L)),
        cast(rng.rand(L)))


def _down_any(oa, a, om, mt, f, x, dims, H, zero, plain=False):
    """The down leg in its base mode (H = 0) or framed, kernel or plain."""
    if H:
        fn = vk.fused_down_sweep_framed_plain if plain \
            else vk.fused_down_sweep_framed
        return fn(oa, a, om, mt, f, x, dims, H, zero)
    fn = vk.fused_down_sweep_plain if plain else vk.fused_down_sweep
    return fn(oa, a, om, mt, f, x, dims, zero)


def _down_pairs(got, want, zero):
    return list(zip(got, want)) if zero else [(got, want)]


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("name", sorted(_DOWN_TILE_CASES))
def test_down_tiles_agree_bit_for_bit(cuda, name, zero):
    """The down leg over every even tile from 2 × 2 to 6 × 4, alone and
    in clusters of 2 to 8 tiles (rows of box R read from the block that
    formed them), in the base mode on odd extents, f2 and
    f1 no multiple of the tile, f0 = 100 (no multiple of a warp), small
    f0, one-sided offsets, and framed on a frame whose H cuts a grid row:
    every tile gives the same bits, which agree with the plain version."""
    dims, oa, om, H, L, (a, mt, f, u, w) = _down_tile_case(name, cuda)
    x = w if zero else u
    got = _down_any(oa, a, om, mt, f, x, dims, H, zero)
    want = _down_any(oa, a, om, mt, f, x, dims, H, zero, plain=True)
    terms = _down_any(oa, -a.abs(), om, -mt.abs(), f.abs(), x.abs(), dims,
                      H, zero, plain=True)
    if zero:
        assert torch.equal(got[0], want[0])   # one product per entry
        _within(got[1], want[1], terms[1])
    else:
        _within(got, want, terms)
    ot, mt_o = (torch.tensor(o, dtype=torch.int32, device=cuda)
                for o in (oa, om))
    tile = vk.down_tile(oa, om, dims)
    for cz, cy in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2)):
        for tz in (2, 4, 6):
            for ty in (2, 4):
                t = tile._replace(tz=tz, ty=ty, cz=cz, cy=cy)
                other = vk._launch_down(oa, om, ot, a, mt_o, mt, f, x, dims,
                                        H, L, zero, t, "down")
                assert all(torch.equal(o_, g)
                           for o_, g in _down_pairs(other, got, zero)), \
                    (tz, ty, cz, cy)


@pytest.mark.parametrize("framed", [False, True])
def test_down_skips_neighbours_outside_the_frame(cuda, framed):
    """An A or Mᵀ entry whose neighbour lies outside the frame is skipped,
    not multiplied by a staged 0: with +Inf in every such entry the
    results stay finite and equal, bit for bit, those with the entries
    0, and agree with the plain version (which skips them too)."""
    name = "framed_cut_row" if framed else "ragged"
    dims, oa, om, H, L, (a, mt, f, u, w) = _down_tile_case(name, cuda)
    rows = torch.arange(L, device=cuda)

    def poison(data, offsets, value):
        data = data.clone()
        for k, o in enumerate(offsets):
            out = (rows + o < 0) | (rows + o >= L)
            data[k, out] = value
        return data
    ot, mt_o = (torch.tensor(o, dtype=torch.int32, device=cuda)
                for o in (oa, om))
    tile = vk.down_tile(oa, om, dims)
    for zero, x in ((False, u), (True, w)):
        runs = []
        for value in (float("inf"), 0.0):
            ai, mti = poison(a, oa, value), poison(mt, om, value)
            for cz in (1, 2):
                runs.append(vk._launch_down(
                    oa, om, ot, ai, mt_o, mti, f, x, dims, H, L, zero,
                    tile._replace(cz=cz, cy=1), "down"))
        want = _down_any(oa, poison(a, oa, float("inf")), om,
                         poison(mt, om, float("inf")), f, x, dims, H, zero,
                         plain=True)
        rc = [r[1] if zero else r for r in runs]
        assert all(bool(torch.isfinite(v).all()) for v in rc)
        assert all(torch.equal(v, rc[0]) for v in rc[1:])
        w_rc = want[1] if zero else want
        assert bool(torch.isfinite(w_rc).all())
        terms = _down_any(oa, -poison(a, oa, 0.0).abs(), om,
                          -poison(mt, om, 0.0).abs(), f.abs(), x.abs(), dims,
                          H, zero, plain=True)
        _within(rc[0], w_rc, terms[1] if zero else terms)


def test_down_entry_refuses_a_short_tile(cuda):
    """The C entry checks the tile against A's and Mᵀ's offsets: a halo of
    box R or box U one row or plane short on any side is refused, and so
    are odd tile extents and clusters past 8 tiles."""
    dims, oa, om, H, L, (a, mt, f, u, w) = _down_tile_case("wide_reach",
                                                           cuda)
    ot, mt_o = (torch.tensor(o, dtype=torch.int32, device=cuda)
                for o in (oa, om))
    tile = vk.down_tile(oa, om, dims)
    assert all(tile.halo) and all(tile.ahalo)
    bad = [tile._replace(tz=3), tile._replace(ty=1), tile._replace(tz=0),
           tile._replace(cz=0), tile._replace(cz=3, cy=3)]
    for field in ("halo", "ahalo"):
        for k in range(4):
            halo = list(getattr(tile, field))
            halo[k] -= 1
            bad.append(tile._replace(**{field: tuple(halo)}))
    launches = vk.fused_down_sweep.launches
    for t in bad:
        with pytest.raises(RuntimeError, match="invalid argument"):
            vk._launch_down(oa, om, ot, a, mt_o, mt, f, u, dims, H, L,
                            False, t, "down")
    assert vk.fused_down_sweep.launches == launches


def test_down_wrapper_refuses_a_box_past_shared_memory(cuda):
    """A grid row of 4,096 points with a row and a plane of halo on each
    side cannot be staged: the wrappers raise, with no fallback."""
    dims = (4, 4, 4096)
    oa, a, om, mt, w, f, u, _ = _leg(dims, _plane_offsets(dims),
                                     _plane_offsets(dims), cuda)
    launches = vk.fused_down_sweep.launches
    for zero, x in ((False, u), (True, w)):
        with pytest.raises(ValueError, match="shared memory"):
            vk.fused_down_sweep(oa, a, om, mt, f, x, dims, zero)
    assert vk.fused_down_sweep.launches == launches


@pytest.mark.parametrize("bad", ["device", "dtype", "float64", "f_shape",
                                 "uc_shape", "offsets_dtype", "dims"])
def test_fused_wrappers_refuse_malformed_operands(cuda, bad):
    dims = (4, 4, 8)
    oa, a, om, m, w, f, u, uc = _leg(dims, _plane_offsets(dims),
                                     _plane_offsets(dims), cuda)
    if bad == "device":
        u = u.cpu()
    elif bad == "dtype":
        f = f.half()
    elif bad == "float64":
        a, m, w, f, u, uc = (t.double() for t in (a, m, w, f, u, uc))
    elif bad == "f_shape":
        f = f[:-1]
    elif bad == "uc_shape":
        uc = uc[:-1]
    elif bad == "offsets_dtype":
        oa = oa.long()
    else:
        dims = (4, 4, 9)
    launches = (vk.fused_down_sweep.launches, vk.fused_up_sweep.launches)
    with pytest.raises(ValueError):
        vk.fused_up_sweep(oa, a, om, m, w, f, u, uc, dims)
    if bad != "uc_shape":
        with pytest.raises(ValueError):
            vk.fused_down_sweep(oa, a, om, m, f, u, dims)
    assert (vk.fused_down_sweep.launches, vk.fused_up_sweep.launches) \
        == launches


def test_device_setup_solve_on_card_matches_cpu(cuda):
    """poisson3d(24) with the stencil levels built on the card and the
    fused legs launched, against the host build on the CPU: the same level
    shapes, iterations within one, the true residual within tolerance."""
    from amgcl_tpu_torch import AMGParams, CG, make_solver, poisson3d
    A, rhs = poisson3d(24)
    runs = {}
    for device, setup in (("cpu", False), (cuda, True)):
        solve = make_solver(A, AMGParams(dtype=torch.float32),
                            CG(maxiter=100, tol=1e-6), refine=3,
                            device=device, device_setup=setup)
        assert solve.precond.device_built == setup
        launches = vk.fused_down_sweep.launches
        x, info = solve(rhs)
        if setup:
            assert vk.fused_down_sweep.launches > launches
        runs[setup] = (info.iters, x.double().cpu().numpy(),
                       [h[0].nrows for h in solve.precond.host_levels])
    assert runs[True][2] == runs[False][2]
    assert abs(runs[True][0] - runs[False][0]) <= 1
    x = runs[True][1]
    assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) <= 1e-6


# -- the windowed-ELL kernels (csrc/well_block.cu, b = 1) and the BiCGStab tail

def _well(n_out, ncols, K, dtype, device, seed=0, empty=None):
    """Random windowed-ELL arrays: n_out rows in tiles of 1,024, windows of
    2,048 columns whose starts differ from tile to tile, about a quarter
    of the slots padding (column 0, value 0). Tile ``empty`` holds no entry
    and starts at ncols, as tile_windows packs such a tile."""
    rng = np.random.RandomState(seed)
    tile, win = 1024, 2048
    n_tiles = -(-n_out // tile)
    starts = rng.randint(0, max(ncols - win, 0) // 1024 + 1, n_tiles) * 1024
    span = np.minimum(win, ncols - starts)
    cols = (rng.rand(n_tiles, tile, K) * span[:, None, None]).astype(
        np.int32)
    vals = rng.standard_normal((n_tiles, tile, K))
    pad = rng.rand(n_tiles, tile, K) < 0.25
    cols[pad], vals[pad] = 0, 0.0
    if empty is not None:
        starts[empty] = ncols
        cols[empty], vals[empty] = 0, 0.0
    x, f, w = rng.standard_normal(ncols), rng.standard_normal(n_out), \
        rng.rand(n_out)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)
    fl = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    return i32(starts), i32(cols), fl(vals), fl(x), fl(f), fl(w)


_WELL_CASES = [
    # (n_out, ncols, K, empty tile)
    (5000, 5000, 4, None),            # ragged last tile
    (6144, 6144, 8, 2),               # empty tile; ncols a multiple of 1024
    (10000, 10000, 20, None),
    (30000, 30000, 48, 7),
    (3000, 3000, 52, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,K,empty", _WELL_CASES)
def test_well_square_modes_match_plain(cuda, n, m, K, empty, dtype):
    st, cl, v, x, f, w = _well(n, m, K, dtype, cuda, seed=K, empty=empty)
    terms = wk.windowed_ell_spmv_plain(st, cl, v.abs(), x.abs(), n)
    got = wk.windowed_ell_spmv(st, cl, v, x, n)
    want = wk.windowed_ell_spmv_plain(st, cl, v, x, n)
    _close(got, want, float(terms.max()), dtype)
    got = wk.windowed_ell_residual(st, cl, v, f, x, n)
    want = wk.windowed_ell_residual_plain(st, cl, v, f, x, n)
    scale = float((terms + f.abs()).max())
    _close(got, want, scale, dtype)
    got = wk.windowed_ell_scaled_correction(st, cl, v, w, f, x, n)
    want = wk.windowed_ell_scaled_correction_plain(st, cl, v, w, f, x, n)
    _close(got, want, float((x.abs() + w * (terms + f.abs())).max()),
           dtype)
    for wv in (None, w):
        got = wk.windowed_ell_spmv_dots(st, cl, v, x, wv, n)
        want = wk.windowed_ell_spmv_dots_plain(st, cl, v, x, wv, n)
        _close(got[0], want[0], float(terms.max()), dtype)
        _dot_close(got[1], want[1], terms, 2 * terms, dtype)
        _dot_close(got[2], want[2], terms, x, dtype)
        if wv is None:
            assert got[3] is None
        else:
            _dot_close(got[3], want[3], terms, wv, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(5000, 12000), (12000, 5000)])
def test_well_rectangular_spmv_and_residual_match_plain(cuda, n, m, dtype):
    st, cl, v, x, f, _ = _well(n, m, 12, dtype, cuda, seed=n)
    terms = wk.windowed_ell_spmv_plain(st, cl, v.abs(), x.abs(), n)
    _close(wk.windowed_ell_spmv(st, cl, v, x, n),
           wk.windowed_ell_spmv_plain(st, cl, v, x, n),
           float(terms.max()), dtype)
    _close(wk.windowed_ell_residual(st, cl, v, f, x, n),
           wk.windowed_ell_residual_plain(st, cl, v, f, x, n),
           float((terms + f.abs()).max()), dtype)


def test_well_starts_are_read(cuda):
    """The same columns under shifted window starts give another product:
    a kernel that ignored the starts would return the same one."""
    st, cl, v, x, _, _ = _well(6000, 20000, 16, torch.float32, cuda, seed=3)
    assert len(set(st.tolist())) > 2
    y = wk.windowed_ell_spmv(st, cl, v, x, 6000)
    y0 = wk.windowed_ell_spmv(torch.zeros_like(st), cl, v, x, 6000)
    assert float((y - y0).abs().max()) > 1.0
    _close(y0, wk.windowed_ell_spmv_plain(torch.zeros_like(st), cl, v, x,
                                          6000),
           float(wk.windowed_ell_spmv_plain(
               torch.zeros_like(st), cl, v.abs(), x.abs(), 6000).max()),
           torch.float32)


def test_well_dots_are_bit_identical_and_counted(cuda):
    st, cl, v, x, _, w = _well(30000, 30000, 48, torch.float32, cuda)
    launches = wk.windowed_ell_spmv_dots.launches
    a = wk.windowed_ell_spmv_dots(st, cl, v, x, w, 30000)
    b = wk.windowed_ell_spmv_dots(st, cl, v, x, w, 30000)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert wk.windowed_ell_spmv_dots.launches == launches + 2


@pytest.mark.parametrize("bad", ["cpu_x", "dtype", "cols_dtype",
                                 "starts_shape", "n_out", "rect_dots",
                                 "f_shape", "bf16"])
def test_well_wrappers_refuse_malformed_operands(cuda, bad):
    n = 3000
    st, cl, v, x, f, w = _well(n, n, 8, torch.float32, cuda)
    if bad == "cpu_x":
        st = st.cpu()
    elif bad == "dtype":
        f = f.double()
    elif bad == "cols_dtype":
        cl = cl.long()
    elif bad == "starts_shape":
        st = st[:-1]
    elif bad == "n_out":
        n = 1000
    elif bad == "rect_dots":
        x = torch.cat([x, x[:5]])
    elif bad == "f_shape":
        f = f[:-1]
    elif bad == "bf16":
        v = v.bfloat16()
    counters = (wk.windowed_ell_residual, wk.windowed_ell_spmv_dots)
    launches = [c.launches for c in counters]
    with pytest.raises(ValueError):
        if bad == "rect_dots":
            wk.windowed_ell_spmv_dots(st, cl, v, x, None, n)
        else:
            wk.windowed_ell_residual(st, cl, v, f, x, n)
    assert [c.launches for c in counters] == launches


def _poisoned(n, dtype, device):
    """Leave NaN in the allocator's free block of n entries, which the
    next output of that size takes: a row the kernel does not write
    stays NaN."""
    torch.full((n,), float("nan"), dtype=dtype, device=device)


def _written(fn, n, dtype, device):
    _poisoned(n, dtype, device)
    out = fn()
    y = out[0] if isinstance(out, tuple) else out
    assert bool(torch.isfinite(y).all()), "rows left unwritten"
    return out


def _well_edges(n_out, ncols, K, dtype, device, seed=0):
    """Windowed-ELL operands at the scalar kernel's edges: tiles of 1,024
    (the last one ragged), tile 1 without entries and starting at ncols
    where there are three tiles or more, and the last tile's window
    starting 512 columns before ncols, so that some of its slots, values
    nonzero, lie at or past the end of x and must contribute nothing."""
    empty = 1 if n_out > 2 * 1024 else None
    st, cl, v, x, f, w = _well(n_out, ncols, K, dtype, "cpu", seed=seed,
                               empty=empty)
    rng = np.random.RandomState(seed + 1)
    st[-1] = max(ncols - 512, 0)
    cl[-1] = torch.as_tensor(rng.randint(0, 1024, cl[-1].shape),
                             dtype=torch.int32)
    v[-1] = torch.as_tensor(rng.standard_normal(v[-1].shape)).to(dtype)
    return [t.to(device) for t in (st, cl, v, x, f, w)]


_WELL_EDGE_CASES = [
    # (n_out, K): n_out no multiple of the rows a warp or a block covers
    (3109, 4), (200, 4), (3109, 12), (3109, 48), (2085, 52), (3109, 100),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,K", _WELL_EDGE_CASES)
def test_well_scalar_geometry_edges(cuda, n, K, dtype):
    """Every mode of the sub-warp kernel at K from 4 to 100 (K = 12, 52
    and 100 no multiple of 4 x its lanes), on every row of a ragged grid,
    an empty tile and slots past the end of x; the dots also bit for bit
    from run to run."""
    st, cl, v, x, f, w = _well_edges(n, n, K, dtype, cuda, seed=K)
    lanes = wk.launch_geometry(n, K).lanes
    assert lanes == 4 or lanes * 4 >= K
    assert int(((cl[-1].long() + st[-1]) >= n).sum()) > 0
    terms = wk.windowed_ell_spmv_plain(st, cl, v.abs(), x.abs(), n)
    got = _written(lambda: wk.windowed_ell_spmv(st, cl, v, x, n), n, dtype,
                   cuda)
    _close(got, wk.windowed_ell_spmv_plain(st, cl, v, x, n),
           float(terms.max()), dtype)
    got = _written(lambda: wk.windowed_ell_residual(st, cl, v, f, x, n), n,
                   dtype, cuda)
    _close(got, wk.windowed_ell_residual_plain(st, cl, v, f, x, n),
           float((terms + f.abs()).max()), dtype)
    got = _written(lambda: wk.windowed_ell_scaled_correction(
        st, cl, v, w, f, x, n), n, dtype, cuda)
    _close(got, wk.windowed_ell_scaled_correction_plain(st, cl, v, w, f, x,
                                                        n),
           float((x.abs() + w * (terms + f.abs())).max()), dtype)
    for wv in (None, w):
        got = _written(lambda: wk.windowed_ell_spmv_dots(st, cl, v, x, wv,
                                                         n), n, dtype, cuda)
        want = wk.windowed_ell_spmv_dots_plain(st, cl, v, x, wv, n)
        _close(got[0], want[0], float(terms.max()), dtype)
        _dot_close(got[1], want[1], terms, 2 * terms, dtype)
        _dot_close(got[2], want[2], terms, x, dtype)
        if wv is not None:
            _dot_close(got[3], want[3], terms, wv, dtype)
        again = wk.windowed_ell_spmv_dots(st, cl, v, x, wv, n)
        assert all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(got, again))


@pytest.mark.parametrize("bad", ["vals", "cols", "K"])
def test_well_scalar_refuses_misaligned_rows(cuda, bad):
    """The scalar kernel reads rows in 16-byte vectors: a base off a
    16-byte boundary, or K no multiple of 4, raises before any launch."""
    n = 3000
    st, cl, v, x, f, _ = _well(n, n, 8, torch.float32, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    if bad == "vals":
        v = shifted(v)
    elif bad == "cols":
        cl = shifted(cl)
    else:
        cl, v = cl[:, :, :6].contiguous(), v[:, :, :6].contiguous()
    assert bad == "K" or (v.data_ptr() | cl.data_ptr()) % 16
    launches = wk.windowed_ell_residual.launches
    with pytest.raises(ValueError, match="16-byte"):
        wk.windowed_ell_residual(st, cl, v, f, x, n)
    assert wk.windowed_ell_residual.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 1000, 1056 * 256 * 3 + 7])
def test_bicgstab_tail_matches_plain(cuda, n, dtype):
    rng = np.random.RandomState(n + 1)
    ph, sh, s, t, x, rh = (torch.as_tensor(rng.standard_normal(n)).to(
        device=cuda, dtype=dtype) for _ in range(6))
    launches = fv.bicgstab_tail.launches
    for a, om in ((torch.tensor(0.37, dtype=dtype, device=cuda),
                   torch.tensor(-1.3, dtype=dtype, device=cuda)),
                  (-1.25, 0.5)):
        got = fv.bicgstab_tail(a, ph, om, sh, s, t, x, rh)
        want = fv.bicgstab_tail_plain(a, ph, om, sh, s, t, x, rh)
        scale = float(x.abs().max() + s.abs().max()
                      + 1.3 * (ph.abs().max() + sh.abs().max()
                               + t.abs().max()))
        _close(got[0], want[0], scale, dtype)
        _close(got[1], want[1], scale, dtype)
        # r' = s − ω t may cancel: its error scales with |s| + |ω t|
        # (the kernel may fuse the product), and so do the dots'
        rn_terms = s.abs() + abs(float(om)) * t.abs()
        _dot_close(got[2], want[2], rn_terms, 2 * rn_terms, dtype)
        _dot_close(got[3], want[3], rh, rn_terms, dtype)
    assert fv.bicgstab_tail.launches == launches + 2
    with pytest.raises(ValueError):
        fv.bicgstab_tail(0.1, ph, torch.tensor(0.2, dtype=dtype), sh, s, t,
                         x, rh)


# -- the Krylov tails' one launch (csrc/vec.cu tail_dots_kernel) -------------

def _tail_calls(n, dtype, device, seed):
    """The three tails on one set of random vectors, each a closure."""
    rng = np.random.RandomState(seed)
    v = [torch.as_tensor(rng.standard_normal(n)).to(device=device,
                                                    dtype=dtype)
         for _ in range(6)]
    a, w, b, one = (torch.tensor(c, dtype=dtype, device=device)
                    for c in (0.37, -1.3, -0.37, 1.0))
    return v, {"bicg_tail": lambda: fv.bicgstab_tail(a, v[0], w, *v[1:]),
               "axpby_dot": lambda: fv.axpby_dot(b, v[0], one, v[1]),
               "xr": lambda: fv.xr_update(a, *v[:4])}


def _tail_ordered(mode, out, v):
    """The tails' order (fused_vec.ordered_tail_dots) on a call's own
    r' (or z) and r̂, as bytes."""
    np_ = lambda t: t.cpu().numpy()
    if mode == "bicg_tail":
        want = fv.ordered_tail_dots(np_(out[1]), np_(v[5]))
    else:
        want = fv.ordered_tail_dots(np_(out[-2]))
    return [d.tobytes() for d in want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 255, 257, 1000, 85623, 256 * 1056])
def test_tail_dots_follow_the_tails_order(cuda, n, dtype):
    """The dots of bicgstab_tail and axpby_dot (one launch) and of
    xr_update (two) equal, bit for bit, the tails' order
    (fused_vec.ordered_tail_dots) on the call's own r' (or z) and r̂, at
    ragged n, the BiCGStab paths' and the largest n of one element a
    thread."""
    v, calls = _tail_calls(n, dtype, cuda, seed=n)
    for mode, fn in calls.items():
        out = fn()
        dots = out[2:] if mode == "bicg_tail" else out[-1:]
        assert [_bits(d) for d in dots] == _tail_ordered(mode, out, v), mode
        assert all(d.dim() == 0 and d.device.type == "cuda" for d in dots)


def test_tail_dots_are_one_kernel_a_call(cuda):
    """A call of bicgstab_tail and one of axpby_dot under one
    torch.profiler: two device kernels in all, each the one-launch tail
    (the partials' sum runs in the grid's last block), and one launch
    counted each."""
    from torch.profiler import ProfilerActivity, profile
    _, calls = _tail_calls(85623, torch.float32, cuda, seed=1)
    fns = (calls["bicg_tail"], calls["axpby_dot"])
    for fn in fns:              # the stream's ticket is made once, here
        fn()
    torch.cuda.synchronize()
    launches = (fv.bicgstab_tail.launches, fv.axpby_dot.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2 and all("tail_dots_kernel" in k
                                     for k in kernels), kernels
    assert (fv.bicgstab_tail.launches, fv.axpby_dot.launches) \
        == (launches[0] + 1, launches[1] + 1)


def test_tail_dots_on_two_streams_at_once(cuda):
    """Two streams run bicgstab_tail and axpby_dot at the BiCGStab paths'
    n at once, each several times: every call gets the bits of the same
    call made alone (each stream has its own ticket)."""
    sets = [_tail_calls(85623, torch.float32, cuda, seed=s)[1]
            for s in (1, 2)]
    run = lambda c: c["bicg_tail"]() + c["axpby_dot"]()
    alone = [[_bits(t) for t in run(c)] for c in sets]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(4):
        for k, (s, c) in enumerate(zip(streams, sets)):
            with torch.cuda.stream(s):
                outs[k].append(run(c))
    torch.cuda.synchronize()
    for k in (0, 1):
        for got in outs[k]:
            assert [_bits(t) for t in got] == alone[k]


@pytest.mark.parametrize("mode", ["bicg_tail", "axpby_dot", "xr"])
def test_tail_after_a_refused_launch(cuda, monkeypatch, mode):
    """The C entries refuse a grid one block short: the wrapper raises and
    counts no launch, the stream's ticket is still 0, and the next call
    gives the bits of a call made before."""
    v, calls = _tail_calls(85623, torch.float32, cuda, seed=5)
    wrapper = {"bicg_tail": fv.bicgstab_tail, "axpby_dot": fv.axpby_dot,
               "xr": fv.xr_update}[mode]
    before = [_bits(t) for t in calls[mode]()]
    blocks = fv.tail_blocks
    monkeypatch.setattr(fv, "tail_blocks", lambda n: blocks(n) - 1)
    launches = wrapper.launches
    with pytest.raises(RuntimeError):
        calls[mode]()
    assert wrapper.launches == launches
    monkeypatch.setattr(fv, "tail_blocks", blocks)
    ticket = dk._ticket(v[0].device,
                        torch.cuda.current_stream().cuda_stream)
    assert int(ticket.item()) == 0
    assert [_bits(t) for t in calls[mode]()] == before


@pytest.mark.parametrize("order,side", [("identity", "right"),
                                        ("rcm", "left")])
def test_unstructured_solve_on_card_matches_cpu(cuda, order, side):
    """A small fe_like_problem with BiCGStab in float64: the card and the
    CPU build the same hierarchy, take the same iterations and agree on
    x to 1e-8 (BiCGStab amplifies the other summation order); every
    windowed-ELL kernel of the side launches and no plain version runs
    on the card. The true residual meets tol on the right side; on the
    left side tol bounds the preconditioned residual, and the true one
    stays below 1e-6."""
    from amgcl_tpu_torch import AMGParams, BiCGStab, fe_like_problem, \
        make_solver
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    A, rhs = fe_like_problem(n=6000, nnz_target=6000 * 18, seed=1)
    if order == "rcm":
        perm = cuthill_mckee(A)
        A, rhs = permute(A, perm), rhs[perm]
    runs = {}
    for device in ("cpu", cuda):
        solve = make_solver(A, AMGParams(dtype=torch.float64,
                                         coarse_enough=500),
                            BiCGStab(maxiter=100, tol=1e-8,
                                     precond_side=side), device=device,
                            device_setup=True)
        kernels = (wk.windowed_ell_spmv, wk.windowed_ell_residual,
                   wk.windowed_ell_scaled_correction,
                   wk.windowed_ell_spmv_dots, fv.bicgstab_tail)
        before = [k.launches for k in kernels]
        plain = wk.windowed_ell_residual_plain.calls
        x, info = solve(rhs)
        launched = [k.launches - b for k, b in zip(kernels, before)]
        if device != "cpu":
            assert wk.windowed_ell_residual_plain.calls == plain
            assert all(launched[1:3]) and launched[4] > 0
            assert (launched[3] > 0) == (side == "right")
            assert (launched[0] > 0) == (side == "left")
        runs[torch.device(device).type] = (
            info.iters, x.double().cpu().numpy(),
            [lv["rows"] for lv in info.hierarchy["levels"]])
    assert runs["cpu"][2] == runs["cuda"][2]
    assert runs["cpu"][0] == runs["cuda"][0]
    x, x_cpu = runs["cuda"][1], runs["cpu"][1]
    assert np.linalg.norm(x - x_cpu) <= 1e-8 * np.linalg.norm(x_cpu)
    true_res = np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs)
    assert true_res <= (1e-8 if side == "right" else 1e-6)


# -- block windowed ELL ------------------------------------------------------

def _well_block(n_out, ncols, K, b, dtype, device, seed=0, empty=None):
    """Random block windowed-ELL operands over b×b blocks, laid out as
    _well's: window starts that differ from tile to tile, a quarter of
    the slots padding, tile ``empty`` without entries starting at
    ncols. Returns (starts, cols, vals, x, f, S, w) with S the
    (n_out, b, b) scale and w a vector."""
    st, cl, _, _, _, _ = _well(n_out, ncols, K, dtype, device, seed, empty)
    rng = np.random.RandomState(seed + 1)
    vals = rng.standard_normal(tuple(cl.shape) + (b, b))
    pad = rng.rand(*cl.shape) < 0.25
    vals[pad] = 0.0
    if empty is not None:
        vals[empty] = 0.0
    fl = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    return (st, cl, fl(vals), fl(rng.standard_normal(ncols * b)),
            fl(rng.standard_normal(n_out * b)),
            fl(rng.standard_normal((n_out, b, b)) * 0.1),
            fl(rng.rand(n_out * b)))


_WELL_BLOCK_CASES = [
    # (n_out, ncols, K, b, empty tile)
    (5000, 5000, 8, 3, None),         # ragged last tile
    (6144, 6144, 12, 2, 2),           # empty tile; ncols a multiple of 1024
    (3000, 3000, 100, 3, None),       # the L2 operator's K
    (4100, 4100, 20, 4, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,K,b,empty", _WELL_BLOCK_CASES)
def test_well_block_square_modes_match_plain(cuda, n, m, K, b, empty,
                                             dtype):
    st, cl, v, x, f, S, w = _well_block(n, m, K, b, dtype, cuda, seed=K,
                                        empty=empty)
    terms = wbk.windowed_ell_block_spmv_plain(st, cl, v.abs(), x.abs(), n)
    _close(wbk.windowed_ell_block_spmv(st, cl, v, x, n),
           wbk.windowed_ell_block_spmv_plain(st, cl, v, x, n),
           float(terms.max()), dtype)
    res_terms = terms + f.abs()
    _close(wbk.windowed_ell_block_residual(st, cl, v, f, x, n),
           wbk.windowed_ell_block_residual_plain(st, cl, v, f, x, n),
           float(res_terms.max()), dtype)
    corr_terms = x.abs() + torch.einsum(
        "nij,nj->ni", S.abs(), res_terms.reshape(-1, b)).reshape(-1)
    _close(wbk.windowed_ell_block_scaled_correction(st, cl, v, S, f, x, n),
           wbk.windowed_ell_block_scaled_correction_plain(st, cl, v, S, f,
                                                          x, n),
           float(corr_terms.max()), dtype)
    for wv in (None, w):
        got = wbk.windowed_ell_block_spmv_dots(st, cl, v, x, wv, n)
        want = wbk.windowed_ell_block_spmv_dots_plain(st, cl, v, x, wv, n)
        _close(got[0], want[0], float(terms.max()), dtype)
        _dot_close(got[1], want[1], terms, 2 * terms, dtype)
        _dot_close(got[2], want[2], terms, x, dtype)
        if wv is None:
            assert got[3] is None
        else:
            _dot_close(got[3], want[3], terms, wv, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,K", [(13310, 110592, 48), (110592, 13310, 8),
                                   (1049, 13310, 112)])
def test_well_block_rectangular_spmv_and_residual_match_plain(cuda, n, m, K,
                                                              dtype):
    """The shapes of the block path's restrictions and prolongation."""
    st, cl, v, x, f, _, _ = _well_block(n, m, K, 3, dtype, cuda, seed=n)
    terms = wbk.windowed_ell_block_spmv_plain(st, cl, v.abs(), x.abs(), n)
    _close(wbk.windowed_ell_block_spmv(st, cl, v, x, n),
           wbk.windowed_ell_block_spmv_plain(st, cl, v, x, n),
           float(terms.max()), dtype)
    _close(wbk.windowed_ell_block_residual(st, cl, v, f, x, n),
           wbk.windowed_ell_block_residual_plain(st, cl, v, f, x, n),
           float((terms + f.abs()).max()), dtype)


def test_well_block_starts_are_read(cuda):
    st, cl, v, x, _, _, _ = _well_block(6000, 20000, 16, 3, torch.float32,
                                        cuda, seed=3)
    assert len(set(st.tolist())) > 2
    y = wbk.windowed_ell_block_spmv(st, cl, v, x, 6000)
    y0 = wbk.windowed_ell_block_spmv(torch.zeros_like(st), cl, v, x, 6000)
    assert float((y - y0).abs().max()) > 1.0


def test_well_block_dots_are_bit_identical_and_counted(cuda):
    st, cl, v, x, _, _, w = _well_block(30000, 30000, 8, 3, torch.float32,
                                        cuda)
    launches = wbk.windowed_ell_block_spmv_dots.launches
    a = wbk.windowed_ell_block_spmv_dots(st, cl, v, x, w, 30000)
    b = wbk.windowed_ell_block_spmv_dots(st, cl, v, x, w, 30000)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert wbk.windowed_ell_block_spmv_dots.launches == launches + 2


@pytest.mark.parametrize("bad", ["block5", "rect_block", "cpu_x", "dtype",
                                 "cols_shape", "n_out", "x_len", "S_shape",
                                 "rect_correction"])
def test_well_block_wrappers_refuse_malformed_operands(cuda, bad):
    n = 3000
    st, cl, v, x, f, S, w = _well_block(n, n, 8, 3, torch.float32, cuda)
    mode = "correction"
    if bad == "block5":
        v = torch.zeros(tuple(cl.shape) + (5, 5), device=cuda)
        x, f = torch.zeros(5 * n, device=cuda), torch.zeros(5 * n,
                                                            device=cuda)
        S = torch.zeros(n, 5, 5, device=cuda)
    elif bad == "rect_block":
        v = v[..., :2].contiguous()
        mode = "spmv"
    elif bad == "cpu_x":
        st = st.cpu()
    elif bad == "dtype":
        f = f.double()
    elif bad == "cols_shape":
        cl = cl[:, :, :-1].contiguous()
    elif bad == "n_out":
        n = 1000
    elif bad == "x_len":
        x = x[:-1]
        mode = "spmv"
    elif bad == "S_shape":
        S = S[:, :2, :2].contiguous()
    elif bad == "rect_correction":
        x = torch.cat([x, x[:30]])
    counters = (wbk.windowed_ell_block_spmv,
                wbk.windowed_ell_block_scaled_correction)
    launches = [c.launches for c in counters]
    with pytest.raises(ValueError) as err:
        if mode == "spmv":
            wbk.windowed_ell_block_spmv(st, cl, v, x, n)
        else:
            wbk.windowed_ell_block_scaled_correction(st, cl, v, S, f, x, n)
    if bad in ("block5", "rect_block"):
        assert "2 or 3 or 4" in str(err.value)
    assert [c.launches for c in counters] == launches


def _well_block_edges(n_out, ncols, K, b, dtype, device, seed=0):
    """Block windowed-ELL operands at the sub-warp kernel's edges, laid
    out as _well_edges: tiles of 1,024 (the last ragged), tile 1 without
    entries and starting at ncols where there are three tiles or more,
    and the last tile's window starting 512 block columns before ncols,
    so that some of its slots, blocks nonzero, lie past the end of x."""
    empty = 1 if n_out > 2 * 1024 else None
    st, cl, v, x, f, S, w = _well_block(n_out, ncols, K, b, dtype, "cpu",
                                        seed=seed, empty=empty)
    rng = np.random.RandomState(seed + 2)
    st[-1] = max(ncols - 512, 0)
    cl[-1] = torch.as_tensor(rng.randint(0, 1024, cl[-1].shape),
                             dtype=torch.int32)
    v[-1] = torch.as_tensor(rng.standard_normal(v[-1].shape)).to(dtype)
    return [t.to(device) for t in (st, cl, v, x, f, S, w)]


_WELL_BLOCK_EDGE_CASES = [
    # (n_out, K, b): n_out no multiple of a block's 32 or 64 nodes
    (3109, 48, 2), (3109, 48, 3), (3109, 48, 4), (2085, 8, 3), (200, 4, 4),
    (3109, 12, 2), (3109, 20, 3), (1049, 100, 3),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,K,b", _WELL_BLOCK_EDGE_CASES)
def test_well_block_geometry_edges(cuda, n, K, b, dtype):
    """Every mode of the sub-warp block kernel at K 4-100 (steps of 16,
    8 or 4 slots, the last one partly filled), b = 2, 3, 4, on every node
    of a ragged grid, an empty tile and slots past the end of x; the dots
    also bit for bit from run to run."""
    st, cl, v, x, f, S, w = _well_block_edges(n, n, K, b, dtype, cuda,
                                              seed=K + b)
    assert int(((cl[-1].long() + st[-1]) >= n).sum()) > 0
    assert wk.launch_geometry(n, K, block=True).lanes >= b
    terms = wbk.windowed_ell_block_spmv_plain(st, cl, v.abs(), x.abs(), n)
    m = n * b
    got = _written(lambda: wbk.windowed_ell_block_spmv(st, cl, v, x, n), m,
                   dtype, cuda)
    _close(got, wbk.windowed_ell_block_spmv_plain(st, cl, v, x, n),
           float(terms.max()), dtype)
    res_terms = terms + f.abs()
    got = _written(lambda: wbk.windowed_ell_block_residual(st, cl, v, f, x,
                                                           n), m, dtype,
                   cuda)
    _close(got, wbk.windowed_ell_block_residual_plain(st, cl, v, f, x, n),
           float(res_terms.max()), dtype)
    corr_terms = x.abs() + torch.einsum(
        "nij,nj->ni", S.abs(), res_terms.reshape(-1, b)).reshape(-1)
    got = _written(lambda: wbk.windowed_ell_block_scaled_correction(
        st, cl, v, S, f, x, n), m, dtype, cuda)
    _close(got, wbk.windowed_ell_block_scaled_correction_plain(
        st, cl, v, S, f, x, n), float(corr_terms.max()), dtype)
    for wv in (None, w):
        got = _written(lambda: wbk.windowed_ell_block_spmv_dots(
            st, cl, v, x, wv, n), m, dtype, cuda)
        want = wbk.windowed_ell_block_spmv_dots_plain(st, cl, v, x, wv, n)
        _close(got[0], want[0], float(terms.max()), dtype)
        _dot_close(got[1], want[1], terms, 2 * terms, dtype)
        _dot_close(got[2], want[2], terms, x, dtype)
        if wv is not None:
            _dot_close(got[3], want[3], terms, wv, dtype)
        again = wbk.windowed_ell_block_spmv_dots(st, cl, v, x, wv, n)
        assert all(a is None and c is None or torch.equal(a, c)
                   for a, c in zip(got, again))


@pytest.mark.parametrize("bad", ["vals", "cols", "K"])
def test_well_block_refuses_misaligned_nodes(cuda, bad):
    """The block kernel reads a node's slots in 16-byte vectors: a base
    off a 16-byte boundary, or K no multiple of 4, raises before any
    launch."""
    n = 3000
    st, cl, v, x, f, _, _ = _well_block(n, n, 8, 3, torch.float32, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    if bad == "vals":
        v = shifted(v)
    elif bad == "cols":
        cl = shifted(cl)
    else:
        cl, v = cl[:, :, :6].contiguous(), v[:, :, :6].contiguous()
    launches = wbk.windowed_ell_block_residual.launches
    with pytest.raises(ValueError, match="16-byte"):
        wbk.windowed_ell_block_residual(st, cl, v, f, x, n)
    assert wbk.windowed_ell_block_residual.launches == launches


def test_block_solve_on_card_matches_cpu(cuda):
    """poisson3d_block(16, 3) with BiCGStab in float64: the card and the
    CPU build the same hierarchy, take the same iterations and agree on
    x to 1e-8; every block kernel and the tail launch, and no plain
    version runs on the card."""
    from amgcl_tpu_torch import (AMGParams, BiCGStab, make_solver,
                                 poisson3d_block)
    A, rhs = poisson3d_block(16, 3)
    runs = {}
    kernels = (wbk.windowed_ell_block_spmv, wbk.windowed_ell_block_residual,
               wbk.windowed_ell_block_scaled_correction,
               wbk.windowed_ell_block_spmv_dots, fv.bicgstab_tail)
    plains = (wbk.windowed_ell_block_spmv_plain,
              wbk.windowed_ell_block_residual_plain,
              wbk.windowed_ell_block_scaled_correction_plain,
              wbk.windowed_ell_block_spmv_dots_plain)
    for device in ("cpu", cuda):
        solve = make_solver(A, AMGParams(dtype=torch.float64,
                                         coarse_enough=500),
                            BiCGStab(maxiter=100, tol=1e-8), device=device,
                            device_setup=True)
        before = [k.launches for k in kernels]
        calls = [p.calls for p in plains]
        x, info = solve(rhs)
        if device != "cpu":
            assert all(k.launches > b for k, b in zip(kernels, before))
            assert [p.calls for p in plains] == calls
        runs[torch.device(device).type] = (
            info.iters, x.double().cpu().numpy(),
            [lv["rows"] for lv in info.hierarchy["levels"]])
    assert runs["cpu"][2] == runs["cuda"][2] and len(runs["cpu"][2]) == 3
    assert runs["cpu"][0] == runs["cuda"][0]
    x, x_cpu = runs["cuda"][1], runs["cpu"][1]
    assert np.linalg.norm(x - x_cpu) <= 1e-8 * np.linalg.norm(x_cpu)
    assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) <= 1e-8


# -- dense window (csrc/densewin.cu) and axpby_dot (csrc/vec.cu) --------------

def _dwin(n_out, ncols, win, dtype, device, seed=0, empty=None):
    """Random dense-window operands: n_out rows in tiles of 64, window
    starts (multiples of 1,024) that differ from tile to tile and may
    reach past ncols, the block entries past ncols and past n_out zero,
    as csr_to_dense_window leaves them. Tile ``empty`` holds no entry and
    starts at ncols floored to 1,024, as tile_windows packs such a
    tile."""
    rng = np.random.RandomState(seed)
    tile = 64
    n_tiles = -(-n_out // tile)
    starts = rng.randint(0, (ncols - 1) // 1024 + 1, n_tiles) * 1024
    blocks = rng.standard_normal((n_tiles, tile, win))
    cols = starts[:, None] + np.arange(win)
    blocks[np.broadcast_to((cols >= ncols)[:, None, :], blocks.shape)] = 0.0
    blocks.reshape(-1, win)[n_out:] = 0.0
    if empty is not None:
        starts[empty] = ncols // 1024 * 1024
        blocks[empty] = 0.0
    x, f, w = rng.standard_normal(ncols), rng.standard_normal(n_out), \
        rng.rand(n_out)
    fl = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    return (torch.as_tensor(starts.astype(np.int32), device=device),
            fl(blocks), fl(x), fl(f), fl(w))


_DWIN_CASES = [
    # (n_out, ncols, win, empty tile)
    (1000, 1000, 1024, None),         # n no multiple of 64
    (5000, 5000, 2048, 3),            # an empty tile
    (130, 130, 1024, 1),              # the reference's empty-tile fixture
    (6000, 6000, 3072, None),         # windows past ncols
    (64, 64, 1024, None),
]


def _dwin_terms(st, B, x, n):
    return dwk.dense_window_spmv_plain(st, B.abs(), x.abs(), n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,win,empty", _DWIN_CASES)
def test_dwin_modes_match_plain(cuda, n, m, win, empty, dtype):
    st, B, x, f, w = _dwin(n, m, win, dtype, cuda, seed=n, empty=empty)
    assert int(st.max()) + win > m
    terms = _dwin_terms(st, B, x, n)
    _close(dwk.dense_window_spmv(st, B, x, n),
           dwk.dense_window_spmv_plain(st, B, x, n), float(terms.max()),
           dtype)
    _close(dwk.dense_window_residual(st, B, f, x, n),
           dwk.dense_window_residual_plain(st, B, f, x, n),
           float((terms + f.abs()).max()), dtype)
    _close(dwk.dense_window_scaled_correction(st, B, w, f, x, n),
           dwk.dense_window_scaled_correction_plain(st, B, w, f, x, n),
           float((x.abs() + w * (terms + f.abs())).max()), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(3000, 9000), (9000, 3000)])
def test_dwin_rectangular_spmv_and_residual_match_plain(cuda, n, m, dtype):
    st, B, x, f, _ = _dwin(n, m, 2048, dtype, cuda, seed=m)
    terms = _dwin_terms(st, B, x, n)
    _close(dwk.dense_window_spmv(st, B, x, n),
           dwk.dense_window_spmv_plain(st, B, x, n), float(terms.max()),
           dtype)
    _close(dwk.dense_window_residual(st, B, f, x, n),
           dwk.dense_window_residual_plain(st, B, f, x, n),
           float((terms + f.abs()).max()), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dwin_built_on_card_matches_cpu(cuda, dtype):
    """An RCM-ordered fe_like_problem packed on the card: the blocks equal
    the CPU packing bit for bit, and each kernel agrees with its plain
    version on them."""
    from amgcl_tpu_torch import fe_like_problem
    from amgcl_tpu_torch.ops.densewin import csr_to_dense_window
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    A, _ = fe_like_problem(n=3000, nnz_target=3000 * 18, seed=4)
    A = permute(A, cuthill_mckee(A))
    D = csr_to_dense_window(A, dtype, device=cuda)
    D_cpu = csr_to_dense_window(A, dtype, device="cpu")
    assert torch.equal(D.blocks.cpu(), D_cpu.blocks)
    assert torch.equal(D.window_starts.cpu(), D_cpu.window_starts)
    assert len(set(D.window_starts.tolist())) > 1
    rng = np.random.RandomState(5)
    x, f, w = (torch.as_tensor(rng.standard_normal(A.nrows)).to(
        device=cuda, dtype=dtype) for _ in range(3))
    st, B, n = D.window_starts, D.blocks, A.nrows
    terms = _dwin_terms(st, B, x, n)
    _close(D.mv(x), dwk.dense_window_spmv_plain(st, B, x, n),
           float(terms.max()), dtype)
    _close(dwk.dense_window_residual(st, B, f, x, n),
           dwk.dense_window_residual_plain(st, B, f, x, n),
           float((terms + f.abs()).max()), dtype)
    _close(dwk.dense_window_scaled_correction(st, B, w, f, x, n),
           dwk.dense_window_scaled_correction_plain(st, B, w, f, x, n),
           float((x.abs() + w.abs() * (terms + f.abs())).max()), dtype)


def test_dwin_starts_are_read(cuda):
    """The same blocks under other window starts give another product: a
    kernel that ignored the starts would return the same one."""
    st, B, x, _, _ = _dwin(6000, 20000, 2048, torch.float32, cuda, seed=3)
    assert len(set(st.tolist())) > 2
    y = dwk.dense_window_spmv(st, B, x, 6000)
    y0 = dwk.dense_window_spmv(torch.zeros_like(st), B, x, 6000)
    assert float((y - y0).abs().max()) > 1.0
    _close(y0, dwk.dense_window_spmv_plain(torch.zeros_like(st), B, x, 6000),
           float(_dwin_terms(torch.zeros_like(st), B, x, 6000).max()),
           torch.float32)


def test_dwin_is_bit_identical_and_counted(cuda):
    st, B, x, f, w = _dwin(5000, 5000, 2048, torch.float32, cuda)
    kernels = (dwk.dense_window_spmv, dwk.dense_window_residual,
               dwk.dense_window_scaled_correction)
    before = [k.launches for k in kernels]
    calls = dwk.dense_window_spmv_plain.calls
    runs = [[dwk.dense_window_spmv(st, B, x, 5000),
             dwk.dense_window_residual(st, B, f, x, 5000),
             dwk.dense_window_scaled_correction(st, B, w, f, x, 5000)]
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 2]
    assert dwk.dense_window_spmv_plain.calls == calls


@pytest.mark.parametrize("bad", ["cpu_starts", "dtype", "noncontiguous",
                                 "starts_dtype", "n_out", "rect_correction",
                                 "f_shape", "bf16", "win"])
def test_dwin_wrappers_refuse_malformed_operands(cuda, bad):
    n = 3000
    st, B, x, f, w = _dwin(n, n, 1024, torch.float32, cuda)
    if bad == "cpu_starts":
        st = st.cpu()
    elif bad == "dtype":
        f = f.double()
    elif bad == "noncontiguous":
        B = B.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "starts_dtype":
        st = st.long()
    elif bad == "n_out":
        n = 1000
    elif bad == "rect_correction":
        x = torch.cat([x, x[:5]])
    elif bad == "f_shape":
        f = f[:-1]
    elif bad == "bf16":
        B = B.bfloat16()
    elif bad == "win":
        B = B[:, :, :1022].contiguous()
    counters = (dwk.dense_window_residual,
                dwk.dense_window_scaled_correction)
    launches = [c.launches for c in counters]
    with pytest.raises(ValueError):
        if bad == "rect_correction":
            dwk.dense_window_scaled_correction(st, B, w, f, x, n)
        else:
            dwk.dense_window_residual(st, B, f, x, n)
    assert [c.launches for c in counters] == launches


_DWIN_CHUNK_CASES = [
    # (n, win, dtype), square: chunks of 2,048 float32 / 1,024 float64
    # columns
    (1000, 1024, torch.float32),          # one chunk; n no multiple of 64
    (5000, 4608, torch.float32),          # 2 chunks + a ragged 512
    (5000, 4608, torch.float64),          # 4 chunks + a ragged 512
    (2500, 6000, torch.float32),          # every window partly past ncols
    (20000, 19456, torch.float32),        # widest the 10 MiB rule admits
    (12000, 9216, torch.float64),         # the same in float64
    (700, 4100, torch.float64),           # win no multiple of 128
]


@pytest.mark.parametrize("n,win,dtype", _DWIN_CHUNK_CASES)
def test_dwin_chunked_staging(cuda, n, win, dtype):
    """Every mode of the staged kernel over windows of one chunk, of
    several with a ragged last chunk, partly past ncols and as wide as
    the reference's rule admits; every row written, and bit for bit from
    run to run."""
    st, B, x, f, w = _dwin(n, n, win, dtype, cuda, seed=win)
    terms = _dwin_terms(st, B, x, n)
    runs = []
    for _ in range(2):
        runs.append([
            _written(lambda: dwk.dense_window_spmv(st, B, x, n), n, dtype,
                     cuda),
            _written(lambda: dwk.dense_window_residual(st, B, f, x, n), n,
                     dtype, cuda),
            _written(lambda: dwk.dense_window_scaled_correction(
                st, B, w, f, x, n), n, dtype, cuda)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    y, r, c = runs[0]
    _close(y, dwk.dense_window_spmv_plain(st, B, x, n), float(terms.max()),
           dtype)
    _close(r, dwk.dense_window_residual_plain(st, B, f, x, n),
           float((terms + f.abs()).max()), dtype)
    _close(c, dwk.dense_window_scaled_correction_plain(st, B, w, f, x, n),
           float((x.abs() + w * (terms + f.abs())).max()), dtype)


@pytest.mark.parametrize("bad", ["misaligned", "tile"])
def test_dwin_refuses_misaligned_or_other_tiles(cuda, bad):
    """Blocks off a 16-byte boundary, or tiles of other than 64 rows,
    raise before any launch."""
    n = 3000
    st, B, x, f, _ = _dwin(n, n, 1024, torch.float32, cuda)
    if bad == "misaligned":
        buf = torch.empty(B.numel() + 1, device=cuda)
        B2 = buf[1:].view(B.shape)
        B2.copy_(B)
        B = B2
        assert B.data_ptr() % 16
    else:
        st = torch.cat([st, st])
        B = B.reshape(2 * B.shape[0], 32, B.shape[2])
    launches = dwk.dense_window_residual.launches
    with pytest.raises(ValueError):
        dwk.dense_window_residual(st, B, f, x, n)
    assert dwk.dense_window_residual.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 1000, 1056 * 256 * 3 + 7])
def test_axpby_dot_matches_plain(cuda, n, dtype):
    rng = np.random.RandomState(n + 2)
    x, y = (torch.as_tensor(rng.standard_normal(n)).to(device=cuda,
                                                        dtype=dtype)
            for _ in range(2))
    launches = fv.axpby_dot.launches
    calls = fv.axpby_dot_plain.calls
    for a, b in ((torch.tensor(-0.37, dtype=dtype, device=cuda),
                  torch.tensor(1.0, dtype=dtype, device=cuda)), (1.25, -0.5)):
        got = fv.axpby_dot(a, x, b, y)
        want = fv.axpby_dot_plain(a, x, b, y)
        terms = abs(float(a)) * x.abs() + abs(float(b)) * y.abs()
        _close(got[0], want[0], float(terms.max()), dtype)
        _dot_close(got[1], want[1], terms, terms, dtype)
        assert got[1].dim() == 0
    assert fv.axpby_dot.launches == launches + 2
    assert fv.axpby_dot_plain.calls == calls + 2
    a = torch.tensor(0.5, dtype=dtype, device=cuda)
    bad_args = [(a, x, a, y.cpu()), (a, x, a.cpu(), y),
                (a, x, a, y.to(torch.float16)), (a, x, a, y[:-1])]
    if n > 2:                 # a stride-2 view of one entry is contiguous
        bad_args.append((a, x[::2], a, y[::2]))
    for bad in bad_args:
        with pytest.raises(ValueError):
            fv.axpby_dot(*bad)
    assert fv.axpby_dot.launches == launches + 2


@pytest.mark.parametrize("side", ["right", "left"])
def test_dense_window_solve_on_card_matches_cpu(cuda, side):
    """A small RCM-ordered fe_like_problem on a float64 dense-window
    hierarchy (D2's format) with BiCGStab: the card and the CPU build the
    same hierarchy and agree on x to 1e-8; every dense-window kernel
    launches and no plain version runs on the card. On the right side
    they take the same iterations. On the left side (D2's) the count is
    held within 2: on this system it moves between 13 and 15 when the
    rhs moves by 1e-15 relative, on the CPU alone, while x moves by
    about 2e-10 relative; the left side's tol bounds the preconditioned
    residual, and the true one stays below 2e-7 there."""
    from amgcl_tpu_torch import AMGParams, BiCGStab, fe_like_problem, \
        make_solver
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    A, rhs = fe_like_problem(n=6000, nnz_target=6000 * 18, seed=1)
    perm = cuthill_mckee(A)
    A, rhs = permute(A, perm), rhs[perm]
    kernels = (dwk.dense_window_spmv, dwk.dense_window_residual,
               dwk.dense_window_scaled_correction)
    plains = (dwk.dense_window_spmv_plain, dwk.dense_window_residual_plain,
              dwk.dense_window_scaled_correction_plain)
    runs = {}
    for device in ("cpu", cuda):
        solve = make_solver(A, AMGParams(dtype=torch.float64,
                                         matrix_format="dwin",
                                         coarse_enough=500),
                            BiCGStab(maxiter=100, tol=1e-8,
                                     precond_side=side), device=device,
                            device_setup=True)
        before = [k.launches for k in kernels]
        calls = [p.calls for p in plains]
        x, info = solve(rhs)
        if device != "cpu":
            assert all(k.launches > b for k, b in zip(kernels, before))
            assert [p.calls for p in plains] == calls
        assert info.resid <= 1e-8
        runs[torch.device(device).type] = (
            info.iters, x.double().cpu().numpy(),
            [(lv["rows"], lv["format"]) for lv in info.hierarchy["levels"]])
    assert runs["cpu"][2] == runs["cuda"][2]
    assert all(f == "DenseWindowMatrix" for _, f in runs["cuda"][2])
    if side == "right":
        assert runs["cpu"][0] == runs["cuda"][0]
    else:
        assert abs(runs["cpu"][0] - runs["cuda"][0]) <= 2
    x, x_cpu = runs["cuda"][1], runs["cpu"][1]
    assert np.linalg.norm(x - x_cpu) <= 1e-8 * np.linalg.norm(x_cpu)
    assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) \
        <= (1e-8 if side == "right" else 1e-6)


def test_bicgstabl_solve_on_card_matches_cpu(cuda):
    """A small fe_like_problem with right BiCGStab(2) in float64 (K1's
    configuration): the same iterations on the card and the CPU, x within
    1e-8, one axpby_dot launch per BiCG step and no plain version on the
    card."""
    from amgcl_tpu_torch import AMGParams, BiCGStabL, fe_like_problem, \
        make_solver
    A, rhs = fe_like_problem(n=6000, nnz_target=6000 * 18, seed=1)
    runs = {}
    for device in ("cpu", cuda):
        solve = make_solver(A, AMGParams(dtype=torch.float64,
                                         coarse_enough=500),
                            BiCGStabL(L=2, maxiter=100, tol=1e-8),
                            device=device,
                            device_setup=True)
        launches = fv.axpby_dot.launches
        calls = fv.axpby_dot_plain.calls
        x, info = solve(rhs)
        if device != "cpu":
            assert fv.axpby_dot.launches - launches >= info.iters > 0
            assert fv.axpby_dot_plain.calls == calls
        runs[torch.device(device).type] = (info.iters,
                                           x.double().cpu().numpy())
    assert runs["cpu"][0] == runs["cuda"][0]
    x, x_cpu = runs["cuda"][1], runs["cpu"][1]
    assert np.linalg.norm(x - x_cpu) <= 1e-8 * np.linalg.norm(x_cpu)
    assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) <= 1e-8


# -- the gather kernel (csrc/gather.cu) ---------------------------------------

_GATHER_CASES = [
    # (n_out, ncols, K, empty tile): ragged last tiles, an empty tile,
    # rectangular operators both ways
    (5000, 5000, 4, None),
    (6144, 6144, 8, 2),
    (10000, 10000, 12, None),
    (30000, 30000, 16, 7),
    (3000, 9000, 16, None),
    (9000, 3000, 8, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,K,empty", _GATHER_CASES)
def test_gather_matches_plain(cuda, n, m, K, empty, dtype):
    st, cl, v, x, _, _ = _well(n, m, K, dtype, cuda, seed=100 + K,
                               empty=empty)
    terms = gk.gather_spmv_plain(st, cl, v.abs(), x.abs(), n)
    launches = gk.gather_spmv.launches
    got = gk.gather_spmv(st, cl, v, x, n)
    assert gk.gather_spmv.launches == launches + 1
    _close(got, gk.gather_spmv_plain(st, cl, v, x, n), float(terms.max()),
           dtype)
    if empty is not None:
        rows = slice(empty * 1024, min((empty + 1) * 1024, n))
        assert not torch.any(got[rows])


def test_gather_starts_are_read(cuda):
    """The same columns under shifted window starts give another product:
    a kernel that ignored the starts would return the same one."""
    for K in gk.KS:
        st, cl, v, x, _, _ = _well(6000, 20000, K, torch.float32, cuda,
                                   seed=K)
        assert len(set(st.tolist())) > 2
        zero = torch.zeros_like(st)
        y = gk.gather_spmv(st, cl, v, x, 6000)
        y0 = gk.gather_spmv(zero, cl, v, x, 6000)
        assert float((y - y0).abs().max()) > 1.0
        _close(y, gk.gather_spmv_plain(st, cl, v, x, 6000), float(
            gk.gather_spmv_plain(st, cl, v.abs(), x.abs(), 6000).max()),
            torch.float32)


def test_gather_is_bit_identical_and_not_plain(cuda):
    st, cl, v, x, _, _ = _well(30000, 30000, 16, torch.float32, cuda)
    calls = gk.gather_spmv_plain.calls
    a = gk.gather_spmv(st, cl, v, x, 30000)
    b = gk.gather_spmv(st, cl, v, x, 30000)
    assert torch.equal(a, b) and gk.gather_spmv_plain.calls == calls


@pytest.mark.parametrize("bad", ["cpu_starts", "dtype", "cols_dtype",
                                 "starts_shape", "n_out", "K20", "block",
                                 "noncontiguous", "bf16", "x_matrix"])
def test_gather_refuses_malformed_operands(cuda, bad):
    n = 3000
    K = 20 if bad == "K20" else 8
    st, cl, v, x, _, _ = _well(n, n, K, torch.float32, cuda)
    if bad == "cpu_starts":
        st = st.cpu()
    elif bad == "dtype":
        x = x.double()
    elif bad == "cols_dtype":
        cl = cl.long()
    elif bad == "starts_shape":
        st = st[:-1]
    elif bad == "n_out":
        n = 1000
    elif bad == "block":
        v = v[..., None, None].expand(-1, -1, -1, 2, 2).contiguous()
    elif bad == "noncontiguous":
        v = v.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "bf16":
        v = v.bfloat16()
    elif bad == "x_matrix":
        x = x[:, None]
    launches = gk.gather_spmv.launches
    with pytest.raises(ValueError):
        gk.gather_spmv(st, cl, v, x, n)
    assert gk.gather_spmv.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", gk.KS)
def test_gather_geometries_agree_bit_for_bit(cuda, monkeypatch, K, dtype):
    """Every block size the kernel takes gives the default grid's bits
    (each row's chain runs in one thread, in slot order), over a ragged
    last tile, an empty tile and slots past the end of x."""
    n = 5000
    st, cl, v, x, _, _ = _well(n, n, K, dtype, cuda, seed=K, empty=2)
    want = _bits(gk.gather_spmv(st, cl, v, x, n))
    for threads in (32, 64, 96, 128):
        monkeypatch.setattr(gk, "launch_geometry", lambda n_, K_, t=threads:
                            gk.Geometry(t, -(-n_ // t)))
        assert _bits(gk.gather_spmv(st, cl, v, x, n)) == want, threads


@pytest.mark.parametrize("threads,short", [(100, 0), (16, 0), (512, 0),
                                           (128, 1)])
def test_gather_entry_refuses_a_bad_grid(cuda, monkeypatch, threads,
                                         short):
    """The C entry refuses blocks that are not whole warps of at most 256
    threads and a grid one block short of the rows: the wrapper raises
    and counts no launch."""
    n = 5000
    st, cl, v, x, _, _ = _well(n, n, 16, torch.float32, cuda)
    monkeypatch.setattr(gk, "launch_geometry", lambda n_, K_: gk.Geometry(
        threads, -(-n_ // threads) - short))
    launches = gk.gather_spmv.launches
    with pytest.raises(RuntimeError):
        gk.gather_spmv(st, cl, v, x, n)
    assert gk.gather_spmv.launches == launches


@pytest.mark.parametrize("bad", ["vals", "cols"])
def test_gather_refuses_misaligned_rows(cuda, bad):
    """The gather kernel reads rows in 16-byte vectors: cols_local or vals
    off a 16-byte boundary raises before any launch."""
    n = 3000
    st, cl, v, x, _, _ = _well(n, n, 8, torch.float32, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    if bad == "vals":
        v = shifted(v)
    else:
        cl = shifted(cl)
    assert (v.data_ptr() | cl.data_ptr()) % 16
    launches = gk.gather_spmv.launches
    with pytest.raises(ValueError, match="16-byte"):
        gk.gather_spmv(st, cl, v, x, n)
    assert gk.gather_spmv.launches == launches


def test_mv_runs_gather_on_card(cuda):
    """WindowedEllMatrix.mv on a scalar operator with K = 16 launches the
    gather kernel, not B.8's, and agrees with the plain version."""
    from amgcl_tpu_torch import fe_like_problem
    from amgcl_tpu_torch.ops.unstructured import csr_to_windowed_ell
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    A, _ = fe_like_problem(n=20000, nnz_target=6 * 20000, seed=4)
    A = permute(A, cuthill_mckee(A))
    W = csr_to_windowed_ell(A, torch.float32, device=cuda)
    assert W.K == 16 and len(set(W.window_starts.tolist())) > 2
    x = torch.as_tensor(np.random.RandomState(5).standard_normal(
        A.ncols)).to(device=cuda, dtype=torch.float32)
    before = (gk.gather_spmv.launches, wk.windowed_ell_spmv.launches)
    y = W.mv(x)
    assert (gk.gather_spmv.launches, wk.windowed_ell_spmv.launches) == (
        before[0] + 1, before[1])
    terms = gk.gather_spmv_plain(W.window_starts, W.cols_local,
                                 W.vals.abs(), x.abs(), A.nrows)
    _close(y, gk.gather_spmv_plain(W.window_starts, W.cols_local, W.vals,
                                   x, A.nrows), float(terms.max()),
           torch.float32)


@pytest.mark.parametrize("solver", ["GMRES", "FGMRES"])
def test_gmres_solve_on_card_matches_cpu(cuda, solver):
    """A small G1-like fe_like_problem with GMRES (left) or FGMRES in
    float64: the same iterations on the card and the CPU, x within 1e-8,
    the gather kernel at least once an Arnoldi step and no plain version
    on the card. Both report a residual within tol; FGMRES's is the true
    one, left GMRES's the preconditioned one."""
    import amgcl_tpu_torch as T
    A, rhs = T.fe_like_problem(n=6000, nnz_target=6 * 6000, seed=1)
    runs = {}
    for device in ("cpu", cuda):
        solve = T.make_solver(A, T.AMGParams(dtype=torch.float64,
                                             coarse_enough=300),
                              getattr(T, solver)(maxiter=100, tol=1e-8),
                              device=device,
                              device_setup=True)
        launches = gk.gather_spmv.launches
        calls = gk.gather_spmv_plain.calls
        x, info = solve(rhs)
        if device != "cpu":
            assert gk.gather_spmv.launches - launches >= info.iters > 0
            assert gk.gather_spmv_plain.calls == calls
        assert info.resid <= 1e-8
        runs[torch.device(device).type] = (info.iters,
                                           x.double().cpu().numpy())
    assert runs["cpu"][0] == runs["cuda"][0]
    x, x_cpu = runs["cuda"][1], runs["cpu"][1]
    assert np.linalg.norm(x - x_cpu) <= 1e-8 * np.linalg.norm(x_cpu)
    if solver == "FGMRES":
        assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) <= 1e-7


def test_npre2_npost0_cycle_on_card_matches_cpu(cuda):
    """poisson3d(24) with npre = 2, npost = 0 under BiCGStab, the stencil
    levels built on the card: the separate pre-sweeps, the down leg's
    base mode and the prolongation through the smoothed transfer run
    there (the fused up leg does not), within one iteration of the host
    build on the CPU, the true residual within tolerance."""
    from amgcl_tpu_torch import AMGParams, BiCGStab, make_solver, poisson3d
    A, rhs = poisson3d(24)
    runs = {}
    for device, setup in (("cpu", False), (cuda, True)):
        solve = make_solver(A, AMGParams(dtype=torch.float32, npre=2,
                                         npost=0),
                            BiCGStab(maxiter=100, tol=1e-6), refine=3,
                            device=device, device_setup=setup)
        assert solve.precond.device_built == setup
        down, up = vk.fused_down_sweep.launches, vk.fused_up_sweep.launches
        x, info = solve(rhs)
        if setup:
            assert vk.fused_down_sweep.launches > down
            assert vk.fused_up_sweep.launches == up
        runs[setup] = (info.iters, x.double().cpu().numpy())
    assert abs(runs[True][0] - runs[False][0]) <= 1
    x = runs[True][1]
    assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) <= 1e-6


# -- the framed legs (csrc/vcycle.cu, framed mode) and the sharded solve ------

def _reach(offsets):
    return max(abs(o) for o in offsets)


def _framed(dims, offs_a, offs_m, device, seed=0, extra=0, zero=False):
    """Random framed operands of both legs on a slab of ``dims``: the down
    leg's frames of H = reach(A) + reach(Mᵀ) + ``extra`` rows, the up
    leg's of the least hp. Every frame's halos hold random values on both
    sides (or zeros with ``zero``), as an interior shard's do."""
    n = int(np.prod(dims))
    c2, c1, c0 = vk.coarse_dims(dims)
    s = dims[1] * dims[2]
    H = _reach(offs_a) + _reach(offs_m) + extra
    hp = max(1, -(-(_reach(offs_a) + _reach(offs_m)) // (2 * s)))
    L, Lm, ncf = n + 2 * H, n + 4 * hp * s, (c2 + 2 * hp) * c1 * c0
    rng = np.random.RandomState(seed)
    cast = lambda a: torch.as_tensor(a).to(device=device,
                                           dtype=torch.float32)

    def frame(rows, length, halo, scale=1.0):
        a = rng.standard_normal(rows + (length,)) * scale
        if zero:
            a[..., :halo] = 0.0
            a[..., length - halo:] = 0.0
        return cast(a)

    return {"dims": dims, "oa": offs_a, "om": offs_m, "H": H, "hp": hp,
            "a_fr": frame((len(offs_a),), L, H),
            "mt_fr": frame((len(offs_m),), L, H),
            "f_fr": frame((), L, H), "u_fr": frame((), L, H),
            "w_fr": cast(np.abs(frame((), L, H).cpu().numpy())),
            "a": cast(rng.standard_normal((len(offs_a), n))),
            "m_fr": frame((len(offs_m),), Lm, 2 * hp * s),
            "u_up": frame((), Lm, 2 * hp * s),
            "uc_fr": frame((), ncf, hp * c1 * c0),
            "w": cast(rng.rand(n)), "f": cast(rng.standard_normal(n))}


_FRAMED_CASES = {
    # name: (slab dims, A offsets, M offsets, extra halo rows)
    "planes": ((4, 8, 16), None, None, 0),
    "planes_wide_H": ((4, 8, 16), None, None, 37),
    "smallest": ((2, 2, 2), None, None, 0),
    "odd_xy": ((2, 5, 7), None, None, 3),
    "two_plane_halo": ((4, 8, 16), (-256, -129, -1, 0, 1, 129, 256),
                       (-128, -1, 0, 1, 128), 0),
    "one_sided": ((4, 8, 128), (-1024, -128, -1, 0), (-1024, 0, 1, 128), 0),
}


def _framed_case(name, device, zero=False):
    dims, oa, om, extra = _FRAMED_CASES[name]
    oa = oa or _plane_offsets(dims)
    om = om or _plane_offsets(dims)
    return _framed(dims, oa, om, device, seed=len(name), extra=extra,
                   zero=zero)


def _down_framed_terms(c, x, zero_guess):
    got = vk.fused_down_sweep_framed_plain(
        c["oa"], -c["a_fr"].abs(), c["om"], -c["mt_fr"].abs(),
        c["f_fr"].abs(), x.abs(), c["dims"], c["H"], zero_guess)
    return got[1] if zero_guess else got


@pytest.mark.parametrize("name", sorted(_FRAMED_CASES))
def test_framed_down_matches_plain(cuda, name):
    c = _framed_case(name, cuda)
    launches = vk.fused_down_sweep_framed.launches
    calls = vk.fused_down_sweep_framed_plain.calls
    args = (c["oa"], c["a_fr"], c["om"], c["mt_fr"], c["f_fr"])
    got = vk.fused_down_sweep_framed(*args, c["u_fr"], c["dims"], c["H"])
    want = vk.fused_down_sweep_framed_plain(*args, c["u_fr"], c["dims"],
                                            c["H"])
    _within(got, want, _down_framed_terms(c, c["u_fr"], False))
    u_z, rc_z = vk.fused_down_sweep_framed(*args, c["w_fr"], c["dims"],
                                           c["H"], zero_guess=True)
    u_p, rc_p = vk.fused_down_sweep_framed_plain(*args, c["w_fr"],
                                                 c["dims"], c["H"], True)
    assert torch.equal(u_z, u_p)
    _within(rc_z, rc_p, _down_framed_terms(c, c["w_fr"], True))
    assert vk.fused_down_sweep_framed.launches == launches + 2
    assert vk.fused_down_sweep_framed_plain.calls == calls + 4


@pytest.mark.parametrize("name", sorted(_FRAMED_CASES))
def test_framed_up_matches_plain(cuda, name):
    c = _framed_case(name, cuda)
    launches = vk.fused_up_sweep_framed.launches
    args = (c["oa"], c["a"], c["om"], c["m_fr"], c["w"], c["f"], c["u_up"],
            c["uc_fr"], c["dims"], c["hp"])
    got = vk.fused_up_sweep_framed(*args)
    want = vk.fused_up_sweep_framed_plain(*args)
    terms = vk.fused_up_sweep_framed_plain(
        c["oa"], -c["a"].abs(), c["om"], -c["m_fr"].abs(), c["w"].abs(),
        c["f"].abs(), c["u_up"].abs(), c["uc_fr"].abs(), c["dims"], c["hp"])
    _within(got, want, terms)
    assert vk.fused_up_sweep_framed.launches == launches + 1


@pytest.mark.parametrize("name", ["planes_wide_H", "two_plane_halo"])
def test_framed_legs_on_a_zero_frame_are_the_base_legs(cuda, name):
    """On frames whose halos are zero the framed kernels give the base
    kernels' results bit for bit."""
    c = _framed_case(name, cuda, zero=True)
    dims, H, hp = c["dims"], c["H"], c["hp"]
    n = int(np.prod(dims))
    t0 = 2 * hp * dims[1] * dims[2]
    nc1 = int(np.prod(vk.coarse_dims(dims)[1:]))
    tile = lambda v, h, m=n: v[..., h:h + m].contiguous()
    oa = torch.tensor(c["oa"], dtype=torch.int32, device=cuda)
    om = torch.tensor(c["om"], dtype=torch.int32, device=cuda)
    a, mt = tile(c["a_fr"], H), tile(c["mt_fr"], H)
    for zg, x in ((False, c["u_fr"]), (True, c["w_fr"])):
        got = vk.fused_down_sweep_framed(c["oa"], c["a_fr"], c["om"],
                                         c["mt_fr"], c["f_fr"], x, dims, H,
                                         zg)
        want = vk.fused_down_sweep(oa, a, om, mt, tile(c["f_fr"], H),
                                   tile(x, H), dims, zg)
        pairs = zip(got, want) if zg else [(got, want)]
        assert all(torch.equal(g, w_) for g, w_ in pairs)
    got = vk.fused_up_sweep_framed(c["oa"], c["a"], c["om"], c["m_fr"],
                                   c["w"], c["f"], c["u_up"], c["uc_fr"],
                                   dims, hp)
    want = vk.fused_up_sweep(oa, c["a"], om, tile(c["m_fr"], t0), c["w"],
                             c["f"], tile(c["u_up"], t0),
                             tile(c["uc_fr"], hp * nc1, dims[0] // 2 * nc1),
                             dims)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["H_short", "odd_lz", "f_frame", "a_frame",
                                 "hp_short", "u_frame", "uc_frame",
                                 "m_frame", "cpu_frame"])
def test_framed_wrappers_refuse_malformed_operands(cuda, bad):
    c = _framed_case("two_plane_halo", cuda)
    dims, H, hp = c["dims"], c["H"], c["hp"]
    down = dict(a_fr=c["a_fr"], mt_fr=c["mt_fr"], f_fr=c["f_fr"],
                u_fr=c["u_fr"])
    up = dict(m_fr=c["m_fr"], u_up=c["u_up"], uc_fr=c["uc_fr"])
    leg = "down"
    if bad == "H_short":
        H -= 1
    elif bad == "odd_lz":
        dims = (3,) + dims[1:]
        leg = "both"
    elif bad == "f_frame":
        down["f_fr"] = down["f_fr"][:-1]
    elif bad == "a_frame":
        down["a_fr"] = down["a_fr"][:, 1:].contiguous()
    elif bad == "cpu_frame":
        down["u_fr"] = down["u_fr"].cpu()
    elif bad == "hp_short":
        hp, leg = hp - 1, "up"
    else:
        key = {"u_frame": "u_up", "uc_frame": "uc_fr",
               "m_frame": "m_fr"}[bad]
        up[key] = up[key][..., :-1].contiguous()
        leg = "up"
    launches = (vk.fused_down_sweep_framed.launches,
                vk.fused_up_sweep_framed.launches)
    if leg in ("down", "both"):
        with pytest.raises(ValueError):
            vk.fused_down_sweep_framed(c["oa"], down["a_fr"], c["om"],
                                       down["mt_fr"], down["f_fr"],
                                       down["u_fr"], dims, H)
    if leg in ("up", "both"):
        with pytest.raises(ValueError):
            vk.fused_up_sweep_framed(c["oa"], c["a"], c["om"], up["m_fr"],
                                     c["w"], c["f"], up["u_up"],
                                     up["uc_fr"], dims, hp)
    assert (vk.fused_down_sweep_framed.launches,
            vk.fused_up_sweep_framed.launches) == launches


def test_sharded_solve_on_card_matches_cpu(cuda):
    """poisson3d(32) over four shards of one card against the same on the
    CPU: one V-cycle on a random vector within 1e-5 (a converged x hides
    a wrong preconditioner: a framed down leg that reads zero at the
    halos still gives x within 1e-4), the framed legs at both sharded
    levels and the DIA SpMV of the halo product's interior launched, no
    plain version run, the same iterations and x within 1e-4."""
    from amgcl_tpu_torch import (AMGParams, CG, DistStencilSolver,
                                 make_mesh, poisson3d)
    from amgcl_tpu_torch.parallel import host_full, put_sharded
    A, rhs = poisson3d(32)
    v = np.random.RandomState(5).standard_normal(A.nrows)
    runs, cycles = {}, {}
    for device in ("cpu", cuda):
        s = DistStencilSolver(A, make_mesh(4, device=device), AMGParams(),
                              CG(maxiter=100, tol=1e-6))
        cycles[device == "cpu"] = host_full(s.hier.shard_apply(
            put_sharded(v, s.mesh, dtype=torch.float32))).astype(np.float64)
        before = (vk.fused_down_sweep_framed.launches,
                  vk.fused_up_sweep_framed.launches, dk.dia_spmv.launches,
                  vk.fused_down_sweep_framed_plain.calls)
        x, info = s(rhs)
        after = (vk.fused_down_sweep_framed.launches,
                 vk.fused_up_sweep_framed.launches, dk.dia_spmv.launches,
                 vk.fused_down_sweep_framed_plain.calls)
        if device != "cpu":
            assert x.device.type == "cuda"
            assert [a - b for a, b in zip(after, before)] \
                == [8 * info.iters, 8 * info.iters, 4 * (info.iters + 1),
                    0]
        runs[device == "cpu"] = (info.iters, x.double().cpu().numpy())
    assert np.linalg.norm(cycles[False] - cycles[True]) \
        <= 1e-5 * np.linalg.norm(cycles[True])
    assert runs[True][0] == runs[False][0]
    x, x_cpu = runs[False][1], runs[True][1]
    assert np.linalg.norm(x - x_cpu) <= 1e-4 * np.linalg.norm(x_cpu)
    assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) <= 1e-4


@pytest.mark.parametrize("nd", [1, 4])
def test_halo_mv_on_card_matches_cpu(cuda, nd):
    """The halo product of a 7-point stencil over z-slabs (the split
    branch at four shards) on the card against the CPU's within 1e-5 of
    the largest entry. On one shard it is one DIA SpMV of the slab; at
    four, one a shard for the interior."""
    from amgcl_tpu_torch.parallel import (dia_halo_mv, host_full,
                                          make_mesh, put_sharded)
    dims = (16, 8, 8)
    s = dims[1] * dims[2]
    offs = (-s, -dims[2], -1, 0, 1, dims[2], s)
    n = int(np.prod(dims))
    rng = np.random.RandomState(11)
    data = rng.standard_normal((len(offs), n))
    x = rng.standard_normal(n)
    got = {}
    for device in ("cpu", cuda):
        mesh = make_mesh(nd, device=device)
        d = put_sharded(data, mesh, dtype=torch.float32, axis=1)
        v = put_sharded(x, mesh, dtype=torch.float32)
        before = dk.dia_spmv.launches
        got[device == "cpu"] = host_full(dia_halo_mv(d, offs, v))
        if device != "cpu":
            assert dk.dia_spmv.launches - before == nd
    np.testing.assert_allclose(got[False], got[True], rtol=0,
                               atol=1e-5 * np.abs(got[True]).max())


_PLAIN = (dk.dia_spmv_plain, dk.dia_residual_plain,
          dk.dia_scaled_correction_plain, dk.dia_spmv_dots_plain,
          dk.dia_residual_dot_plain, fv.xr_update_plain,
          fv.bicgstab_tail_plain, wk.windowed_ell_spmv_plain,
          wk.windowed_ell_residual_plain,
          wk.windowed_ell_scaled_correction_plain,
          wk.windowed_ell_spmv_dots_plain, wbk.windowed_ell_block_spmv_plain,
          wbk.windowed_ell_block_residual_plain,
          wbk.windowed_ell_block_scaled_correction_plain,
          wbk.windowed_ell_block_spmv_dots_plain, gk.gather_spmv_plain,
          vk.fused_down_sweep_plain, vk.fused_up_sweep_plain)

#: smoother or coarsening -> (system, AMGParams fields)
_A8_CASES = {
    "smoother_jacobi": ("poisson", lambda T: dict(relax=T.DampedJacobi())),
    "smoother_chebyshev": ("poisson", lambda T: dict(relax=T.Chebyshev())),
    "smoother_spai1": ("fe", lambda T: dict(relax=T.Spai1())),
    "smoother_gauss_seidel": ("fe", lambda T: dict(relax=T.GaussSeidel())),
    "smoother_ilu0": ("fe", lambda T: dict(relax=T.ILU0())),
    "smoother_ilut": ("fe", lambda T: dict(relax=T.ILUT())),
    "smoother_iluk": ("poisson", lambda T: dict(relax=T.ILUK(k=1))),
    "smoother_ilup": ("poisson", lambda T: dict(relax=T.ILUP())),
    "smoother_block_jacobi": ("block", lambda T: dict(
        relax=T.DampedJacobi())),
    "smoother_as_block": ("block", lambda T: dict(relax=T.AsBlock(
        T.Spai1()))),
    "coarsening_aggregation_grid": ("poisson", lambda T: dict(
        coarsening=T.Aggregation())),
    "coarsening_aggregation": ("fe", lambda T: dict(
        coarsening=T.Aggregation())),
    "coarsening_ruge_stuben": ("fe", lambda T: dict(
        coarsening=T.RugeStuben())),
    "coarsening_ruge_stuben_pmis": ("fe", lambda T: dict(
        coarsening=T.RugeStuben(splitting="pmis"))),
    "coarsening_emin": ("fe", lambda T: dict(
        coarsening=T.SmoothedAggrEMin())),
    "coarsening_nullspace": ("elastic", None),
    "coarsening_as_scalar": ("block", lambda T: dict(
        coarsening=T.AsScalar(T.SmoothedAggregation()))),
}


@pytest.mark.parametrize("name", sorted(_A8_CASES))
def test_smoother_and_coarsening_on_card_match_cpu(cuda, name):
    """Each smoother and coarsening on a small system in float64 (BiCGStab
    for the unstructured and block systems, CG otherwise): the same
    iterations on the card and the CPU, x within 1e-8, and no plain
    version on the card. Both build with the device setup (the
    rigid-body nullspace takes the host setup's aggregates on both:
    ``models/amg.device_mis_declined``)."""
    import amgcl_tpu_torch as T
    system, fields = _A8_CASES[name]
    if system == "poisson":
        A, rhs = T.poisson3d(24)
    elif system == "fe":
        A, rhs = T.fe_like_problem(n=6000, nnz_target=28 * 6000, seed=1)
    elif system == "block":
        A, rhs = T.poisson3d_block(12, 3)
    else:
        A, rhs, coords = T.q1_elasticity2d(48)
        fields = lambda T: dict(coarsening=T.SmoothedAggregation(
            nullspace=T.rigid_body_modes(coords)))
    solver = T.CG if system in ("poisson", "elastic") else T.BiCGStab
    runs = {}
    for device in ("cpu", cuda):
        solve = T.make_solver(A, T.AMGParams(dtype=torch.float64,
                                             coarse_enough=500,
                                             **fields(T)),
                              solver(maxiter=200, tol=1e-8), device=device,
                              device_setup=True)
        calls = [p.calls for p in _PLAIN]
        x, info = solve(rhs)
        if device != "cpu":
            assert [p.calls for p in _PLAIN] == calls
        assert info.resid <= 1e-8
        runs[torch.device(device).type] = (info.iters,
                                           x.double().cpu().numpy())
    assert runs["cpu"][0] == runs["cuda"][0]
    x, x_cpu = runs["cuda"][1], runs["cpu"][1]
    assert np.linalg.norm(x - x_cpu) <= 1e-8 * np.linalg.norm(x_cpu)


# -- the bfloat16 modes (B.1, B.2, the fused legs, B.8, B.9) ------------------

_BF = torch.bfloat16


def _to_bf16(*ts):
    return [t.to(_BF) if t.is_floating_point() else t for t in ts]


def _equal_bf16(kern, plain, args):
    """The bfloat16 mode of ``kern`` equal, bit for bit, to its plain
    version (each rounds every operation alike), one bfloat16 launch."""
    launches = kern.bf16_launches
    got, want = kern(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, p in zip(got, want):
        assert g.dtype == _BF and g.device.type == "cuda"
        assert torch.equal(g, p), float((g.float() - p.float()).abs().max())
    assert kern.bf16_launches == launches + 1


@pytest.mark.parametrize("n,m,offsets", [(n, n, o) for n, o in _SQUARE]
                         + [(4096, 1000, (-40, -8, -1, 0, 3, 40, 900)),
                            (1000, 4096, (-40, -8, -1, 0, 3, 40, 900))])
def test_bf16_dia_modes_equal_plain(cuda, n, m, offsets):
    off, data, x, f, w = _to_bf16(*_dia(n, m, offsets, torch.float32, cuda))
    _equal_bf16(dk.dia_spmv, dk.dia_spmv_plain, (off, data, x))
    _equal_bf16(dk.dia_residual, dk.dia_residual_plain, (off, data, f, x))
    if n == m:
        _equal_bf16(dk.dia_scaled_correction, dk.dia_scaled_correction_plain,
                    (off, data, w, f, x))


@pytest.mark.parametrize("name", sorted(_LEG_CASES))
def test_bf16_fused_legs_equal_plain(cuda, name):
    dims, leg = _case(name, cuda)
    oa, a, om, m, w, f, u, uc = _to_bf16(*leg)
    oa_h, om_h = tuple(oa.tolist()), tuple(om.tolist())
    for zero in (False, True):
        _equal_bf16(vk.fused_down_sweep, vk.fused_down_sweep_plain,
                    (oa_h, a, om_h, m, f, w if zero else u, dims, zero))
    if dims[0] % 2 == 0:
        _equal_bf16(vk.fused_up_sweep, vk.fused_up_sweep_plain,
                    (oa_h, a, om_h, m, w, f, u, uc, dims))


def test_bf16_leg_tiles_are_planned_in_bytes(cuda):
    """A 7-point level too wide for the float32 up leg's boxes (a grid row
    of 1,700 points) fits in bfloat16, whose boxes take half the bytes,
    and the kernel agrees with its plain version there."""
    dims = (2, 4, 1700)
    offs = _plane_offsets(dims)
    assert vk.up_tile(offs, offs, dims) is None
    assert vk.up_tile(offs, offs, dims, _BF) is not None
    oa, a, om, m, w, f, u, uc = _to_bf16(*_leg(dims, offs, offs, cuda))
    _equal_bf16(vk.fused_up_sweep, vk.fused_up_sweep_plain,
                (offs, a, offs, m, w, f, u, uc, dims))


@pytest.mark.parametrize("n,m,K,empty", _WELL_CASES
                         + [(n, n, K, None) for n, K in _WELL_EDGE_CASES])
def test_bf16_well_modes_equal_plain(cuda, n, m, K, empty):
    st, cl, v, x, f, w = _well(n, m, K, _BF, cuda, seed=K, empty=empty)
    _equal_bf16(wk.windowed_ell_spmv, wk.windowed_ell_spmv_plain,
                (st, cl, v, x, n))
    _equal_bf16(wk.windowed_ell_residual, wk.windowed_ell_residual_plain,
                (st, cl, v, f, x, n))
    _equal_bf16(wk.windowed_ell_scaled_correction,
                wk.windowed_ell_scaled_correction_plain,
                (st, cl, v, w, f, x, n))


@pytest.mark.parametrize("which", ["framed_down", "framed_up"])
def test_bf16_kernels_without_a_mode_refuse(cuda, which):
    """A kernel with no bfloat16 mode (the framed legs, ROADMAP B.18)
    raises on bfloat16 operands: it neither launches nor runs its plain
    version."""
    with pytest.raises(ValueError, match="float32"):
        dims = (4, 4, 8)
        offs = _plane_offsets(dims)
        n, H = 128, 64
        fr = torch.zeros((len(offs), n + 2 * H), dtype=_BF, device=cuda)
        v = torch.zeros(n + 2 * H, dtype=_BF, device=cuda)
        if which == "framed_down":
            vk.fused_down_sweep_framed(offs, fr, offs, fr, v, v, dims, H)
        else:
            hp = 2
            Lm = n + 2 * hp * 2 * 32
            a = torch.zeros((len(offs), n), dtype=_BF, device=cuda)
            mf = torch.zeros((len(offs), Lm), dtype=_BF, device=cuda)
            vn = torch.zeros(n, dtype=_BF, device=cuda)
            vk.fused_up_sweep_framed(
                offs, a, offs, mf, vn, vn,
                torch.zeros(Lm, dtype=_BF, device=cuda),
                torch.zeros((2 + 2 * hp) * 2 * 4, dtype=_BF,
                            device=cuda), dims, hp)


def test_bf16_solve_on_card_matches_cpu(cuda):
    """poisson3d(24) with a bfloat16 hierarchy under a float32 CG, built
    on the card and on the CPU (the device build on both): the V-cycle's
    bfloat16 modes round as their plain versions, the float32 Krylov
    kernels sum in their own order, so the iterations agree within one;
    both meet the tolerance, and no plain version runs on the card."""
    from amgcl_tpu_torch import AMGParams, CG, make_solver, poisson3d
    A, rhs = poisson3d(24)
    runs = {}
    for device in ("cpu", cuda):
        solve = make_solver(A, AMGParams(dtype=_BF),
                            CG(maxiter=100, tol=1e-6), refine=3,
                            solver_dtype=torch.float32, device=device,
                            device_setup=True)
        lv = solve.precond.hierarchy.levels[0]
        assert lv.A.dtype == _BF and lv.down is not None
        calls = [p.calls for p in (dk.dia_residual_plain,
                                   vk.fused_down_sweep_plain,
                                   vk.fused_up_sweep_plain)]
        x, info = solve(rhs)
        if device != "cpu":
            assert [p.calls for p in (dk.dia_residual_plain,
                                      vk.fused_down_sweep_plain,
                                      vk.fused_up_sweep_plain)] == calls
        runs[torch.device(device).type] = (info.iters,
                                           x.double().cpu().numpy())
    assert abs(runs["cuda"][0] - runs["cpu"][0]) <= 1
    x = runs["cuda"][1]
    assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) <= 1e-6


# -- the bfloat16 Krylov modes (B.3, B.4, B.5, B.10) and gather (B.16) -------

def _bf_ulps(a, b):
    """The largest distance of two bfloat16 tensors in bfloat16 ULPs."""
    def key(t):
        i = t.detach().float().cpu().numpy().view(np.int32) >> 16
        i = i.astype(np.int64)
        return np.where(i < 0, -32768 - i, i)
    return int(np.abs(key(a) - key(b)).max()) if a.numel() else 0


def _bf_ordered(a, b, order=dk.ordered_dot):
    """The kernels' bfloat16 dot: float32 sums of a·b in the kernels'
    order (``order``), rounded once to bfloat16."""
    got = order(a.float().cpu().numpy(), b.float().cpu().numpy())
    return torch.tensor(float(np.float32(got))).to(_BF)


def _dots_agree(got, want, exact):
    """Each kernel dot equal, bit for bit, to ``exact`` (its order on its
    own vectors) and within one bfloat16 ULP of the plain version's
    (torch's order)."""
    for g, w, e in zip(got, want, exact):
        assert g.dtype == _BF and g.dim() == 0 and g.device.type == "cuda"
        assert torch.equal(g.cpu(), e), (float(g), float(e))
        assert _bf_ulps(g, w) <= 1, (float(g), float(w))


@pytest.mark.parametrize("n,offsets", _DOTS_CASES)
def test_bf16_dia_dots_equal_plain(cuda, n, offsets):
    """dia_spmv_dots (with and without w) and dia_residual_dot in
    bfloat16: y and r bit for bit with the plain versions and with the
    bfloat16 dia_spmv and dia_residual, the dots the float32 sums of the
    kernels' order rounded once, within one ULP of the plain version's."""
    off, data, x, f, w = _to_bf16(*_dia(n, n, offsets, torch.float32, cuda,
                                        seed=n))
    host = tuple(offsets)
    launches = (dk.dia_spmv_dots.bf16_launches,
                dk.dia_residual_dot.bf16_launches)
    for ww in (w, None):
        got = dk.dia_spmv_dots(host, data, x, ww)
        want = dk.dia_spmv_dots_plain(off, data, x, ww)
        y = got[0]
        assert torch.equal(y, want[0])
        assert torch.equal(y, dk.dia_spmv(off, data, x))
        vecs = (y, x) + (() if ww is None else (ww,))
        _dots_agree([d for d in got[1:] if d is not None],
                    [d for d in want[1:] if d is not None],
                    [_bf_ordered(y, v) for v in vecs])
    r, rr = dk.dia_residual_dot(host, data, f, x)
    want = dk.dia_residual_dot_plain(off, data, f, x)
    assert torch.equal(r, want[0])
    assert torch.equal(r, dk.dia_residual(off, data, f, x))
    _dots_agree([rr], [want[1]], [_bf_ordered(r, r)])
    assert (dk.dia_spmv_dots.bf16_launches,
            dk.dia_residual_dot.bf16_launches) == (launches[0] + 2,
                                                   launches[1] + 1)


@pytest.mark.parametrize("n", [1, 1000, 85623, 1056 * 256 * 3 + 7])
def test_bf16_tails_equal_plain(cuda, n):
    """xr_update, bicgstab_tail and axpby_dot in bfloat16: the vectors bit
    for bit with the plain versions, the dots within one ULP of theirs
    and, up to 270,336 elements (one a thread), the float32 sums of the
    kernels' order (``ordered_tail_dots``) rounded once; n above that runs
    the grid-stride loop more than once a thread."""
    rng = np.random.RandomState(n)
    v = [torch.as_tensor(rng.standard_normal(n)).to(device=cuda, dtype=_BF)
         for _ in range(6)]
    a = torch.tensor(0.37, dtype=_BF, device=cuda)
    b = torch.tensor(-1.25, dtype=_BF, device=cuda)
    f32 = lambda t: t.float().cpu().numpy()
    cases = [(fv.xr_update, fv.xr_update_plain, (a, *v[:4]), 2, None),
             (fv.bicgstab_tail, fv.bicgstab_tail_plain,
              (a, v[0], b, v[1], v[2], v[3], v[4], v[5]), 2, v[5]),
             (fv.axpby_dot, fv.axpby_dot_plain, (a, v[0], b, v[1]), 1, None)]
    for kern, plain, args, nvec, rhat in cases:
        launches = kern.bf16_launches
        got, want = kern(*args), plain(*args)
        assert kern.bf16_launches == launches + 1
        for g, p in zip(got[:nvec], want[:nvec]):
            assert g.dtype == _BF and torch.equal(g, p)
        for g, p in zip(got[nvec:], want[nvec:]):
            assert g.dtype == _BF and _bf_ulps(g, p) <= 1, (float(g),
                                                            float(p))
        if n <= 256 * 1056:
            exact = fv.ordered_tail_dots(
                f32(got[nvec - 1]), None if rhat is None else f32(rhat))
            for g, e in zip(got[nvec:], exact):
                assert torch.equal(g.cpu(), torch.tensor(float(e)).to(_BF))


@pytest.mark.parametrize("n,m,K,empty", [c for c in _WELL_CASES
                                         if c[0] == c[1]])
def test_bf16_well_dots_equal_plain(cuda, n, m, K, empty):
    """windowed_ell_spmv_dots in bfloat16: y bit for bit with the plain
    version and the bfloat16 windowed_ell_spmv, the dots within one ULP of
    the plain version's."""
    st, cl, v, x, f, w = _well(n, m, K, _BF, cuda, seed=K, empty=empty)
    launches = wk.windowed_ell_spmv_dots.bf16_launches
    for ww in (w, None):
        got = wk.windowed_ell_spmv_dots(st, cl, v, x, ww, n)
        want = wk.windowed_ell_spmv_dots_plain(st, cl, v, x, ww, n)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[0], wk.windowed_ell_spmv(st, cl, v, x, n))
        for g, p in zip(got[1:], want[1:]):
            assert (g is None) == (p is None)
            if g is not None:
                assert g.dtype == _BF and _bf_ulps(g, p) <= 1, (float(g),
                                                                float(p))
    assert wk.windowed_ell_spmv_dots.bf16_launches == launches + 2


@pytest.mark.parametrize("n,m,K,empty", _GATHER_CASES)
def test_bf16_gather_equals_plain(cuda, n, m, K, empty):
    """gather_spmv in bfloat16 bit for bit with its plain version: each
    product and running sum rounded, slot by slot, by both."""
    st, cl, v, x, _, _ = _well(n, m, K, _BF, cuda, seed=100 + K,
                               empty=empty)
    _equal_bf16(gk.gather_spmv, gk.gather_spmv_plain, (st, cl, v, x, n))


def test_bf16_krylov_solve_on_card_matches_cpu(cuda):
    """poisson3d(24) with a bfloat16 hierarchy and the default, bfloat16,
    CG loop, built on the card and on the CPU: the vectors of every mode
    round as their plain versions and a dot moves by at most one ULP, so
    the counts agree within two; the bfloat16 Krylov modes launch and no
    plain version runs on the card."""
    from amgcl_tpu_torch import AMGParams, CG, make_solver, poisson3d
    A, rhs = poisson3d(24)
    kerns = (dk.dia_spmv_dots, dk.dia_residual_dot, fv.xr_update)
    plains = (dk.dia_spmv_dots_plain, dk.dia_residual_dot_plain,
              fv.xr_update_plain, dk.dia_residual_plain,
              vk.fused_down_sweep_plain, vk.fused_up_sweep_plain)
    runs = {}
    for device in ("cpu", cuda):
        solve = make_solver(A, AMGParams(dtype=_BF),
                            CG(maxiter=100, tol=1e-6), refine=3,
                            device=device, device_setup=True)
        assert solve.solver_dtype == _BF and solve.A_dev.dtype == _BF
        launches = [k.bf16_launches for k in kerns]
        calls = [p.calls for p in plains]
        x, info = solve(rhs)
        if device != "cpu":
            assert [p.calls for p in plains] == calls
            assert all(k.bf16_launches > n
                       for k, n in zip(kerns, launches))
        runs[torch.device(device).type] = (info.iters,
                                           x.double().cpu().numpy())
    assert abs(runs["cuda"][0] - runs["cpu"][0]) <= 2
    for _, x in runs.values():
        assert np.linalg.norm(rhs - A.spmv(x)) / np.linalg.norm(rhs) <= 1e-5


# -- the accelerator setup: device MIS, segment-sum plans, rebuild ------------

def test_device_mis_on_card_matches_cpu(cuda):
    """The distance-2 MIS rounds on the card twice and on the CPU, on a
    small unstructured system: the same aggregates each time."""
    from amgcl_tpu_torch import fe_like_problem
    from amgcl_tpu_torch.coarsening.device_mis import aggregates_on_device
    A, _ = fe_like_problem(n=6000, nnz_target=28 * 6000, seed=1)
    got = [aggregates_on_device(A, 0.08, d) for d in (cuda, cuda, "cpu")]
    for agg, n in got[1:]:
        assert n == got[0][1] and np.array_equal(agg, got[0][0])


def test_segment_plans_on_card_repeat_and_match_cpu(cuda):
    """The smoothing and Galerkin plans' numeric pass on the card: bit
    for bit from run to run, and equal to the CPU's in float64 (both sum
    each segment in entry order)."""
    from amgcl_tpu_torch import fe_like_problem
    from amgcl_tpu_torch.coarsening.device_mis import aggregates_on_device
    from amgcl_tpu_torch.coarsening.smoothed_aggregation import _filtered
    from amgcl_tpu_torch.ops import segment_spgemm as seg
    A, _ = fe_like_problem(n=6000, nnz_target=28 * 6000, seed=1)
    agg, n_agg = aggregates_on_device(A, 0.08, "cpu")
    Af, dinv = _filtered(A, 0.08)
    plan = seg.SmoothPlan(Af, agg, n_agg)
    P = [plan.prolongation(Af, dinv, 0.6, d) for d in (cuda, cuda, "cpu")]
    assert np.array_equal(P[0].val, P[1].val)
    assert np.array_equal(P[0].val, P[2].val)
    g = seg.GalerkinPlan(A, P[2], P[2].transpose())
    Ac = [g.coarse(A, 1.0, d).val for d in (cuda, cuda, "cpu")]
    assert np.array_equal(Ac[0], Ac[1]) and np.array_equal(Ac[0], Ac[2])


def test_rebuild_on_card_equals_a_fresh_build(cuda):
    """A host-loop hierarchy built with the setup on the card, rebuilt
    with doubled values through its plans: the host levels and the level
    operators equal a fresh build's bit for bit, and so do two builds."""
    from amgcl_tpu_torch import AMG, AMGParams, CSR, fe_like_problem
    A, _ = fe_like_problem(n=6000, nnz_target=28 * 6000, seed=1)
    prm = AMGParams(dtype=torch.float32, coarse_enough=500)
    amg = AMG(A, prm, device=cuda)
    twin = AMG(A, prm, device=cuda)
    A2 = CSR(A.ptr, A.col, A.val * 2.0, A.ncols)
    for other in (twin, None):
        if other is None:
            amg.rebuild(A2)
            other = AMG(A2, prm, device=cuda)
        for (Ai, _, _), (Bi, _, _) in zip(amg.host_levels,
                                          other.host_levels):
            assert np.array_equal(Ai.val, Bi.val)
        for lv, lw in zip(amg.hierarchy.levels, other.hierarchy.levels):
            ts = [v for v in vars(lv.A).values() if torch.is_tensor(v)]
            us = [v for v in vars(lw.A).values() if torch.is_tensor(v)]
            assert all(torch.equal(t, u) for t, u in zip(ts, us))
        assert torch.equal(amg.hierarchy.coarse.inv,
                           other.hierarchy.coarse.inv)


def test_device_inverse_on_card(cuda):
    """The float32 coarse inverse on the card with its Newton–Schulz
    polish: kept for a well-conditioned level, and close to the host
    float64 inverse."""
    import scipy.sparse as sp
    from amgcl_tpu_torch import CSR
    from amgcl_tpu_torch.solver.direct import DenseDirectSolver
    n = 300
    L = sp.diags([-np.ones(n - 1), 2.1 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).tocsr()
    s = DenseDirectSolver.build(CSR.from_scipy(L), torch.float32, cuda,
                                device_inv=True)
    assert s.device_rnorm is not None and s.device_rnorm < 1e-3
    ref = np.linalg.inv(L.toarray())
    assert np.abs(s.inv.double().cpu().numpy() - ref).max() \
        <= 1e-4 * np.abs(ref).max()


# -- the serving slice: stacked solves and the buckets' CUDA graphs ------------

def _serve_bundle(cuda, m=24, solver=None, **kw):
    from amgcl_tpu_torch import AMGParams, CG, make_solver, poisson3d
    A, rhs = poisson3d(m)
    return A, rhs, make_solver(A, AMGParams(dtype=torch.float32),
                               solver or CG(maxiter=100, tol=1e-6),
                               device=cuda, **kw)


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_bucket_graph_replay_equals_eager_apply(cuda, B):
    """Every bucket's replay gives the eager per-column apply's bits, on
    fresh inputs each time (the static buffers are refilled); the
    bucket is captured once; the hierarchy's fused legs launch inside
    the graph only at capture."""
    A, rhs, solve = _serve_bundle(cuda)
    pre = solve.stacked_precond()
    assert pre.lowering == "per-column-graph"
    rng = np.random.RandomState(B)
    for rep in range(3):
        R = torch.as_tensor(rng.standard_normal((B, A.nrows)),
                            dtype=torch.float32, device=cuda).T
        got = pre(R)
        want = pre.eager(R)
        assert torch.equal(got, want), rep
    assert pre.captures == {B: 1} and pre.replays == {B: 3}
    launches = vk.fused_down_sweep.launches
    pre(R)
    assert vk.fused_down_sweep.launches == launches   # replayed, not launched


def test_capture_stream_ticket_is_made_once_outside_capture(cuda):
    """The capture stream's ticket exists before the bucket's capture and
    is reused by every capture on that stream: a graph captured there
    with the dot kernel and the BiCGStab tail (both ticketed) replays to
    the eager results and leaves the ticket where it was, at 0; a ticket
    missing during a capture is refused."""
    A, rhs, solve = _serve_bundle(cuda)
    pre = solve.stacked_precond()
    pre(torch.rand(2, A.nrows, device=cuda).T)        # captures B = 2
    side = pre._stream
    key = (side.device, side.cuda_stream)
    ticket = dk._TICKETS[key]
    ptr = ticket.data_ptr()
    pre(torch.rand(4, A.nrows, device=cuda).T)        # captures B = 4
    assert pre.captures == {2: 1, 4: 1} and dk._TICKETS[key] is ticket
    off, data = solve.A_dev.offsets, solve.A_dev.data
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, ph, sh, s_, t_, xx, rh = (
        torch.rand(A.nrows, device=cuda, generator=gen) for _ in range(7))
    alpha = torch.tensor(0.25, device=cuda)
    omega = torch.tensor(0.75, device=cuda)

    def body():
        return dk.dia_spmv_dots(off, data, x)[:3] + fv.bicgstab_tail(
            alpha, ph, omega, sh, s_, t_, xx, rh)

    want = body()
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        got = body()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert dk._TICKETS[key] is ticket and ticket.data_ptr() == ptr
        assert int(ticket.item()) == 0
    fresh = torch.cuda.Stream(cuda)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="ensure_ticket"):
        with torch.cuda.graph(g, stream=fresh):
            dk.dia_spmv_dots(off, data, x)


def test_capture_refused_by_name_on_a_syncing_preconditioner(cuda):
    """A nested Krylov preconditioner syncs with the host: it runs
    uncaptured under its own lowering tag and ``reason`` names why; a
    hierarchy that syncs without saying so fails its capture with the
    module and line of the sync."""
    from amgcl_tpu_torch import AMGParams, poisson3d
    from amgcl_tpu_torch.models import runtime as P
    from amgcl_tpu_torch.serve import StackedPrecond
    A, rhs = poisson3d(16)
    nested = P.precond_from_config(
        A, {"class": "nested", "solver.type": "cg", "solver.maxiter": 3,
            "precond.class": "amg"}, device=cuda)
    pre = StackedPrecond(nested.hierarchy.apply, nested.hierarchy, cuda)
    assert pre.lowering == "per-column-uncaptured"
    assert "NestedHierarchy" in pre.reason
    R = torch.rand(2, A.nrows, device=cuda).T
    assert torch.equal(pre(R), pre.eager(R)) and pre.captures == {}

    class Syncing:
        def apply(self, r):
            return r * float(r.abs().max())

    sync = StackedPrecond(Syncing().apply, Syncing(), cuda)
    assert sync.lowering == "per-column-graph"
    with pytest.raises(RuntimeError, match="Syncing.*test_torch_cuda"):
        sync(R)


@pytest.mark.parametrize("solver", ["CG", "BiCGStab", "GMRES", "BlockCG"])
def test_stacked_solve_on_card_matches_cpu(cuda, solver):
    """A float64 stacked solve of 4 columns through the graphs: the
    per-column counts of the same solve on the CPU, x within 1e-9, no
    plain version run on the card, and a service over the bundle gives
    the same columns."""
    import amgcl_tpu_torch as T
    from amgcl_tpu_torch.serve import BlockCG, SolverService
    A, rhs = T.poisson3d(16)
    mk = (BlockCG if solver == "BlockCG" else getattr(T, solver))
    R = np.random.RandomState(9).rand(A.nrows, 4)
    out = {}
    for dev in ("cpu", cuda):
        solve = T.make_solver(A, T.AMGParams(dtype=torch.float64),
                              mk(maxiter=100, tol=1e-8), device=dev)
        calls = dk.dia_spmv_plain.calls
        x, info = solve(R)
        if dev != "cpu":
            assert dk.dia_spmv_plain.calls == calls
            assert info.extra["lowering"] == "per-column-graph"
            with SolverService(solve, batch=4) as svc:
                xs, rep = svc.solve_batch(R)
            assert torch.equal(xs, x)
        out[str(dev)] = (x.cpu().numpy(), info.extra["per_rhs"]["iters"])
    assert out["cpu"][1] == out["cuda"][1]
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-9,
                               atol=1e-12)


# -- the bfloat16 block windowed ELL (B.11-B.13) and dense window (B.14/B.15) -

def _bf16_block_modes(st, cl, v, x, f, S, w, n):
    """Every block mode in bfloat16 against its plain version: the
    vectors bit for bit, the dots within one ULP, one bfloat16 launch
    each."""
    _equal_bf16(wbk.windowed_ell_block_spmv,
                wbk.windowed_ell_block_spmv_plain, (st, cl, v, x, n))
    _equal_bf16(wbk.windowed_ell_block_residual,
                wbk.windowed_ell_block_residual_plain, (st, cl, v, f, x, n))
    _equal_bf16(wbk.windowed_ell_block_scaled_correction,
                wbk.windowed_ell_block_scaled_correction_plain,
                (st, cl, v, S, f, x, n))
    for ww in (None, w):
        launches = wbk.windowed_ell_block_spmv_dots.bf16_launches
        got = wbk.windowed_ell_block_spmv_dots(st, cl, v, x, ww, n)
        want = wbk.windowed_ell_block_spmv_dots_plain(st, cl, v, x, ww, n)
        assert wbk.windowed_ell_block_spmv_dots.bf16_launches == launches + 1
        assert torch.equal(got[0], want[0])
        for g, p in zip(got[1:], want[1:]):
            assert (g is None) == (p is None)
            if g is not None:
                assert g.dtype == _BF and _bf_ulps(g, p) <= 1, (float(g),
                                                                float(p))


@pytest.mark.parametrize("n,m,K,b,empty", _WELL_BLOCK_CASES)
def test_bf16_well_block_modes_equal_plain(cuda, n, m, K, b, empty):
    """The block kernel's bfloat16 mode (each product exact in float, a
    row's sum in slot, then column order, rounded once, then every
    operation rounded) bit for bit with its plain version, on random
    blocks and a random non-symmetric scale."""
    _bf16_block_modes(*_well_block(n, m, K, b, _BF, cuda, seed=K,
                                   empty=empty), n)


@pytest.mark.parametrize("n,K,b", _WELL_BLOCK_EDGE_CASES)
def test_bf16_well_block_geometry_edges(cuda, n, K, b):
    """The bfloat16 block modes at the kernel's edges (K 4-100, so that
    3×3 nodes start 8 bytes off a 16-byte boundary where K / 4 is odd;
    an empty tile; slots past the end of x), every node written."""
    st, cl, v, x, f, S, w = _well_block_edges(n, n, K, b, _BF, cuda,
                                              seed=K + b)
    _poisoned(n * b, _BF, cuda)
    _bf16_block_modes(st, cl, v, x, f, S, w, n)


@pytest.mark.parametrize("n,m,K", [(13310, 110592, 48), (110592, 13310, 8),
                                   (1049, 13310, 112)])
def test_bf16_well_block_rectangular_equal_plain(cuda, n, m, K):
    """The block path's transfer shapes in bfloat16."""
    st, cl, v, x, f, _, _ = _well_block(n, m, K, 3, _BF, cuda, seed=n)
    _equal_bf16(wbk.windowed_ell_block_spmv,
                wbk.windowed_ell_block_spmv_plain, (st, cl, v, x, n))
    _equal_bf16(wbk.windowed_ell_block_residual,
                wbk.windowed_ell_block_residual_plain, (st, cl, v, f, x, n))


@pytest.mark.parametrize("n,m,win,empty", _DWIN_CASES
                         + [(1000, 1000, 128, None), (700, 1500, 192, 3),
                            (5000, 5000, 4608, None), (640, 9000, 8200, 2)])
def test_bf16_dwin_modes_equal_plain(cuda, n, m, win, empty):
    """The dense window's bfloat16 mode (each product exact in float, the
    lanes' sums and the warp's xor tree in float, the row sum rounded
    once, then every operation rounded) bit for bit with its plain
    version, which sums in the kernel's order: windows narrower than 256
    columns, chunks of 4,096 with a ragged last one, windows past ncols,
    an empty tile; every row written."""
    st, B, x, f, w = _dwin(n, m, win, _BF, cuda, seed=n + win, empty=empty)
    _poisoned(n, _BF, cuda)
    _equal_bf16(dwk.dense_window_spmv, dwk.dense_window_spmv_plain,
                (st, B, x, n))
    _equal_bf16(dwk.dense_window_residual, dwk.dense_window_residual_plain,
                (st, B, f, x, n))
    if n == m:
        _equal_bf16(dwk.dense_window_scaled_correction,
                    dwk.dense_window_scaled_correction_plain,
                    (st, B, w, f, x, n))


def test_bf16_block_and_dwin_solves_on_card_match_cpu(cuda):
    """A bfloat16 block hierarchy and a bfloat16 dense-window one under
    the default bfloat16 CG, on the card and on the CPU: every level in
    its format, the counts within one (the dots sum in another order),
    and no plain version on the card."""
    from amgcl_tpu_torch import AMGParams, CG, make_solver, poisson3d, \
        poisson3d_block
    for A, fmt in ((poisson3d_block(12, 3)[0], {}),
                   (poisson3d(16)[0], dict(matrix_format="dwin"))):
        rhs = np.random.RandomState(5).standard_normal(
            A.nrows * A.block_size[0])
        runs = {}
        for device in ("cpu", cuda):
            solve = make_solver(A, AMGParams(dtype=_BF, **fmt),
                                CG(tol=1e-6), device=device)
            plains = _PLAIN + (dwk.dense_window_spmv_plain,
                               dwk.dense_window_residual_plain,
                               dwk.dense_window_scaled_correction_plain)
            calls = [p.calls for p in plains]
            x, info = solve(rhs)
            if device != "cpu":
                assert [p.calls for p in plains] == calls
            assert all(lv.A.dtype == _BF
                       for lv in solve.precond.hierarchy.levels)
            runs[torch.device(device).type] = info.iters
        assert abs(runs["cpu"] - runs["cuda"]) <= 1, runs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_m", [True, False])
def test_stencil_galerkin_device_route_on_card_equals_host(cuda, with_m,
                                                          dtype):
    """The stencil Galerkin plan's numeric pass on the card, bit for bit
    with its host route (the native multiply-add batch): each product is
    rounded before its subtraction on both, in the same order."""
    from amgcl_tpu_torch import poisson3d
    from amgcl_tpu_torch.ops import stencil as st
    A, _ = poisson3d(17)
    grid = (17, 17, 17)
    Ad = st.host_dia_from_csr(A, grid, dtype)
    M = None
    if with_m:
        Af, Dinv = st.filtered_dia(Ad, 0.08)
        M = st.scale_rows(Af, Dinv)
        M.data = M.data * dtype(0.57)
        M = M.drop_empty()
    plan = st.StencilGalerkinPlan(
        Ad.offsets3, None if M is None else M.offsets3, Ad.dims,
        (2, 2, 2), (9, 9, 9), dtype)
    m = None if M is None else M.data
    host = plan.apply(Ad.data, m)
    got = plan.apply(Ad.data, m, torch.device("cuda"))
    assert got.offsets3 == host.offsets3
    assert got.data.dtype == host.data.dtype
    assert np.array_equal(got.data, host.data)
