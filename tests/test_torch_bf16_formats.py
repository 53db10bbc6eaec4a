"""The bfloat16 modes of the block windowed ELL (ROADMAP B.19: the kernels
B.11–B.13) and of the dense window (B.20: B.14/B.15) against the JAX
package on the CPU:

- each plain version against the JAX kernel in interpret mode on the same
  bfloat16 inputs (b = 2, 3 and 4; K = 12, so that the 3×3 nodes' runs of
  216 bytes put every other node 8 bytes off a 16-byte boundary; random
  blocks; a non-symmetric scale; an empty tile whose padding points past
  x; a rectangular operator; dense windows narrower than 256 columns,
  past the end of x and over an empty tile);
- the port's bfloat16 dense-window packing against the JAX package's bit
  for bit, duplicated entries and its width and budget rules (2 bytes a
  value) included;
- the levels of chip_smoke.py's BFB1 and BFD2 at reduced sizes;
- the plain versions' float32 sums in the kernels' order against a
  float64 product, within the bfloat16 bound.

The JAX package forms these bfloat16 kernels on the CPU with each product
of two bfloat16 values kept exact in float32, a row summed in float32 and
rounded once, and every later operation rounded to bfloat16 (the dense
window too: its bfloat16 product is not rounded there).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from amgcl_tpu.models.amg import AMG as RefAMG, AMGParams as RefParams
from amgcl_tpu.ops import densewin as ref_dw
from amgcl_tpu.ops import unstructured as ref_un
from amgcl_tpu.ops.csr import CSR as RefCSR
from amgcl_tpu.telemetry.ledger import DeviceMemoryBudget as RefBudget

import amgcl_tpu_torch as T
from amgcl_tpu_torch.ops import densewin as dw
from amgcl_tpu_torch.ops import densewin_kernels as dwk
from amgcl_tpu_torch.ops import unstructured as U
from amgcl_tpu_torch.ops import well_block_kernels as wbk
from amgcl_tpu_torch.ops.densewin import DenseWindowMatrix
from amgcl_tpu_torch.ops.unstructured import WindowedEllMatrix
from amgcl_tpu_torch.telemetry.ledger import DeviceMemoryBudget

BF = torch.bfloat16
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


def _f32(a):
    """A JAX or torch bfloat16 array as float32 numpy (exact)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _ulp_gaps(a, b):
    """Entry by entry, the distance of two float32 arrays of bfloat16
    values in bfloat16 ULPs (bit patterns mapped to integers in value
    order)."""
    def key(x):
        i = (np.asarray(x, np.float32).view(np.int32) >> 16).astype(np.int64)
        return np.where(i < 0, -32768 - i, i)
    return np.abs(key(a) - key(b))


def _bf(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(BF)


def _jbf(a):
    return jnp.asarray(np.asarray(a, np.float32), dtype=jnp.bfloat16)


# -- block windowed ELL (B.11-B.13) ------------------------------------------

def _block_system(b, seed, rect=False):
    """A random banded BCSR of b×b blocks (port and JAX CSR). Square: 3,072
    nodes whose middle tile (1,024-2,047) holds no entry, the block-column
    count a multiple of 1,024 (so that tile's padding points one past x),
    rows of 5 to 12 blocks with row 0 at 12 (K = 12). Rectangular: 2,500 ×
    5,000 nodes (a restriction's shape) with a ragged last tile."""
    rng = np.random.RandomState(seed)
    n, m = (2500, 5000) if rect else (3072, 3072)
    rows, cols = [], []
    for i in range(n):
        if not rect and 1024 <= i < 2048:
            continue
        c = int(i * m / n)
        k = 12 if i == 0 else rng.randint(5, 13)
        for j in sorted(rng.choice(np.arange(max(0, c - 40),
                                             min(m, c + 41)), k,
                                   replace=False)):
            rows.append(i)
            cols.append(j)
    S = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, m))
    S.sort_indices()
    val = rng.standard_normal((S.nnz, b, b))
    return (T.CSR(S.indptr, S.indices, val, m),
            RefCSR(S.indptr, S.indices, val, m))


_BLOCK_CASES = [(2, False), (3, False), (4, False), (3, True)]


def _block_operands(b, rect, seed):
    A, A_r = _block_system(b, seed, rect)
    W = U.csr_to_windowed_ell(A, BF)
    W_r = ref_un.csr_to_windowed_ell(A_r, jnp.bfloat16)
    assert np.array_equal(_f32(W.vals), _f32(W_r.vals))
    assert np.array_equal(W.cols_local.numpy(), np.asarray(W_r.cols_local))
    assert np.array_equal(W.window_starts.numpy(),
                          np.asarray(W_r.window_starts))
    rng = np.random.RandomState(seed + 100)
    n, m = A.nrows * b, A.ncols * b
    v = {"x": rng.standard_normal(m), "f": rng.standard_normal(n),
         "w": rng.standard_normal(n),
         "S": rng.standard_normal((A.nrows, b, b)) * 0.3}
    return A, W, W_r, v


@pytest.mark.parametrize("b,rect", _BLOCK_CASES)
def test_block_operators_cover_what_they_claim(b, rect):
    """K = 12 (odd nodes of 3×3 blocks 8 bytes off in bfloat16), an empty
    tile whose padding points one past x, a rectangular operator whose
    tiles start apart."""
    A, W, _, _ = _block_operands(b, rect, seed=b)
    assert W.K == 12 and W.block == (b, b) and W.vals.dtype == BF
    node_bytes = W.K * b * b * 2
    if b == 3:
        assert node_bytes % 16 == 8
    if rect:
        assert A.nrows % U._TILE and len(set(W.window_starts.tolist())) > 1
    else:
        assert W.window_starts.tolist()[1] == A.ncols


@pytest.mark.parametrize("b,rect", _BLOCK_CASES)
def test_block_modes_match_jax_kernels(b, rect):
    """B.11–B.13 in bfloat16: each plain version against the JAX kernel
    in interpret mode. Vectors within one bfloat16 ULP, and bit for bit
    in all but a few entries (XLA sums a row's exact products in its own
    float32 order, the port in slot, then block-column order: here 1 of
    12,288 entries of y at b = 4 lies one ULP apart, the rest and every
    other case bit for bit); dots within one ULP (here equal)."""
    A, W, W_r, v = _block_operands(b, rect, seed=10 + b)
    g, g_r = (W.window_starts, W.cols_local, W.vals), \
        (W_r.window_starts, W_r.cols_local, W_r.vals)
    n, win = W.shape[0], W_r.win
    t = {k: _bf(a) for k, a in v.items()}
    j = {k: _jbf(a) for k, a in v.items()}
    pairs = [(wbk.windowed_ell_block_spmv_plain(*g, t["x"], n),
              ref_un.windowed_ell_block_spmv(*g_r, j["x"], win, n,
                                             interpret=True)),
             (wbk.windowed_ell_block_residual_plain(*g, t["f"], t["x"], n),
              ref_un.windowed_ell_block_residual(*g_r, j["f"], j["x"], win,
                                                 n, interpret=True))]
    if not rect:
        pairs.append((
            wbk.windowed_ell_block_scaled_correction_plain(
                *g, t["S"], t["f"], t["x"], n),
            ref_un.windowed_ell_block_scaled_correction(
                *g_r, j["S"], j["f"], j["x"], win, n, interpret=True)))
        for w in (None, "w"):
            got = wbk.windowed_ell_block_spmv_dots_plain(
                *g, t["x"], None if w is None else t[w], n)
            want = ref_un.windowed_ell_block_spmv_dots(
                *g_r, j["x"], None if w is None else j[w], win=win,
                n_out=n, interpret=True)
            pairs.append((got[0], want[0]))
            for gd, wd in zip(got[1:], want[1:]):
                assert (gd is None) == (wd is None)
                if gd is not None:
                    assert gd.dtype == BF and gd.dim() == 0
                    assert _ulp_gaps(_f32(gd), _f32(wd)).max() <= 1
    for got, want in pairs:
        assert got.dtype == BF and got.shape == (n * b,)
        gaps = _ulp_gaps(_f32(got), _f32(want))
        assert gaps.max() <= 1 and (gaps > 0).sum() <= 2, \
            (int(gaps.max()), int((gaps > 0).sum()))


def test_block_correction_reads_the_scale_as_stored():
    """A non-symmetric scale and non-symmetric blocks: the correction's
    bfloat16 plain version equals, bit for bit, x + S r formed from the
    rounded residual with S[i] applied row by row (and differs from Sᵀ's)."""
    A, W, _, v = _block_operands(3, False, seed=31)
    n = W.shape[0]
    t = {k: _bf(a) for k, a in v.items()}
    g = (W.window_starts, W.cols_local, W.vals)
    r = wbk.windowed_ell_block_residual_plain(*g, t["f"], t["x"], n)
    S = t["S"].float()
    assert not torch.equal(S, S.transpose(1, 2))
    got = wbk.windowed_ell_block_scaled_correction_plain(*g, t["S"], t["f"],
                                                         t["x"], n)
    r3 = r.float().reshape(-1, 3)
    corr = S[:, :, 0] * r3[:, None, 0] + S[:, :, 1] * r3[:, None, 1] \
        + S[:, :, 2] * r3[:, None, 2]
    want = (t["x"] + corr.reshape(-1).to(BF))
    assert torch.equal(got, want)
    corr_t = torch.einsum("nji,nj->ni", S, r3).reshape(-1).to(BF)
    assert not torch.equal(got, t["x"] + corr_t)


@pytest.mark.parametrize("b", [2, 3, 4])
def test_block_product_order_within_the_bfloat16_bound(b):
    """The plain version's float32 sum in the kernel's order, rounded
    once, against the float64 product of the same bfloat16 values: within
    bfloat16's unit roundoff (2⁻⁸) of the float64 value plus the float32
    sum's rounding."""
    A, W, _, v = _block_operands(b, False, seed=40 + b)
    x = _bf(v["x"])
    y = _f32(wbk.windowed_ell_block_spmv_plain(
        W.window_starts, W.cols_local, W.vals, x, W.shape[0]))
    Ab = sp.bsr_matrix((_f32(_bf(A.val)).astype(np.float64), A.col, A.ptr),
                       shape=(A.nrows * b, A.ncols * b))
    exact = Ab @ _f32(x).astype(np.float64)
    terms = abs(Ab) @ np.abs(_f32(x).astype(np.float64))
    err = np.abs(y - exact)
    assert np.all(err <= 2.0 ** -8 * np.abs(exact) * 1.01
                  + W.K * b * 2.0 ** -24 * terms)


# -- dense window (B.14/B.15) -------------------------------------------------

def _dwin_operands(n_out, ncols, win, seed, empty=None):
    """Random dense-window operands as csr_to_dense_window leaves them:
    tiles of 64 rows, starts (multiples of 1,024) that differ and reach
    past ncols, the entries there and past n_out zero; tile ``empty``
    holds nothing and starts at ncols floored to 1,024."""
    rng = np.random.RandomState(seed)
    n_tiles = -(-n_out // 64)
    starts = rng.randint(0, (ncols - 1) // 1024 + 1, n_tiles) * 1024
    if empty is not None:
        starts[empty] = ncols // 1024 * 1024
    blocks = rng.standard_normal((n_tiles, 64, win))
    cols = starts[:, None] + np.arange(win)
    blocks[np.broadcast_to((cols >= ncols)[:, None, :], blocks.shape)] = 0.0
    blocks.reshape(-1, win)[n_out:] = 0.0
    if empty is not None:
        blocks[empty] = 0.0
    vecs = [rng.standard_normal(ncols), rng.standard_normal(n_out),
            rng.rand(n_out)]
    return starts.astype(np.int32), blocks, vecs


_DWIN_CASES = [
    # (n_out, ncols, win, empty tile)
    (1000, 1000, 128, None),      # narrower than 256 columns
    (700, 1500, 192, 3),          # narrower, a ragged vector, empty tile
    (3000, 3000, 1024, 5),
    (2500, 2600, 3072, None),     # every window past ncols
    (640, 9000, 4608, None),      # chunks of 4,096 and a ragged 512
]


@pytest.mark.parametrize("n,m,win,empty", _DWIN_CASES)
def test_dense_window_modes_match_jax_kernels(n, m, win, empty):
    """B.14/B.15 in bfloat16: each plain version against the JAX kernel in
    interpret mode on the same bfloat16 blocks and vectors, bit for bit
    (each product exact in float32, the row summed in float32 and rounded
    once, then every operation rounded, by both)."""
    starts, blocks, (x, f, w) = _dwin_operands(n, m, win, seed=win + n,
                                               empty=empty)
    tb, jb = _bf(blocks), _jbf(blocks)
    ts, js = torch.as_tensor(starts), jnp.asarray(starts)
    tx, tf, tw = (_bf(a) for a in (x, f, w))
    jx, jf, jw = (_jbf(a) for a in (x, f, w))
    pairs = [
        (dwk.dense_window_spmv_plain(ts, tb, tx, n),
         ref_dw.dense_window_spmv(js, jb, jx, win, n, interpret=True)),
        (dwk.dense_window_residual_plain(ts, tb, tf, tx, n),
         ref_dw.dense_window_residual(js, jb, jf, jx, win, n,
                                      interpret=True))]
    if n == m:
        pairs.append((
            dwk.dense_window_scaled_correction_plain(ts, tb, tw, tf, tx, n),
            ref_dw.dense_window_scaled_correction(js, jb, jw, jf, jx, win,
                                                  n, interpret=True)))
    for got, want in pairs:
        assert got.dtype == BF and got.shape == (n,)
        assert np.array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("n,m,win,empty", _DWIN_CASES[:4])
def test_dense_window_order_within_the_bfloat16_bound(n, m, win, empty):
    """The plain version's float32 sum in the kernel's lane order against
    the float64 product of the same bfloat16 values, within the bfloat16
    bound; a bfloat16 product rounded before the sum (the rule the JAX
    package's CPU arithmetic does not take) gives other values."""
    starts, blocks, (x, _, _) = _dwin_operands(n, m, win, seed=win,
                                               empty=empty)
    tb, tx = _bf(blocks), _bf(x)
    y = _f32(dwk.dense_window_spmv_plain(torch.as_tensor(starts), tb, tx, n))
    B = _f32(tb).astype(np.float64)
    xp = np.concatenate([_f32(tx).astype(np.float64), np.zeros(win)])
    xw = xp[starts.astype(np.int64)[:, None] + np.arange(win)]
    exact = np.einsum("trw,tw->tr", B, xw).reshape(-1)[:n]
    terms = np.einsum("trw,tw->tr", np.abs(B), np.abs(xw)).reshape(-1)[:n]
    assert np.all(np.abs(y - exact) <= 2.0 ** -8 * np.abs(exact) * 1.01
                  + win * 2.0 ** -24 * terms)
    rounded = _f32(_bf(B * xw[:, None, :])).astype(np.float64).sum(-1)
    assert not np.array_equal(y, _f32(_bf(rounded.reshape(-1)[:n])))


def test_dense_window_launch_geometry_in_bfloat16():
    """bfloat16 chunks are 4,096 columns, or the window rounded up to a
    multiple of 256 (32 of the kernel's 8-value vectors) where narrower;
    the float32 and float64 chunks are as before."""
    g = dwk.launch_geometry
    assert [g(3, w, 2).chunk for w in (128, 192, 1024, 3072, 4608)] \
        == [256, 256, 1024, 3072, 4096]
    assert g(3, 4608, 2).smem == 2 * 4096 * 2
    assert [g(3, w, 4).chunk for w in (128, 1024, 4608)] == [128, 1024, 2048]
    assert [g(3, w, 8).chunk for w in (128, 1024, 4608)] == [128, 1024, 1024]


def _dup_matrix():
    """A 200 × 3,000 CSR with duplicated entries in CSR order (1 and three
    times 2⁻⁹ at (0, 3): 1.0 when each sum is rounded to bfloat16, 1.0078125
    when they are summed first), a value that rounds twice (1 + 2⁻⁸ + 2⁻³⁰,
    through float32 to 1.0), and a wide band."""
    rng = np.random.RandomState(3)
    rows = [0, 0, 0, 0, 1, 2, 2]
    cols = [3, 3, 3, 3, 1, 5, 5]
    vals = [1.0, 2 ** -9, 2 ** -9, 2 ** -9, 1 + 2 ** -8 + 2 ** -30,
            1 + 2 ** -8 + 2 ** -30, 2 ** -9]
    for i in range(3, 200):
        for j in rng.choice(np.arange(max(0, 10 * i - 500),
                                      min(3000, 10 * i + 500)), 6,
                            replace=False):
            rows.append(i)
            cols.append(int(j))
            vals.append(rng.standard_normal() * 1.37)
    order = np.argsort(rows, kind="stable")
    r, c, v = (np.asarray(a)[order] for a in (rows, cols, vals))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=200))])
    return T.CSR(ptr, c, v, 3000), RefCSR(ptr, c, v, 3000)


def test_dense_window_packing_matches_jax_bit_for_bit():
    """The port's bfloat16 packing against the JAX package's: the same
    starts, window and blocks bit for bit, duplicated entries added in CSR
    order with each sum rounded, and the same bytes charged."""
    A, A_r = _dup_matrix()
    budget, budget_r = DeviceMemoryBudget(1 << 30), RefBudget(1 << 30)
    M = dw.csr_to_dense_window(A, BF, budget=budget, device="cpu")
    M_r = ref_dw.csr_to_dense_window(A_r, jnp.bfloat16, budget=budget_r)
    assert M.win == M_r.win and M.shape == M_r.shape
    assert np.array_equal(M.window_starts.numpy(),
                          np.asarray(M_r.window_starts))
    assert M.blocks.dtype == BF
    assert np.array_equal(_f32(M.blocks), _f32(M_r.blocks))
    assert float(M.blocks[0, 0, 3]) == 1.0
    assert float(M.blocks[0, 1, 1]) == 1.0
    assert budget.used == budget_r.used == M.blocks.numel() * 2


def test_dense_window_width_and_budget_rules_in_bfloat16():
    """The width rule at 2 bytes a value: a 25,600-column window passes in
    bfloat16 and declines ("vmem") in float32, in both packages; a budget
    one byte short of the bfloat16 blocks declines ("window" untouched,
    "budget" after an earlier charge) as the JAX package's does."""
    rows, cols = [0, 0] + list(range(1, 64)), [0, 24999] + list(range(1, 64))
    S = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(64, 25000))
    A = T.CSR(S.indptr, S.indices, S.data, 25000)
    A_r = RefCSR(S.indptr, S.indices, S.data, 25000)
    for dt, jdt in ((BF, jnp.bfloat16), (torch.float32, jnp.float32)):
        why, why_r = {}, {}
        got = dw.csr_to_dense_window(A, dt, why=why, device="cpu")
        want = ref_dw.csr_to_dense_window(A_r, jdt, why=why_r)
        assert (got is None) == (want is None) == (dt != BF)
        assert why == why_r
    need = 64 * 25600 * 2
    for total, spent, reason in ((need - 1, 0, "window"),
                                 (need, 1, "budget"), (need, 0, None)):
        budget, budget_r = DeviceMemoryBudget(total), RefBudget(total)
        budget.try_charge(spent)
        budget_r.try_charge(spent)
        why, why_r = {}, {}
        got = dw.csr_to_dense_window(A, BF, budget=budget, why=why,
                                     device="cpu")
        want = ref_dw.csr_to_dense_window(A_r, jnp.bfloat16,
                                          budget=budget_r, why=why_r)
        assert (got is None) == (want is None) == (reason is not None)
        assert why.get("why") == why_r.get("why") == reason
        assert why["need_bytes"] == why_r["need_bytes"] == need


# -- the levels of BFB1 and BFD2 at reduced sizes ------------------------------

def _ref(A):
    return RefCSR(A.ptr, A.col, A.val, A.ncols)


def test_bfb1_levels_match_jax():
    """BFB1's hierarchy (B1's call under AMGParams(dtype=bfloat16)) on
    poisson3d_block(16, 3) with coarse_enough=300: the JAX package's levels
    and block shapes; every A, P and R a bfloat16 block windowed ELL of
    3×3 blocks with its K and window, and A's blocks bit for bit."""
    A, _ = T.poisson3d_block(16, 3)
    ref = RefAMG(_ref(A), RefParams(dtype=jnp.bfloat16, coarse_enough=300))
    port = T.AMG(A, T.AMGParams(dtype=BF, coarse_enough=300), device="cpu")
    pl, rl = port.hierarchy.levels, ref.hierarchy.levels
    assert len(pl) == len(rl) >= 3
    for p, r in zip(pl, rl):
        parts = [(p.A, r.A)] + ([(p.P, r.P), (p.R, r.R)]
                                if p.P is not None else [])
        for got, want in parts:
            assert type(got) is WindowedEllMatrix and got.dtype == BF
            assert type(want).__name__ == "WindowedEllMatrix"
            assert (got.shape, got.block, got.K, got.win) == (
                tuple(want.shape), (3, 3), want.cols_local.shape[2],
                want.win)
        assert np.array_equal(_f32(p.A.vals), _f32(r.A.vals))
        if p.P is not None:
            assert p.relax.scale.dtype == BF
            assert _ulp_gaps(_f32(p.relax.scale),
                             _f32(r.relax.scale)).max() <= 1


def test_bfd2_levels_match_jax():
    """BFD2's hierarchy (D2's call under AMGParams(dtype=bfloat16)) on U2's
    system cut to 6,000 rows: the JAX package's level rows and windows;
    every A, M and Mᵀ a bfloat16 dense window, L0's blocks bit for bit."""
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    A, _ = T.fe_like_problem(6000, nnz_target=int(U1_NNZ_PER_ROW * 6000))
    A = permute(A, cuthill_mckee(A))
    prm = dict(matrix_format="dwin")
    ref = RefAMG(_ref(A), RefParams(dtype=jnp.bfloat16, **prm))
    port = T.AMG(A, T.AMGParams(dtype=BF, **prm), device="cpu")
    pl, rl = port.hierarchy.levels, ref.hierarchy.levels
    assert [lv.A.shape for lv in pl] == [tuple(lv.A.shape) for lv in rl]
    assert len(pl) >= 2
    for p, r in zip(pl, rl):
        parts = [(p.A, r.A)] + ([(p.P.M, r.P.M), (p.R.Mt, r.R.Mt)]
                                if p.P is not None else [])
        for got, want in parts:
            assert type(got) is DenseWindowMatrix and got.dtype == BF
            assert type(want).__name__ == "DenseWindowMatrix"
            assert (got.shape, got.win) == (tuple(want.shape), want.win)
    assert np.array_equal(_f32(pl[0].A.blocks), _f32(rl[0].A.blocks))
