"""Launch geometry of the scalar windowed-ELL kernel (csrc/well_block.cu)
and the dense-window kernel (csrc/densewin.cu), on the CPU.

Each wrapper computes its grid in one small function
(``well_kernels.launch_geometry``, ``densewin_kernels.launch_geometry``).
Over every operator of small U1, U2 and D2 hierarchies (the paths'
calls at a few thousand rows) and over the extreme shapes (K = 4 and
K = 100, the widest windows the 10 MiB rule admits in float32 and
float64), the grid must cover ``n_out``, ``partials`` must hold one
entry per block and per dot, the lanes must be a power of two that
divides a block, and the dense window's chunk must be a multiple of 128
columns whose two buffers fit the 232,448 bytes of shared memory a
block can have. The kernels themselves run only on a card
(tests/test_torch_cuda.py).
"""

import pytest
import torch

from amgcl_tpu_torch import AMG, AMGParams, fe_like_problem
from amgcl_tpu_torch.ops import densewin_kernels as dwk
from amgcl_tpu_torch.ops import well_kernels as wk
from amgcl_tpu_torch.ops.densewin import DenseWindowMatrix
from amgcl_tpu_torch.ops.unstructured import WindowedEllMatrix
from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute

_BLOCK = 256
_MAX_SMEM = 232448


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One BLAS, OpenMP and torch thread while this module runs: the
    suite's parallel workers would oversubscribe the cores."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


def _operators(hier):
    """Every windowed-ELL and dense-window operator of a hierarchy: each
    level's A, P and R, and a smoothed transfer's M and Mᵀ."""
    found = []
    for lv in hier.levels:
        for op in (lv.A, lv.P, lv.R):
            for m in (op, getattr(op, "M", None), getattr(op, "Mt", None)):
                if isinstance(m, (WindowedEllMatrix, DenseWindowMatrix)):
                    found.append(m)
    return found


_PATHS = {
    # the paths' orders and formats at 4,000 rows
    "U1": ("identity", "auto"),
    "U2": ("rcm", "auto"),
    "D2": ("rcm", "dwin"),
}


def _hierarchy(path, dtype):
    order, fmt = _PATHS[path]
    A, _ = fe_like_problem(n=4000, nnz_target=4000 * 28, seed=3)
    if order == "rcm":
        A = permute(A, cuthill_mckee(A))
    return AMG(A, AMGParams(dtype=dtype, matrix_format=fmt,
                            coarse_enough=200), device="cpu").hierarchy


def _check_well(n_out, K, ndots):
    geo = wk.launch_geometry(n_out, K, ndots=ndots)
    lanes = geo.lanes
    assert lanes in (1, 2, 4) and _BLOCK % lanes == 0
    # one 4-slot vector a lane, up to 4 lanes
    assert lanes * 4 >= K or lanes == 4
    assert lanes == 1 or (lanes // 2) * 4 < K
    assert geo.rows_per_block == _BLOCK // lanes
    # the grid covers every row, and no block is wholly idle
    assert geo.nblocks * geo.rows_per_block >= n_out
    assert (geo.nblocks - 1) * geo.rows_per_block < max(n_out, 1)
    # the dots' partials: one per 256 rows and dot, as a thread per row
    assert geo.partials == -(-n_out // _BLOCK) * ndots
    return geo


def _check_dwin(n_out, n_tiles, win, itemsize):
    geo = dwk.launch_geometry(n_tiles, win, itemsize)
    assert geo.nblocks == n_tiles and geo.nblocks * 64 >= n_out
    assert geo.rows_per_warp * 8 == 64
    assert geo.chunk % 128 == 0 and geo.chunk > 0
    # a lane's 16-byte vectors keep their place from chunk to chunk
    assert (geo.chunk // (16 // itemsize)) % 32 == 0
    # the chunks cover the window, the last one at least partly used
    nchunks = -(-win // geo.chunk)
    assert (nchunks - 1) * geo.chunk < win <= nchunks * geo.chunk
    assert geo.smem == 2 * geo.chunk * itemsize <= _MAX_SMEM
    return geo


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path", ["U1", "U2"])
def test_well_geometry_covers_every_level(path, dtype):
    """Every windowed-ELL operator of U1's and U2's hierarchies, in the
    shapes the kernels receive (SPMV_DOTS on the square ones)."""
    ops = [m for m in _operators(_hierarchy(path, dtype))
           if isinstance(m, WindowedEllMatrix)]
    assert len(ops) >= 3
    for M in ops:
        n, m = M.shape
        n_tiles, tile, K = M.vals.shape[:3]
        assert K % 4 == 0 and (n_tiles - 1) * tile < n <= n_tiles * tile
        _check_well(n, K, 3 if n == m else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dwin_geometry_covers_every_level(dtype):
    """Every dense-window operator of D2's hierarchy (A, M and Mᵀ)."""
    ops = [m for m in _operators(_hierarchy("D2", dtype))
           if isinstance(m, DenseWindowMatrix)]
    assert len(ops) >= 3
    for D in ops:
        n_tiles, tile, win = D.blocks.shape
        assert tile == 64
        _check_dwin(D.shape[0], n_tiles, win, D.blocks.element_size())


@pytest.mark.parametrize("n_out", [1, 15, 16, 17, 255, 256, 257, 85623])
@pytest.mark.parametrize("K", [4, 8, 12, 16, 20, 32, 36, 48, 52, 64, 100])
def test_well_geometry_extremes(K, n_out):
    """K from 4 to 100 against row counts at and beside every multiple of
    a warp's and a block's rows."""
    geo = _check_well(n_out, K, 3)
    want = {4: 1, 8: 2}.get(K, 4)
    assert geo.lanes == want


def test_well_block_geometry_is_a_thread_per_node():
    """The block kernels (b = 2-4) keep a thread per node, whatever K."""
    for K in (4, 12, 48):
        geo = wk.launch_geometry(110592, K, block=True, ndots=3)
        assert geo.lanes == 1 and geo.nblocks == 432
        assert geo.partials == 432 * 3


def _widest(itemsize):
    """The widest window, a multiple of 1,024 columns, that the
    reference's rule ((2·64 + 4)·win·itemsize ≤ 10 MiB) admits."""
    win = (10 << 20) // ((2 * 64 + 4) * itemsize) // 1024 * 1024
    assert (2 * 64 + 4) * (win + 1024) * itemsize > 10 << 20
    return win


@pytest.mark.parametrize("win,itemsize", [
    (1024, 4), (1024, 8), (4, 4), (2, 8), (4100, 8), (4608, 4),
    (11264, 4), (11264, 8), ("widest", 4), ("widest", 8), (1 << 20, 4)])
def test_dwin_geometry_extremes(win, itemsize):
    """Narrow, ragged, D2's L0 and the widest admitted windows in both
    dtypes, and one far past the rule: the chunks stay at 8 KB a buffer,
    so the shared memory does not grow with the window."""
    if win == "widest":
        win = _widest(itemsize)
    geo = _check_dwin(1000, 16, win, itemsize)
    assert geo.smem <= 16384


def test_dwin_rule_admits_what_the_tests_use():
    """The widest windows of the card tests are the rule's: 19,456
    float32 and 9,216 float64 columns."""
    assert (_widest(4), _widest(8)) == (19456, 9216)


def test_a_grid_sized_by_threads_would_not_cover_the_rows():
    """At U2's L0 (85,623 rows, K 48) a row takes 4 lanes, so a block
    covers 64 rows: one block per 256 rows, the thread-per-row grid,
    would leave three rows of four unwritten. The dots' partials stay one
    per 256 rows."""
    geo = wk.launch_geometry(85623, 48, ndots=3)
    assert geo.lanes == 4 and geo.rows_per_block == 64
    assert geo.nblocks == 1338 and geo.partials == 3 * 335
    assert -(-85623 // _BLOCK) * geo.rows_per_block < 85623
