"""Launch geometry of the windowed-ELL kernels (csrc/well_block.cu), the
dense-window kernel (csrc/densewin.cu), the fused legs' tiles
(csrc/vcycle.cu), the DIA dot kernels (csrc/dia.cu), the gather kernel
(csrc/gather.cu) and the Krylov tails' order (csrc/vec.cu), on the CPU.

Each wrapper computes its grid in one small function
(``well_kernels.launch_geometry``, ``densewin_kernels.launch_geometry``).
Over every operator of small U1, U2 and D2 hierarchies (the paths'
calls at a few thousand rows) and over the extreme shapes (K = 4 and
K = 100, the widest windows the 10 MiB rule admits in float32 and
float64), the grid must cover ``n_out``, ``partials`` must hold one
entry per block and per dot, the lanes must be a power of two that
divides a block, and the dense window's chunk must be a multiple of 128
columns whose two buffers fit the 232,448 bytes of shared memory a
block can have. The block kernels' sub-warps cover every node at K 4-48
and b 2-4. The up leg's tile (``vcycle_kernels.up_tile``) is checked
by brute force: for every tile of the main path's L0 and L1, of S1's
framed slabs and of random offset sets on odd and small grids, every row
that the first design's up_kernel read (each tile row's A neighbours
inside the frame) must lie in the staged box at the slot the kernel
reads; a halo one row or plane short must leave one out. The down leg's
tile (``vcycle_kernels.down_tile``) likewise: each tile row's Mᵀ
neighbours in box R, the A neighbours of each row of R that a block forms
in box U, the rows a block of a cluster fetches from the block that
formed them, and each coarse cell's children in its tile, on the main
path's levels, S1's slabs with frames whose edges cut a grid row, and
random offsets on odd grids. The DIA dot kernels' groups
(``dia_kernels.launch_geometry``) by brute force over random offset
sets, square and rectangular, at group edges: one partial per 256 rows,
every interior group's terms in range, and no group more could be
interior; and their summation order (``dia_kernels.ordered_dot``)
against ``torch.dot``. The gather kernel's grid
(``gather_kernels.launch_geometry``) by brute force: every row's every
4-slot vector taken by exactly one lane, a row's lanes in one warp, and
the refusals; the tails' order (``fused_vec.ordered_tail_dots``) spelled
out, against ``torch.dot``, and refused where a thread chains elements.
The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from amgcl_tpu_torch import AMG, AMGParams, fe_like_problem
from amgcl_tpu_torch.ops import densewin_kernels as dwk
from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.ops import gather_kernels as gk
from amgcl_tpu_torch.ops import vcycle_kernels as vk
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


@pytest.mark.parametrize("n_out", [1, 31, 33, 1049, 13310, 110591])
@pytest.mark.parametrize("b", [2, 3, 4])
@pytest.mark.parametrize("K", [4, 8, 12, 16, 24, 32, 48])
def test_well_block_geometry_is_a_sub_warp_per_node(K, b, n_out):
    """The block kernels (b = 2-4) load a node with 4 lanes up to K = 8
    and 8 above, whatever b; the grid covers every node with no idle
    block, at node counts that are no multiple of a block's nodes, and
    the dots' partials stay one per 256 nodes."""
    geo = wk.launch_geometry(n_out, K, block=True, ndots=3)
    assert geo.lanes == (4 if K <= wk.BLOCK_LANES_K else 8)
    assert geo.lanes >= b and 32 % geo.lanes == 0
    assert geo.rows_per_block == _BLOCK // geo.lanes
    assert geo.nblocks * geo.rows_per_block >= n_out
    assert (geo.nblocks - 1) * geo.rows_per_block < n_out
    assert geo.partials == -(-n_out // _BLOCK) * 3


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


# -- the fused up leg's tiles (csrc/vcycle.cu, up_kernel) ---------------------

#: up_tile's plan at the main path's L0 and L1: (tz, ty, U rows and T
#: rows a tile row)
PLANS = {128: (8, 16, 1.40625, 1.875), 64: (4, 8, 3.0, 6.0)}

def _box_faults(dims, offsets, rows, inner, halo, h, L):
    """Reads from the rows ``rows`` (flat tile-relative rows with their
    box's inner origin ``inner`` = (plane, row) and extent (nz, ny)) that
    miss a box of that inner region with ``halo``, in a frame of ``L``
    rows where tile row i is frame row ``h`` + i: for every row inside
    the frame and every offset whose neighbour lies inside the frame, the
    slot the kernel reads (the row's slot plus the offset's nearest split)
    must lie in the box and hold that neighbour's frame row, wrapped rows
    included."""
    f2, f1, f0 = dims
    s = f1 * f0
    (rz, ry, x), (oz, oy), (nz, ny) = rows, inner[:2], inner[2:]
    z_lo, z_hi, y_lo, y_hi = halo
    BY, BZ = ny + y_lo + y_hi, nz + z_lo + z_hi
    nbox = BZ * BY * f0
    bz0, by0 = oz - z_lo, oy - y_lo
    b = ((rz - bz0) * BY + ry - by0) * f0 + x
    j = h + rz * s + ry * f0 + x                # the frame row
    live = (j >= 0) & (j < L)
    faults = 0
    for o in offsets:
        q = j + o
        read = live & (q >= 0) & (q < L)
        dz, dy, dx = vk.split_nearest(o, s, f0)
        e = b + (dz * BY + dy) * f0 + dx
        inside = (e >= 0) & (e < nbox)
        e = np.clip(e, 0, nbox - 1)
        r = e // f0
        held = h + ((bz0 + r // BY) * f1 + by0 + r % BY) * f0 + e % f0
        faults += int((read & ~(inside & (held == q))).sum())
    return faults


def _tile_rows(dims, tz, ty, z_from, z_to, y_from, y_to, clip,
               origins=None):
    """The rows (z, y, x) from plane z_from to z_to and row y_from to
    y_to of every tile of tz planes × ty rows (or of the tiles at
    ``origins``), relative to each tile's origin (oz, oy), a tile a row
    of the arrays; with ``clip`` the rows inside the grid only. Returns
    (z, y, x), (oz, oy)."""
    f2, f1, f0 = dims
    if origins is None:
        origins = np.meshgrid(np.arange(0, f2, tz), np.arange(0, f1, ty),
                              indexing="ij")
    tz0, ty0 = (np.asarray(o).reshape(-1, 1) for o in origins)
    z, y, x = np.meshgrid(np.arange(z_from, z_to), np.arange(y_from, y_to),
                          np.arange(f0), indexing="ij")
    z, y, x = tz0 + z.ravel(), ty0 + y.ravel(), x.ravel() + 0 * tz0
    oz, oy = tz0 + 0 * z, ty0 + 0 * y
    if clip:
        keep = (z < f2) & (y < f1)
        return (z[keep], y[keep], x[keep]), (oz[keep], oy[keep])
    return (z, y, x), (oz, oy)


def _up_faults(dims, a_offsets, m_offsets, tile, zoff=0, fz=None):
    """Rows that the first design's up_kernel read and the tiled kernel
    does not find where it looks, over every tile at once: the A
    neighbours of each tile row inside the frame (where the first design
    recomputed u') in box U, and the M neighbours of each of U's rows
    inside the frame (where it read T uc) in box T."""
    f2, f1, f0 = dims
    fz = f2 if fz is None else fz
    h, L = zoff * f1 * f0, fz * f1 * f0
    hz_lo, hz_hi, hy_lo, hy_hi = tile.halo
    rows, (oz, oy) = _tile_rows(dims, tile.tz, tile.ty, 0, tile.tz, 0,
                                tile.ty, True)
    faults = _box_faults(dims, a_offsets, rows,
                         (oz, oy, tile.tz, tile.ty), tile.halo, h, L)
    # every row of U, rows past f1 running into the next plane
    rows, (oz, oy) = _tile_rows(dims, tile.tz, tile.ty, -hz_lo,
                                tile.tz + hz_hi, -hy_lo, tile.ty + hy_hi,
                                False)
    faults += _box_faults(dims, m_offsets, rows,
                          (oz - hz_lo, oy - hy_lo,
                           tile.tz + hz_lo + hz_hi, tile.ty + hy_lo + hy_hi),
                          tile.mhalo, h, L)
    return faults


def _stencil(dims, reach):
    """The flat offsets of every (dz, dy, dx) step with |step| <= reach
    on each axis that a 27-point (reach 1) or wider stencil has."""
    _, f1, f0 = dims
    r = range(-reach, reach + 1)
    return sorted({(dz * f1 + dy) * f0 + dx for dz in r for dy in r
                   for dx in r})


def _plane_offsets(dims):
    _, f1, f0 = dims
    return [-f1 * f0, -f0, -1, 0, 1, f0, f1 * f0]


@pytest.fixture(scope="module")
def l1_steps():
    """L0's and L1's A offsets of a port device build of poisson3d(32)
    on the CPU, as (dz, dy, dx) steps, so that they can be laid on any
    grid: 7 and 33 diagonals."""
    from amgcl_tpu_torch import CG, make_solver, poisson3d
    A, _ = poisson3d(32)
    solve = make_solver(A, AMGParams(), CG(tol=1e-6), device="cpu",
                        device_setup=True)
    steps = []
    for lv in solve.precond.hierarchy.levels[:2]:
        _, f1, f0 = lv.P.T.fine
        steps.append([vk.split_nearest(o, f1 * f0, f0)
                      for o in lv.A.offsets])
        assert lv.A.offsets == lv.P.M.offsets
    assert [len(st) for st in steps] == [7, 33]
    return steps


def _lay(steps, dims):
    _, f1, f0 = dims
    return sorted((dz * f1 + dy) * f0 + dx for dz, dy, dx in steps)


def _check_tile(dims, a_offsets, m_offsets, zoff=0, fz=None):
    tile = vk.up_tile(a_offsets, m_offsets, dims)
    assert tile is not None and tile.smem <= vk.MAX_BOX_BYTES
    assert tile.smem == vk.up_box(tile.tz, tile.ty, tile.halo, tile.mhalo,
                                  dims[2])
    assert tile.halo == vk.up_halo(a_offsets, dims)
    assert tile.mhalo == vk.up_halo(m_offsets, dims)
    assert tile.nblocks == -(-dims[0] // tile.tz) * -(-dims[1] // tile.ty)
    assert _up_faults(dims, a_offsets, m_offsets, tile, zoff, fz) == 0
    return tile


def _short(tile):
    """The tile with each nonzero side of its A halo, then of its M halo,
    one short, in turn."""
    for field in ("halo", "mhalo"):
        for k, h in enumerate(getattr(tile, field)):
            if h:
                halo = list(getattr(tile, field))
                halo[k] -= 1
                yield tile._replace(**{field: tuple(halo)})


@pytest.mark.parametrize("level,dims", [
    (0, (128, 128, 128)), (1, (64, 64, 64)), (0, (32, 32, 32)),
    (1, (16, 16, 16))])
def test_up_tile_holds_the_main_path_reads(l1_steps, level, dims):
    """The main path's L0 and L1 (128³ and 64³; the build's own 32³ and
    16³): every tile row's A neighbours lie in the box, including the
    rows an x step wraps into the previous or next grid row and plane."""
    offsets = _lay(l1_steps[level], dims)
    tile = _check_tile(dims, offsets, offsets)
    assert tile.halo == tile.mhalo == ((1, 1, 1, 1) if level == 0
                                       else (2, 2, 2, 2))


@pytest.mark.parametrize("level,dims,hp", [
    (0, (32, 128, 128), 1), (1, (16, 64, 64), 2), (0, (8, 32, 32), 1),
    (1, (4, 16, 16), 2)])
def test_up_tile_holds_the_framed_slab_reads(l1_steps, level, dims, hp):
    """S1's framed slabs (and those of poisson3d(32) on four shards):
    tile plane z is frame plane z + 2·hp of a frame of lz + 4·hp planes,
    so the box's halo planes come from the frame."""
    offsets = _lay(l1_steps[level], dims)
    assert hp == vk._reach(offsets) * 2 // (2 * dims[1] * dims[2])
    _check_tile(dims, offsets, offsets, zoff=2 * hp, fz=dims[0] + 4 * hp)


_RANDOM_GRIDS = [(2, 2, 2), (4, 3, 5), (6, 7, 8), (8, 5, 3), (2, 9, 1),
                 (10, 4, 7), (4, 33, 6), (34, 3, 2)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dims", _RANDOM_GRIDS)
def test_up_tile_holds_random_reads(dims, seed):
    """Random offset sets, one-sided ones included, of up to two planes'
    reach on odd and small grids (f0 <= 8), base and framed, and every
    tile shape up to 4 × 4 beside up_tile's own, ragged ones included."""
    rng = np.random.RandomState(seed * 131 + sum(dims))
    f2, f1, f0 = dims
    s = f1 * f0
    reach = min(2 * s, f2 * s - 1)

    def offsets():
        o = sorted(set(rng.randint(-reach, reach + 1, 9).tolist()) | {0})
        return [v for v in o if v >= 0] if seed % 2 else o
    oa, om = offsets(), offsets()
    tile = _check_tile(dims, oa, om)
    hp = -(-(vk._reach(oa) + vk._reach(om)) // (2 * s))
    for zoff, fz in ((0, None), (2 * hp, f2 + 4 * hp)):
        for tz in range(1, 5):
            for ty in range(1, 5):
                forced = tile._replace(tz=tz, ty=ty)
                assert _up_faults(dims, oa, om, forced, zoff, fz) == 0


@pytest.mark.parametrize("case", ["L0", "L1", "S1 L1", "random"])
def test_up_tile_short_halo_misses_a_read(l1_steps, case):
    """The mutant: a halo one row or plane short on any side, of either
    box, leaves a read outside the box (or at a slot holding another
    row); on poisson3d(32)'s own L0 and L1, S1's L1 slab and a random
    set."""
    if case == "random":
        dims, oa = (6, 7, 8), [-75, -9, -1, 0, 2, 57, 110]
        om = [-66, -8, 0, 1, 63]
        zoff, fz = 0, None
    else:
        dims = {"L0": (32, 32, 32), "L1": (16, 16, 16),
                "S1 L1": (16, 64, 64)}[case]
        oa = om = _lay(l1_steps[case != "L0"], dims)
        zoff, fz = (4, 24) if case == "S1 L1" else (0, None)
    tile = _check_tile(dims, oa, om, zoff, fz)
    mutants = list(_short(tile))
    assert len(mutants) == sum(1 for h in tile.halo + tile.mhalo if h) >= 4
    for m in mutants:
        assert _up_faults(dims, oa, om, m, zoff, fz) > 0, (m.halo, m.mhalo)


@pytest.mark.parametrize("f0,fits", [(1024, True), (1648, True),
                                     (1649, False), (8192, False)])
def test_up_tile_refuses_a_box_past_shared_memory(f0, fits):
    """One grid row of a 7-point level stages 3 × 3 rows of u' and 5 × 5
    of T uc, 34 × f0 × 4 bytes: up to f0 = 1,648 they fit a block's
    shared memory beside its offsets, past it there is no tile (and the
    up leg is not built for such a level)."""
    dims = (4, 4, f0)
    offsets = _plane_offsets(dims)
    tile = vk.up_tile(offsets, offsets, dims)
    assert (tile is not None) == fits
    assert fits or 34 * f0 * 4 > vk.MAX_BOX_BYTES


def test_up_tile_main_path_plan():
    """The tiles the main path's L0 and L1 get, with the rows their boxes
    stage per tile row (U, T)."""
    plans = {}
    for dims, reach in (((128, 128, 128), None), ((64, 64, 64), 1)):
        offsets = _plane_offsets(dims) if reach is None else sorted(
            set(_stencil(dims, reach)) | {2, -2, 2 * dims[2],
                                          -2 * dims[2],
                                          2 * dims[1] * dims[2],
                                          -2 * dims[1] * dims[2]})
        tile = vk.up_tile(offsets, offsets, dims)
        rows = tile.tz * tile.ty
        plans[dims[0]] = (tile.tz, tile.ty) + tuple(
            r / rows for r in vk.up_boxes(tile.tz, tile.ty, tile.halo,
                                          tile.mhalo))
    assert plans == PLANS


# -- the fused down leg's tiles (csrc/vcycle.cu, down_kernel) -----------------

#: down_tile's plan at the main path's L0 and L1: (tz, ty, cluster, R
#: rows and U rows a tile row)
DOWN_PLANS = {128: (8, 16, (1, 1), 1.40625, 1.875),
              64: (4, 8, (2, 1), 3.0, 5.0)}


def _blocks(dims, tile):
    """Every block the down leg launches: its tile's origin (z0, y0) and
    its place (iz, iy) in its cluster of cz × cy tiles."""
    f2, f1, _ = dims
    cz, cy = tile.cz, tile.cy
    sz, sy, iz, iy = np.meshgrid(np.arange(-(-f2 // (cz * tile.tz))),
                                 np.arange(-(-f1 // (cy * tile.ty))),
                                 np.arange(cz), np.arange(cy), indexing="ij")
    return ((sz * cz + iz).ravel() * tile.tz, (sy * cy + iy).ravel()
            * tile.ty, iz.ravel(), iy.ravel())


def _owned(tile, iz, iy):
    """The rows [oz0, oz1) × [oy0, oy1) of box R that block (iz, iy) of
    its cluster forms, as down_kernel takes them."""
    z_lo, z_hi, y_lo, y_hi = tile.halo
    return (np.where(iz == 0, 0, z_lo),
            np.where(iz == tile.cz - 1, tile.tz + z_lo + z_hi,
                     z_lo + tile.tz),
            np.where(iy == 0, 0, y_lo),
            np.where(iy == tile.cy - 1, tile.ty + y_lo + y_hi,
                     y_lo + tile.ty))


def _copy_faults(dims, tile):
    """Rows of a block's box R that it does not form and that the copy
    from its cluster fetches wrongly: the owner down_kernel computes must
    form that row (of the same grid, at the box slot read)."""
    _, f1, _ = dims
    z_lo, z_hi, y_lo, y_hi = tile.halo
    z0, y0, iz, iy = _blocks(dims, tile)
    bz, by = np.meshgrid(np.arange(tile.tz + z_lo + z_hi),
                         np.arange(tile.ty + y_lo + y_hi), indexing="ij")
    bz, by = bz.ravel(), by.ravel()
    faults = 0
    for b in range(len(z0)):
        oz0, oz1, oy0, oy1 = _owned(tile, iz[b], iy[b])
        foreign = ~((bz >= oz0) & (bz < oz1) & (by >= oy0) & (by < oy1))
        Z = bz - z_lo + iz[b] * tile.tz
        Y = by - y_lo + iy[b] * tile.ty
        jz = np.clip(Z // tile.tz, 0, tile.cz - 1)
        jy = np.clip(Y // tile.ty, 0, tile.cy - 1)
        pz, py = Z - jz * tile.tz + z_lo, Y - jy * tile.ty + y_lo
        qz0, qz1, qy0, qy1 = _owned(tile, jz, jy)
        formed = (pz >= qz0) & (pz < qz1) & (py >= qy0) & (py < qy1)
        row = (z0[b] - z_lo + bz) * f1 + y0[b] - y_lo + by
        there = ((z0[b] + (jz - iz[b]) * tile.tz - z_lo + pz) * f1
                 + y0[b] + (jy - iy[b]) * tile.ty - y_lo + py)
        faults += int((foreign & ~(formed & (row == there))).sum())
    return faults


def _down_faults(dims, a_offsets, mt_offsets, tile, H=0, L=None):
    """Rows that the first design's down_kernel read and the tiled kernel
    does not find where it looks, over every block at once, in a frame of
    L rows where tile row i is frame row H + i: the Mᵀ neighbours of each
    tile row inside the frame (where the first design recomputed r) in
    box R; the A neighbours of each row of R that a block forms, inside
    the frame (where the first design read u), in box U; and in a
    cluster, the rows of box R that the copy fetches."""
    f2, f1, f0 = dims
    L = f2 * f1 * f0 if L is None else L
    z_lo, y_lo = tile.halo[0], tile.halo[2]
    z0, y0, iz, iy = _blocks(dims, tile)
    rows, (oz, oy) = _tile_rows(dims, tile.tz, tile.ty, 0, tile.tz, 0,
                                tile.ty, True, (z0, y0))
    faults = _box_faults(dims, mt_offsets, rows,
                         (oz, oy, tile.tz, tile.ty), tile.halo, H, L)
    for pz in range(tile.cz):
        for py in range(tile.cy):
            # the rows of R that the blocks at (pz, py) form, rows past f1
            # running into the next plane
            at = (iz == pz) & (iy == py)
            oz0, oz1, oy0, oy1 = (int(v) for v in _owned(tile, pz, py))
            rows, (oz, oy) = _tile_rows(
                dims, tile.tz, tile.ty, oz0 - z_lo, oz1 - z_lo, oy0 - y_lo,
                oy1 - y_lo, False, (z0[at], y0[at]))
            faults += _box_faults(dims, a_offsets, rows,
                                  (oz + oz0 - z_lo, oy + oy0 - y_lo,
                                   oz1 - oz0, oy1 - oy0), tile.ahalo, H, L)
    return faults + _copy_faults(dims, tile)


def _cell_faults(dims, tz, ty):
    """Coarse cells that the tiles' cell sums miss or take twice, and
    children that lie outside the tile of their cell's sum: the kernel
    sums the cells (z0/2 + [0, tz/2)) × (y0/2 + [0, ty/2)) × all c0 of
    the tile at (z0, y0) that lie in the coarse grid."""
    f2, f1, f0 = dims
    c2, c1, _ = vk.coarse_dims(dims)
    taken = np.zeros((c2, c1), int)
    faults = 0
    for z0 in range(0, f2, tz):
        for y0 in range(0, f1, ty):
            for cz in range(z0 // 2, min(c2, z0 // 2 + tz // 2)):
                for cy in range(y0 // 2, min(c1, y0 // 2 + ty // 2)):
                    taken[cz, cy] += 1
                    for z in (2 * cz, 2 * cz + 1):
                        for y in (2 * cy, 2 * cy + 1):
                            if z < f2 and y < f1:
                                faults += not (z0 <= z < z0 + tz
                                               and y0 <= y < y0 + ty)
    return faults + int((taken != 1).sum())


def _check_down(dims, a_offsets, mt_offsets, H=0, L=None):
    tile = vk.down_tile(a_offsets, mt_offsets, dims)
    assert tile is not None and tile.smem <= vk.MAX_BOX_BYTES
    assert tile.tz % 2 == 0 and tile.ty % 2 == 0
    assert tile.smem == vk.down_box(tile.tz, tile.ty, tile.halo,
                                    tile.ahalo, dims[2], tile.cz, tile.cy)
    assert (tile.halo, tile.ahalo) == vk.down_halo(a_offsets, mt_offsets,
                                                   dims)
    assert tile.cz * tile.cy <= 2
    assert tile.nblocks == len(_blocks(dims, tile)[0])
    assert _down_faults(dims, a_offsets, mt_offsets, tile, H, L) == 0
    assert _cell_faults(dims, tile.tz, tile.ty) == 0
    return tile


def _short_down(tile):
    """The tile with each nonzero side of its R halo, then of its U halo,
    one short, in turn."""
    for field in ("halo", "ahalo"):
        for k, h in enumerate(getattr(tile, field)):
            if h:
                halo = list(getattr(tile, field))
                halo[k] -= 1
                yield tile._replace(**{field: tuple(halo)})


@pytest.mark.parametrize("level,dims", [
    (0, (128, 128, 128)), (1, (64, 64, 64)), (0, (32, 32, 32)),
    (1, (16, 16, 16))])
def test_down_tile_holds_the_main_path_reads(l1_steps, level, dims):
    """The main path's L0 and L1 (128³ and 64³; the build's own 32³ and
    16³): every tile row's Mᵀ neighbours lie in box R and every R row's
    A neighbours in box U, including the rows an x step wraps into the
    previous or next grid row and plane; every cell's children lie in
    its tile."""
    offsets = _lay(l1_steps[level], dims)
    tile = _check_down(dims, offsets, offsets)
    assert tile.halo == tile.ahalo == ((1, 1, 1, 1) if level == 0
                                       else (2, 2, 2, 2))
    for cz, cy in ((1, 1), (2, 2)):
        pair = tile._replace(cz=cz, cy=cy, tz=4, ty=8)
        assert _down_faults(dims, offsets, offsets, pair) == 0


@pytest.mark.parametrize("extra", [0, 37])
@pytest.mark.parametrize("level,dims", [
    (0, (32, 128, 128)), (1, (16, 64, 64)), (0, (8, 32, 32)),
    (1, (4, 16, 16))])
def test_down_tile_holds_the_framed_slab_reads(l1_steps, level, dims, extra):
    """S1's framed slabs (and those of poisson3d(32) on four shards):
    tile row i is frame row H + i of L = n + 2H, H = reach(A) + reach(Mᵀ)
    (whole planes on S1) and, with ``extra``, 37 rows more, so that the
    frame's edges cut a grid row and the box's rows past the slab come
    from the frame point by point."""
    offsets = _lay(l1_steps[level], dims)
    n = int(np.prod(dims))
    H = 2 * vk._reach(offsets) + extra
    assert extra or H == (2 if level == 0 else 4) * dims[1] * dims[2]
    _check_down(dims, offsets, offsets, H, n + 2 * H)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dims", _RANDOM_GRIDS + [(3, 5, 7), (5, 3, 1)])
def test_down_tile_holds_random_reads(dims, seed):
    """Random offset sets, one-sided ones included, of up to two planes'
    reach on odd and small grids (f0 <= 8), base and framed (H a random
    count of rows at or above the reach), alone and in clusters of 2 to 8
    tiles, and every even tile shape up to 4 × 4
    beside down_tile's own."""
    rng = np.random.RandomState(seed * 137 + sum(dims))
    f2, f1, f0 = dims
    s = f1 * f0
    n = f2 * s
    reach = min(2 * s, n - 1)

    def offsets():
        o = sorted(set(rng.randint(-reach, reach + 1, 9).tolist()) | {0})
        return [v for v in o if v >= 0] if seed % 2 else o
    oa, om = offsets(), offsets()
    tile = _check_down(dims, oa, om)
    H = vk._reach(oa) + vk._reach(om) + int(rng.randint(0, 2 * f0 + 1))
    for h, L in ((0, None), (H, n + 2 * H)):
        for cz, cy in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2)):
            for tz in (2, 4):
                for ty in (2, 4):
                    forced = tile._replace(tz=tz, ty=ty, cz=cz, cy=cy)
                    assert _down_faults(dims, oa, om, forced, h, L) == 0
                    assert _cell_faults(dims, tz, ty) == 0


@pytest.mark.parametrize("case", ["L0", "L1", "S1 L1", "random"])
def test_down_tile_short_halo_misses_a_read(l1_steps, case):
    """The mutant: a halo one row or plane short on any side, of box R or
    box U, leaves a read outside the box (or at a slot holding another
    row), alone and in clusters of 2 × 2 tiles; on poisson3d(32)'s own L0
    and L1, S1's L1 slab with a frame whose edges cut a grid row, and a
    random set."""
    H, L = 0, None
    if case == "random":
        dims, oa = (6, 7, 8), [-75, -9, -1, 0, 2, 57, 110]
        om = [-66, -8, 0, 1, 63]
    else:
        dims = {"L0": (32, 32, 32), "L1": (16, 16, 16),
                "S1 L1": (16, 64, 64)}[case]
        oa = om = _lay(l1_steps[case != "L0"], dims)
        if case == "S1 L1":
            H = 2 * vk._reach(oa) + 37
            L = int(np.prod(dims)) + 2 * H
    tile = _check_down(dims, oa, om, H, L)
    for cz, cy in ((1, 1), (2, 2)):
        tile = tile._replace(cz=cz, cy=cy)
        mutants = list(_short_down(tile))
        assert len(mutants) == sum(1 for h in tile.halo + tile.ahalo
                                   if h) >= 4
        for m in mutants:
            assert _down_faults(dims, oa, om, m, H, L) > 0, \
                (m.halo, m.ahalo, cz, cy)


@pytest.mark.parametrize("f0,fits", [(1024, True), (1218, True),
                                     (1219, False), (8192, False)])
def test_down_tile_refuses_a_box_past_shared_memory(f0, fits):
    """A tile of 2 × 2 rows of a 7-point level in a pair of tiles stages
    4 × 4 rows of r and, around the 3 × 4 it forms, 5 × 6 of u: 46 × f0 ×
    4 bytes, up to f0 = 1,218 beside a block's offsets (alone, 52 rows, up
    to 1,078); past that there is no tile (and the down leg is not built
    for such a level)."""
    dims = (4, 4, f0)
    offsets = _plane_offsets(dims)
    tile = vk.down_tile(offsets, offsets, dims)
    assert (tile is not None) == fits
    if fits:
        assert (tile.tz, tile.ty, tile.cz * tile.cy) == (2, 2, 2)
        assert tile.smem <= vk.MAX_BOX_BYTES
    assert 46 * 1218 * 4 <= vk.MAX_BOX_BYTES < 46 * 1219 * 4


def test_down_tile_main_path_plan():
    """The tiles the main path's L0 and L1 get, with the rows their boxes
    stage per tile row (R, U): L0's tiles alone, L1's in pairs."""
    plans = {}
    for dims, reach in (((128, 128, 128), None), ((64, 64, 64), 1)):
        offsets = _plane_offsets(dims) if reach is None else sorted(
            set(_stencil(dims, reach)) | {2, -2, 2 * dims[2],
                                          -2 * dims[2],
                                          2 * dims[1] * dims[2],
                                          -2 * dims[1] * dims[2]})
        tile = vk.down_tile(offsets, offsets, dims)
        rows = tile.tz * tile.ty
        plans[dims[0]] = (tile.tz, tile.ty, (tile.cz, tile.cy)) + tuple(
            r / rows for r in vk.down_boxes(tile.tz, tile.ty, tile.halo,
                                            tile.ahalo, tile.cz, tile.cy))
    assert plans == DOWN_PLANS


# -- the DIA dot kernels (csrc/dia.cu dots_kernel) -----------------------------

def _dots_faults(n, m, offsets, geo):
    """Faults of a dot-kernel geometry, by brute force: a group count
    other than one per GROUP rows, and each interior group with a row
    past n or a row and diagonal whose column lies outside [0, m)."""
    R = dk.GROUP
    faults = []
    if geo.groups * R < n or (geo.groups - 1) * R >= n:
        faults.append(("groups", geo.groups))
    if geo.lo < 0 or geo.hi > geo.groups:
        faults.append(("range", geo.lo, geo.hi))
    offs = np.asarray(offsets, dtype=np.int64)
    for b in range(geo.lo, geo.hi):
        rows = np.arange(b * R, (b + 1) * R)
        faults += [("row", b, int(r)) for r in rows[rows >= n][:1]]
        cols = rows[:, None] + offs[None, :]
        bad = (cols < 0) | (cols >= m)
        faults += [("term", b, int(r), int(o))
                   for r, o in zip(*np.nonzero(bad))][:1]
    return faults


def _dots_cases():
    rng = np.random.RandomState(12)
    edges = (1, 255, 256, 257, 511, 512, 513, 2048, 6145, 10000, 20482)
    cases = []
    for n in edges:
        for rect in (0, 1, -1):
            m = max(1, n + rect * int(rng.randint(1, 3000)))
            k = int(rng.randint(0, 12))
            offs = sorted(set(int(o) for o in rng.randint(-2500, 2500, k)))
            cases.append((n, m, tuple(offs)))
    cases += [(2097152, 2097152, (-16384, -128, -1, 0, 1, 128, 16384)),
              (262144, 262144, (-4096, -64, -1, 0, 1, 64, 4096)),
              (8192, 8192, (0,)), (8192, 8192, ()), (4098, 4098, (-1, 1)),
              (1000, 1000, (-37, -1, 0, 2, 40))]
    return cases


@pytest.mark.parametrize("n,m,offsets", _dots_cases())
def test_dia_dots_geometry_by_brute_force(n, m, offsets):
    """The groups cover n, one per 256 rows (a partial each), every
    interior group's terms lie in range, and the range is as wide as it
    may be: one group more on either side (where there is one) is
    caught."""
    geo = dk.launch_geometry(n, m, offsets)
    assert _dots_faults(n, m, offsets, geo) == []
    wider = []
    if geo.lo > 0:
        wider.append(geo._replace(lo=geo.lo - 1))
    if geo.hi < geo.groups:
        wider.append(geo._replace(hi=geo.hi + 1))
    for w in wider:
        assert _dots_faults(n, m, offsets, w), w


def test_dia_dots_geometry_main_path():
    """The main path's L0: 8,192 groups of 256 rows (a partial a dot
    each), all but the 64 at each end (the ±16,384 reach) interior."""
    geo = dk.launch_geometry(2097152, 2097152,
                             (-16384, -128, -1, 0, 1, 128, 16384))
    assert geo == dk.Geometry(8192, 64, 8128)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 70000, 300000])
def test_ordered_dot_agrees_with_torch_dot(n, dtype):
    """The dot kernels' order (ops/dia_kernels.ordered_dot) is a dot
    product: within the card tests' dot tolerance of torch.dot."""
    from tests.test_torch_cuda import _dot_close
    rng = np.random.RandomState(n)
    a, b = (rng.standard_normal(n).astype(dtype) for _ in range(2))
    got = dk.ordered_dot(a, b)
    assert got.dtype == dtype
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    _dot_close(torch.tensor(got), torch.dot(ta, tb), ta, tb,
               torch.float32 if dtype == np.float32 else torch.float64)


def test_ordered_dot_sums_in_its_stated_order():
    """Spelled out on 3 × 256 groups: each group's pairwise tree, then
    lane t of 256 adds partials t, t+256, … to 0 — a reversed sum or a
    plain left-to-right sum of the same products gives other bits."""
    rng = np.random.RandomState(3)
    n = 256 * 600 + 17
    a = (rng.standard_normal(n) * 10.0 ** rng.randint(-3, 4, n)).astype(
        np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    p = np.zeros(601 * 256, np.float32)
    p[:n] = a * b
    s = p.reshape(601, 256)
    for stride in (128, 64, 32, 16, 8, 4, 2, 1):
        s = s[:, :stride] + s[:, stride:2 * stride]
    part = s[:, 0]
    lanes = []
    for t in range(256):
        acc = np.float32(0)
        for c in range(t, 601, 256):
            acc = np.float32(acc + part[c])
        lanes.append(acc)
    s = np.asarray(lanes, np.float32).reshape(1, 256)
    for stride in (128, 64, 32, 16, 8, 4, 2, 1):
        s = s[:, :stride] + s[:, stride:2 * stride]
    want = s[0, 0]
    assert dk.ordered_dot(a, b).tobytes() == want.tobytes()
    assert dk.ordered_dot(a[::-1], b[::-1]).tobytes() != want.tobytes()
    assert np.float32(np.cumsum(a * b, dtype=np.float32)[-1]).tobytes() \
        != want.tobytes()


def test_c_ints_refuses_values_outside_int32():
    """The C entries take offsets as C ints: a value ctypes would wrap is
    refused, not passed on."""
    assert list(dk.c_ints((-16384, 0, 2 ** 31 - 1))) == [-16384, 0,
                                                         2 ** 31 - 1]
    for bad in ((2 ** 31,), (-2 ** 31 - 1, 0)):
        with pytest.raises(ValueError):
            dk.c_ints(bad)


# -- the gather kernel (csrc/gather.cu) ----------------------------------------

def _gather_cover(n_out, geo):
    """How many threads take each of n_out rows, by brute force over every
    thread of the grid: thread t of block b serves row b · threads + t."""
    row = np.arange(geo.nblocks * geo.threads)
    return np.bincount(row[row < n_out], minlength=n_out)


@pytest.mark.parametrize("K", gk.KS)
@pytest.mark.parametrize("n_out", [1, 31, 32, 33, 255, 256, 257, 1000,
                                   30000, 85623])
def test_gather_geometry_takes_every_row_once(n_out, K):
    """Each row taken by exactly one thread, blocks of whole warps up to
    the kernel's 256 threads, and no block wholly idle."""
    geo = gk.launch_geometry(n_out, K)
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 256
    assert (geo.nblocks - 1) * geo.threads < n_out \
        <= geo.nblocks * geo.threads
    assert np.all(_gather_cover(n_out, geo) == 1), geo


def test_gather_geometry_main_paths():
    """G1's and G1r's L0 (85,623 rows): 335 blocks of 256 rows, which at
    64 registers a thread (4 blocks an SM) are all in flight on the
    card's 132 SMs at once."""
    geo = gk.launch_geometry(85623, 16)
    assert geo == gk.Geometry(256, 335) and geo.nblocks <= 132 * 4


@pytest.mark.parametrize("K", [0, 2, 6, 20, 48])
def test_gather_geometry_refuses_other_k(K):
    with pytest.raises(ValueError, match="takes K"):
        gk.launch_geometry(1000, K)


# -- the Krylov tails' order (csrc/vec.cu) --------------------------------------

@pytest.mark.parametrize("n,blocks", [(1, 1), (256, 1), (257, 2),
                                      (85623, 335), (270336, 1056),
                                      (270337, 1056), (1 << 21, 1056)])
def test_tail_blocks(n, blocks):
    """One block per 256 elements up to the fixed grid of 1,056."""
    assert fv.tail_blocks(n) == blocks


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 85623, 270336])
def test_ordered_tail_dots_agree_with_torch_dot(n, dtype):
    """Both dots of the tails' order are dot products: within the card
    tests' dot tolerance of torch.dot."""
    from tests.test_torch_cuda import _dot_close
    rng = np.random.RandomState(n + 1)
    r, rh = (rng.standard_normal(n).astype(dtype) for _ in range(2))
    rr, hr = fv.ordered_tail_dots(r, rh)
    assert (rr.dtype, hr.dtype) == (dtype, dtype)
    assert fv.ordered_tail_dots(r) == (rr,)
    tr, th = torch.as_tensor(r), torch.as_tensor(rh)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    _dot_close(torch.tensor(rr), torch.dot(tr, tr), tr, tr, tdt)
    _dot_close(torch.tensor(hr), torch.dot(th, tr), th, tr, tdt)


def test_ordered_tail_dots_sum_in_their_stated_order():
    """Spelled out at the BiCGStab paths' n (335 blocks): a thread's
    product fma'd onto +0, each block's pairwise tree, lane t of 256
    adding partials t, t+256 to 0, the tree over the lanes — the order of
    block_reduce_store and reduce_partials. A left-to-right sum of the
    same products gives other bits."""
    rng = np.random.RandomState(4)
    n = 85623
    r = (rng.standard_normal(n) * 10.0 ** rng.randint(-3, 4, n)).astype(
        np.float32)
    rh = rng.standard_normal(n).astype(np.float32)
    blocks = fv.tail_blocks(n)

    def spelled(a):
        p = np.zeros(blocks * 256, np.float32)
        p[:n] = a * r + np.float32(0)
        s = p.reshape(blocks, 256)
        for stride in (128, 64, 32, 16, 8, 4, 2, 1):
            s = s[:, :stride] + s[:, stride:2 * stride]
        part = s[:, 0]
        lanes = []
        for t in range(256):
            acc = np.float32(0)
            for c in range(t, blocks, 256):
                acc = np.float32(acc + part[c])
            lanes.append(acc)
        s = np.asarray(lanes, np.float32).reshape(1, 256)
        for stride in (128, 64, 32, 16, 8, 4, 2, 1):
            s = s[:, :stride] + s[:, stride:2 * stride]
        return s[0, 0]
    want = (spelled(r), spelled(rh))
    got = fv.ordered_tail_dots(r, rh)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    assert np.float32(np.cumsum(r * r, dtype=np.float32)[-1]).tobytes() \
        != want[0].tobytes()


def test_ordered_tail_dots_refuse_a_chained_length():
    """Past 256 · 1,056 elements a thread chains several fmas, which numpy
    cannot round as the card does: refused."""
    fv.ordered_tail_dots(np.ones(256 * 1056, np.float32))
    with pytest.raises(ValueError, match="one a thread"):
        fv.ordered_tail_dots(np.ones(256 * 1056 + 1, np.float32))
