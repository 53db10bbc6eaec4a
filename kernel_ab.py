"""Time the windowed-ELL (scalar and block), dense-window, fused
down- and up-leg and DIA kernels of one checkout of amgcl_tpu_torch at
the shapes of their chip_smoke.py records, so that two checkouts can be
compared inside one run on one card.

    python3 kernel_ab.py TREE LABEL [--sweep] [--legs] [--dia] [--gather]
                         [--tail] [--solve]

imports ``amgcl_tpu_torch`` from the directory TREE (a checkout, or an
unpacked ``git archive`` of one), builds its kernels there, and prints
one line ``AB {json}``: the median device time in ms (chip_smoke.py's
``time_ms``: CUDA events, L2 flushed before each of 20 calls) of
``windowed_ell_spmv`` at U2's and U1's L0, ``windowed_ell_residual``,
``windowed_ell_scaled_correction`` and ``windowed_ell_spmv_dots`` (with
w) at U1's L0 (each with its output's digest, and digested again on U1's
L0 in float64), and ``dense_window_spmv``, ``dense_window_residual`` and
``dense_window_scaled_correction`` at D2's L0, with ``torch.bmm`` over
the gathered x windows beside them (each mode's output digested there in
float32 and on the same blocks in float64); every mode of the block windowed ELL
at B1's L0 A, L0 R and L1 A in float32 and L0 A in float64 (the
square-only modes where the operator is square), with torch's BSR
product (``chip_smoke.library_block``) beside SPMV and RESIDUAL; and
``fused_up_sweep`` at the main path's L0 and L1 and
``fused_up_sweep_framed`` at S1's interior L0 and L1 slabs, on DIA
operators of the levels' offsets; ``fused_down_sweep`` in zero-guess and
base mode at the main path's L0 and L1, and ``fused_down_sweep_framed``
(zero guess) at S1's interior L0 and L1 slabs beside the base mode on the
same slab. Each block, down-leg and up-leg case also prints ``digest``:
the sha1 of its output's bytes (dots included), its inputs from one
seeded numpy generator, so that equal digests on two checkouts show the
two kernels bit-identical. Run the two checkouts in turns (A, B, B, A)
in one command, each in its own process. With ``--sweep`` (a tree that
plans the down tile) it also times each down-leg case over a set of
tiles, alone and in clusters of tiles, and prints whether each one's
digest equals the planner's tile's; with ``--legs`` it times the fused
legs alone; with ``--solve`` it also times the two paths that run the
fused legs, the main path and S1, as chip_smoke.py builds them: the
median host-clock time of 7 warm solves, each synchronised, with the
iterations. With ``--dia`` it times, alone, every mode of the DIA
kernels (``dia_spmv``, ``dia_residual``, ``dia_scaled_correction``,
``dia_spmv_dots`` with and without w, ``dia_residual_dot``) with a
digest each (dots included) at the main path's L0 in float32 and
float64 and L1 in float32, at 70,000 rows of 8 diagonals and at a
ragged 1,000 rows of 5, on random operators of those offsets. With
``--gather`` it times ``gather_spmv`` with a digest each at G1's and
G1r's L0 and G1's float64 refinement operator (built as chip_smoke.py's
``check_gather`` builds them: the hierarchy's L0, ``to_device`` in
float64), beside B.8 (``windowed_ell_spmv``) and torch's CSR product on
the same operator, and on chip_smoke.py's random operators at K 4, 8 and
12 in both dtypes; with ``--sweep`` as well, on a tree whose gather has
``launch_geometry``, each case over blocks of 64, 128 and 256 rows, with
whether its digest equals the default's. Beside G1's, G1r's and the
float64 case it also reads, for attribution, ``torch.sum`` over as many
cold bytes as the operator's format (the floor of a cold read under this
timer). With
``--tail`` it times and digests (dots included) ``xr_update``,
``bicgstab_tail`` and ``axpby_dot`` in both dtypes at n = 85,623 (the
BiCGStab paths'), 2,097,152 (the main path's) and a ragged 1,000, and
one empty kernel launch (``torch.cuda._sleep(0)``), the floor under
them. ``--dia``, ``--gather`` and ``--tail`` run alone (without the
default cases), together if given together. Needs a CUDA card.
"""

import hashlib
import json
import sys
import time

import numpy as np
import torch

from chip_smoke import library_block, time_ms


def digest(out):
    """The sha1 of an output's bytes, a tuple's parts in turn."""
    h = hashlib.sha1()
    for t in out if isinstance(out, tuple) else (out,):
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def block_cases(out, rng):
    """Every block kernel mode at B1's operators, timed beside torch's
    BSR product, with its output's digest."""
    from amgcl_tpu_torch import AMG, AMGParams, poisson3d_block
    from amgcl_tpu_torch.ops import well_block_kernels as wbk
    A, _ = poisson3d_block(48, 3)
    # the host setup's levels (greedy aggregates): operators that any
    # checkout builds alike, so that digests compare kernels only
    L = AMG(A, AMGParams(), device="cuda",
            device_setup=False).hierarchy.levels
    a64 = L[0].A
    a64 = type(a64)(a64.window_starts, a64.cols_local, a64.vals.double(),
                    a64.shape, a64.win, a64.block)
    for label, M in (("L0 A", L[0].A), ("L0 R", L[0].R), ("L1 A", L[1].A),
                     ("L0 A f64", a64)):
        n, m = M.shape
        b, dt = M.block[0], M.dtype
        vec = lambda k: torch.as_tensor(rng.standard_normal(k)).to(
            device="cuda", dtype=dt)
        x, f, w = vec(m * b), vec(n * b), vec(n * b)
        S = vec(n * b * b).reshape(n, b, b)
        g = (M.window_starts, M.cols_local, M.vals)
        C, kind = library_block(M)
        key = "B1 %s" % label
        out[key + " format digest"] = digest((M.vals, M.cols_local))
        cases = [("spmv", lambda: wbk.windowed_ell_block_spmv(*g, x, n)),
                 ("residual",
                  lambda: wbk.windowed_ell_block_residual(*g, f, x, n))]
        if n == m:
            cases += [
                ("correction", lambda: wbk.windowed_ell_block_scaled_correction(
                    *g, S, f, x, n)),
                ("spmv_dots w", lambda: wbk.windowed_ell_block_spmv_dots(
                    *g, x, w, n))]
        for mode, fn in cases:
            out["%s %s digest" % (key, mode)] = digest(fn())
            out["%s %s" % (key, mode)] = time_ms(fn)
        out[key + " %s mv" % kind] = time_ms(lambda: torch.mv(C, x))
        out[key + " %s addmv" % kind] = time_ms(
            lambda: torch.addmv(f, C, x, alpha=-1.0))
        del C


def _stencil_offsets(dims, level):
    """A's (and M's) offsets at the main path's L0 (7-point) and L1 (the
    27-point steps and the two-step ones along each axis, 33)."""
    _, f1, f0 = dims
    s = f1 * f0
    if level == 0:
        return [-s, -f0, -1, 0, 1, f0, s]
    r = (-1, 0, 1)
    steps = {(dz * f1 + dy) * f0 + dx for dz in r for dy in r for dx in r}
    return sorted(steps | {2, -2, 2 * f0, -2 * f0, 2 * s, -2 * s})


def up_cases(out, rng, host_offsets):
    """fused_up_sweep at the main path's L0 and L1 and its framed mode
    on S1's interior L0 and L1 slabs (hp coarse planes of frame on each
    side), on random DIA operators of the levels' offsets."""
    from amgcl_tpu_torch.ops import vcycle_kernels as vk
    cuda = lambda a: torch.as_tensor(a).to(device="cuda",
                                          dtype=torch.float32)
    for label, dims, level, hp in (
            ("main L0", (128, 128, 128), 0, 0),
            ("main L1", (64, 64, 64), 1, 0),
            ("S1 L0 interior", (32, 128, 128), 0, 1),
            ("S1 L1 interior", (16, 64, 64), 1, 2)):
        offs = _stencil_offsets(dims, level)
        n = int(np.prod(dims))
        c2, c1, c0 = vk.coarse_dims(dims)
        s2 = 2 * dims[1] * dims[2]
        Lm, ncf = n + 2 * hp * s2, (c2 + 2 * hp) * c1 * c0
        a = cuda(rng.standard_normal((len(offs), n)).astype(np.float32))
        m = cuda(rng.standard_normal((len(offs), Lm)).astype(np.float32))
        w = cuda(rng.rand(n).astype(np.float32))
        f = cuda(rng.standard_normal(n).astype(np.float32))
        u = cuda(rng.standard_normal(Lm).astype(np.float32))
        uc = cuda(rng.standard_normal(ncf).astype(np.float32))
        if hp:
            fn = lambda: vk.fused_up_sweep_framed(offs, a, offs, m, w, f, u,
                                                  uc, dims, hp)
        else:
            o = offs if host_offsets else torch.tensor(
                offs, dtype=torch.int32, device="cuda")
            fn = lambda: vk.fused_up_sweep(o, a, o, m, w, f, u, uc, dims)
        out["up %s digest" % label] = digest(fn())
        out["up %s" % label] = time_ms(fn)
        del a, m


def down_cases(out, rng, host_offsets, sweep):
    """fused_down_sweep at the main path's L0 and L1 (zero guess and
    base) and fused_down_sweep_framed (zero guess, H = reach(A) +
    reach(Mᵀ)) at S1's interior L0 and L1 slabs beside the base mode on
    the slab, on random DIA operators of the levels' offsets; with
    ``sweep`` each case over other tiles too."""
    from amgcl_tpu_torch.ops import vcycle_kernels as vk
    cuda = lambda a: torch.as_tensor(a).to(device="cuda",
                                          dtype=torch.float32)
    for label, dims, level, framed in (
            ("main L0", (128, 128, 128), 0, False),
            ("main L1", (64, 64, 64), 1, False),
            ("S1 L0 interior", (32, 128, 128), 0, True),
            ("S1 L1 interior", (16, 64, 64), 1, True)):
        offs = _stencil_offsets(dims, level)
        n = int(np.prod(dims))
        H = 2 * max(abs(o) for o in offs) if framed else 0
        L = n + 2 * H
        a = cuda(rng.standard_normal((len(offs), L)).astype(np.float32))
        mt = cuda(rng.standard_normal((len(offs), L)).astype(np.float32))
        f = cuda(rng.standard_normal(L).astype(np.float32))
        u = cuda(rng.standard_normal(L).astype(np.float32))
        w = cuda(rng.rand(L).astype(np.float32))
        o = offs if host_offsets else torch.tensor(
            offs, dtype=torch.int32, device="cuda")
        inner = lambda v: v[..., H:H + n].contiguous()
        modes = [("zero", w, True)] + ([] if framed else [("base", u, False)])
        for mode, x, zero in modes:
            if framed:
                args = (offs, a, offs, mt, f, x, dims, H, zero)
                fn = lambda: vk.fused_down_sweep_framed(*args)
                key = "down %s framed %s" % (label, mode)
                # the base mode on the slab's own rows
                sargs = (o, inner(a), o, inner(mt), inner(f), inner(x),
                         dims, zero)
                out["down %s slab base %s digest" % (label, mode)] = digest(
                    vk.fused_down_sweep(*sargs))
                out["down %s slab base %s" % (label, mode)] = time_ms(
                    lambda: vk.fused_down_sweep(*sargs))
            else:
                args = (o, a, o, mt, f, x, dims, zero)
                fn = lambda: vk.fused_down_sweep(*args)
                key = "down %s %s" % (label, mode)
            out[key + " digest"] = digest(fn())
            out[key] = time_ms(fn)
            if sweep:
                _sweep_down(out, key, offs, a, mt, f, x, dims, H, L, zero)
        del a, mt


def _sweep_down(out, key, offs, a, mt, f, x, dims, H, L, zero):
    """One down-leg case over even tiles of 2–16 planes and rows whose
    boxes fit, alone and in clusters of 2–8 tiles: each launch's time, and
    whether its digest equals the planner's tile's."""
    from amgcl_tpu_torch.ops import dia_kernels as dk
    from amgcl_tpu_torch.ops import vcycle_kernels as vk
    o = dk.offsets_on(offs, "cuda")
    plan = vk.down_tile(offs, offs, dims)
    want = out[key + " digest"]
    res = {}
    for cz, cy in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (2, 4)):
        for tz in (2, 4, 8, 16):
            for ty in (2, 4, 8, 16):
                t = plan._replace(tz=tz, ty=ty, cz=cz, cy=cy)
                if vk.down_box(tz, ty, t.halo, t.ahalo, dims[2], cz, cy) \
                        > vk.MAX_BOX_BYTES or cz * tz > dims[0] \
                        or cy * ty > dims[1]:
                    continue
                fn = lambda: vk._launch_down(offs, offs, o, a, o, mt, f, x,
                                             dims, H, L, zero, t, "sweep")
                res["%dx%d c%dx%d" % (tz, ty, cz, cy)] = [
                    time_ms(fn), digest(fn()) == want]
    out[key + " sweep"] = res


def dia_cases(out, host_offsets):
    """Every DIA kernel mode at the main path's L0 (float32 and float64)
    and L1, at 70,000 rows of 8 diagonals and at 1,000 rows of 5 (both
    dtypes), each timed with its output's digest. A tree whose dot
    kernels take host offsets gets them so, an earlier one the tensor."""
    from amgcl_tpu_torch.ops import dia_kernels as dk
    rng = np.random.RandomState(12)
    f32, f64 = torch.float32, torch.float64
    for label, offs, n, dtypes in (
            ("main L0", _stencil_offsets((128, 128, 128), 0), 1 << 21,
             (f32, f64)),
            ("main L1", _stencil_offsets((64, 64, 64), 1), 1 << 18, (f32,)),
            ("batched", [-4096, -64, -3, -1, 0, 2, 64, 4096], 70000,
             (f32, f64)),
            ("ragged", [-37, -1, 0, 2, 40], 1000, (f32, f64))):
        for dt in dtypes:
            cuda = lambda a: torch.as_tensor(a).to(device="cuda", dtype=dt)
            data = cuda(rng.standard_normal((len(offs), n)))
            x, f = cuda(rng.standard_normal(n)), cuda(rng.standard_normal(n))
            w = cuda(rng.rand(n))
            o = torch.tensor(offs, dtype=torch.int32, device="cuda")
            oh = tuple(offs) if host_offsets else o
            key = "dia %s %s" % (label, str(dt).split(".")[-1])
            for mode, fn in (
                    ("spmv", lambda: dk.dia_spmv(o, data, x)),
                    ("residual", lambda: dk.dia_residual(o, data, f, x)),
                    ("correction",
                     lambda: dk.dia_scaled_correction(o, data, w, f, x)),
                    ("spmv_dots w", lambda: dk.dia_spmv_dots(oh, data, x, w)),
                    ("spmv_dots", lambda: dk.dia_spmv_dots(oh, data, x)),
                    ("residual_dot",
                     lambda: dk.dia_residual_dot(oh, data, f, x))):
                out["%s %s digest" % (key, mode)] = digest(fn())
                out["%s %s" % (key, mode)] = time_ms(fn)
            del data


def gather_cases(out, sweep):
    """gather_spmv at G1's and G1r's L0, G1's float64 refinement
    operator and random K 4/8/12 operators in both dtypes, each beside
    B.8 and torch's CSR product on the same operator; with ``sweep`` each
    case over every geometry the kernel takes."""
    from amgcl_tpu_torch import AMG, AMGParams
    from amgcl_tpu_torch.ops import device as dev
    from amgcl_tpu_torch.ops import gather_kernels as gk
    from amgcl_tpu_torch.ops import well_kernels as wk
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    from chip_smoke import g1_problem, library_csr, random_gather_operator
    A, _ = g1_problem()
    Ap = permute(A, cuthill_mckee(A))
    cases = [
        ("G1 L0", AMG(A, AMGParams(), device="cuda").hierarchy.levels[0].A),
        ("G1r L0", AMG(Ap, AMGParams(), device="cuda").hierarchy.levels[0].A),
        ("G1 L0 f64", dev.to_device(A, "auto", torch.float64, "cuda"))]
    rng = np.random.RandomState(20261017)
    for K in (4, 8, 12):
        for dt in (torch.float32, torch.float64):
            cases.append(("random K%d %s" % (K, str(dt).split(".")[-1]),
                          random_gather_operator(K, dt, rng)))
    rng = np.random.RandomState(13)
    for label, M in cases:
        n, m = M.shape
        x = torch.as_tensor(rng.standard_normal(m)).to(device="cuda",
                                                       dtype=M.dtype)
        g = (M.window_starts, M.cols_local, M.vals)
        key = "gather %s" % label
        fn = lambda: gk.gather_spmv(*g, x, n)
        out[key + " K"] = M.K
        out[key + " digest"] = digest(fn())
        out[key] = time_ms(fn)
        out[key + " B.8"] = time_ms(lambda: wk.windowed_ell_spmv(*g, x, n))
        C = library_csr(M)
        out[key + " CSR"] = time_ms(lambda: torch.mv(C, x))
        if not label.startswith("random"):
            # the floor under a cold read of the format's bytes: one
            # library reduction over as many bytes (not the port's)
            buf = torch.ones(M.vals[0].numel() * M.window_starts.numel()
                             * (M.vals.element_size() + 4) // 4,
                             device="cuda")
            out[key + " read floor"] = time_ms(lambda: torch.sum(buf))
            del buf
        if sweep and hasattr(gk, "launch_geometry"):
            res = {}
            plan = gk.launch_geometry
            for threads in (64, 128, 256):
                gk.launch_geometry = (lambda n_, K_, t=threads:
                                      gk.Geometry(t, -(-n_ // t)))
                try:
                    res[threads] = [time_ms(fn),
                                    digest(fn()) == out[key + " digest"]]
                finally:
                    gk.launch_geometry = plan
            out[key + " sweep"] = res
        del C


def tail_cases(out):
    """xr_update, bicgstab_tail and axpby_dot in both dtypes at the
    BiCGStab paths' n, the main path's and a ragged 1,000, each timed
    with its outputs' digest (dots included), and one empty launch."""
    from amgcl_tpu_torch.ops import fused_vec as fv
    rng = np.random.RandomState(14)
    out["empty launch"] = time_ms(lambda: torch.cuda._sleep(0))
    for n in (85623, 1 << 21, 1000):
        for dt in (torch.float32, torch.float64):
            v = [torch.as_tensor(rng.standard_normal(n)).to(device="cuda",
                                                            dtype=dt)
                 for _ in range(6)]
            a, w, b, one = (torch.tensor(c, dtype=dt, device="cuda")
                            for c in (0.37, -1.3, -0.37, 1.0))
            key = "tail n=%d %s" % (n, str(dt).split(".")[-1])
            for mode, fn in (
                    ("xr", lambda: fv.xr_update(a, *v[:4])),
                    ("bicg_tail", lambda: fv.bicgstab_tail(a, v[0], w,
                                                           *v[1:])),
                    ("axpby_dot", lambda: fv.axpby_dot(b, v[0], one,
                                                       v[1]))):
                out["%s %s digest" % (key, mode)] = digest(fn())
                out["%s %s" % (key, mode)] = time_ms(fn)
            del v


def _warm(fn, n=7):
    """(iterations, median ms) of n warm solves after two more."""
    fn()
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return info.iters, float(np.median(times))


def solve_cases(out):
    """The main path (poisson3d(128), CG, refine=3, the stencil levels
    built on the card) and S1 (its four z-slab shards of one card)."""
    from amgcl_tpu_torch import (AMGParams, CG, DistStencilSolver,
                                 make_mesh, make_solver, poisson3d)
    A, rhs = poisson3d(128)
    solve = make_solver(A, AMGParams(dtype=torch.float32),
                        CG(maxiter=100, tol=1e-6), refine=3)
    out["main iters"], out["main warm ms"] = _warm(lambda: solve(rhs))
    del solve
    s = DistStencilSolver(A, make_mesh(4), AMGParams(dtype=torch.float32),
                          CG(maxiter=100, tol=1e-6))
    out["S1 iters"], out["S1 warm ms"] = _warm(lambda: s(rhs))


def main(tree, label, sweep=False, legs=False, solve=False, dia=False,
         gather=False, tail=False):
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    import amgcl_tpu_torch
    from amgcl_tpu_torch.ops import cuda_lib
    from amgcl_tpu_torch.ops import vcycle_kernels as vk
    if not amgcl_tpu_torch.__file__.startswith(tree):
        raise RuntimeError("imported %s, not the tree %s"
                           % (amgcl_tpu_torch.__file__, tree))
    t0 = time.perf_counter()
    cuda_lib.lib()
    out = {"tree": label, "build_s": round(time.perf_counter() - t0, 2)}
    if dia or gather or tail:
        if dia:
            from amgcl_tpu_torch.ops import dia_kernels as dk
            dia_cases(out, hasattr(dk, "launch_geometry"))
        if gather:
            gather_cases(out, sweep)
        if tail:
            tail_cases(out)
    else:
        if not legs:
            other_cases(out)
        # a tree whose legs plan their tile on the host takes the offsets
        # as ints; an earlier one as device tensors
        up_cases(out, np.random.RandomState(10), hasattr(vk, "up_tile"))
        down_cases(out, np.random.RandomState(11), hasattr(vk, "down_tile"),
                   sweep)
    if solve:
        solve_cases(out)
    print("AB " + json.dumps(out))
    return 0


def other_cases(out):
    """The windowed-ELL, dense-window and block cases."""
    from amgcl_tpu_torch import fe_like_problem
    from amgcl_tpu_torch.ops import densewin_kernels as dwk
    from amgcl_tpu_torch.ops import well_kernels as wk
    from amgcl_tpu_torch.ops.densewin import csr_to_dense_window
    from amgcl_tpu_torch.ops.unstructured import csr_to_windowed_ell
    from amgcl_tpu_torch.utils.adapters import cuthill_mckee, permute
    rng = np.random.RandomState(7)
    A, _ = fe_like_problem()
    Ap = permute(A, cuthill_mckee(A))
    n = A.nrows

    def vec():
        return torch.as_tensor(rng.standard_normal(n)).float().cuda()
    for name, C, dt in (("U2 L0", Ap, torch.float32),
                        ("U1 L0", A, torch.float32),
                        ("U1 L0 f64", A, torch.float64)):
        M = csr_to_windowed_ell(C, dt, device="cuda")
        g = (M.window_starts, M.cols_local, M.vals)
        x, f, w = (v.to(dt) for v in (vec(), vec(), vec()))
        calls = {"spmv": lambda: wk.windowed_ell_spmv(*g, x, n)}
        if name != "U2 L0":
            calls.update({
                "residual": lambda: wk.windowed_ell_residual(*g, f, x, n),
                "correction": lambda: wk.windowed_ell_scaled_correction(
                    *g, w, f, x, n),
                "spmv_dots w": lambda: wk.windowed_ell_spmv_dots(*g, x, w,
                                                                 n)})
        for mode, fn in calls.items():
            if dt == torch.float32:
                out["%s %s" % (name, mode)] = time_ms(fn)
            out["%s %s digest" % (name, mode)] = digest(fn())
        del M, g
    D = csr_to_dense_window(Ap, torch.float32, device="cuda")
    st, B = D.window_starts, D.blocks
    win = B.shape[2]
    x, f, w = vec(), vec(), vec()
    xw = torch.cat([x, x.new_zeros(win)])[
        st.long()[:, None] + torch.arange(win, device="cuda")].unsqueeze(-1)
    out["D2 L0 bmm"] = time_ms(lambda: torch.bmm(B, xw))
    out["D2 L0 spmv"] = time_ms(lambda: dwk.dense_window_spmv(st, B, x, n))
    out["D2 L0 residual"] = time_ms(
        lambda: dwk.dense_window_residual(st, B, f, x, n))
    out["D2 L0 correction"] = time_ms(
        lambda: dwk.dense_window_scaled_correction(st, B, w, f, x, n))
    del xw
    # each mode's output digested on the float32 blocks and on the same
    # blocks widened to float64
    for tag, dt in (("", torch.float32), (" f64", torch.float64)):
        Bd, xd, fd, wd = (v.to(dt) for v in (B, x, f, w))
        for mode, fn in (
                ("spmv", lambda: dwk.dense_window_spmv(st, Bd, xd, n)),
                ("residual", lambda: dwk.dense_window_residual(
                    st, Bd, fd, xd, n)),
                ("correction", lambda: dwk.dense_window_scaled_correction(
                    st, Bd, wd, fd, xd, n))):
            out["D2 L0%s %s digest" % (tag, mode)] = digest(fn())
        del Bd
    del D, B
    block_cases(out, np.random.RandomState(10))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], "--sweep" in sys.argv[3:],
                  "--legs" in sys.argv[3:], "--solve" in sys.argv[3:],
                  "--dia" in sys.argv[3:], "--gather" in sys.argv[3:],
                  "--tail" in sys.argv[3:]))
