"""Restarted GMRES(m) and flexible FGMRES(m) (counterpart of
``amgcl_tpu/solver/gmres.py``; reference: amgcl/solver/gmres.hpp:72-322,
amgcl/solver/detail/givens_rotations.hpp, amgcl/solver/fgmres.hpp).

Arnoldi with classical Gram-Schmidt and one reorthogonalization pass
(CGS2: two stacked products with the basis a step) and Givens rotations
for the least-squares update, in real arithmetic. GMRES is
left-preconditioned by default, its residual measured in the
preconditioned norm; FGMRES, and GMRES with ``pside="right"``, keep a
per-step preconditioned direction Z, so the preconditioner may change
between steps.

The JAX package traces each restart cycle as a ``while_loop``; here the
cycle is host control flow. The basis V (m+1, n), the directions Z, the
Hessenberg column, the rotations, the rhs g of the least-squares problem
and its triangular factor R stay on the device in the working dtype.
The stored rotations are kept as their accumulated product, so applying
them to a new Hessenberg column is one matrix-vector product; that
changes only the rounding against the reference's rotation-by-rotation
loop. Each Arnoldi step fetches what its convergence test and its
Hessenberg-breakdown guard need (the new residual estimate and the new
diagonal of R) in one host sync; the first step of a cycle also carries
the cycle's starting residual (and, in a solve's first cycle, the rhs
norm), so a cycle costs one sync a step. Should that starting residual
already meet the tolerance, the step is dropped uncommitted, which is
the reference's zero-step cycle. A cycle ends with one triangular solve
of its committed leading block on the device.

A stacked (n, B) rhs keeps the columns in step at restart boundaries, as
the JAX package's vmapped loop does: every active column starts a cycle
together, a cycle's step j runs for the columns still active in it (all
of them then at step j), and each column keeps its own basis, rotations
and triangular factor (``_arnoldi_cycle_stacked``), with one host sync a
step for the B columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.telemetry import health as H
from amgcl_tpu_torch.telemetry.history import HistoryMixin


def _givens(a, b):
    """Real Givens rotation (c, s), [c s; -s c] @ [a; b] = [±h; 0], with
    the reference's zero guards (c real, s = sign(a)·b/h, sign(0) = 1)."""
    absa = torch.abs(a)
    h = torch.sqrt(absa ** 2 + torch.abs(b) ** 2)
    one = torch.ones_like(h)
    h = torch.where(h == 0, one, h)
    pha = torch.where(absa == 0, one, a / torch.where(absa == 0, one, absa))
    return absa / h, pha * b / h


class _Run:
    """Host state of one solve that the restart cycles share: the
    tolerance scale (known after the first fetch), the iteration count,
    the committed residual, the guard state and the history."""

    def __init__(self, solver, dtype):
        self.solver = solver
        self.tiny = torch.finfo(dtype).tiny
        self.scale = self.eps = self.res = self.hs = None
        self.it = 0
        self.hist = solver._hist_init()

    def resolve(self, norm_rhs, res0):
        self.scale = norm_rhs if norm_rhs > 0 else 1.0
        self.eps = self.solver.tol * self.scale
        self.res = res0
        self.hs = self.solver._guard_init(res0 / self.scale)

    def go(self):
        return self.hs is None or self.solver._guard_go(self.hs)


def _arnoldi_cycle(run, apply_op, r0, beta, m, direction=None,
                   n_steps=None, pending=None):
    """One restart cycle from the residual ``r0`` of norm ``beta`` (a 0-d
    tensor on the device). ``apply_op(v)`` returns ``(w, z)``: the
    operator applied to the expansion direction v, and the vector to
    accumulate into x (v itself, or M v for the flexible variant).
    ``direction(j, V)`` overrides the expansion direction at step j
    (LGMRES's augmentation), ``n_steps`` caps the cycle below m.
    ``pending`` is the solve's rhs norm (a 0-d tensor) while the run has
    not fetched it yet. Returns ``(dx, steps, res)`` and advances nothing
    in ``run`` but its guard state and history."""
    n, dtype, device = r0.shape[0], r0.dtype, r0.device
    one = torch.ones((), dtype=dtype, device=device)
    V = torch.zeros((m + 1, n), dtype=dtype, device=device)
    V[0] = r0 / torch.where(beta == 0, one, beta)
    Z = torch.zeros((m, n), dtype=dtype, device=device)
    R = torch.eye(m, dtype=dtype, device=device)
    g = torch.zeros(m + 1, dtype=dtype, device=device)
    g[0] = beta
    Q = torch.eye(m + 1, dtype=dtype, device=device)
    cap = m if n_steps is None else n_steps
    solver = run.solver
    res = None                  # the cycle's starting residual, unfetched
    j = 0
    while j < cap and (res is None or res > run.eps) and run.go():
        v = V[j] if direction is None else direction(j, V)
        w, z = apply_op(v)
        Vj = V[:j + 1]
        # CGS2: h = V w, w -= Vᵀ h, twice
        h1 = fv.stack_dots(Vj, w)
        w = w - torch.mv(Vj.T, h1)
        h2 = fv.stack_dots(Vj, w)
        w = w - torch.mv(Vj.T, h2)
        hn = torch.sqrt(torch.abs(dev.inner_product(w, w)))
        h = torch.zeros(m + 1, dtype=dtype, device=device)
        h[:j + 1] = h1 + h2
        h[j + 1] = hn
        h = torch.mv(Q, h)      # the stored rotations k < j
        c, s = _givens(h[j], h[j + 1])
        rjj = c * h[j] + s * h[j + 1]
        gj = g[j]
        res_n_t = torch.abs(-s * gj)
        fetch = [res_n_t, rjj]
        if res is None:
            fetch.append(beta)
            if pending is not None:
                fetch.append(pending)
        got = torch.stack(fetch).tolist()
        res_n, rjj_h = got[0], got[1]
        if res is None:
            res = got[2]
            if pending is not None:
                run.resolve(got[3], res)
                pending = None
            if not (res > run.eps):
                break           # the reference's zero-step cycle
        if solver.guard:
            # Hessenberg breakdown: the new diagonal of R vanishes while
            # the pre-step residual is above eps (gmres.py:127-140)
            ok = solver._guard_step(
                run.hs, run.it + j, res_n / run.scale,
                ((H.BREAKDOWN_HESSENBERG,
                  H.bad_denom(rjj_h, run.tiny) and res > run.eps),))
        else:
            ok = True
        solver._hist_put(run.hist, run.it + j, res_n / run.scale, keep=ok)
        if not ok:
            continue            # the fatal trip ends the loop
        Z[j] = z
        V[j + 1] = w / torch.where(hn == 0, one, hn)
        rot = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
        Q[j:j + 2] = rot @ Q[j:j + 2]
        g[j + 1] = -s * gj
        g[j] = c * gj
        h[j] = rjj
        R[:j + 1, j] = h[:j + 1]
        res = res_n
        j += 1
    if j == 0:
        return torch.zeros_like(r0), 0, res
    y = dev.small_solve_upper(R[:j, :j], g[:j, None])
    return torch.mv(Z[:j].T, y[:, 0]), j, res


def _arnoldi_cycle_stacked(cols, apply_op, r0, beta, m, in_cycle,
                           direction=None, n_steps=None):
    """One restart cycle of :func:`_arnoldi_cycle` for the columns of a
    (n, B) block where ``in_cycle`` holds, from the residual block ``r0``
    of column norms ``beta`` ((B,) on the device). Each column keeps its
    own basis V (m + 1, n, B), directions Z, rotations Q (B, m + 1,
    m + 1), least-squares rhs g (B, m + 1) and factor R (B, m, m); a step
    commits where the column is in the cycle, below its cap, above its
    eps and its guards pass. Returns ``(dx (n, B), steps [B], res [B])``
    (zero steps and the starting residual for a column that took none)
    and advances nothing in ``cols`` but its guard states and
    histories."""
    n, B = r0.shape
    dtype, device = r0.dtype, r0.device
    solver = cols.solver
    ones = torch.ones_like(beta)
    # the blocks are stored (k, B, n): each column of V[j] is contiguous
    V = torch.zeros((m + 1, B, n), dtype=dtype, device=device) \
        .transpose(1, 2)
    V[0] = r0 / torch.where(beta == 0, ones, beta)
    Z = torch.zeros((m, B, n), dtype=dtype, device=device).transpose(1, 2)
    R = torch.eye(m, dtype=dtype, device=device).repeat(B, 1, 1)
    g = torch.zeros((B, m + 1), dtype=dtype, device=device)
    g[:, 0] = beta
    Q = torch.eye(m + 1, dtype=dtype, device=device).repeat(B, 1, 1)
    cap = m if n_steps is None else n_steps
    tiny = torch.finfo(dtype).tiny
    res = [None] * B             # each column's cycle residual, unfetched
    steps = [0] * B
    live = list(in_cycle)
    for j in range(cap):
        live = [live[b] and cols.go(b)
                and (res[b] is None or res[b] > cols.eps[b])
                for b in range(B)]
        if not any(live):
            break
        v = V[j] if direction is None else direction(j, V)
        w, z = apply_op(v)
        Vj = V[:j + 1]
        # CGS2 a column: h = V w, w -= Vᵀ h, twice
        h1 = fv.stack_dots(Vj, w)
        w = w - torch.einsum("knb,kb->nb", Vj, h1)
        h2 = fv.stack_dots(Vj, w)
        w = w - torch.einsum("knb,kb->nb", Vj, h2)
        hn = torch.sqrt(torch.abs(fv.col_dots(w, w)))
        h = torch.zeros((B, m + 1), dtype=dtype, device=device)
        h[:, :j + 1] = (h1 + h2).T
        h[:, j + 1] = hn
        h = torch.einsum("bik,bk->bi", Q, h)     # the stored rotations
        c, s = _givens(h[:, j], h[:, j + 1])
        rjj = c * h[:, j] + s * h[:, j + 1]
        gj = g[:, j]
        got = S.fetch(torch.abs(-s * gj), rjj,
                      *(() if j else (beta,)))
        res_n, rjj_h = got[0], got[1]
        oks = []
        for b in range(B):
            if not live[b]:
                oks.append(False)
                continue
            if j == 0:
                res[b] = got[2][b]
                if not (res[b] > cols.eps[b]):
                    live[b] = False      # the reference's zero-step cycle
                    oks.append(False)
                    continue
            sc = cols.scale[b]
            if solver.guard:
                ok = solver._guard_step(
                    cols.hs[b], cols.its[b] + j, res_n[b] / sc,
                    ((H.BREAKDOWN_HESSENBERG,
                      H.bad_denom(rjj_h[b], tiny)
                      and res[b] > cols.eps[b]),))
            else:
                ok = True
            solver._hist_put(cols.hist[b], cols.its[b] + j,
                             res_n[b] / sc, keep=ok)
            if ok:
                res[b] = res_n[b]
                steps[b] += 1
            else:
                live[b] = False          # the fatal trip ends its cycle
            oks.append(ok)
        if not any(oks):
            continue
        mk = S.Columns.mask(oks, beta)
        Z[j] = torch.where(mk, z, Z[j])
        V[j + 1] = torch.where(mk, w / torch.where(hn == 0, ones, hn), V[j + 1])
        rot = torch.stack([torch.stack([c, s], -1),
                           torch.stack([-s, c], -1)], -2)  # (B, 2, 2)
        Qn = Q.clone()
        Qn[:, j:j + 2] = rot @ Q[:, j:j + 2]
        Q = S.where_rows(mk, Qn, Q)
        gn = g.clone()
        gn[:, j + 1] = -s * gj
        gn[:, j] = c * gj
        g = S.where_rows(mk, gn, g)
        h[:, j] = rjj
        R[:, :j + 1, j] = S.where_rows(mk, h[:, :j + 1], R[:, :j + 1, j])
    # each column's leading block solved at once: R is the identity past
    # a column's committed steps and its rhs zero there
    taken = torch.tensor(steps, device=device)
    gm = torch.where(torch.arange(m, device=device)[None, :]
                     < taken[:, None], g[:, :m], torch.zeros_like(g[:, :m]))
    y = dev.small_solve_upper(R, gm[..., None])[..., 0]
    dx = torch.einsum("knb,bk->nb", Z, y)
    return dx, steps, res


@dataclass
class GMRES(HistoryMixin):
    """Restarted GMRES(M) (reference default M = 30). ``pside`` selects
    the preconditioning side: left (the JAX package's default) or right,
    which shares the flexible machinery (for a constant preconditioner
    FGMRES is right-preconditioned GMRES)."""
    M: int = 30
    maxiter: int = 100
    tol: float = 1e-8
    pside: str = "left"
    record_history: bool = False  # per-iteration relative residuals
    guard: bool = True      # in-loop health guards (telemetry/health.py)

    flexible = False

    def solve(self, A, precond, rhs, x0=None):
        """Returns ``(x, iters, relative_residual, health_state)``, with
        the residual history appended when ``record_history``. The
        iteration count is tested only between restart cycles, so a cycle
        started below ``maxiter`` may take it up to M - 1 past it, as in
        the reference. A stacked (n, B) rhs returns per-column lists,
        as :meth:`CG.solve` does."""
        if self.pside not in ("left", "right"):
            raise ValueError("pside must be 'left' or 'right', got %r"
                             % (self.pside,))
        if self.M < 1:
            raise ValueError("M must be at least 1, got %r" % (self.M,))
        if rhs.dim() == 2:
            rhs, x = S.entry(rhs, x0)
        else:
            x = torch.zeros_like(rhs) if x0 is None else x0
        if self.flexible or self.pside == "right":
            def apply_op(v):
                z = precond(v)
                return dev.spmv(A, z), z

            def resid0(x):
                return dev.residual(rhs, A, x)
        else:
            def apply_op(v):
                return precond(dev.spmv(A, v)), v

            def resid0(x):
                return precond(dev.residual(rhs, A, x))

        if rhs.dim() == 2:
            return _restarted_stacked(self, apply_op, resid0, rhs, x,
                                      self.M)
        # the (preconditioned) rhs norm scales the relative criterion; it
        # and the first residual reach the host with the first step
        norm_rhs = dev.norm(resid0(torch.zeros_like(rhs)))
        r = resid0(x)
        beta = dev.norm(r)
        run = _Run(self, rhs.dtype)
        while run.it < self.maxiter and (
                run.scale is None or (run.res > run.eps and run.go())):
            if run.scale is not None:
                r = resid0(x)
                beta = dev.norm(r)
            dx, steps, run.res = _arnoldi_cycle(
                run, apply_op, r, beta, self.M,
                pending=norm_rhs if run.scale is None else None)
            x = x + dx
            run.it += steps
        if run.scale is None:           # maxiter <= 0: no cycle ran
            run.resolve(*torch.stack([norm_rhs, beta]).tolist())
        return self._hist_result(x, run.it, run.res / run.scale, run.hs,
                                 run.hist)


def _restarted_stacked(solver, apply_op, presid, rhs, x, m, K=None,
                       finish=None):
    """The restart loop of GMRES (and, with ``K`` stored corrections,
    LGMRES) over a (n, B) block: every active column starts a cycle
    together; columns leave the loop on their own condition and stay
    frozen. ``presid(x)`` is the (preconditioned) residual block and
    ``finish(dx)`` the correction a cycle adds to x (dx itself, or M dx
    for right-preconditioned LGMRES)."""
    r0 = presid(torch.zeros_like(rhs))
    norm_rhs = torch.sqrt(torch.abs(fv.col_dots(r0, r0)))
    r = presid(x)
    beta = torch.sqrt(torch.abs(fv.col_dots(r, r)))
    nb, b0 = S.fetch(norm_rhs, beta)
    cols = S.Columns(solver, nb, b0)
    aug = []                    # LGMRES's stored corrections, newest first
    mk = m if K is None else m - K

    def direction(j, V):
        return V[j] if j < mk else aug[j - mk]

    first = True
    while True:
        act = cols.actives()
        if not any(act):
            break
        if not first:
            r = presid(x)
            beta = torch.sqrt(torch.abs(fv.col_dots(r, r)))
        first = False
        dx, steps, res = _arnoldi_cycle_stacked(
            cols, apply_op, r, beta, m, act,
            direction=None if K is None else direction,
            n_steps=None if K is None else mk + len(aug))
        if K is not None:
            nrm = torch.sqrt(torch.abs(fv.col_dots(dx, dx)))
            aug.insert(0, dx / torch.where(nrm == 0, torch.ones_like(nrm),
                                           nrm))
            del aug[K:]
        step = dx if finish is None else finish(dx)
        x = torch.where(cols.mask(act, x), x + step, x)
        for b in range(cols.B):
            if act[b]:
                cols.its[b] += steps[b]
                cols.res[b] = res[b]
    return cols.result(x)


@dataclass
class FGMRES(GMRES):
    """Flexible (right-preconditioned) GMRES: the preconditioner may
    change between iterations (reference: amgcl/solver/fgmres.hpp)."""
    flexible = True
