"""BiCGStab(L): L BiCG steps combined with an L-step minimal-residual
polynomial update (Sleijpen–Fokkema), curing the ω-breakdowns of plain
BiCGStab on strongly non-symmetric or indefinite problems (counterpart
of ``amgcl_tpu/solver/bicgstabl.py``; reference:
amgcl/solver/bicgstabl.hpp, default L = 2).

``pside`` selects the preconditioning side (default right, the
reference's): right runs the recurrence on op = A∘M in correction form,
tracking the true residuals; left runs on op = M∘A with preconditioned
residuals, and its convergence test uses the preconditioned rhs norm.

The JAX package traces the loop as one ``while_loop`` whose steps commit
candidate states under masks; here the same recurrences run as host
control flow. The iterate, the residual and search bases (lists of L + 1
vectors) and ρ, α, ω stay on the device. Each BiCG step fetches the
scalars its commit decision and its guards need (ζ, ρ₁, γ) in one host
sync; the last step's sync also carries the minimal-residual step's
residual, which is computed before the decision and dropped when the
step ends the solve, so a cycle of L steps costs L syncs. A stacked
(n, B) rhs runs the cycle on the block, a column leaving the cycle (and
skipping its minimal-residual step) where its own 1-D loop would, with
one host sync a step for the B columns (``solver/stacked.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.telemetry import health as H
from amgcl_tpu_torch.telemetry.history import HistoryMixin


def _safe(d):
    """The denominator with an exact zero replaced by one, as the JAX
    package guards it: the guards flag such a step."""
    return torch.where(d == 0, torch.ones_like(d), d)


@dataclass
class BiCGStabL(HistoryMixin):
    """``delta`` enables the reliable-update scheme of bicgstabl.hpp:
    386-409: when the recursive residual has dropped far enough below its
    running peaks, the true residual of the inner operator is recomputed,
    and on the stronger condition the accumulated correction is flushed
    into the solution and the effective rhs re-centred. ``delta = 0``
    (the reference default) disables it."""
    L: int = 2
    maxiter: int = 100
    tol: float = 1e-8
    pside: str = "right"  # the reference default (bicgstabl.hpp:137)
    delta: float = 0.0    # reliable-update threshold (bicgstabl.hpp:110)
    record_history: bool = False  # per-iteration relative residuals
    guard: bool = True    # in-loop health guards (telemetry/health.py)

    def solve(self, A, precond, rhs, x0=None):
        """Returns ``(x, iters, relative_residual, health_state)``, with
        the residual history appended when ``record_history``.
        ``precond`` maps a vector r to an approximate solution of
        A z = r. Each committed BiCG step counts one iteration. A stacked
        (n, B) rhs returns per-column lists, as :meth:`CG.solve` does."""
        if self.pside not in ("left", "right"):
            raise ValueError("pside must be 'left' or 'right', got %r"
                             % (self.pside,))
        Lp = int(self.L)
        if Lp < 1:
            raise ValueError("L must be at least 1, got %r" % (self.L,))
        if rhs.dim() == 2:
            return self._solve_stacked(A, precond, rhs, x0)
        right = self.pside == "right"
        dot = dev.inner_product
        x_init = torch.zeros_like(rhs) if x0 is None else x0
        if right:
            def op(v):
                return dev.spmv(A, precond(v))

            def op_dot_rhat(v, rhat):
                # spmv + <y, rhat> in one operator pass where A has one
                y, _, _, yr = dev.spmv_dots(A, precond(v), rhat)
                return y, yr

            b_p = rhs
            # fused residual + <r,r>: zeta0 rides the operator pass
            r0, zz0 = fv.residual_dot(rhs, A, x_init)
            x = torch.zeros_like(rhs)
        else:
            def op(v):
                return precond(dev.spmv(A, v))

            def op_dot_rhat(v, rhat):
                y = op(v)
                return y, dot(rhat, y)

            b_p = precond(rhs)
            r0 = b_p - op(x_init)
            zz0 = dot(r0, r0)
            x = x_init
        norm_rhs, zeta0 = torch.stack(
            [dev.norm(b_p), torch.sqrt(torch.abs(zz0))]).tolist()
        scale = norm_rhs if norm_rhs > 0 else 1.0
        eps = self.tol * scale
        use_delta = self.delta > 0
        if use_delta and not right:
            # reliable updates need the correction form on both sides:
            # run from x = 0 against B = r0, flush into xbase
            x = torch.zeros_like(rhs)
        tiny = torch.finfo(rhs.dtype).tiny
        guard = bool(self.guard)
        rhat = r0
        zeros = torch.zeros_like(rhs)
        R = [r0] + [zeros] * Lp
        U = [zeros] * (Lp + 1)
        one = torch.ones((), dtype=rhs.dtype, device=rhs.device)
        rho, alpha, omega = one, torch.zeros_like(one), one
        tiny_eye = 1e-300 * torch.eye(Lp, dtype=rhs.dtype, device=rhs.device)
        xbase, B, rnc, rnt = x_init, r0, zeta0, zeta0
        it, res = 0, zeta0
        hs = self._guard_init(zeta0 / scale)
        hist = self._hist_init()
        while it < self.maxiter and res > eps and self._guard_go(hs):
            # the reference leaves the whole solve the moment a BiCG step's
            # residual drops to eps (bicgstabl.hpp:296-299, `goto done`):
            # without that, a near-exact preconditioner makes the next step
            # divide ~0 by ~0
            live = True
            took = 0
            trip_rho = trip_gamma = nan_seen = False
            rho = -omega * rho
            for j in range(Lp):
                rho1 = dot(rhat, R[j])
                beta = alpha * rho1 / _safe(rho)
                Uc = list(U)
                for i in range(j + 1):
                    Uc[i] = R[i] - beta * Uc[i]
                Uc[j + 1], gamma = op_dot_rhat(Uc[j], rhat)
                alpha_c = rho1 / _safe(gamma)
                # R[0]'s update carries the zeta reduction in the same pass
                r0c, zz = fv.axpby_dot(-alpha_c, Uc[1], one, R[0])
                Rc = list(R)
                Rc[0] = r0c
                for i in range(1, j + 1):
                    Rc[i] = Rc[i] - alpha_c * Uc[i + 1]
                Rc[j + 1] = op(Rc[j])
                xc = x + alpha_c * Uc[0]
                fetch = [torch.sqrt(torch.abs(zz)), rho1, gamma]
                if j == Lp - 1:
                    # the minimal-residual step on the candidate state; its
                    # residual rides this step's sync
                    mr = self._minimal_residual(xc, Rc, Uc, tiny_eye)
                    fetch.append(mr[4])
                got = torch.stack(fetch).tolist()
                zeta = got[0]
                if guard:
                    trip_rho |= H.bad_denom(got[1], tiny)
                    trip_gamma |= H.bad_denom(got[2], tiny)
                    nan_seen |= not math.isfinite(zeta)
                # when guarding, a non-finite step residual is never
                # committed (the health flags below stop the loop)
                step_ok = not guard or math.isfinite(zeta)
                self._hist_put(hist, it + took, zeta / scale, keep=step_ok)
                if step_ok:
                    took += 1
                    x, R, U, rho, alpha, res = xc, Rc, Uc, rho1, alpha_c, zeta
                    rnc, rnt = max(rnc, zeta), max(rnt, zeta)
                live = step_ok and zeta > eps
                if not live:
                    break
            if live:
                # -- MR part: minimize ||R[0] - sum_j g_j R[j]|| over j=1..L
                res_c = got[3]
                if guard:
                    nan_seen |= not math.isfinite(res_c)
                if not guard or math.isfinite(res_c):
                    x, R, U, omega = mr[:4]
                    res = res_c
            # the cycle's last counted step ends at the committed (post-MR)
            # residual, so that history[-1] is the returned residual
            self._hist_put(hist, it + took - 1, res / scale, keep=took > 0)
            # one guard update per cycle, on the committed residual, with
            # the per-step trips (the loop state stays committed)
            self._guard_step(hs, it + max(took - 1, 0), res / scale,
                             ((H.BREAKDOWN_RHO, trip_rho),
                              (H.BREAKDOWN_ALPHA, trip_gamma),
                              (H.NAN, nan_seen)))
            it += took
            if not use_delta:
                continue
            # -- reliable updates (bicgstabl.hpp:386-409)
            rnc, rnt = max(res, rnc), max(res, rnt)
            update_x = res < self.delta * zeta0 and zeta0 <= rnc and live
            recomp = ((res < self.delta * rnt and res <= rnt) or update_x) \
                and live
            if recomp:
                # M x once, for both the true residual and the flush
                Mx = precond(x) if right else x
                r_true = B - (dev.spmv(A, Mx) if right else op(x))
                R = [r_true] + R[1:]
                if update_x:
                    x = torch.zeros_like(x)
                    xbase = xbase + Mx
                    B = r_true
                    rnc = res
                rnt = res
        if use_delta:
            x = xbase + (precond(x) if right else x)
        elif right:
            x = x_init + precond(x)
        return self._hist_result(x, it, res / scale, hs, hist)

    @staticmethod
    def _minimal_residual(x, R, U, tiny_eye):
        """The MR update of (x, R, U): returns (x', R', U', ω', ‖R'[0]‖)
        with ω' = γ_L, all on the device. The (L, L) system G + 1e-300·I
        is solved there, in the working dtype, as the JAX package does
        (a bfloat16 one in float32, ``dev.small_solve``)."""
        Rs = torch.stack(R)
        gram = fv.block_dots(Rs[1:], Rs)          # (L, L+1)
        gam = dev.small_solve(gram[:, 1:] + tiny_eye, gram[:, 0])
        Lp = len(R) - 1
        Us = torch.stack(U)
        R_new = [Rs[0] - gam @ Rs[1:]] + list(R[1:])
        U_new = [Us[0] - gam @ Us[1:]] + list(U[1:])
        res = torch.sqrt(torch.abs(dev.inner_product(R_new[0], R_new[0])))
        return x + gam @ Rs[:Lp], R_new, U_new, gam[Lp - 1], res

    def _solve_stacked(self, A, precond, rhs, x0):
        """The 1-D cycle on a (n, B) block: per column its steps' commits,
        its early exit from the cycle, its minimal-residual step and its
        reliable updates."""
        Lp = int(self.L)
        right = self.pside == "right"
        rhs, x_init = S.entry(rhs, x0)
        if right:
            def op(v):
                return dev.spmv(A, precond(v))

            def op_dot_rhat(v, rhat):
                y, _, _, yr = dev.spmv_dots(A, precond(v), rhat)
                return y, yr

            b_p = rhs
            r0, zz0 = fv.residual_dot(rhs, A, x_init)
            x = torch.zeros_like(rhs)
        else:
            def op(v):
                return precond(dev.spmv(A, v))

            def op_dot_rhat(v, rhat):
                y = op(v)
                return y, fv.col_dots(rhat, y)

            b_p = precond(rhs)
            r0 = b_p - op(x_init)
            zz0 = fv.col_dots(r0, r0)
            x = x_init
        norm_rhs, zeta0 = S.fetch(torch.sqrt(torch.abs(fv.col_dots(b_p,
                                                                     b_p))),
                                  torch.sqrt(torch.abs(zz0)))
        cols = S.Columns(self, norm_rhs, zeta0)
        nb = cols.B
        use_delta = self.delta > 0
        if use_delta and not right:
            x = torch.zeros_like(rhs)
        tiny = torch.finfo(rhs.dtype).tiny
        guard = bool(self.guard)
        rhat = r0
        zeros = torch.zeros_like(rhs)
        R = [r0] + [zeros] * Lp
        U = [zeros] * (Lp + 1)
        one = torch.ones_like(zz0)
        rho, alpha, omega = one, torch.zeros_like(one), one
        tiny_eye = 1e-300 * torch.eye(Lp, dtype=rhs.dtype, device=rhs.device)
        xbase, Bv = x_init, r0
        rnc, rnt = list(zeta0), list(zeta0)
        while True:
            act = cols.actives()
            if not any(act):
                break
            live = list(act)
            took = [0] * nb
            trip_rho, trip_gamma, nan_seen = ([False] * nb for _ in range(3))
            rho = torch.where(cols.mask(act, rho), -omega * rho, rho)
            for j in range(Lp):
                if not any(live):
                    break
                rho1 = fv.col_dots(rhat, R[j])
                beta = alpha * rho1 / _safe(rho)
                Uc = list(U)
                for i in range(j + 1):
                    Uc[i] = R[i] - beta * Uc[i]
                Uc[j + 1], gamma = op_dot_rhat(Uc[j], rhat)
                alpha_c = rho1 / _safe(gamma)
                r0c, zz = fv.axpby_dot(-alpha_c, Uc[1], one, R[0])
                Rc = list(R)
                Rc[0] = r0c
                for i in range(1, j + 1):
                    Rc[i] = Rc[i] - alpha_c * Uc[i + 1]
                Rc[j + 1] = op(Rc[j])
                xc = x + alpha_c * Uc[0]
                vals = [torch.sqrt(torch.abs(zz)), rho1, gamma]
                if j == Lp - 1:
                    mr = self._minimal_residual_stacked(xc, Rc, Uc, tiny_eye)
                    vals.append(mr[4])
                got = S.fetch(*vals)
                oks = []
                for b in range(nb):
                    if not live[b]:
                        oks.append(False)
                        continue
                    zeta = got[0][b]
                    if guard:
                        trip_rho[b] |= H.bad_denom(got[1][b], tiny)
                        trip_gamma[b] |= H.bad_denom(got[2][b], tiny)
                        nan_seen[b] |= not math.isfinite(zeta)
                    step_ok = not guard or math.isfinite(zeta)
                    self._hist_put(cols.hist[b], cols.its[b] + took[b],
                                   zeta / cols.scale[b], keep=step_ok)
                    if step_ok:
                        took[b] += 1
                        cols.res[b] = zeta
                        rnc[b], rnt[b] = max(rnc[b], zeta), max(rnt[b], zeta)
                    live[b] = step_ok and zeta > cols.eps[b]
                    oks.append(step_ok)
                m = cols.mask(oks, rho)
                x = torch.where(m, xc, x)
                R = [torch.where(m, a, c) for a, c in zip(Rc, R)]
                U = [torch.where(m, a, c) for a, c in zip(Uc, U)]
                rho, alpha = S.commit(m, (rho1, alpha_c), (rho, alpha))
            # -- MR part, for the columns still live after their L steps
            mr_ok = [False] * nb
            for b in range(nb):
                if live[b]:
                    res_c = got[3][b]
                    if guard:
                        nan_seen[b] |= not math.isfinite(res_c)
                    if not guard or math.isfinite(res_c):
                        mr_ok[b] = True
                        cols.res[b] = res_c
            if any(mr_ok):
                m = cols.mask(mr_ok, rho)
                x = torch.where(m, mr[0], x)
                R[0] = torch.where(m, mr[1], R[0])
                U[0] = torch.where(m, mr[2], U[0])
                omega = torch.where(m, mr[3], omega)
            recomp, update = [False] * nb, [False] * nb
            for b in range(nb):
                if not act[b]:
                    continue
                res, sc = cols.res[b], cols.scale[b]
                self._hist_put(cols.hist[b], cols.its[b] + took[b] - 1,
                               res / sc, keep=took[b] > 0)
                self._guard_step(cols.hs[b], cols.its[b] + max(took[b] - 1, 0),
                                 res / sc,
                                 ((H.BREAKDOWN_RHO, trip_rho[b]),
                                  (H.BREAKDOWN_ALPHA, trip_gamma[b]),
                                  (H.NAN, nan_seen[b])))
                cols.its[b] += took[b]
                if not use_delta:
                    continue
                # -- reliable updates (bicgstabl.hpp:386-409)
                rnc[b], rnt[b] = max(res, rnc[b]), max(res, rnt[b])
                update[b] = res < self.delta * zeta0[b] \
                    and zeta0[b] <= rnc[b] and live[b]
                recomp[b] = ((res < self.delta * rnt[b] and res <= rnt[b])
                             or update[b]) and live[b]
                if recomp[b]:
                    if update[b]:
                        rnc[b] = res
                    rnt[b] = res
            if any(recomp):
                Mx = precond(x) if right else x
                r_true = Bv - (dev.spmv(A, Mx) if right else op(x))
                R[0] = torch.where(cols.mask(recomp, rho), r_true, R[0])
                if any(update):
                    mu = cols.mask(update, rho)
                    x = torch.where(mu, torch.zeros_like(x), x)
                    xbase = torch.where(mu, xbase + Mx, xbase)
                    Bv = torch.where(mu, r_true, Bv)
        if use_delta:
            x = xbase + (precond(x) if right else x)
        elif right:
            x = x_init + precond(x)
        return cols.result(x)

    @staticmethod
    def _minimal_residual_stacked(x, R, U, tiny_eye):
        """:meth:`_minimal_residual` a column of (n, B) blocks: the
        (B, L, L) Gram systems solved at once."""
        Lp = len(R) - 1
        Rs, Us = S.stack(R), S.stack(U)
        gram = fv.block_dots(Rs[1:], Rs)          # (B, L, L+1)
        gam = dev.small_solve(gram[:, :, 1:] + tiny_eye, gram[:, :, 0])
        r0 = Rs[0] - S.combine(gam, Rs[1:])
        u0 = Us[0] - S.combine(gam, Us[1:])
        res = torch.sqrt(torch.abs(fv.col_dots(r0, r0)))
        return x + S.combine(gam, Rs[:Lp]), r0, u0, gam[:, Lp - 1], res
