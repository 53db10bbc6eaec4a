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
step ends the solve, so a cycle of L steps costs L syncs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
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
        A z = r. Each committed BiCG step counts one iteration."""
        if rhs.dim() != 1:
            raise NotImplementedError(
                "a stacked (n, B) rhs (the JAX package's serving entry) is "
                "not ported; solve one right-hand side at a time")
        if self.pside not in ("left", "right"):
            raise ValueError("pside must be 'left' or 'right', got %r"
                             % (self.pside,))
        Lp = int(self.L)
        if Lp < 1:
            raise ValueError("L must be at least 1, got %r" % (self.L,))
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
        is solved there, in the working dtype, as the JAX package does."""
        Rs = torch.stack(R)
        gram = fv.block_dots(Rs[1:], Rs)          # (L, L+1)
        gam = torch.linalg.solve_ex(gram[:, 1:] + tiny_eye, gram[:, 0])[0]
        Lp = len(R) - 1
        Us = torch.stack(U)
        R_new = [Rs[0] - gam @ Rs[1:]] + list(R[1:])
        U_new = [Us[0] - gam @ Us[1:]] + list(U[1:])
        res = torch.sqrt(torch.abs(dev.inner_product(R_new[0], R_new[0])))
        return x + gam @ Rs[:Lp], R_new, U_new, gam[Lp - 1], res
