"""Preconditioned BiCGStab with a selectable preconditioning side
(counterpart of ``amgcl_tpu/solver/bicgstab.py``; reference:
amgcl/solver/bicgstab.hpp, default side right). The convergence
criterion uses the unpreconditioned rhs norm for both sides; with the
left side the tracked residual is the preconditioned one.

The recurrences are the JAX package's, written as a Python loop: α, ω
and ρ stay 0-d tensors on the device, and each iteration fetches the
scalars the convergence test and the three breakdown guards need (the
residual norm, ρ, the α denominator, ω) in one host sync. A stacked
(n, B) rhs runs the same recurrences on the block, one host sync an
iteration for the B columns (``solver/stacked.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.telemetry import health as H
from amgcl_tpu_torch.telemetry.history import HistoryMixin


def _safe(d):
    """The denominator with an exact zero replaced by one: the guards
    discard the step such a zero produces."""
    return torch.where(d == 0, torch.ones_like(d), d)


@dataclass
class BiCGStab(HistoryMixin):
    maxiter: int = 100
    tol: float = 1e-8
    abstol: float = 0.0
    precond_side: str = "right"
    record_history: bool = False  # per-iteration relative residuals
    guard: bool = True      # in-loop health guards (telemetry/health.py)

    def solve(self, A, precond, rhs, x0=None):
        """Returns ``(x, iters, relative_residual, health_state)``, with
        the residual history appended when ``record_history``.
        ``precond`` maps a vector r to an approximate solution of
        A z = r. A stacked (n, B) rhs returns per-column lists, as
        :meth:`CG.solve` does."""
        if self.precond_side not in ("left", "right"):
            raise ValueError("precond_side must be 'left' or 'right', got %r"
                             % self.precond_side)
        if rhs.dim() == 2:
            return self._solve_stacked(A, precond, rhs, x0)
        left = self.precond_side == "left"
        x = torch.zeros_like(rhs) if x0 is None else x0
        if left:
            r = precond(dev.residual(rhs, A, x))
            rr0 = dev.inner_product(r, r)
        else:
            # fused residual + <r,r>: one operator pass
            r, rr0 = fv.residual_dot(rhs, A, x)
        rhat = r
        norm_rhs, res = torch.stack(
            [dev.norm(rhs), torch.sqrt(torch.abs(rr0))]).tolist()
        scale = norm_rhs if norm_rhs > 0 else 1.0
        eps = max(self.tol * scale, self.abstol)
        tiny = torch.finfo(rhs.dtype).tiny
        hs = self._guard_init(res / scale)
        hist = self._hist_init()
        one = torch.ones((), dtype=rhs.dtype, device=rhs.device)
        p = torch.zeros_like(r)
        v = torch.zeros_like(r)
        # rhat = r, so the first iteration's rho = <rhat, r> = <r, r>
        rho, rho_c, alpha, omega = one, rr0, one, one
        it = 0
        while it < self.maxiter and res > eps and self._guard_go(hs):
            # rho_c = <rhat, r> of the current r, from the previous tail
            rho_n = rho_c
            beta = (rho_n / _safe(rho)) * (alpha / _safe(omega))
            p_n = r + beta * (p - omega * v)
            if left:
                phat = p_n
                v_n = precond(dev.spmv(A, phat))
                denom = dev.inner_product(rhat, v_n)
            else:
                # spmv + <v, rhat> in one operator pass
                phat = precond(p_n)
                v_n, _, _, denom = dev.spmv_dots(A, phat, rhat)
            alpha_n = rho_n / _safe(denom)
            s = r - alpha_n * v_n
            if left:
                shat = s
                t = precond(dev.spmv(A, shat))
                tt, ts = dev.inner_product(t, t), dev.inner_product(t, s)
            else:
                shat = precond(s)
                t, tt, _, ts = dev.spmv_dots(A, shat, s)
            omega_n = ts / _safe(tt)
            # fused tail: x and r updated with <r,r> and the next rho
            x_n, r_n, rr, rho_next = fv.bicgstab_tail(
                alpha_n, phat, omega_n, shat, s, t, x, rhat)
            res_n, rho_h, denom_h, omega_h = torch.stack(
                [torch.sqrt(torch.abs(rr)), rho_n, denom, omega_n]).tolist()
            # the three breakdowns of the reference (bicgstab.hpp throws
            # on each): rho, the alpha denominator and omega
            ok = self._guard_step(
                hs, it, res_n / scale,
                ((H.BREAKDOWN_RHO, H.bad_denom(rho_h, tiny)),
                 (H.BREAKDOWN_ALPHA, H.bad_denom(denom_h, tiny)),
                 (H.BREAKDOWN_OMEGA, H.bad_denom(omega_h, tiny))))
            x, r, p, v, rho, rho_c, alpha, omega, res = self._guard_commit(
                ok, (x_n, r_n, p_n, v_n, rho_n, rho_next, alpha_n, omega_n,
                     res_n),
                (x, r, p, v, rho, rho_c, alpha, omega, res))
            self._hist_put(hist, it, res_n / scale, keep=ok)
            it += int(ok)
        if norm_rhs == 0:
            x = torch.zeros_like(x)
        return self._hist_result(x, it, res / scale, hs, hist)

    def _solve_stacked(self, A, precond, rhs, x0):
        """The 1-D recurrences on a (n, B) block, columns frozen once
        their own loop condition fails."""
        left = self.precond_side == "left"
        rhs, x = S.entry(rhs, x0)
        if left:
            r = precond(dev.residual(rhs, A, x))
            rr0 = fv.col_dots(r, r)
        else:
            r, rr0 = fv.residual_dot(rhs, A, x)
        rhat = r
        norm_rhs, res = S.fetch(torch.sqrt(torch.abs(fv.col_dots(rhs, rhs))),
                                torch.sqrt(torch.abs(rr0)))
        cols = S.Columns(self, norm_rhs, res,
                         [max(self.tol * (v if v > 0 else 1.0), self.abstol)
                          for v in norm_rhs])
        tiny = torch.finfo(rhs.dtype).tiny
        one = torch.ones_like(rr0)
        p = torch.zeros_like(r)
        v = torch.zeros_like(r)
        rho, rho_c, alpha, omega = one, rr0, one, one
        while True:
            act = cols.actives()
            if not any(act):
                break
            rho_n = rho_c
            beta = (rho_n / _safe(rho)) * (alpha / _safe(omega))
            p_n = r + beta * (p - omega * v)
            if left:
                phat = p_n
                v_n = precond(dev.spmv(A, phat))
                denom = fv.col_dots(rhat, v_n)
            else:
                phat = precond(p_n)
                v_n, _, _, denom = dev.spmv_dots(A, phat, rhat)
            alpha_n = rho_n / _safe(denom)
            s = r - alpha_n * v_n
            if left:
                shat = s
                t = precond(dev.spmv(A, shat))
                tt, ts = fv.col_dots(t, t), fv.col_dots(t, s)
            else:
                shat = precond(s)
                t, tt, _, ts = dev.spmv_dots(A, shat, s)
            omega_n = ts / _safe(tt)
            x_n, r_n, rr, rho_next = fv.bicgstab_tail(
                alpha_n, phat, omega_n, shat, s, t, x, rhat)
            res_n, rho_h, denom_h, omega_h = S.fetch(
                torch.sqrt(torch.abs(rr)), rho_n, denom, omega_n)
            oks = []
            for b in range(cols.B):
                ok = act[b] and self._guard_step(
                    cols.hs[b], cols.its[b], res_n[b] / cols.scale[b],
                    ((H.BREAKDOWN_RHO, H.bad_denom(rho_h[b], tiny)),
                     (H.BREAKDOWN_ALPHA, H.bad_denom(denom_h[b], tiny)),
                     (H.BREAKDOWN_OMEGA, H.bad_denom(omega_h[b], tiny))))
                if act[b]:
                    self._hist_put(cols.hist[b], cols.its[b],
                                   res_n[b] / cols.scale[b], keep=ok)
                if ok:
                    cols.res[b] = res_n[b]
                    cols.its[b] += 1
                oks.append(ok)
            m = cols.mask(oks, r)
            x, r, p, v, rho, rho_c, alpha, omega = S.commit(
                m, (x_n, r_n, p_n, v_n, rho_n, rho_next, alpha_n, omega_n),
                (x, r, p, v, rho, rho_c, alpha, omega))
        x = torch.where(cols.mask([v > 0 for v in norm_rhs], x), x,
                    torch.zeros_like(x))
        return cols.result(x)
