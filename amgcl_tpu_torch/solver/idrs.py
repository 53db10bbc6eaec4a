"""IDR(s): induced dimension reduction with biorthogonalization (van
Gijzen & Sonneveld 2011; counterpart of ``amgcl_tpu/solver/idrs.py``;
reference: amgcl/solver/idrs.hpp, default s = 4).

The shadow space P is a fixed pseudo-random (s, n) block, orthonormalized
by modified Gram-Schmidt. The JAX package draws it from JAX's own
generator (``jax.random.normal`` of a key folded with each row index);
the port draws it from a ``torch.Generator`` seeded with the same number
(4321), so the two spaces differ and so do the iteration counts, by a
few. A given block can be handed in instead (``shadow``, see
:func:`amgcl_tpu_torch.convert.idrs_with_shadow`), which lets the tests
run both packages on the same space.

The recurrences are the JAX package's, written as host control flow:
G, U, M, f and ω stay on the device. Each of the s biorthogonalization
sub-steps and the closing dimension-reduction step counts one iteration,
and with guards on (or history recorded) fetches its guard scalars and
residual in one host sync; as in the reference, the convergence test
runs only after all s + 1 of them. A stacked (n, B) rhs runs the same
steps on the block, every column on the same shadow space, with one host
sync a step for the B columns (``solver/stacked.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.telemetry import health as H
from amgcl_tpu_torch.telemetry.history import HistoryMixin

#: seed of the port's shadow space (the JAX package's key is
#: PRNGKey(4321))
SHADOW_SEED = 4321


def shadow_block(s, n, dtype, device):
    """The port's (s, n) shadow space: standard normal draws from a
    ``torch.Generator`` seeded with :data:`SHADOW_SEED` (in float64 on
    the CPU, one row of s per unknown), cast to ``dtype`` on ``device``
    and orthonormalized by modified Gram-Schmidt there."""
    gen = torch.Generator().manual_seed(SHADOW_SEED)
    P = torch.randn((n, s), generator=gen, dtype=torch.float64).T
    return _mgs(P.to(dtype=dtype, device=device).contiguous())


def _mgs(P):
    """Modified Gram-Schmidt over the rows of P, as the reference's
    ``_shadow_block`` (a zero row stays zero)."""
    for i in range(P.shape[0]):
        for l in range(i):
            P[i] = P[i] - dev.inner_product(P[l], P[i]) * P[l]
        nrm = dev.norm(P[i])
        P[i] = P[i] / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return P


def _safe(d):
    """The denominator with an exact zero replaced by one: the guards
    flag such a step."""
    return torch.where(d == 0, torch.ones_like(d), d)


@dataclass
class IDRs(HistoryMixin):
    """``shadow`` is None (the port's seeded space) or a fixed (s, n)
    orthonormal block, a numpy array or tensor, used as it is."""
    s: int = 4
    maxiter: int = 100
    tol: float = 1e-8
    replacement: bool = False   # unused: kept for interface parity, as
    #                             the JAX package keeps it
    record_history: bool = False  # per-iteration relative residuals
    guard: bool = True      # in-loop health guards (telemetry/health.py)
    shadow: Any = None

    def solve(self, A, precond, rhs, x0=None):
        """Returns ``(x, iters, relative_residual, health_state)``, with
        the residual history appended when ``record_history``. A stacked
        (n, B) rhs returns per-column lists, as :meth:`CG.solve` does."""
        s = int(self.s)
        if s < 1:
            raise ValueError("s must be at least 1, got %r" % (self.s,))
        n, dtype, device = rhs.shape[0], rhs.dtype, rhs.device
        if self.shadow is None:
            P = shadow_block(s, n, dtype, device)
        else:
            P = torch.as_tensor(self.shadow).to(dtype=dtype, device=device)
            if tuple(P.shape) != (s, n):
                raise ValueError("shadow has shape %s, expected (%d, %d)"
                                 % (tuple(P.shape), s, n))
        if rhs.dim() == 2:
            return self._solve_stacked(A, precond, rhs, x0, P)
        x = torch.zeros_like(rhs) if x0 is None else x0
        r, rr0 = fv.residual_dot(rhs, A, x)
        norm_rhs, res = torch.stack(
            [dev.norm(rhs), torch.sqrt(torch.abs(rr0))]).tolist()
        scale = norm_rhs if norm_rhs > 0 else 1.0
        eps = self.tol * scale
        tiny = torch.finfo(dtype).tiny
        guard = bool(self.guard)
        fetch_steps = guard or self.record_history
        hs = self._guard_init(res / scale)
        hist = self._hist_init()
        G = torch.zeros((s, n), dtype=dtype, device=device)
        U = torch.zeros((s, n), dtype=dtype, device=device)
        M = torch.eye(s, dtype=dtype, device=device)
        eye = torch.eye(s, dtype=dtype, device=device)
        om = torch.ones((), dtype=dtype, device=device)
        idx = torch.arange(s, device=device)
        it = 0
        while it < self.maxiter and res > eps and self._guard_go(hs):
            f = fv.stack_dots(P, r)
            alive = True
            trip_rho = trip_om = nan_seen = False
            took = 0
            for k in range(s):
                # solve the lower-right (s-k) system M[k:,k:] c = f[k:] as
                # a masked full solve: rows/cols < k act as identity
                mask = idx >= k
                Mk = torch.where(mask[:, None] & mask[None, :], M, eye)
                fk = torch.where(mask, f, torch.zeros_like(f))
                c = dev.small_solve(Mk, fk)   # zeros for i < k
                v = precond(r - c @ G)
                u = om * v + c @ U
                g = dev.spmv(A, u)
                # biorthogonalize against P[0..k-1]
                for i in range(k):
                    al = dev.inner_product(P[i], g) / M[i, i]
                    g = g - al * G[i]
                    u = u - al * U[i]
                G[k] = g
                U[k] = u
                M[:, k] = fv.stack_dots(P, g)
                beta = f[k] / _safe(M[k, k])
                # fused sub-step tail: x += β U[k], r -= β G[k], <r,r>
                x_n, r_n, rr_k = fv.xr_update(beta, U[k], G[k], x, r)
                f_n = f - beta * M[:, k]
                if not fetch_steps:
                    x, r, f = x_n, r_n, f_n
                    took += 1
                    continue
                mkk, res_k = torch.stack(
                    [M[k, k], torch.sqrt(torch.abs(rr_k))]).tolist()
                if guard:
                    # M[k,k] = <P_k, g> ≈ 0: the residual left the shadow
                    # space, the IDR(s) analogue of a rho-breakdown
                    bad = H.bad_denom(mkk, tiny)
                    trip_rho |= alive and bad
                    nan_seen |= alive and not math.isfinite(res_k)
                    step_ok = alive and not bad and math.isfinite(res_k)
                else:
                    step_ok = True
                if step_ok:
                    x, r, f, res = x_n, r_n, f_n, res_k
                self._hist_put(hist, it + k, res_k / scale, keep=step_ok)
                took += int(step_ok)
                alive = step_ok
            # dimension-reduction step into the next Sonneveld space
            # (spmv + <t,t>, <t,r> in one operator pass where A has one)
            v = precond(r)
            t, tt, _, tr = dev.spmv_dots(A, v, r)
            om_n = tr / _safe(tt)
            # fused tail: x += ω v, r -= ω t and <r,r> in one pass
            x_n, r_n, rr_n = fv.xr_update(om_n, v, t, x, r)
            tt_h, res_n = torch.stack(
                [tt, torch.sqrt(torch.abs(rr_n))]).tolist()
            if guard:
                bad = H.bad_denom(tt_h, tiny)
                trip_om |= alive and bad
                nan_seen |= alive and not math.isfinite(res_n)
                fin_ok = alive and not bad and math.isfinite(res_n)
            else:
                fin_ok = True
            if fin_ok:
                x, r, om, res = x_n, r_n, om_n, res_n
            self._hist_put(hist, it + s, res_n / scale, keep=fin_ok)
            took += int(fin_ok)
            if guard:
                self._guard_step(hs, it + max(took - 1, 0), res / scale,
                                 ((H.BREAKDOWN_RHO, trip_rho),
                                  (H.BREAKDOWN_OMEGA, trip_om),
                                  (H.NAN, nan_seen)))
            it += took
        return self._hist_result(x, it, res / scale, hs, hist)

    def _solve_stacked(self, A, precond, rhs, x0, P):
        """The 1-D steps on a (n, B) block over the shadow space P; the
        per-column state G, U (s, n, B), M (B, s, s), f (B, s), ω (B,)."""
        s = int(self.s)
        rhs, x = S.entry(rhs, x0)
        nb = rhs.shape[1]
        dtype, device = rhs.dtype, rhs.device
        r, rr0 = fv.residual_dot(rhs, A, x)
        norm_rhs, res = S.fetch(torch.sqrt(torch.abs(fv.col_dots(rhs, rhs))),
                                torch.sqrt(torch.abs(rr0)))
        cols = S.Columns(self, norm_rhs, res)
        tiny = torch.finfo(dtype).tiny
        guard = bool(self.guard)
        fetch_steps = guard or self.record_history
        G = S.stack([torch.zeros_like(rhs)] * s)
        U = S.stack([torch.zeros_like(rhs)] * s)
        eye = torch.eye(s, dtype=dtype, device=device)
        M = eye.repeat(nb, 1, 1)
        om = torch.ones_like(rr0)
        idx = torch.arange(s, device=device)
        while True:
            act = cols.actives()
            if not any(act):
                break
            ma = cols.mask(act, om)
            f = (P @ r).T                               # (B, s)
            alive = list(act)
            trip_rho, trip_om, nan_seen = ([False] * nb for _ in range(3))
            took = [0] * nb
            for k in range(s):
                mask = idx >= k
                Mk = torch.where(mask[:, None] & mask[None, :], M, eye)
                fk = torch.where(mask, f, torch.zeros_like(f))
                c = dev.small_solve(Mk, fk)   # zeros for i < k
                v = precond(r - S.combine(c, G))
                u = om * v + S.combine(c, U)
                g = dev.spmv(A, u)
                for i in range(k):
                    al = (P[i] @ g) / M[:, i, i]
                    g = g - al * G[i]
                    u = u - al * U[i]
                G[k] = torch.where(ma, g, G[k])
                U[k] = torch.where(ma, u, U[k])
                M[:, :, k] = S.where_rows(ma, (P @ g).T, M[:, :, k])
                beta = f[:, k] / _safe(M[:, k, k])
                x_n, r_n, rr_k = fv.xr_update(beta, U[k], G[k], x, r)
                f_n = f - beta[:, None] * M[:, :, k]
                if not fetch_steps:
                    x, r = S.commit(ma, (x_n, r_n), (x, r))
                    f = S.where_rows(ma, f_n, f)
                    took = [t + int(a) for t, a in zip(took, act)]
                    continue
                mkk, res_k = S.fetch(M[:, k, k], torch.sqrt(torch.abs(rr_k)))
                oks = []
                for b in range(nb):
                    if not act[b]:
                        oks.append(False)
                        continue
                    if guard:
                        bad = H.bad_denom(mkk[b], tiny)
                        trip_rho[b] |= alive[b] and bad
                        nan_seen[b] |= alive[b] and not math.isfinite(res_k[b])
                        step_ok = alive[b] and not bad \
                            and math.isfinite(res_k[b])
                    else:
                        step_ok = True
                    if step_ok:
                        cols.res[b] = res_k[b]
                    self._hist_put(cols.hist[b], cols.its[b] + k,
                                   res_k[b] / cols.scale[b], keep=step_ok)
                    took[b] += int(step_ok)
                    alive[b] = step_ok
                    oks.append(step_ok)
                m = cols.mask(oks, om)
                x, r = S.commit(m, (x_n, r_n), (x, r))
                f = S.where_rows(m, f_n, f)
            # dimension-reduction step into the next Sonneveld space
            v = precond(r)
            t, tt, _, tr = dev.spmv_dots(A, v, r)
            om_n = tr / _safe(tt)
            x_n, r_n, rr_n = fv.xr_update(om_n, v, t, x, r)
            tt_h, res_n = S.fetch(tt, torch.sqrt(torch.abs(rr_n)))
            oks = []
            for b in range(nb):
                if not act[b]:
                    oks.append(False)
                    continue
                if guard:
                    bad = H.bad_denom(tt_h[b], tiny)
                    trip_om[b] |= alive[b] and bad
                    nan_seen[b] |= alive[b] and not math.isfinite(res_n[b])
                    fin_ok = alive[b] and not bad and math.isfinite(res_n[b])
                else:
                    fin_ok = True
                if fin_ok:
                    cols.res[b] = res_n[b]
                self._hist_put(cols.hist[b], cols.its[b] + s,
                               res_n[b] / cols.scale[b], keep=fin_ok)
                took[b] += int(fin_ok)
                if guard:
                    self._guard_step(cols.hs[b],
                                     cols.its[b] + max(took[b] - 1, 0),
                                     cols.res[b] / cols.scale[b],
                                     ((H.BREAKDOWN_RHO, trip_rho[b]),
                                      (H.BREAKDOWN_OMEGA, trip_om[b]),
                                      (H.NAN, nan_seen[b])))
                cols.its[b] += took[b]
                oks.append(fin_ok)
            m = cols.mask(oks, om)
            x, r, om = S.commit(m, (x_n, r_n, om_n), (x, r, om))
        return cols.result(x)
