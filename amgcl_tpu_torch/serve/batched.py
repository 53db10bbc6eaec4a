"""Stacked (n, B) solves: the stacked entry of every Krylov solver, block
CG, the per-column health decode and the bucket's CUDA graph
(counterpart of ``amgcl_tpu/serve/batched.py``).

The JAX package retires B right-hand sides in one compiled program by
vmapping each solver's 1-D body over the columns, with its Pallas kernels
turned off for the stacked trace (their shapes are exact 1-D ones). The
port keeps its hand kernels and goes the other way: every operator and
preconditioner application of a stacked solve runs column by column
through the same 1-D path a single right-hand side takes
(``ops/device.py``, ``models/amg.apply_columns``), the Krylov vector
tier works on the (n, B) block in torch, and the loop fetches the B
columns' scalars in one host sync an iteration (``solver/stacked.py``).

* :func:`stacked_solve` — the counterpart of ``vmap_solve``: a solver's
  ``solve`` on stacked operands, iterations and residuals as (B,) arrays.
* :class:`StackedPrecond` — a bundle's preconditioner on (n, B) blocks.
  On the card the per-column apply of one (n, B, dtype) bucket is
  captured once as a CUDA graph, from a static (B, n) input to a static
  (B, n) output, and every later application replays it: the
  counterpart of the JAX package's resident program per (shape, B)
  bucket (``amgcl_tpu/serve/service.py:235-239``).
* :class:`BlockCG` — block CG over one shared Krylov subspace (O'Leary).
* :func:`decode_batched_health` — per-column guard states as the
  ``SolveReport.health`` dict of a stacked solve.

Batched hand kernels, which would read each operator once for the B
columns as the JAX package's batched DIA/ELL branches do, are later work
(ROADMAP).
"""

from __future__ import annotations

import math
import threading
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from amgcl_tpu_torch.models.amg import apply_columns, host_sync_reason
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops import dia_kernels as dk
from amgcl_tpu_torch.ops import fused_vec as fv
from amgcl_tpu_torch.solver import stacked as S
from amgcl_tpu_torch.telemetry import health as H
from amgcl_tpu_torch.telemetry.history import HistoryMixin

#: lowering tags of a stacked solve (the JAX package's is "xla-batched"):
#: the preconditioner of each bucket replayed as a CUDA graph, applied
#: column by column without a graph (a preconditioner that syncs with the
#: host), or column by column on the CPU
GRAPH = "per-column-graph"
UNCAPTURED = "per-column-uncaptured"
PER_COLUMN = "per-column"


def lowering_kind(device, hier=None):
    """The lowering a stacked solve takes: :data:`GRAPH`,
    :data:`UNCAPTURED` (``hier`` syncs with the host,
    :func:`~amgcl_tpu_torch.models.amg.host_sync_reason`) or
    :data:`PER_COLUMN` (the CPU)."""
    if torch.device(device).type != "cuda":
        return PER_COLUMN
    return UNCAPTURED if hier is not None and host_sync_reason(hier) \
        else GRAPH


def stacked_solve(solver, A, precond, rhs, x0=None, **kw):
    """Solve ``A x[:, b] = rhs[:, b]`` for every column of a stacked
    (n, B) rhs (the counterpart of ``vmap_solve``): ``x`` is (n, B),
    ``iters`` and ``resid`` (B,) numpy arrays, then the solver's other
    slots (the :class:`~amgcl_tpu_torch.telemetry.health.StackedHealth`,
    and the per-column histories when recording). ``precond`` maps an
    (n, B) block to an (n, B) block; ``kw`` goes to ``solver.solve``."""
    got = solver.solve(A, precond, rhs, x0, **kw)
    return (got[0], np.asarray(got[1]), np.asarray(got[2])) + tuple(got[3:])


def decode_batched_health(flags, first_it):
    """Per-column guard states (``flags`` (B,), ``first_it``
    (B, N_FLAGS)) as the ``SolveReport.health`` dict of a stacked solve:
    the headline fields decode the union of the columns' trips (one bad
    column shows on the batch report), ``per_rhs`` holds each column's
    decode and ``unhealthy_rhs`` the columns that tripped."""
    flags = np.asarray(flags)
    first_it = np.asarray(first_it)
    per = [H.decode(int(flags[b]), first_it[b])
           for b in range(flags.shape[0])]
    union = 0
    for b in range(flags.shape[0]):
        union |= int(flags[b])
    fi = np.where((first_it >= 0).any(axis=0),
                  np.where(first_it < 0, np.iinfo(np.int32).max,
                           first_it).min(axis=0), -1)
    out = H.decode(union, fi)
    out["per_rhs"] = per
    out["unhealthy_rhs"] = [b for b, p in enumerate(per) if not p["ok"]]
    return out


def _origin(exc):
    """``file:line (function)`` of the code that made a capture fail: the
    innermost traceback frame outside torch itself, searched from the
    first exception of ``exc``'s chain (a failed capture's own error is
    often followed by the graph's end-of-capture one); None if none."""
    chain = []
    while exc is not None and exc not in chain:
        chain.append(exc)
        exc = exc.__cause__ or exc.__context__
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "/torch/" not in f.filename.replace("\\", "/")]
        if frames:
            f = frames[-1]
            path = f.filename.replace("\\", "/")
            path = path[path.rindex("amgcl_tpu_torch"):] \
                if "amgcl_tpu_torch" in path else path.rsplit("/", 1)[-1]
            return "%s:%d (%s)" % (path, f.lineno, f.name)
    return None


#: the side stream every StackedPrecond warms and captures its buckets on,
#: one per device. A stream's first cuBLAS call (the coarse level's
#: matmul) gives it a workspace (32 MiB on Hopper) that lives as long as
#: the process: a side stream for each preconditioner would leave one
#: behind at every readmission of a released bundle (serve/farm.py)
_CAPTURE_STREAMS = {}
#: held by every bucket capture, so that one capture at a time uses the
#: stream, and by ``make_solver``'s construction and rebuild: torch
#: refuses a pageable host-to-device copy in one thread while another
#: captures, so a setup (a farm registration in the caller's thread)
#: waits for a capture in the dispatch thread to end, and the reverse
CAPTURE_LOCK = threading.RLock()


def _capture_stream(device):
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    side = _CAPTURE_STREAMS.get(device)
    if side is None:
        side = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return side


class _Bucket:
    """One captured bucket: the graph and its static (B, n) buffers."""

    def __init__(self, graph, inp, out):
        self.graph = graph
        self.inp = inp
        self.out = out


class StackedPrecond:
    """A preconditioner on (n, B) blocks, column by column through the
    1-D ``apply`` (a map of a residual vector in the Krylov dtype to a
    correction): on the card, with a hierarchy that does not sync with
    the host, each (n, B, dtype) bucket is captured once as a CUDA graph
    and replayed at every later call; elsewhere the columns run eagerly
    (:func:`lowering_kind` names which). ``captures``, ``capture_s`` and
    ``replays`` count per bucket size B. One lock serializes the copy
    into a bucket's static input, its replay and the copy out, so callers
    on several threads (a service's worker and ``solve_batch``) share
    the buckets."""

    def __init__(self, apply, hier, device):
        self.apply = apply
        self.hier = hier
        self.device = torch.device(device)
        self.lowering = lowering_kind(self.device, hier)
        self.reason = host_sync_reason(hier)
        self.captures = {}
        self.capture_s = {}
        self.replays = {}
        self.lock = threading.Lock()
        self._buckets = {}
        #: the capture stream this preconditioner's buckets were captured
        #: on (the device's, shared), set at the first capture
        self._stream = None

    def eager(self, r):
        """The per-column apply without a graph (the graph's reference)."""
        return apply_columns(self.apply, r)

    def __call__(self, r):
        if self.lowering != GRAPH:
            return self.eager(r)
        rows = dev.columns(r)
        with self.lock:
            bk = self._bucket(rows.shape[1], rows.shape[0], rows.dtype)
            bk.inp.copy_(rows)
            bk.graph.replay()
            self.replays[rows.shape[0]] = \
                self.replays.get(rows.shape[0], 0) + 1
            return bk.out.clone().T

    @property
    def capture_total_s(self):
        return sum(self.capture_s.values())

    def _bucket(self, n, B, dtype):
        key = (n, B, dtype)
        bk = self._buckets.get(key)
        if bk is None:
            bk = self._buckets[key] = self._capture(n, B, dtype)
        return bk

    def _capture(self, n, B, dtype):
        """Warm the per-column apply on the device's capture stream
        (whatever a first launch makes once, as the dot kernels' ticket
        of that stream, is made there, outside the capture), then capture
        it from the static input to the static output; one capture at a
        time uses the stream."""
        with CAPTURE_LOCK:
            return self._capture_on(_capture_stream(self.device), n, B,
                                    dtype)

    def _capture_on(self, side, n, B, dtype):
        t0 = time.perf_counter()
        self._stream = side
        dk.ensure_ticket(side)
        inp = torch.zeros((B, n), dtype=dtype, device=self.device)
        out = torch.empty_like(inp)

        def body():
            for b in range(B):
                out[b].copy_(self.apply(inp[b]))

        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                body()
        except Exception as e:
            where = _origin(e)
            raise RuntimeError(
                "capturing the stacked preconditioner apply of %s in a CUDA "
                "graph failed%s: %s" % (type(self.hier).__name__,
                                        " in " + where if where else "",
                                        e)) from e
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.captures[B] = self.captures.get(B, 0) + 1
        self.capture_s[B] = self.capture_s.get(B, 0.0) \
            + time.perf_counter() - t0
        return _Bucket(graph, inp, out)


def _safe_gram_solve(M, R):
    """Solve the (B, B) Gram system M X = R with a relative jitter on the
    diagonal: near convergence the residual columns shrink together and
    M approaches singular; the jitter keeps the update finite while the
    per-column masking freezes converged iterates."""
    B = M.shape[0]
    scale = torch.trace(torch.abs(M)) / B
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    eps = torch.finfo(M.dtype).eps
    eye = torch.eye(B, dtype=M.dtype, device=M.device)
    return torch.linalg.solve_ex(M + (eps * scale) * eye, R)[0]


def _mm(P, C):
    """``P @ C`` for an (n, B) block and a (B, B) matrix, as the (n, B)
    view of a (B, n) block."""
    return (C.T @ P.T).T


@dataclass
class BlockCG(HistoryMixin):
    """Block conjugate gradients over one shared Krylov subspace (O'Leary
    1980; amgcl_tpu/serve/batched.py:147-284): all B columns contribute
    search directions, the per-step coefficients are (B, B) Gram solves
    (:func:`~amgcl_tpu_torch.ops.fused_vec.block_dots`). Where the
    right-hand sides share spectral content it needs fewer iterations
    than B independent CG solves.

    Takes an (n,) or stacked (n, B) rhs and iterates the block as a
    whole. A converged column's iterate freezes while its residual keeps
    riding the shared subspace (dropping it would make the Gram system
    singular). Guards: NaN per column; a non-finite Gram step
    (BREAKDOWN_ALPHA) ends the block, as the subspace is shared. Returns
    ``(x, iters, resid, health)`` with per-column lists and a
    :class:`~amgcl_tpu_torch.telemetry.health.StackedHealth` for a
    stacked rhs (the 1-D solvers' slots for an (n,) rhs), the per-column
    histories appended when recording. Each iteration fetches the B
    residual norms and the step's finiteness in one host sync."""

    maxiter: int = 100
    tol: float = 1e-8
    abstol: float = 0.0
    record_history: bool = False
    guard: bool = True

    def solve(self, A, precond, rhs, x0=None):
        squeeze = rhs.dim() == 1
        R0 = S.block(rhs[:, None] if squeeze else rhs)
        X = torch.zeros_like(R0) if x0 is None \
            else S.block(x0[:, None] if squeeze else x0)
        B = R0.shape[1]

        def col_norms(V):
            return torch.sqrt(torch.abs(fv.col_dots(V, V)))

        R = dev.residual(R0, A, X)
        nb, res = S.fetch(col_norms(R0), col_norms(R))
        scale = [v if v > 0 else 1.0 for v in nb]
        eps = [max(self.tol * s, self.abstol) for s in scale]
        Z = precond(R)
        P = Z
        rho = fv.block_dots(Z.T, R.T)                        # (B, B)
        its = [0] * B
        flags = np.zeros(B, np.int64)
        first = np.full((B, H.N_FLAGS), -1, np.int64)
        hist = [self._hist_init() for _ in range(B)]
        fatal = False
        it = 0
        while not fatal:
            active = np.array([res[b] > eps[b] and its[b] < self.maxiter
                               for b in range(B)])
            if not active.any():
                break
            Q = dev.spmv(A, P)
            M = fv.block_dots(P.T, Q.T)                      # Pᵀ A P
            alpha = _safe_gram_solve(M, rho)
            Xn = X + _mm(P, alpha)
            Rn = R - _mm(Q, alpha)
            res_t = col_norms(Rn)
            Zn = precond(Rn)
            rho_n = fv.block_dots(Zn.T, Rn.T)
            beta = _safe_gram_solve(rho, rho_n)
            Pn = Zn + _mm(P, beta)
            fin = torch.isfinite(res_t + torch.abs(torch.diagonal(alpha))) \
                .all().to(res_t.dtype)
            res_n, (step_ok,) = S.fetch(res_t, fin)
            step_ok = step_ok > 0
            if self.guard:
                col_nan = np.array([not math.isfinite(v) for v in res_n]) \
                    & active
                flags[col_nan] |= H.NAN
                H._trip_first(first, H.NAN, col_nan, it)
                bkdn = active & (not step_ok)
                flags[bkdn] |= H.BREAKDOWN_ALPHA
                H._trip_first(first, H.BREAKDOWN_ALPHA, bkdn, it)
                fatal = (not step_ok) or bool(np.all(col_nan | ~active))
                commit = active & ~col_nan & step_ok
            else:
                commit = active & step_ok
            # converged or broken columns freeze their iterate; the block
            # state (R, P, Z, rho) advances as a whole
            X = torch.where(S.Columns.mask(commit.tolist(), X), Xn, X)
            for b in np.flatnonzero(commit):
                res[b] = res_n[b]
                its[b] += 1
                self._hist_put(hist[b], it, res_n[b] / scale[b])
            R, P, Z, rho = Rn, Pn, Zn, rho_n
            it += 1
        X = torch.where(S.Columns.mask([v > 0 for v in nb], X), X,
                    torch.zeros_like(X))
        rel = [r / s for r, s in zip(res, scale)]
        states = [H.HealthState(prev_res=rel[b], best_res=rel[b],
                                flags=int(flags[b]),
                                first_it=[int(v) for v in first[b]])
                  for b in range(B)]
        if squeeze:
            out = (X[:, 0], its[0], rel[0], states[0] if self.guard else None)
            return out + (hist[0],) if self.record_history else out
        out = (X, its, rel, H.StackedHealth(states) if self.guard else None)
        return out + (hist,) if self.record_history else out
