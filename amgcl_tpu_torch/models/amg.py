"""The AMG hierarchy: construction, device-side V/W-cycle.

Counterpart of ``amgcl_tpu/models/amg.py`` (reference:
amgcl/amg.hpp:63-557). On a CUDA device the stencil levels of a
structured problem are built on the device (``ops/stencil_device.py``)
and the host loop continues from the first level whose stencil has grown
past the diagonal-pair regime; otherwise the hierarchy is built level by
level on the host in CSR (do_init loop, amg.hpp:467-512) and each level's
operator, transfer operators and smoother state move to the device as
tensors. ``apply`` runs the multigrid cycle (amg.hpp:514-553) eagerly on
the device, through the fused whole-leg kernels (``ops/vcycle.py``) at
every level that has them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from amgcl_tpu_torch.coarsening.smoothed_aggregation import \
    SmoothedAggregation
from amgcl_tpu_torch.coarsening.stall import CoarseningStall
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.csr import CSR
from amgcl_tpu_torch.ops.densewin import DenseWindowMatrix
from amgcl_tpu_torch.ops.segment_spgemm import ensure_plan
from amgcl_tpu_torch.ops.structured import build_implicit_transfers
from amgcl_tpu_torch.ops.unstructured import WindowedEllMatrix
from amgcl_tpu_torch.ops.vcycle import build_fused_down, build_fused_up
from amgcl_tpu_torch.relaxation.spai0 import Spai0
from amgcl_tpu_torch.solver.direct import DenseDirectSolver
from amgcl_tpu_torch.telemetry.ledger import dense_window_budget
from amgcl_tpu_torch.telemetry.structure import fingerprint, reorder_plan
from amgcl_tpu_torch.utils.adapters import permute
from amgcl_tpu_torch.utils.devices import (held_tensors, resolve_device,
                                           storage_bytes)


@dataclass
class AMGParams:
    """Hierarchy parameters (reference: amg::params, amgcl/amg.hpp:93-182)."""
    coarsening: Any = field(default_factory=SmoothedAggregation)
    relax: Any = field(default_factory=Spai0)
    coarse_enough: int = 3000
    direct_coarse: bool = True
    max_levels: int = 100
    npre: int = 1
    npost: int = 1
    ncycle: int = 1          # 1 = V-cycle, 2 = W-cycle
    pre_cycles: int = 1      # cycles per preconditioner application
    dtype: torch.dtype = torch.float32
    matrix_format: str = "auto"   # device format for level operators


class Level:
    """Device-resident state of one hierarchy level. ``down``/``up`` are
    the fused whole-leg handles (``ops/vcycle.py``), or None where the
    level is not eligible and the cycle composes its legs."""

    def __init__(self, A, relax, P=None, R=None, down=None, up=None):
        self.A = A          # device matrix (level operator)
        self.relax = relax  # smoother state (None on the coarsest level)
        self.P = P          # prolongation to this level from the next coarser
        self.R = R          # restriction to the next coarser level
        self.down = down
        self.up = up


class Hierarchy:
    """Levels plus the coarse solver; ``apply`` is the preconditioner."""

    def __init__(self, levels, coarse, npre=1, npost=1, ncycle=1,
                 pre_cycles=1):
        self.levels = list(levels)
        self.coarse = coarse
        self.npre = int(npre)
        self.npost = int(npost)
        self.ncycle = int(ncycle)
        self.pre_cycles = int(pre_cycles)

    def cycle(self, i, f):
        """One multigrid cycle at level i for rhs f, zero initial guess
        (reference: amgcl/amg.hpp:514-553)."""
        lv = self.levels[i]
        if i == len(self.levels) - 1:
            if self.coarse is not None:
                return self.coarse.solve(f)
            return lv.relax.apply(lv.A, f)
        if self.npre == 1 and lv.down is not None and lv.down.w is not None:
            # whole down leg in one pass: pre-smooth from zero, residual,
            # filtered tentative restriction
            u, fc = lv.down.zero(f)
        else:
            if self.npre > 0:
                u = lv.relax.apply(lv.A, f)      # first pre-sweep from zero
                for _ in range(self.npre - 1):
                    u = lv.relax.apply_pre(lv.A, f, u)
            else:
                u = dev.clear(f)
            if lv.down is not None:
                fc = lv.down(f, u)   # one-pass residual + restriction
            else:
                fc = dev.spmv(lv.R, dev.residual(f, lv.A, u))
        uc = self.cycle(i + 1, fc)
        for _ in range(self.ncycle - 1):      # W-cycle: extra coarse visits
            rc = dev.residual(fc, self.levels[i + 1].A, uc)
            uc = uc + self.cycle(i + 1, rc)
        if lv.up is not None and self.npost >= 1:
            # one pass: prolong + correct + first post-smoothing sweep
            u = lv.up(f, u, uc)
            extra = self.npost - 1
        else:
            u = u + dev.spmv(lv.P, uc)
            extra = self.npost
        for _ in range(extra):
            u = lv.relax.apply_post(lv.A, f, u)
        return u

    def apply(self, r):
        """Preconditioner application (amg.hpp:288-297): pre_cycles
        cycles. A stacked (n, B) residual runs column by column through
        the 1-D cycle (:func:`apply_columns`), fused legs included."""
        if r.dim() == 2:
            return apply_columns(self.apply, r)
        x = self.cycle(0, r)
        for _ in range(self.pre_cycles - 1):
            rr = dev.residual(r, self.levels[0].A, x)
            x = x + self.cycle(0, rr)
        return x

    @property
    def system_matrix(self):
        return self.levels[0].A

    def bytes(self) -> int:
        """Device bytes of operators, transfers, smoother states and the
        coarse inverse."""
        total = 0
        for lv in self.levels:
            for part in (lv.A, lv.P, lv.R):
                total += part.bytes() if part is not None else 0
            if lv.relax is not None:
                total += lv.relax.bytes()
        if self.coarse is not None:
            total += self.coarse.inv.numel() * self.coarse.inv.element_size()
        return total


def apply_columns(apply, r):
    """The 1-D preconditioner ``apply`` on a stacked (n, B) residual,
    column by column: the port's counterpart of ``jax.vmap(apply)``,
    which the JAX package gives every preconditioner (its stacked trace
    takes XLA lowerings; the port's hand kernels take each column as a
    contiguous vector, ``ops/device.py``). Returns the (n, B) view of
    the (B, n) stack of the columns' results."""
    return dev.stacked(dev.per_column(apply, r))


def host_sync_reason(hier):
    """Why ``hier.apply`` cannot be captured in a CUDA graph, or None: a
    hierarchy that syncs with the host (a nested Krylov solve, the Schur
    correction's inner solves) says so in ``host_sync``, and a wrapper
    (deflation, CPR) inherits its inner hierarchy's reason."""
    reason = getattr(hier, "host_sync", None)
    if reason:
        return "%s: %s" % (type(hier).__name__, reason)
    for name in ("base", "p_hier", "inner"):
        sub = getattr(hier, name, None)
        if sub is not None and hasattr(sub, "apply"):
            got = host_sync_reason(sub)
            if got:
                return got
    return None


def _human_bytes(n: float) -> str:
    for unit in ("B", "K", "M", "G"):
        if n < 1024 or unit == "G":
            return "%.2f %s" % (n, unit)
        n /= 1024.0


def check_dtype(dtype):
    """Refuse a dtype the port has no kernels for, rather than running in
    another: float16 hierarchies are ROADMAP A.15, complex values the
    complex-values item of queue A. bfloat16 passes: a hierarchy takes
    it (a Krylov loop does not, :func:`check_krylov_dtype`)."""
    dtype = torch.empty((), dtype=dtype).dtype
    if dtype.is_complex:
        raise NotImplementedError(
            "complex values (%s) are not ported yet (ROADMAP A.8, complex "
            "values)" % dtype)
    if dtype.itemsize < 4 and dtype != torch.bfloat16:
        raise NotImplementedError(
            "%s hierarchies are not ported yet (ROADMAP A.15, float16 "
            "hierarchies)" % dtype)
    return dtype


def check_krylov_dtype(dtype):
    """:func:`check_dtype`, and refuse a bfloat16 Krylov loop: it needs
    the bfloat16 modes of the Krylov kernels (B.3–B.5, B.10), which are
    ROADMAP B.17. A bfloat16 hierarchy runs under a float32 loop
    (``solver_dtype=torch.float32``)."""
    dtype = check_dtype(dtype)
    if dtype == torch.bfloat16:
        raise NotImplementedError(
            "a bfloat16 Krylov loop is not ported yet (ROADMAP B.17, the "
            "bfloat16 modes of B.3-B.5 and B.10); keep the hierarchy in "
            "bfloat16 and pass solver_dtype=torch.float32")
    return dtype


def check_reorder(mode):
    """Refuse a ``reorder`` other than "auto", "rcm", "cm" or "off"."""
    if mode not in ("auto", "rcm", "cm", "off"):
        raise ValueError("reorder must be 'auto', 'rcm', 'cm' or 'off', "
                         "got %r" % (mode,))
    return mode


def device_mis_declined(prm):
    """Why the device MIS cannot aggregate this configuration, or None.
    Its rounds leave single-node aggregates wherever a node's strong
    neighbours were taken by other roots: the nullspace QR of a
    near-nullspace of several vectors refuses those, so the hierarchy
    would stop at one level, and the coarse levels, numbered by root
    priority, spread the band past the dense window's width rule. Such
    configurations build their host loop with the host setup: the
    greedy pass and the host plans."""
    if prm.matrix_format == "dwin":
        return "matrix_format='dwin': coarse levels numbered by root " \
            "priority outgrow the dense window's width rule"
    coarsening = prm.coarsening
    while coarsening is not None:
        ns = getattr(coarsening, "nullspace", None)
        if ns is not None and np.ndim(ns) == 2 and np.shape(ns)[1] > 1:
            return "a near-nullspace of %d vectors: the QR refuses the " \
                "MIS's single-node aggregates" % np.shape(ns)[1]
        coarsening = getattr(coarsening, "base", None)
    return None


def check_coarse_size(n, prm):
    """Refuse to densify a coarsest level of ``n`` scalar unknowns far
    above the direct-solve regime (coarsening stalled): an error beats
    running out of memory."""
    if prm.direct_coarse and n > max(4 * prm.coarse_enough, 20000):
        raise RuntimeError(
            "coarsening stalled at %d unknowns (> coarse_enough=%d); "
            "cannot build a dense coarse solver this large — adjust "
            "coarsening parameters or set direct_coarse=False"
            % (n, prm.coarse_enough))


class AMG:
    """Builds and owns the device hierarchy.

    ``device=None`` means CUDA; without a card that raises unless the
    caller asks for ``device="cpu"``. ``device_setup`` chooses where the
    setup runs — the JAX package's ``AMGCL_TPU_DEVICE_SETUP``: None runs
    it on the device when that is CUDA and on the host otherwise; True
    or False force either. On the device, the stencil levels are built
    there, plain aggregates come from the device MIS, and the Galerkin
    products and the smoothed prolongation run as segment sums against
    cached plans (``ops/segment_spgemm.py``); a configuration outside
    those gates takes the host route all the same, and one the device
    MIS cannot serve (``device_mis_declined``, the reason kept as
    ``mis_declined``) builds its host loop with the host setup.
    ``reorder`` is the JAX package's ``AMGCL_TPU_REORDER``, whose default
    there is ``"auto"``; here it is ``"off"`` (the order is kept), since
    no workload of the port has yet shown a gain from it. ``"auto"``
    permutes a scalar fine operator that the stencil build declined when
    the structure advisor predicts at least a 1.15× byte gain
    (``telemetry/structure.reorder_plan``), ``"rcm"``/``"cm"`` force that
    variant; the hierarchy then lives in the permuted frame
    (``make_solver`` permutes in and out). ``device_inv``
    (``AMGCL_TPU_DEVICE_INV``) inverts a float32 or bfloat16 coarsest
    level on the device (``solver/direct.py``). Usage::

        P = AMG(A, AMGParams(...), device="cuda")
        z = P.hierarchy.apply(r)
    """

    def __init__(self, A, prm: Optional[AMGParams] = None, device=None,
                 device_setup=None, reorder="off", device_inv=False):
        self.prm = prm or AMGParams()
        check_dtype(self.prm.dtype)
        self.device = resolve_device(device)
        self.device_setup = self.device.type == "cuda" \
            if device_setup is None else bool(device_setup)
        self.reorder = check_reorder(reorder)
        self.device_inv = bool(device_inv)
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        self._build(A)

    def _build(self, A: CSR):
        """reference: amgcl/amg.hpp:467-512 do_init, with the device-setup
        prefix of amgcl_tpu/models/amg.py:235-267"""
        prm = self.prm
        t0 = time.perf_counter()
        self.device_built = False
        self._dev_prefix = []
        self._level_ctx = []
        self._reorder = None
        meta_prefix = []
        # per-build state (eps_strong decay, grid dims, setup dtype, the
        # setup's device) lives in this dict, not on the policy object
        # a configuration the device MIS cannot serve builds its host
        # loop with the host setup (greedy pass, host plans)
        self.mis_declined = device_mis_declined(prm) \
            if self.device_setup else None
        ctx = {"setup_device": self.device if self.device_setup
               and self.mis_declined is None else None}
        t_dev = 0.0            # seconds of the device build that was kept
        # the device build takes scalar stencils; block systems build on
        # the host
        if self.device_setup and not A.is_block:
            from amgcl_tpu_torch.ops import stencil_device as sdev
            got = sdev.device_build(A, prm, self.device, self.device_inv)
            if got is not None:
                self.device_built = True
                t_dev = time.perf_counter() - t0
                meta_rows = [(m, None, None) for m in got["meta"]]
                # row 0 is the real fine-level CSR: consumers read
                # host_levels[0][0] as the system matrix
                meta_rows[0] = (A, None, None)
                if got["leftover"] is None:
                    self.hierarchy = Hierarchy(
                        got["levels"], got["coarse"], prm.npre, prm.npost,
                        prm.ncycle, prm.pre_cycles)
                    self.host_levels = meta_rows
                    self._setup_done(t0, t_dev)
                    return
                # hybrid: the stencil grew past the diagonal-pair regime;
                # the host loop continues from the fetched coarse level
                self._dev_prefix = got["levels"]
                meta_prefix = meta_rows[:-1]
                A = got["leftover"]
                ctx["eps_strong"] = got["eps_next"]
        if not self.device_built and not A.is_block:
            # the executed reorder (amgcl_tpu/models/amg.py:268-295): the
            # whole hierarchy is built in the permuted frame
            plan = reorder_plan(A, self.reorder, prm.dtype.itemsize)
            if plan is not None:
                A = permute(A, plan["perm"])
                self._reorder = plan
        coarsening = prm.coarsening
        if prm.dtype.itemsize <= 4 \
                and getattr(coarsening, "setup_dtype", False) is None:
            # a <=32-bit device hierarchy lets the stencil setup algebra
            # run in float32 — same convergence, half the memory traffic
            ctx["setup_dtype"] = np.float32
        host = []
        Acur = A
        # coarse_enough counts scalar unknowns (amgcl_tpu/models/amg.py:314)
        while (Acur.nrows * Acur.block_size[0] > prm.coarse_enough
               and len(meta_prefix) + len(host) + 1 < prm.max_levels):
            try:
                P, R = coarsening.transfer_operators(Acur, ctx)
            except CoarseningStall:
                break     # expected terminal condition: close here
            if P.ncols == 0 or P.ncols >= Acur.ncols:
                break     # coarsening stalled
            # the context the Galerkin product saw (the coarse grid dims
            # among it), kept for a numeric rebuild to match this build
            self._level_ctx.append(dict(ctx))
            Ac = coarsening.coarse_operator(Acur, P, R, ctx)
            host.append((Acur, P, R))
            Acur = Ac
        host.append((Acur, None, None))
        self.host_levels = meta_prefix + host
        self._to_device_levels()
        self._setup_done(t0, t_dev)

    def _setup_done(self, t0, t_dev):
        """Setup wall time, and its split between the device build and
        the host loop with the move to the device."""
        self.setup_seconds = time.perf_counter() - t0
        self.setup_split = {"device_build_s": t_dev,
                            "host_s": self.setup_seconds - t_dev}

    def rebuild(self, A):
        """Numeric-only rebuild for time-dependent problems: the matrix
        values changed, the sparsity pattern did not (reference:
        amg::rebuild, amgcl/amg.hpp:229-269; amgcl_tpu/models/amg.py:
        339-445). ``A`` is a CSR (or scipy matrix) with the same pattern,
        or just the new value array. A hierarchy built wholly or partly
        on the device redoes its build; a host-built one reruns only the
        Galerkin products on the kept transfer operators, rebuilds the
        smoother states and keeps the device transfer operators."""
        old0 = self.host_levels[0][0]
        # a reordered hierarchy holds the permuted operator, while a
        # caller hands back values in the original order: val_perm maps
        # them into the hierarchy's frame (amgcl_tpu/models/amg.py:355-392)
        plan = self._reorder
        if isinstance(A, np.ndarray):
            if A.shape != old0.val.shape:
                raise ValueError(
                    "rebuild(new_vals): value array shape %r does not "
                    "match the operator's %r" % (A.shape, old0.val.shape))
            vals = np.asarray(A)
            if plan is not None:
                vals = vals[plan["val_perm"]]
            A = CSR(old0.ptr, old0.col, vals, old0.ncols)
            same_pattern = True
        else:
            if not isinstance(A, CSR):
                A = CSR.from_scipy(A)
            if A.shape != old0.shape:
                raise ValueError(
                    "rebuild requires the same matrix dimensions")
            if plan is not None and A.nnz == old0.nnz \
                    and not (A.ptr is old0.ptr and A.col is old0.col) \
                    and fingerprint(A) == plan["fingerprint"]:
                # an original-order CSR: its values into the frame
                A = CSR(old0.ptr, old0.col,
                        np.asarray(A.val)[plan["val_perm"]], old0.ncols)
            same_pattern = A.nnz == old0.nnz and (
                (A.ptr is old0.ptr and A.col is old0.col)
                or (np.array_equal(A.ptr, old0.ptr)
                    and np.array_equal(A.col, old0.col)))
        on_device = self.device_built or self._dev_prefix
        if not (same_pattern or on_device):
            raise ValueError(
                "rebuild requires the same sparsity pattern (values-only "
                "update); construct a new AMG for structural changes")
        if same_pattern:
            # caches of the pattern alone carry over
            for attr in ("_rows_cache", "_dia_offsets_cache", "_grid_dims"):
                if not hasattr(A, attr) and hasattr(old0, attr):
                    setattr(A, attr, getattr(old0, attr))
        if on_device:
            # device-built and hybrid hierarchies redo the (on-device)
            # build; the transfer structure comes out the same
            self._build(A)
            return
        t0 = time.perf_counter()
        coarse_operator = self.prm.coarsening.coarse_operator
        host = []
        Acur = A
        for (Ai, P, R), ctx in zip(self.host_levels[:-1], self._level_ctx):
            if isinstance(P, CSR):
                # a first rebuild pays each level's symbolic pass once
                # where the setup runs on the device (amgcl_tpu/models/
                # amg.py:421-445): every later one is numeric
                ensure_plan(Ai, P, R, force=ctx["setup_device"] is not None,
                            device=ctx["setup_device"])
            host.append((Acur, P, R))
            Acur = coarse_operator(Acur, P, R, dict(ctx))
        host.append((Acur, None, None))
        # a released hierarchy (release_device) has no device levels to
        # reuse: its transfers are converted again, the numeric pass on
        # the kept plans is the same
        old_levels = self.hierarchy.levels \
            if self.hierarchy is not None else None
        self.host_levels = host
        self._to_device_levels(reuse_transfers=old_levels)
        self._setup_done(t0, 0.0)

    def _to_device_levels(self, reuse_transfers=None):
        """Move the host levels to the device. ``reuse_transfers``: the
        previous build's device levels in a numeric rebuild, whose
        transfer operators (frozen by the rebuild contract) are kept
        instead of converted again."""
        prm = self.prm
        host = self.host_levels
        dtype, device = prm.dtype, self.device
        # one dense-window budget for the whole hierarchy: every level
        # conversion draws on it (amgcl_tpu/models/amg.py:465)
        budget = self._dwin_budget = dense_window_budget()
        levels = list(self._dev_prefix)    # device-built levels come first
        for i, (Ai, P, R) in enumerate(host[len(levels):-1],
                                       start=len(levels)):
            spec = getattr(P, "_implicit_spec", None)
            if reuse_transfers is not None:
                P_dev, R_dev = reuse_transfers[i].P, reuse_transfers[i].R
            elif spec is not None:
                # matrix-free smoothed transfers (ops/structured.py)
                P_dev, R_dev = build_implicit_transfers(
                    spec, dtype, device, prm.matrix_format)
            else:
                # stored transfers (block systems): banded block
                # operators take windowed ELL, as the level operators do
                P_dev = dev.to_device(P, "auto", dtype, device)
                R_dev = dev.to_device(R, "auto", dtype, device)
            A_dev = self._level_operator(Ai, i, reuse_transfers, budget)
            relax = prm.relax.build(Ai, dtype, device)
            dev.check_bf16_products(
                P_dev, R_dev, *dev.smoother_products(A_dev, relax))
            levels.append(Level(A_dev, relax, P_dev, R_dev,
                                build_fused_down(A_dev, R_dev, relax),
                                build_fused_up(A_dev, P_dev, relax)))
        Alast = host[-1][0]
        check_coarse_size(Alast.nrows * Alast.block_size[0], prm)
        A_last = self._level_operator(Alast, len(host) - 1,
                                      reuse_transfers, budget)
        if prm.direct_coarse:
            coarse = DenseDirectSolver.build(Alast, dtype, device,
                                             self.device_inv)
            levels.append(Level(A_last, None))
        else:
            coarse = None
            relax = prm.relax.build(Alast, dtype, device)
            dev.check_bf16_products(*dev.smoother_products(A_last, relax))
            levels.append(Level(A_last, relax))
        self.hierarchy = Hierarchy(levels, coarse, prm.npre, prm.npost,
                                   prm.ncycle, prm.pre_cycles)

    def _level_operator(self, Ai, i, reuse_transfers, budget):
        """Level i's device operator: in a numeric rebuild, the previous
        operator's structure with Ai's values where its format has a
        value-only route (``ops/device.refresh_values``), else Ai
        converted."""
        prm = self.prm
        if reuse_transfers is not None and i < len(reuse_transfers):
            M = dev.refresh_values(reuse_transfers[i].A, Ai, prm.dtype)
            if M is not None:
                return M
        return dev.to_device(Ai, prm.matrix_format, prm.dtype, self.device,
                             budget)

    # -- eviction and readmission (serve/farm.py's admission) -------------

    def _plan_segments(self):
        """The segment-sum plans' :class:`_Segments` on the host levels'
        transfers (each caches its index arrays on the device)."""
        out = []
        for _, P, _ in self.host_levels[:-1]:
            plan = getattr(P, "_seg_plan", None)
            if plan is not None:
                out.extend(plan.segments())
        return out

    def _device_state(self):
        """What :meth:`release_device` drops: the hierarchy (level
        operators, transfers, smoother states, fused-leg states, the
        coarse inverse), the device-built prefix and the plans' device
        copies of their index arrays."""
        return (self.hierarchy, self._dev_prefix,
                [seg._dev for seg in self._plan_segments()])

    def bytes(self) -> int:
        """Device bytes that :meth:`release_device` frees: each distinct
        storage under the hierarchy, the device-built prefix and the
        plans' cached index arrays, counted once
        (amgcl_tpu/models/amg.py:872-886 walks the hierarchy's leaves).
        0 while released: the farm pool's unit of a charge."""
        if self.hierarchy is None:
            return 0
        return storage_bytes(held_tensors(*self._device_state()),
                             self.device)

    def release_device(self):
        """Eviction (amgcl_tpu/models/amg.py:595-640): drop every device
        tensor this AMG holds — the hierarchy, the device-built prefix,
        the plans' device copies — and keep the host CSR levels and the
        plans, so that readmission is :meth:`rebuild`, never a fresh
        setup. :meth:`bytes` is 0 while released."""
        self.hierarchy = None
        self._dev_prefix = []
        self._dwin_budget = None
        for seg in self._plan_segments():
            seg.release_device()

    @property
    def device_resident(self) -> bool:
        return self.hierarchy is not None

    def readmit(self):
        """The device hierarchy again after :meth:`release_device`, by a
        rebuild with the kept fine operator's values (a no-op while
        resident): a hierarchy built on the device or reordered takes
        the CSR (the reordered one holds the permuted operator, which
        passes through untouched), a host-built one its values alone."""
        if self.device_resident:
            return
        A0 = self.host_levels[0][0]
        if self.device_built or self._reorder is not None:
            self.rebuild(A0)
        else:
            self.rebuild(A0.val)

    @property
    def reorder_plan(self):
        """The executed reorder's plan (``perm``, ``iperm``, ``val_perm``,
        ``variant``, ``fingerprint``, ``predicted_gain``), or None."""
        return self._reorder

    @property
    def dtype(self):
        return self.prm.dtype

    def hierarchy_stats(self):
        """Per-level rows/unknowns/nnz/device format (windowed ELL with
        its K and window, dense window with its window and bytes) plus
        grid and operator complexity — the source
        ``__repr__`` renders from. ``rows`` and ``nnz`` count blocks for a
        block system, ``unknowns`` scalar unknowns; the complexities count
        blocks, as the reference does."""
        host = self.host_levels
        nnz0 = max(host[0][0].nnz, 1)
        rows0 = max(host[0][0].nrows, 1)
        levels = []
        for i, ((Ai, _, _), lv) in enumerate(zip(host,
                                                 self.hierarchy.levels)):
            b = getattr(Ai, "block_size", (1, 1))
            row = {"level": i, "rows": int(Ai.nrows),
                   "unknowns": int(Ai.nrows) * b[0], "nnz": int(Ai.nnz),
                   "block": list(b), "format": type(lv.A).__name__}
            if isinstance(lv.A, WindowedEllMatrix):
                row.update(K=lv.A.K, win=lv.A.win)
            elif isinstance(lv.A, DenseWindowMatrix):
                row.update(win=lv.A.win, format_bytes=lv.A.bytes())
            levels.append(row)
        return {
            "n_levels": len(host),
            "operator_complexity": sum(h[0].nnz for h in host) / nnz0,
            "grid_complexity": sum(h[0].nrows for h in host) / rows0,
            "dtype": str(self.prm.dtype),
            "device": str(self.device),
            "bytes": int(self.hierarchy.bytes()),
            "setup_seconds": self.setup_seconds,
            "levels": levels,
        }

    def __repr__(self):
        st = self.hierarchy_stats()
        b = st["levels"][0]["block"]
        lines = [
            "Number of levels:    %d" % st["n_levels"],
            "Operator complexity: %.2f" % st["operator_complexity"],
            "Grid complexity:     %.2f" % st["grid_complexity"],
            "Memory footprint:    %s" % _human_bytes(st["bytes"]),
        ]
        if b != [1, 1]:
            lines.append("Block size:          %dx%d (nonzeros count "
                         "blocks)" % tuple(b))
        lines += [
            "",
            "level     unknowns       nonzeros  format",
            "-----------------------------------------",
        ]
        for lv in st["levels"]:
            fmt = lv["format"]
            if "K" in lv:
                fmt += " (K %d, window %d)" % (lv["K"], lv["win"])
            elif "win" in lv:
                fmt += " (window %d, %s)" % (
                    lv["win"], _human_bytes(lv["format_bytes"]))
            lines.append("%5d %12d %14d  %s" % (lv["level"], lv["unknowns"],
                                                 lv["nnz"], fmt))
        return "\n".join(lines)
