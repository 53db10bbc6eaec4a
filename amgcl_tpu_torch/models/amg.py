"""The AMG hierarchy: host-side construction, device-side V/W-cycle.

Counterpart of ``amgcl_tpu/models/amg.py`` (reference:
amgcl/amg.hpp:63-557): the hierarchy is built level by level on the host
in CSR (do_init loop, amg.hpp:467-512), each level's operator, transfer
operators and smoother state move to the device as tensors, and ``apply``
runs the multigrid cycle (amg.hpp:514-553) eagerly on the device.
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
from amgcl_tpu_torch.ops.structured import build_implicit_transfers
from amgcl_tpu_torch.relaxation.spai0 import Spai0
from amgcl_tpu_torch.solver.direct import DenseDirectSolver
from amgcl_tpu_torch.utils.devices import resolve_device


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
    the slots of the fused whole-leg V-cycle kernels, not ported yet: they
    stay None and the cycle composes its legs."""

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
        if self.npre > 0:
            u = lv.relax.apply(lv.A, f)      # first pre-sweep from zero
            for _ in range(self.npre - 1):
                u = lv.relax.apply_pre(lv.A, f, u)
        else:
            u = dev.clear(f)
        r = dev.residual(f, lv.A, u)
        fc = dev.spmv(lv.R, r)
        uc = self.cycle(i + 1, fc)
        for _ in range(self.ncycle - 1):      # W-cycle: extra coarse visits
            rc = dev.residual(fc, self.levels[i + 1].A, uc)
            uc = uc + self.cycle(i + 1, rc)
        u = u + dev.spmv(lv.P, uc)
        for _ in range(self.npost):
            u = lv.relax.apply_post(lv.A, f, u)
        return u

    def apply(self, r):
        """Preconditioner application (amg.hpp:288-297): pre_cycles
        cycles."""
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
                total += lv.relax.scale.numel() \
                    * lv.relax.scale.element_size()
        if self.coarse is not None:
            total += self.coarse.inv.numel() * self.coarse.inv.element_size()
        return total


def _human_bytes(n: float) -> str:
    for unit in ("B", "K", "M", "G"):
        if n < 1024 or unit == "G":
            return "%.2f %s" % (n, unit)
        n /= 1024.0


class AMG:
    """Host-side builder and owner of the device hierarchy.

    ``device=None`` means CUDA; without a card that raises unless the
    caller asks for ``device="cpu"``. Usage::

        P = AMG(A, AMGParams(...), device="cuda")
        z = P.hierarchy.apply(r)
    """

    def __init__(self, A, prm: Optional[AMGParams] = None, device=None):
        self.prm = prm or AMGParams()
        self.device = resolve_device(device)
        if not isinstance(A, CSR):
            A = CSR.from_scipy(A)
        self._build(A)

    def _build(self, A: CSR):
        """reference: amgcl/amg.hpp:467-512 do_init"""
        prm = self.prm
        t0 = time.perf_counter()
        coarsening = prm.coarsening
        # per-build state (eps_strong decay, grid dims, setup dtype) lives
        # in this dict, not on the policy object
        ctx = {}
        if prm.dtype.itemsize <= 4:
            # a <=32-bit device hierarchy lets the stencil setup algebra
            # run in float32 — same convergence, half the memory traffic
            ctx["setup_dtype"] = np.float32
        host = []
        Acur = A
        while (Acur.nrows > prm.coarse_enough
               and len(host) + 1 < prm.max_levels):
            try:
                P, R = coarsening.transfer_operators(Acur, ctx)
            except CoarseningStall:
                break     # expected terminal condition: close here
            if P.ncols == 0 or P.ncols >= Acur.ncols:
                break     # coarsening stalled
            Ac = coarsening.coarse_operator(Acur, P, R, ctx)
            host.append((Acur, P, R))
            Acur = Ac
        host.append((Acur, None, None))
        self.host_levels = host
        self._to_device_levels()
        self.setup_seconds = time.perf_counter() - t0

    def _to_device_levels(self):
        prm = self.prm
        host = self.host_levels
        dtype, device = prm.dtype, self.device
        levels = []
        for Ai, P, R in host[:-1]:
            # matrix-free smoothed transfers (ops/structured.py)
            P_dev, R_dev = build_implicit_transfers(
                P._implicit_spec, dtype, device)
            A_dev = dev.to_device(Ai, prm.matrix_format, dtype, device)
            levels.append(Level(A_dev, prm.relax.build(Ai, dtype, device),
                                P_dev, R_dev))
        Alast = host[-1][0]
        if prm.direct_coarse \
                and Alast.nrows > max(4 * prm.coarse_enough, 20000):
            # coarsening stalled far above the direct-solve regime:
            # refusing to densify an enormous matrix beats an OOM
            raise RuntimeError(
                "coarsening stalled at %d unknowns (> coarse_enough=%d); "
                "cannot build a dense coarse solver this large — adjust "
                "coarsening parameters or set direct_coarse=False"
                % (Alast.nrows, prm.coarse_enough))
        A_last = dev.to_device(Alast, prm.matrix_format, dtype, device)
        if prm.direct_coarse:
            coarse = DenseDirectSolver.build(Alast, dtype, device)
            levels.append(Level(A_last, None))
        else:
            coarse = None
            levels.append(Level(A_last, prm.relax.build(Alast, dtype,
                                                        device)))
        self.hierarchy = Hierarchy(levels, coarse, prm.npre, prm.npost,
                                   prm.ncycle, prm.pre_cycles)

    @property
    def dtype(self):
        return self.prm.dtype

    def hierarchy_stats(self):
        """Per-level rows/nnz/device format plus grid and operator
        complexity — the source ``__repr__`` renders from."""
        host = self.host_levels
        nnz0 = max(host[0][0].nnz, 1)
        rows0 = max(host[0][0].nrows, 1)
        levels = [{"level": i, "rows": int(Ai.nrows), "nnz": int(Ai.nnz),
                   "format": type(lv.A).__name__}
                  for i, ((Ai, _, _), lv)
                  in enumerate(zip(host, self.hierarchy.levels))]
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
        lines = [
            "Number of levels:    %d" % st["n_levels"],
            "Operator complexity: %.2f" % st["operator_complexity"],
            "Grid complexity:     %.2f" % st["grid_complexity"],
            "Memory footprint:    %s" % _human_bytes(st["bytes"]),
            "",
            "level     unknowns       nonzeros  format",
            "-----------------------------------------",
        ]
        for lv in st["levels"]:
            lines.append("%5d %12d %14d  %s" % (lv["level"], lv["rows"],
                                                 lv["nnz"], lv["format"]))
        return "\n".join(lines)
