"""Fused whole-leg V-cycle handles and the functions that attach them.

Counterpart of the host side of ``amgcl_tpu/ops/pallas_vcycle.py``. At a
level whose transfers are grid-aligned 2×2×2 smoothed aggregates
(``ImplicitSmoothedP/R`` over a ``GridTentative``), the cycle's down leg
(pre-smooth, residual, filter, restriction) and up leg (prolongation,
filter, correction, first post-smoothing sweep) each run as one kernel
(``ops/vcycle_kernels.py``). ``build_fused_down`` / ``build_fused_up``
decide at setup whether a level is eligible and attach a handle.

The gates are the structural ones, those that define the math: a DIA
level operator, DIA M/Mᵀ, blocks (2, 2, 2), a ≤32-bit dtype (float64
hierarchies keep the composed legs, as in the reference), non-empty
offsets, and a tile whose boxes fit a block's shared memory: for the
down leg boxes of r and u (``vk.down_tile``; one grid row of a 7-point
level up to 1,218 points wide in float32), for the up leg of T uc and u'
(``vk.up_tile``; up to 1,648 in float32). The boxes hold the level's
dtype, so a bfloat16 level fits twice as wide a row. The up leg and the zero-guess mode also
need a scalar ``ScaledResidualSmoother``, and the up leg an even fine z
extent. The CUDA kernels guard every index, so they need none of the TPU
kernel's frames or lane packing.
"""

from __future__ import annotations

from amgcl_tpu_torch.ops import vcycle_kernels as vk
from amgcl_tpu_torch.ops.device import DiaMatrix
from amgcl_tpu_torch.ops.structured import (GridTentative, ImplicitSmoothedP,
                                            ImplicitSmoothedR)
from amgcl_tpu_torch.relaxation.base import ScaledResidualSmoother


def _halo(offsets):
    return max(max(offsets), -min(offsets), 0)


def up_geometry(offs_a, offs_m, dims):
    """Coarse planes the up leg reads on each side of a coarse plane:
    ceil((hA + hM) / 2s), at least 1, with hA and hM the reach of A and M
    in fine rows and s a fine plane (the reference's ``halo_planes``). The
    CUDA kernels read through guarded indices, so this only reports the
    geometry; the down leg reaches hA + hM fine rows the same way."""
    _, f1, f0 = dims
    return max(1, -(-(_halo(offs_a) + _halo(offs_m)) // (2 * f1 * f0)))


def _eligible_dtype(dtype, *others):
    """float32 and bfloat16 (the kernels' dtypes; float16 hierarchies are
    refused at construction), the operators of one dtype."""
    return (dtype.itemsize <= 4 and not dtype.is_complex
            and all(o == dtype for o in others))


def _scalar_scale(relax, dtype):
    if isinstance(relax, ScaledResidualSmoother) \
            and relax.scale.dim() == 1 and relax.scale.dtype == dtype:
        return relax.scale
    return None


class FusedDownSweep:
    """Handle on a level: ``__call__(f, u)`` returns the restricted
    filtered residual ``Tᵀ (I − Mᵀ)(f − A u)`` as a flat coarse vector;
    ``zero(f)`` (when ``w``, the smoother scale, is set) forms the npre = 1
    pre-smoothed iterate ``u = w ∘ f`` in the same pass and returns
    ``(u, fc)``."""

    def __init__(self, A, Mt, T, w):
        self.A = A
        self.Mt = Mt
        self.T = T
        self.w = w
        self.dims = T.fine

    # the offsets as host ints: the kernel checks its tile against them
    # without a copy from the card
    def __call__(self, f, u):
        return vk.fused_down_sweep(self.A.offsets, self.A.data,
                                   self.Mt.offsets, self.Mt.data, f, u,
                                   self.dims)

    def zero(self, f):
        return vk.fused_down_sweep(self.A.offsets, self.A.data,
                                   self.Mt.offsets, self.Mt.data, f,
                                   self.w, self.dims, zero_guess=True)


class FusedUpSweep:
    """Handle on a level: ``__call__(f, u, uc)`` returns ``u' + w ∘ (f −
    A u')`` with ``u' = u + (I − M) T uc``."""

    def __init__(self, A, M, T, w):
        self.A = A
        self.M = M
        self.T = T
        self.w = w
        self.dims = T.fine
        self.halo_planes = up_geometry(A.offsets, M.offsets, T.fine)

    def __call__(self, f, u, uc):
        # the offsets as host ints: the kernel checks its tile against
        # them without a copy from the card
        return vk.fused_up_sweep(self.A.offsets, self.A.data,
                                 self.M.offsets, self.M.data, self.w, f,
                                 u, uc, self.dims)


def _grid_transfer(A_dev, T, op):
    """The shared structural gates: DIA A and transfer operator over 2×2×2
    grid aggregates matching A's rows, non-empty offsets."""
    return (isinstance(A_dev, DiaMatrix) and isinstance(T, GridTentative)
            and isinstance(op, DiaMatrix) and T.block == vk.BLOCK
            and A_dev.shape == (T.shape[0], T.shape[0])
            and op.shape == A_dev.shape
            and bool(A_dev.offsets) and bool(op.offsets))


def build_fused_down(A_dev, R_dev, relax=None):
    """FusedDownSweep for an eligible (A, R) pair, else None. ``relax``:
    the level's smoother state; a scalar ScaledResidualSmoother also
    enables the zero-guess mode."""
    if not isinstance(R_dev, ImplicitSmoothedR) \
            or not _grid_transfer(A_dev, R_dev.T, R_dev.Mt) \
            or not _eligible_dtype(A_dev.dtype, R_dev.Mt.dtype) \
            or vk.down_tile(A_dev.offsets, R_dev.Mt.offsets,
                            R_dev.T.fine, A_dev.dtype) is None:
        return None
    return FusedDownSweep(A_dev, R_dev.Mt, R_dev.T,
                          _scalar_scale(relax, A_dev.dtype))


def build_fused_up(A_dev, P_dev, relax):
    """FusedUpSweep for an eligible (A, P, smoother) triple, else None."""
    if not isinstance(P_dev, ImplicitSmoothedP) \
            or not _grid_transfer(A_dev, P_dev.T, P_dev.M) \
            or not _eligible_dtype(A_dev.dtype, P_dev.M.dtype):
        return None
    w = _scalar_scale(relax, A_dev.dtype)
    if w is None or P_dev.T.fine[0] % 2 or vk.up_tile(
            A_dev.offsets, P_dev.M.offsets, P_dev.T.fine,
            A_dev.dtype) is None:
        return None
    return FusedUpSweep(A_dev, P_dev.M, P_dev.T, w)

