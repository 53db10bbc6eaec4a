"""The host side of a stacked (n, B) solve, shared by the nine solvers'
stacked bodies (counterpart of what ``jax.vmap`` gives the JAX package's
solvers, amgcl_tpu/serve/batched.py:74-106).

The JAX package vmaps each solver's 1-D body over the columns, and its
``while_loop`` batching rule runs the loop while any column is active,
with a column whose condition went false select-frozen. The port's
stacked bodies keep that rule explicitly: every iteration computes the
candidate step of all B columns on the device (the block stored (B, n),
handed around as (n, B) views), fetches the B columns' scalars in one
host sync, runs each active column's guards on the host and commits the
step where the column is active and its guards let it, with one masked
select a block. A column's iteration count, residual, history and guard
flags are therefore those of its own 1-D solve.
"""

from __future__ import annotations

import torch

from amgcl_tpu_torch.telemetry.health import StackedHealth


def block(v):
    """A stacked (n, B) operand as the (n, B) view of a contiguous
    (B, n) block: the one layout a stacked solve makes, where its
    operands enter (none when they are such a view already)."""
    return v.T.contiguous().T


def stack(blocks):
    """k (n, B) blocks as the (k, n, B) view of a (k, B, n) array, so
    each column of each block stays contiguous."""
    return torch.stack([b.T for b in blocks]).transpose(1, 2)


def combine(coef, blocks):
    """``Σ_i coef[b, i] · blocks[i][:, b]`` a column: (B, k) coefficients
    over a (k, n, B) stack, as a (n, B) block."""
    return torch.einsum("bi,ibn->bn", coef, blocks.transpose(1, 2)).T


def fetch(*vals):
    """Host lists of tensors of one dtype (B-vectors, 0-d values), in one
    host sync."""
    flat = [v.reshape(-1) for v in vals]
    host = torch.cat(flat).tolist()
    out, i = [], 0
    for f in flat:
        out.append(host[i:i + f.numel()])
        i += f.numel()
    return out


def where_rows(mask, new, old):
    """``new`` where the column's ``mask`` (a (B,) bool tensor) holds,
    else ``old``, for arrays with the batch axis first, (B, ...); with
    the batch axis last ((n, B) blocks, (k, n, B) stacks, (B,) scalars)
    ``torch.where(mask, new, old)`` broadcasts as it is."""
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def commit(mask, new, old):
    """``torch.where(mask, ·, ·)`` over matching tuples of (…, B)
    arrays."""
    return tuple(torch.where(mask, a, b) for a, b in zip(new, old))


class Columns:
    """Host state of a stacked solve: per column the tolerance scale,
    eps, committed residual norm, iteration count, guard state and
    history, with the 1-D loop condition per column."""

    def __init__(self, solver, norm_rhs, res0, eps=None):
        self.solver = solver
        self.scale = [v if v > 0 else 1.0 for v in norm_rhs]
        self.eps = [solver.tol * s for s in self.scale] if eps is None \
            else list(eps)
        self.res = list(res0)
        self.B = len(self.scale)
        self.its = [0] * self.B
        self.hs = [solver._guard_init(r / s)
                   for r, s in zip(self.res, self.scale)]
        self.hist = [solver._hist_init() for _ in range(self.B)]

    def go(self, b):
        return self.solver._guard_go(self.hs[b])

    def active(self, b):
        """The 1-D loop condition of column b."""
        return (self.its[b] < self.solver.maxiter
                and self.res[b] > self.eps[b] and self.go(b))

    def actives(self):
        return [self.active(b) for b in range(self.B)]

    @staticmethod
    def mask(flags, like):
        """A (B,) bool tensor of host flags on ``like``'s device."""
        return torch.tensor(flags, dtype=torch.bool, device=like.device)

    def result(self, x):
        """The stacked return: ``(x (n, B), iters [B], resid [B],
        StackedHealth)``, with the per-column histories appended when
        recording; the health is None with guards off."""
        rel = [r / s for r, s in zip(self.res, self.scale)]
        out = (x, list(self.its), rel,
               StackedHealth(self.hs) if self.solver.guard else None)
        return out + (self.hist,) if self.solver.record_history else out


def entry(rhs, x0):
    """The stacked operands as (n, B) views of (B, n) blocks: rhs, and
    x0 (zeros when None)."""
    rhs = block(rhs)
    return rhs, (torch.zeros_like(rhs) if x0 is None else block(x0))
