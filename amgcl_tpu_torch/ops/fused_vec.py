"""Fused vector updates of the Krylov outer loop.

Counterpart of ``amgcl_tpu/ops/fused_vec.py`` as far as the Krylov solvers
need it:

* :func:`xr_update` — the CG tail ``x += α·p``, ``r −= α·q`` and
  ``⟨r, r⟩`` from one read of {p, q, x, r}; on CUDA tensors the
  ``amgcl_tpu_torch/csrc/vec.cu`` kernel in mode XR (replacing the TPU
  kernel ``_fused_pass`` in mode ``xr``), on CPU tensors
  :func:`xr_update_plain`.
* :func:`bicgstab_tail` — the BiCGStab tail ``x + α·p̂ + ω·ŝ``,
  ``s − ω·t`` with ``⟨r, r⟩`` and ``⟨r̂, r⟩`` from one read; vec.cu in
  mode BICG_TAIL, one launch (replacing ``_fused_pass`` in mode
  ``bicg_tail``), :func:`bicgstab_tail_plain` on CPU tensors.
* :func:`axpby_dot` — ``z = a·x + b·y`` and ``⟨z, z⟩`` from one read of
  {x, y}; vec.cu in mode AXPBY_DOT, one launch (replacing ``_fused_pass``
  in mode ``axpby_dot``), :func:`axpby_dot_plain` on CPU tensors.

* :func:`stack_dots` and :func:`block_dots` — the stacked products of
  GMRES's and IDR(s)'s bases and the Gram matrix of BiCGStab(L)'s
  minimal-residual step, each one matrix product (the JAX package
  computes them outside any Pallas kernel too).
* :func:`residual_dot` — ``r = f − A x`` and ``⟨r, r⟩`` in one operator
  pass (the DIA kernel for DIA operators, composed otherwise).

Each also takes stacked (n, B) operands (the stacked solves of
``serve/batched.py``), with per-column scalars of shape (B,) and (B,)
dots in the scalar slots: the counterpart of the JAX package's stacked
tier (amgcl_tpu/ops/fused_vec.py:122-160). The JAX package composes that
tier in XLA; here each column goes through the 1-D function (its kernel
on the card, its plain version on the CPU), as do :func:`col_dots`'
per-column dots, so a column of a stacked solve rounds as its 1-D solve
does, bit for bit.

The three tails sum their dots in one fixed order over the grid of
:func:`tail_blocks`: XR in a second launch, the other two in the grid's
last block (an atomic ticket per (device, stream), as the DIA dot
kernels keep), which :func:`ordered_tail_dots` emulates in numpy.

Each tail also takes bfloat16 vectors and scalars (a bfloat16 Krylov
loop): each product and sum rounded to bfloat16 where the JAX body's
bfloat16 expression rounds (amgcl_tpu/ops/fused_vec.py:216-241; its
interpret mode on the CPU rounds after each operation too, which the
parity tests check bit for bit), the dots summed in float32 and rounded
once to bfloat16, by the same launches as in float32. The plain versions
are the JAX body's torch expressions; their dots sum in torch's order,
so a dot may differ from the kernel's by one bfloat16 ULP.
``<wrapper>.bf16_launches`` counts the bfloat16 launches.
"""

from __future__ import annotations

import numpy as np
import torch

from amgcl_tpu_torch.ops import cuda_lib
from amgcl_tpu_torch.ops import device as dev
from amgcl_tpu_torch.ops.dia_kernels import (_BLOCK, _acc_dtype,
                                             _ticket, count_launch,
                                             dia_residual_dot, dtype_code,
                                             ordered_dot)

#: fixed block count of the grid-stride pass: a constant grid keeps the
#: partial sums in the same order for a given n on every run
_MAX_BLOCKS = 1056


def tail_blocks(n):
    """The tails' grid over n elements: one block of 256 threads per 256
    elements, at most :data:`_MAX_BLOCKS` (element i in thread i mod
    (blocks · 256)); the C entries refuse any other."""
    return min(-(-int(n) // _BLOCK), _MAX_BLOCKS)


def ordered_tail_dots(r, rhat=None):
    """``(⟨r, r⟩,)``, or ``(⟨r, r⟩, ⟨r̂, r⟩)`` with ``rhat``, in numpy at
    r's type, summed in the tail kernels' order: each thread's product
    (+0 where a thread has no element), per block of 256 threads the
    256-tree, then lane t of 256 adds partials t, t + 256, … to 0 in that
    order, and the same tree over the 256 lanes. Applied to a kernel's own
    r' (or z) and r̂, it gives the kernel's dots bit for bit. Only for
    n ≤ 256 · 1056: there block b holds elements [256b, 256b + 256), one
    a thread, which is ``dia_kernels.ordered_dot``'s grouping (a thread's
    fma onto +0 and ordered_dot's bare product differ at most in the sign
    of a zero, which the lanes' sums from +0 erase). Above, a thread
    chains several elements' fmas, which numpy cannot round as the card
    does, so larger n is refused."""
    r = np.asarray(r)
    if r.shape[0] > _BLOCK * _MAX_BLOCKS:
        raise ValueError("ordered_tail_dots emulates at most %d elements "
                         "(one a thread), got %d"
                         % (_BLOCK * _MAX_BLOCKS, r.shape[0]))
    return tuple(ordered_dot(a, r) for a in
                 (r,) + (() if rhat is None else (np.asarray(rhat),)))


def xr_update_plain(alpha, p, q, x, r):
    """(x + α·p, r − α·q, ⟨r_new, r_new⟩)."""
    xr_update_plain.calls += 1
    xn = x + alpha * p
    rn = r - alpha * q
    ra = rn.to(_acc_dtype(rn.dtype))
    return xn, rn, torch.dot(ra, ra).to(rn.dtype)


xr_update_plain.calls = 0


def bicgstab_tail_plain(alpha, phat, omega, shat, s, t, x, rhat):
    """(x + α·p̂ + ω·ŝ, s − ω·t, ⟨r_new, r_new⟩, ⟨r̂, r_new⟩)."""
    bicgstab_tail_plain.calls += 1
    xn = x + alpha * phat + omega * shat
    rn = s - omega * t
    acc = _acc_dtype(rn.dtype)
    ra = rn.to(acc)
    return (xn, rn, torch.dot(ra, ra).to(rn.dtype),
            torch.dot(rhat.to(acc), ra).to(rn.dtype))


bicgstab_tail_plain.calls = 0


def axpby_dot_plain(a, x, b, y):
    """(a·x + b·y, ⟨z, z⟩)."""
    axpby_dot_plain.calls += 1
    z = a * x + b * y
    za = z.to(_acc_dtype(z.dtype))
    return z, torch.dot(za, za).to(z.dtype)


axpby_dot_plain.calls = 0


def _scalar(name, v, x):
    """One value of x's dtype on x's device, as a contiguous tensor."""
    if not torch.is_tensor(v):
        v = torch.tensor(v, dtype=x.dtype, device=x.device)
    if v.device != x.device or v.dtype != x.dtype or v.numel() != 1:
        raise ValueError("%s must be one %s value on %s"
                         % (name, x.dtype, x.device))
    return v.contiguous()


def _launch_tail(what, entry, scalars, vecs, nout, ndots, ticket):
    """Validate a tail's operands and launch its vec.cu mode through the
    C entry point named ``entry``, with the stream's ticket where
    ``ticket`` (the one-launch modes); returns (outs, dots) with ``outs``
    the ``nout`` output vectors and dots an (ndots,) tensor."""
    x = vecs["x"]
    code = dtype_code(x.dtype, what)
    n = x.shape[0]
    for name, v in vecs.items():
        if v.device != x.device or v.dtype != x.dtype or v.shape != (n,) \
                or not v.is_contiguous():
            raise ValueError(
                "%s must be a contiguous (%d,) %s tensor on %s, got %s %s "
                "on %s" % (name, n, x.dtype, x.device, tuple(v.shape),
                           v.dtype, v.device))
    scalars = [_scalar(name, v, x) for name, v in scalars]
    outs = [torch.empty_like(x) for _ in range(nout)]
    if n == 0:
        return outs, torch.zeros(ndots, dtype=x.dtype, device=x.device)
    # the kernels write every dot and partial; the partials in float32
    # for bfloat16
    dots = torch.empty(ndots, dtype=x.dtype, device=x.device)
    nblocks = tail_blocks(n)
    partials = torch.empty(nblocks * ndots, dtype=_acc_dtype(x.dtype),
                           device=x.device)
    ptrs = [v.data_ptr() for v in scalars + list(vecs.values())]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        tk = (_ticket(x.device, stream).data_ptr(),) if ticket else ()
        rc = getattr(cuda_lib.lib(), entry)(
            code, n, *ptrs, *(o.data_ptr() for o in outs),
            partials.data_ptr(), dots.data_ptr(), *tk, nblocks, stream)
    cuda_lib.check(rc, what)
    return outs, dots


# -- stacked (n, B) tier ------------------------------------------------------

is_stacked = dev.is_stacked


def col_dots(x, y):
    """``(B,)`` tensor of the per-column dots ``⟨x[:, b], y[:, b]⟩`` of
    stacked (n, B) operands, each the 1-D inner product of its column."""
    return torch.stack(dev.per_column(dev.inner_product, x, y))


def _per_column_tail(fn, scalars, vecs, nvec):
    """``fn`` column by column over stacked operands: column b takes the
    b-th entry of each (B,) scalar (a 0-d scalar or a number as it is)
    and column b of each vector; returns the ``nvec`` stacked vectors
    and the stacked (B,) dots."""
    cols = [dev.columns(v) for v in vecs]
    got = []
    for j in range(cols[0].shape[0]):
        sc = [v[j] if torch.is_tensor(v) and v.dim() == 1 else v
              for v in scalars]
        got.append(fn(*sc, *(c[j] for c in cols)))
    return tuple(dev.stacked(g[i] for g in got) for i in range(nvec)) + \
        tuple(torch.stack([g[i] for g in got])
              for i in range(nvec, len(got[0])))


def xr_update(alpha, p, q, x, r):
    """The CG iteration tail in one pass: ``(x + α·p, r − α·q, ⟨r', r'⟩)``
    with the dot a 0-d tensor on the device. ``alpha`` is a 0-d tensor of
    the vectors' dtype on their device (or a Python number). Stacked
    (n, B) operands take a (B,) ``alpha`` and return a (B,) dot."""
    if is_stacked(p, q, x, r):
        return _per_column_tail(
            lambda a, pc, qc, xc, rc: xr_update(a, pc, qc, xc, rc),
            (alpha,), (p, q, x, r), 2)
    if x.device.type == "cpu":
        return xr_update_plain(alpha, p, q, x, r)
    (xn, rn), dots = _launch_tail("xr_update", "amgcl_xr",
                                  [("alpha", alpha)],
                                  {"p": p, "q": q, "x": x, "r": r}, 2, 1,
                                  False)
    count_launch(xr_update, xn.dtype)
    return xn, rn, dots[0]


xr_update.launches = xr_update.bf16_launches = 0


def bicgstab_tail(alpha, phat, omega, shat, s, t, x, rhat):
    """The BiCGStab iteration tail in one pass: ``(x + α·p̂ + ω·ŝ,
    s − ω·t, ⟨r', r'⟩, ⟨r̂, r'⟩)`` with r' = s − ω·t; the second dot is the
    next iteration's ρ. ``alpha`` and ``omega`` are 0-d tensors of the
    vectors' dtype on their device (or Python numbers); the dots are 0-d
    tensors on the device. Stacked (n, B) operands take (B,) scalars and
    return (B,) dots."""
    if is_stacked(phat, shat, s, t, x, rhat):
        return _per_column_tail(
            lambda a, w, *cols: bicgstab_tail(a, cols[0], w, *cols[1:]),
            (alpha, omega), (phat, shat, s, t, x, rhat), 2)
    if x.device.type == "cpu":
        return bicgstab_tail_plain(alpha, phat, omega, shat, s, t, x, rhat)
    (xn, rn), dots = _launch_tail(
        "bicgstab_tail", "amgcl_bicg_tail",
        [("alpha", alpha), ("omega", omega)],
        {"phat": phat, "shat": shat, "s": s, "t": t, "x": x, "rhat": rhat},
        2, 2, True)
    count_launch(bicgstab_tail, xn.dtype)
    return xn, rn, dots[0], dots[1]


bicgstab_tail.launches = bicgstab_tail.bf16_launches = 0


def axpby_dot(a, x, b, y):
    """``(z, ⟨z, z⟩)`` with ``z = a·x + b·y`` in one pass; the dot is a 0-d
    tensor on the device. ``a`` and ``b`` are 0-d tensors of the vectors'
    dtype on their device (or Python numbers, which a CUDA launch copies
    to the device). Stacked (n, B) operands take (B,) or scalar
    coefficients and return a (B,) dot."""
    if is_stacked(x, y):
        return _per_column_tail(
            lambda ac, bc, xc, yc: axpby_dot(ac, xc, bc, yc), (a, b),
            (x, y), 1)
    if x.device.type == "cpu":
        return axpby_dot_plain(a, x, b, y)
    (z,), dots = _launch_tail("axpby_dot", "amgcl_axpby_dot",
                              [("a", a), ("b", b)], {"x": x, "y": y}, 1, 1,
                              True)
    count_launch(axpby_dot, z.dtype)
    return z, dots[0]


axpby_dot.launches = axpby_dot.bf16_launches = 0


def stack_dots(V, w):
    """``(len(V),)`` vector of ``⟨V_i, w⟩`` — the Arnoldi and shadow-space
    products of GMRES and IDR(s) — as one matrix-vector product (one read
    of V; the JAX package computes it outside any Pallas kernel too,
    amgcl_tpu/ops/fused_vec.py:387-402). Stacked: V (k, n, B) and w
    (n, B) give the (k, B) per-column products."""
    if w.dim() == 2:
        return torch.einsum("knb,nb->kb", V, w)
    return torch.mv(V, w)


def block_dots(X, Y):
    """``(len(X), len(Y))`` matrix of ``⟨X_i, Y_j⟩`` — the Gram products of
    BiCGStab(L)'s minimal-residual step — as one matrix product. Stacked:
    X (k, n, B) and Y (l, n, B) give the (B, k, l) per-column Gram
    matrices."""
    if X.dim() == 3:
        return torch.einsum("inb,jnb->bij", X, Y)
    return torch.matmul(X, Y.T)


def residual_dot(f, A, x):
    """``(r, ⟨r, r⟩)`` with ``r = f − A x``: one kernel pass for square DIA
    operators, the residual seam plus a dot elsewhere. A stacked (n, B)
    pair runs column by column and returns a (B,) dot."""
    if is_stacked(f, x):
        got = dev.per_column(lambda fc, xc: residual_dot(fc, A, xc), f, x)
        return dev.stacked(g[0] for g in got), torch.stack(
            [g[1] for g in got])
    if isinstance(A, dev.DiaMatrix) and A.shape[0] == A.shape[1]:
        return dia_residual_dot(A.offsets, A.data, f, x)
    r = dev.residual(f, A, x)
    return r, dev.inner_product(r, r)
