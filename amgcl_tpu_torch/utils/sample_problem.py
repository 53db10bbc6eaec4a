"""Deterministic test fixtures: the 3-D Poisson problem, scalar and
block-valued, 2-D Q1 elasticity with its node coordinates, and the
coupled systems of the Schur and CPR preconditioners.

Counterpart of ``amgcl_tpu/utils/sample_problem.py::poisson3d``, itself
modelled on the reference's tests/sample_problem.hpp:11-84.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amgcl_tpu_torch.ops.csr import CSR


def poisson3d(n: int, anisotropy: float = 1.0, dtype=np.float64):
    """7-point finite-difference Laplacian on an n×n×n grid.

    Returns ``(A: CSR, rhs: np.ndarray)`` with Dirichlet boundaries folded
    into the operator; ``anisotropy`` scales the z-direction coupling."""
    h2i = float(n - 1) ** 2 if n > 1 else 1.0
    ex = np.ones(n)
    T = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1], format="csr")
    I = sp.identity(n, format="csr")
    Axy = sp.kron(I, sp.kron(I, T)) + sp.kron(I, sp.kron(T, I))
    Az = sp.kron(T, sp.kron(I, I))
    A = (Axy + anisotropy * Az) * h2i
    A = sp.csr_matrix(A.astype(dtype))
    A.sort_indices()
    return CSR.from_scipy(A), np.ones(n ** 3, dtype=dtype)


def poisson3d_block(n: int, b: int, dtype=np.float64):
    """Block-valued variant (``amgcl_tpu/utils/sample_problem.py::
    poisson3d_block``): the scalar Poisson matrix kron the b×b identity,
    its components coupled by 0.01 off the block diagonal, as a b×b BCSR
    over n³ block rows. Returns ``(A: CSR, rhs)`` with ``rhs`` all ones
    over the n³·b unknowns."""
    A, _ = poisson3d(n, dtype=dtype)
    S = sp.kron(A.to_scipy(), sp.identity(b), format="csr")
    C = sp.kron(sp.identity(n ** 3), 0.01 * (np.ones((b, b)) - np.eye(b)),
                format="csr")
    return CSR.from_scipy(sp.csr_matrix(S + C)).to_block(b), \
        np.ones(n ** 3 * b, dtype=dtype)


def q1_elasticity2d(nx: int = 48, E: float = 1.0, nu: float = 0.3,
                    contrast: float = 1e3):
    """Q1 plane-stress elasticity on an nx × nx mesh of unit squares (2×2
    Gauss assembly of BᵀDB), both displacements pinned on the left edge,
    the elements of one quadrant ``contrast`` times stiffer (the
    Serena/Nullspace tutorial situation, reference:
    docs/tutorial/Nullspace.rst; the JAX package's
    ``examples/elasticity_nullspace.py``). Returns ``(A: CSR, rhs,
    coords)``: 2 unknowns a free node, interleaved, and the (nodes, 2)
    coordinates of the free nodes for ``rigid_body_modes``."""
    nn1 = nx + 1
    D = E / (1 - nu * nu) * np.array(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1 - nu) / 2]])
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    Ke = np.zeros((8, 8))
    for xi in gp:
        for eta in gp:
            dN = 0.25 * np.array([          # dN/dxi, dN/deta per node
                [-(1 - eta), -(1 - xi)],
                [(1 - eta), -(1 + xi)],
                [(1 + eta), (1 + xi)],
                [-(1 + eta), (1 - xi)]])
            dNdx = dN * 2.0
            B = np.zeros((3, 8))
            B[0, 0::2] = dNdx[:, 0]
            B[1, 1::2] = dNdx[:, 1]
            B[2, 0::2] = dNdx[:, 1]
            B[2, 1::2] = dNdx[:, 0]
            Ke += 0.25 * B.T @ D @ B
    ex, ey = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    n00 = (ex * nn1 + ey).ravel()
    enodes = np.stack([n00, n00 + nn1, n00 + nn1 + 1, n00 + 1], axis=1)
    edofs = np.stack([enodes * 2, enodes * 2 + 1], axis=2).reshape(-1, 8)
    scale = np.ones(len(edofs))
    scale[(ex.ravel() < nx // 2) & (ey.ravel() < nx // 2)] = contrast
    rows = np.repeat(edofs, 8, axis=1).ravel()
    cols = np.tile(edofs, (1, 8)).ravel()
    vals = (scale[:, None, None] * Ke[None]).ravel()
    ndof = 2 * nn1 * nn1
    K = sp.coo_matrix((vals, (rows, cols)), shape=(ndof, ndof)).tocsr()
    free = np.ones(ndof, bool)
    fixed_nodes = np.arange(nn1)            # nodes with ix == 0
    free[fixed_nodes * 2] = False
    free[fixed_nodes * 2 + 1] = False
    keep = np.flatnonzero(free)
    K = K[keep][:, keep].tocsr()
    K.sort_indices()
    X, Y = np.meshgrid(np.arange(nn1, dtype=float),
                       np.arange(nn1, dtype=float), indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)[keep[::2] // 2]
    return CSR.from_scipy(K), np.ones(K.shape[0]), coords


def stokes_like(n: int):
    """Stabilized Stokes-type saddle point [A Bᵀ; B −εM] on an n×n grid
    (``amgcl_tpu/utils/sample_problem.py::stokes_like``): A the 2-D vector
    Laplacian (two velocity components of n² rows each), B a discrete
    divergence, ε = 1e-2 — the coupled-system fixture of the Schur
    pressure correction. Returns ``(A: CSR, pmask)`` with the n² pressure
    rows last."""
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1])
    L = (sp.kron(sp.identity(n), T) + sp.kron(T, sp.identity(n))).tocsr()
    nu = L.shape[0]
    A = sp.block_diag([L, L]).tocsr()            # two velocity components
    D = sp.diags([-np.ones(nu - 1), np.ones(nu)], [-1, 0],
                 shape=(nu, nu))
    B = sp.hstack([D, 0.5 * D]).tocsr()          # (np_, 2nu)
    M = sp.identity(nu) * 1e-2
    K = sp.bmat([[A, B.T], [B, -M]]).tocsr()
    pmask = np.zeros(K.shape[0], dtype=bool)
    pmask[2 * nu:] = True
    return CSR.from_scipy(K), pmask


def reservoir_like(n: int, b: int = 3):
    """Reservoir-type block system (the CPR fixture of the JAX package's
    ``tests/test_coupled.py::reservoir_like``): poisson3d(n) pressure
    coupling kron the b×b identity, each cell's b − 1 saturation
    equations coupled to its pressure by 0.3 and made strongly diagonal
    (n³ on the diagonal). Returns ``(A: CSR as b×b blocks, rhs)`` with
    ``rhs`` all ones over the n³·b unknowns."""
    Ap, _ = poisson3d(n)
    m = Ap.to_scipy()
    nc = m.shape[0]
    K = sp.kron(m, np.eye(b)).tocsr()
    rows = np.concatenate([np.arange(nc) * b + k for k in range(1, b)])
    extra = sp.csr_matrix(
        (np.full(len(rows), 0.3), (rows, (rows // b) * b)), shape=K.shape)
    diag = sp.csr_matrix(
        (np.full(len(rows), float(nc)), (rows, rows)), shape=K.shape)
    M = (K + extra + diag).tocsr()
    return CSR.from_scipy(M).to_block(b), np.ones(nc * b)
