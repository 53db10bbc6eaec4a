"""Rigid-body near-nullspace of elasticity (reference:
amgcl/coarsening/rigid_body_modes.hpp; counterpart of
``amgcl_tpu/coarsening/rigid_body_modes.py``): 3 modes in 2-D (two
translations, a rotation), 6 in 3-D."""

from __future__ import annotations

import numpy as np


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """``coords``: (n_points, 2 or 3). Returns B, (n_points·dim, 3 or 6),
    the displacement unknowns of a point interleaved, its columns
    orthonormalized."""
    coords = np.asarray(coords, dtype=np.float64)
    n, dim = coords.shape
    c = coords - coords.mean(axis=0, keepdims=True)
    if dim == 2:
        B = np.zeros((2 * n, 3))
        B[0::2, 0] = 1.0
        B[1::2, 1] = 1.0
        B[0::2, 2] = -c[:, 1]
        B[1::2, 2] = c[:, 0]
    elif dim == 3:
        B = np.zeros((3 * n, 6))
        for d in range(3):
            B[d::3, d] = 1.0
        x, y, z = c[:, 0], c[:, 1], c[:, 2]
        B[1::3, 3] = -z
        B[2::3, 3] = y
        B[0::3, 4] = z
        B[2::3, 4] = -x
        B[0::3, 5] = -y
        B[1::3, 5] = x
    else:
        raise ValueError("coords must be 2D or 3D")
    q, _ = np.linalg.qr(B)
    return q
