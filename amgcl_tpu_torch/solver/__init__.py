"""Krylov solvers and the coarse direct solver."""
