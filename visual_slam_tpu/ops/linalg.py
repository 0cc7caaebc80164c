"""Small linear-algebra helpers in float32.

The solves stay in float32 and avoid batched SVD (which lowers to
QR-iteration loops); the homogeneous least-squares solves that SLAM needs everywhere
(8-point, DLT PnP, DLT triangulation) are therefore solved as symmetric
eigenproblems of the row-normalized Gram matrix: batched `eigh` of tiny
(4x4 / 9x9 / 12x12) matrices maps onto fast batched Jacobi sweeps, and the
row normalization (plus the callers' Hartley normalization) keeps the
squared condition number inside float32 range.
"""
from __future__ import annotations

import jax.numpy as jnp


def solve_homogeneous(A: jnp.ndarray) -> jnp.ndarray:
    """argmin_{|x|=1} |A x| for batched A (..., M, N) -> (..., N).

    Rows are normalized to unit length first: it equalizes equation scales,
    which both improves the LS conditioning and keeps Gram entries O(1).
    """
    rn = jnp.linalg.norm(A, axis=-1, keepdims=True)
    A = A / jnp.where(rn > 1e-12, rn, 1.0)
    G = jnp.einsum("...mi,...mj->...ij", A, A)
    _, V = jnp.linalg.eigh(G)
    return V[..., :, 0]


def solve_weighted_homogeneous(A: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """As solve_homogeneous with per-row weights (..., M)."""
    rn = jnp.linalg.norm(A, axis=-1, keepdims=True)
    A = A * (w[..., None] / jnp.where(rn > 1e-12, rn, 1.0))
    G = jnp.einsum("...mi,...mj->...ij", A, A)
    _, V = jnp.linalg.eigh(G)
    return V[..., :, 0]
