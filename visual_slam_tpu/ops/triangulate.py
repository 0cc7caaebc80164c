"""Batched triangulation (pure jnp, fixed-shape, mask-friendly).

Replacement for the reference's per-point SVD loop
`triangulate` (src/v2/helper_functions.py:281-291, used at src/v2/main.py:284)
and `triangulateMidPoint` (src/v2/helper_functions.py:90-123).

Instead of an N-iteration Python loop of 4x4 SVDs, the DLT system is built
for all points at once and solved with a batched symmetric eigendecomposition
of A^T A (4x4), which XLA batches into a few device ops.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import linalg as linalg_mod


def triangulate_dlt(
    P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray
) -> jnp.ndarray:
    """Linear (DLT) two-view triangulation for a batch of correspondences.

    Args:
      P1, P2: (3,4) projection matrices (K @ [R|t], world->pixel).
      uv1, uv2: (N,2) pixel coordinates in each view.
    Returns:
      (N,4) homogeneous world points (unit-norm homogeneous vector; divide by
      last coordinate to dehomogenize, as the caller does in the reference at
      src/v2/main.py:285).
    """
    # Rows of the 4x4 DLT system per point (Hartley-Zisserman 12.2):
    #   u * P[2] - P[0],  v * P[2] - P[1]  for each view.
    r1 = uv1[..., 0:1] * P1[2] - P1[0]
    r2 = uv1[..., 1:2] * P1[2] - P1[1]
    r3 = uv2[..., 0:1] * P2[2] - P2[0]
    r4 = uv2[..., 1:2] * P2[2] - P2[1]
    A = jnp.stack([r1, r2, r3, r4], axis=-2)  # (N,4,4)
    # Row-normalized Gram + eigh (batched Jacobi; row normalization
    # tames the ~f-scale rows of pixel-space projection matrices).
    return linalg_mod.solve_homogeneous(A)


def triangulate_dlt_pairwise(
    P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray
) -> jnp.ndarray:
    """As `triangulate_dlt` but with per-point projection matrices (N,3,4)."""
    r1 = uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :]
    r2 = uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :]
    r3 = uv2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :]
    r4 = uv2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]
    A = jnp.stack([r1, r2, r3, r4], axis=-2)
    return linalg_mod.solve_homogeneous(A)


def triangulate_nviews(
    P: jnp.ndarray, uv: jnp.ndarray, w: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Batched n-view linear triangulation with per-view validity weights.

    ≙ the reference's `triangulate_nviews` (src/v2/helper_functions.py:330-348),
    which loops a per-point SVD of a 3n x (4+n) system with auxiliary scale
    unknowns. Here each view contributes the two standard DLT rows
    (u*P[2]-P[0], v*P[2]-P[1]; Hartley-Zisserman 12.2) — algebraically the
    same null space without the per-view auxiliary unknowns, so the system
    stays (2V,4) and the whole batch reduces to one (N,4,4) Gram + eigh,
    fixed-shape for any view count via zero-weight padding rows.

    Args:
      P: (N,V,3,4) per-point, per-view projection matrices (world->pixel),
         or (V,3,4) shared across points.
      uv: (N,V,2) pixel measurements.
      w: optional (N,V) weights; 0 disables a view (padding). Default: all 1.
    Returns:
      (N,4) homogeneous world points (unit norm; `dehomogenize` to get xyz).
    """
    if P.ndim == 3:
        P = jnp.broadcast_to(P[None], (uv.shape[0],) + P.shape)
    ru = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]  # (N,V,4)
    rv = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]  # (N,V,4)
    A = jnp.concatenate([ru, rv], axis=1)  # (N,2V,4)
    if w is not None:
        # Weighted solve (rows normalized BEFORE weighting, so non-binary
        # weights act as true per-view confidences, not just masks).
        ww = jnp.concatenate([w, w], axis=1)  # (N,2V)
        return linalg_mod.solve_weighted_homogeneous(A, ww)
    return linalg_mod.solve_homogeneous(A)


def dehomogenize(Xh: jnp.ndarray) -> jnp.ndarray:
    """(...,4) homogeneous -> (...,3) euclidean with safe divide."""
    w = Xh[..., 3:4]
    w_safe = jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)
    return Xh[..., :3] / w_safe


def triangulate_midpoint(
    R1: jnp.ndarray,
    t1: jnp.ndarray,
    R2: jnp.ndarray,
    t2: jnp.ndarray,
    xn1: jnp.ndarray,
    xn2: jnp.ndarray,
) -> jnp.ndarray:
    """Mid-point triangulation from normalized image coords.

    ≙ `triangulateMidPoint` (src/v2/helper_functions.py:90-123), used by the
    cheirality vote in `chooseRealizableSolution` (:125-161).

    (R1,t1), (R2,t2) are world->camera transforms. xn1/xn2 are (N,2)
    normalized coordinates. Returns (N,3) world points.
    """
    # Camera centers and ray directions in world frame.
    c1 = -jnp.einsum("ji,j->i", R1, t1)
    c2 = -jnp.einsum("ji,j->i", R2, t2)
    d1 = jnp.einsum("ji,nj->ni", R1, _ray(xn1))  # R^T * ray
    d2 = jnp.einsum("ji,nj->ni", R2, _ray(xn2))
    # Solve min over (s,t) of || (c1 + s d1) - (c2 + t d2) ||^2 per point.
    a = jnp.sum(d1 * d1, axis=-1)
    b = jnp.sum(d1 * d2, axis=-1)
    c = jnp.sum(d2 * d2, axis=-1)
    w = c2 - c1
    d = jnp.sum(d1 * w[None, :], axis=-1)
    e = jnp.sum(d2 * w[None, :], axis=-1)
    denom = a * c - b * b
    denom = jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
    s = (c * d - b * e) / denom
    t = (b * d - a * e) / denom
    p1 = c1[None, :] + s[..., None] * d1
    p2 = c2[None, :] + t[..., None] * d2
    return 0.5 * (p1 + p2)


def _ray(xn: jnp.ndarray) -> jnp.ndarray:
    ones = jnp.ones(xn.shape[:-1] + (1,), dtype=xn.dtype)
    r = jnp.concatenate([xn, ones], axis=-1)
    return r / jnp.linalg.norm(r, axis=-1, keepdims=True)
