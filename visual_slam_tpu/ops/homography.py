"""Homography estimation, scoring, and planar pose recovery (pure jnp).

Replacement for the reference's homography branch:
  - `estimateHomography` + symmetric-transfer-error scoring
    (src/v2/helper_functions.py:73-88, cv2.findHomography RANSAC),
  - `cv2.decomposeHomographyMat` + realizable-solution selection inside
    `estimateRelativePose(..., "Homographic")` (src/v2/helper_functions.py:
    196-209) and `chooseRealizableSolution` (:125-161).

The decomposition is the Faugeras-Lustman SVD construction (the same math
behind cv2.decomposeHomographyMat), yielding 8 (R, t, n) candidates that a
cheirality vote filters — mirroring chooseRealizableSolution.

Convention: H maps normalized image-1 coords to normalized image-2 coords,
x2 ~ H x1, with (R, t) the cam1->cam2 transform and n the plane normal in
cam-1 (H = R + t n^T / d).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import linalg as linalg_mod, ransac as ransac_mod, triangulate as tri


def _homog(x):
    return jnp.concatenate([x, jnp.ones(x.shape[:-1] + (1,), x.dtype)], axis=-1)


def dlt_homography(
    xn1: jnp.ndarray, xn2: jnp.ndarray, weights: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Weighted normalized-DLT homography from >=4 correspondences.

    xn1, xn2: (...,N,2). Returns (...,3,3) with H[2,2] scale free.
    """
    if weights is None:
        weights = jnp.ones(xn1.shape[:-1], dtype=xn1.dtype)
    w_sum = jnp.sum(weights, axis=-1, keepdims=True) + 1e-12
    mu1 = jnp.sum(xn1 * weights[..., None], -2, keepdims=True) / w_sum[..., None]
    mu2 = jnp.sum(xn2 * weights[..., None], -2, keepdims=True) / w_sum[..., None]
    d1 = jnp.sqrt(jnp.sum(jnp.sum((xn1 - mu1) ** 2, -1) * weights, -1, keepdims=True) / w_sum)
    d2 = jnp.sqrt(jnp.sum(jnp.sum((xn2 - mu2) ** 2, -1) * weights, -1, keepdims=True) / w_sum)
    s1 = jnp.sqrt(2.0) / (d1 + 1e-12)
    s2 = jnp.sqrt(2.0) / (d2 + 1e-12)
    p1 = (xn1 - mu1) * s1[..., None]
    p2 = (xn2 - mu2) * s2[..., None]
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    # Rows for h = vec(H) row-major: two equations per correspondence.
    r1 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    r2 = jnp.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)  # (...,2N,9)
    w2 = jnp.concatenate([weights, weights], axis=-1)
    h = linalg_mod.solve_weighted_homogeneous(A, jnp.sqrt(w2))
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    # Denormalize: H = T2^{-1} Hn T1.
    def _T(s, mu):
        zz = jnp.zeros_like(s[..., 0])
        oo = jnp.ones_like(zz)
        sx = s[..., 0]
        return jnp.stack(
            [
                jnp.stack([sx, zz, -sx * mu[..., 0, 0]], -1),
                jnp.stack([zz, sx, -sx * mu[..., 0, 1]], -1),
                jnp.stack([zz, zz, oo], -1),
            ],
            axis=-2,
        )

    def _Tinv(s, mu):
        zz = jnp.zeros_like(s[..., 0])
        oo = jnp.ones_like(zz)
        inv_s = 1.0 / s[..., 0]
        return jnp.stack(
            [
                jnp.stack([inv_s, zz, mu[..., 0, 0]], -1),
                jnp.stack([zz, inv_s, mu[..., 0, 1]], -1),
                jnp.stack([zz, zz, oo], -1),
            ],
            axis=-2,
        )

    H = _Tinv(s2, mu2) @ Hn @ _T(s1, mu1)
    return H / (H[..., 2:3, 2:3] + 1e-12)


def symmetric_transfer_error_sq(
    H: jnp.ndarray, xn1: jnp.ndarray, xn2: jnp.ndarray
) -> jnp.ndarray:
    """d(x2, H x1)^2 + d(x1, H^{-1} x2)^2 (≙ helper_functions.py:80-88)."""
    X1 = _homog(xn1)
    X2 = _homog(xn2)
    Hx1 = jnp.einsum("...ij,...nj->...ni", H, X1)
    fwd = Hx1[..., :2] / (Hx1[..., 2:3] + 1e-12) - xn2
    Hinv = jnp.linalg.inv(H)
    Hx2 = jnp.einsum("...ij,...nj->...ni", Hinv, X2)
    bwd = Hx2[..., :2] / (Hx2[..., 2:3] + 1e-12) - xn1
    return jnp.sum(fwd**2, -1) + jnp.sum(bwd**2, -1)


def estimate_homography_ransac(
    key: jax.Array,
    xn1: jnp.ndarray,
    xn2: jnp.ndarray,
    mask: jnp.ndarray,
    threshold: float,
    n_hyps: int = 512,
):
    """Fixed-budget RANSAC + weighted refit. Returns (H, inliers, n_in)."""

    def solver(idx):
        return dlt_homography(xn1[idx], xn2[idx])

    def residual(H):
        return 0.5 * symmetric_transfer_error_sq(H, xn1, xn2)

    H, inliers, _, n_in = ransac_mod.ransac(
        key,
        solver,
        residual,
        n_data=xn1.shape[0],
        mask=mask,
        n_hyps=n_hyps,
        set_size=4,
        threshold_sq=threshold**2,
    )
    for _ in range(2):
        H = dlt_homography(xn1, xn2, inliers.astype(xn1.dtype))
        res = 0.5 * symmetric_transfer_error_sq(H, xn1, xn2)
        inliers = (res < threshold**2) & mask
    return H, inliers, jnp.sum(inliers)


def decompose_homography(H: jnp.ndarray):
    """Faugeras-Lustman decomposition: H -> 8 candidate (R, t, n).

    Returns (Rs (8,3,3), ts (8,3), ns (8,3)); translations are scaled by the
    unknown plane distance (direction meaningful, like decomposeHomographyMat).
    """
    U, S, Vt = jnp.linalg.svd(H)
    d1, d2, d3 = S[0], S[1], S[2]
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    # Work with H' = H/d2 in the frame of V.
    denom = jnp.maximum(d1**2 - d3**2, 1e-12)
    x1 = jnp.sqrt(jnp.clip((d1**2 - d2**2) / denom, 0.0, 1.0))
    x3 = jnp.sqrt(jnp.clip((d2**2 - d3**2) / denom, 0.0, 1.0))

    def build(e1, e3, flip):
        if not flip:
            sin_t = (d1 - d3) * x1 * x3 * e1 * e3 / d2
            cos_t = (d1 * x3**2 + d3 * x1**2) / d2
            Rp = jnp.array(
                [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
            )
            Rp = jnp.stack(
                [
                    jnp.stack([cos_t, 0.0, -sin_t]),
                    jnp.stack([jnp.zeros(()), jnp.ones(()), jnp.zeros(())]),
                    jnp.stack([sin_t, 0.0, cos_t]),
                ]
            )
            tp = (d1 - d3) * jnp.stack([x1 * e1, jnp.zeros(()), -x3 * e3])
            sign = 1.0
        else:
            sin_p = (d1 + d3) * x1 * x3 * e1 * e3 / d2
            cos_p = (d3 * x1**2 - d1 * x3**2) / d2
            Rp = jnp.stack(
                [
                    jnp.stack([cos_p, 0.0, sin_p]),
                    jnp.stack([jnp.zeros(()), -jnp.ones(()), jnp.zeros(())]),
                    jnp.stack([sin_p, 0.0, -cos_p]),
                ]
            )
            tp = (d1 + d3) * jnp.stack([x1 * e1, jnp.zeros(()), x3 * e3])
            sign = -1.0
        np_ = jnp.stack([x1 * e1, jnp.zeros(()), x3 * e3])
        R = s * U @ Rp @ Vt
        t = jnp.einsum("ij,j->i", U, tp)
        n = jnp.einsum("ji,j->i", Vt, np_)
        return R, t, n

    Rs, ts, ns = [], [], []
    for flip in (False, True):
        for e1 in (1.0, -1.0):
            for e3 in (1.0, -1.0):
                R, t, n = build(e1, e3, flip)
                Rs.append(R)
                ts.append(t)
                ns.append(n)
    return jnp.stack(Rs), jnp.stack(ts), jnp.stack(ns)


def recover_pose_homography(
    H: jnp.ndarray,
    xn1: jnp.ndarray,
    xn2: jnp.ndarray,
    mask: jnp.ndarray,
    distance_thresh: float = 50.0,
):
    """Cheirality vote over the 8 homography decompositions.

    ≙ `chooseRealizableSolution` (helper_functions.py:125-161) applied to the
    homography branch of estimateRelativePose. Returns
    (R, t (unit), X1 (N,3) cam-1 points, good (N,), valid_fraction).
    """
    Rs, ts, ns = decompose_homography(H)
    eyeR = jnp.eye(3, dtype=H.dtype)
    zt = jnp.zeros(3, dtype=H.dtype)

    def count_for(Rc, tc):
        tn = tc / (jnp.linalg.norm(tc) + 1e-12)
        X1 = tri.triangulate_midpoint(eyeR, zt, Rc, tn, xn1, xn2)
        z1 = X1[..., 2]
        X2 = jnp.einsum("ij,nj->ni", Rc, X1) + tn
        z2 = X2[..., 2]
        good = (z1 > 0) & (z2 > 0) & (z1 < distance_thresh) & mask
        return jnp.sum(good), X1, good, tn

    counts, X1s, goods, tns = [], [], [], []
    for k in range(8):
        c, X1, g, tn = count_for(Rs[k], ts[k])
        counts.append(c)
        X1s.append(X1)
        goods.append(g)
        tns.append(tn)
    counts = jnp.stack(counts)
    best = jnp.argmax(counts)
    n_valid = jnp.maximum(jnp.sum(mask), 1)
    frac = counts[best].astype(H.dtype) / n_valid.astype(H.dtype)
    return (
        jnp.stack(Rs)[best],
        jnp.stack(tns)[best],
        jnp.stack(X1s)[best],
        jnp.stack(goods)[best],
        frac,
    )
