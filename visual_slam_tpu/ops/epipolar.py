"""Two-view epipolar geometry: essential-matrix estimation, scoring,
decomposition and cheirality-based pose recovery (pure jnp, batched, masked).

Replacement for the reference's OpenCV calls:
  - `cv2.findEssentialMat` + epipolar-line scoring: `estimateEssential`
    (src/v2/helper_functions.py:47-70),
  - `cv2.recoverPose` + cheirality filtering: `estimateRelativePose`
    (src/v2/helper_functions.py:164-209),
  - 4-candidate cheirality vote: `chooseRealizableSolution`
    (src/v2/helper_functions.py:125-161).

Convention: E satisfies  xn2^T E xn1 = 0  for normalized image coordinates,
with (R, t) the cam1->cam2 transform (X2 = R X1 + t), E = [t]_x R — the same
convention as cv2.findEssentialMat/recoverPose.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import linalg as linalg_mod, triangulate as tri


def _homog(xn: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate(
        [xn, jnp.ones(xn.shape[:-1] + (1,), dtype=xn.dtype)], axis=-1
    )


def eight_point_essential(
    xn1: jnp.ndarray, xn2: jnp.ndarray, weights: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Weighted 8-point essential-matrix estimate from normalized coords.

    Args:
      xn1, xn2: (...,N,2) normalized image coordinates.
      weights: optional (...,N) non-negative weights / validity mask.
    Returns:
      (...,3,3) essential matrix with enforced (1,1,0) singular values.
    """
    if weights is None:
        weights = jnp.ones(xn1.shape[:-1], dtype=xn1.dtype)
    # Hartley normalization (per input set): zero-mean, RMS sqrt(2). Critical
    # for float32 conditioning of the 9x9 eigenproblem (no float64).
    w_sum = jnp.sum(weights, axis=-1, keepdims=True) + 1e-12
    mu1 = jnp.sum(xn1 * weights[..., None], axis=-2, keepdims=True) / w_sum[..., None]
    mu2 = jnp.sum(xn2 * weights[..., None], axis=-2, keepdims=True) / w_sum[..., None]
    d1 = jnp.sqrt(
        jnp.sum(jnp.sum((xn1 - mu1) ** 2, -1) * weights, -1, keepdims=True) / w_sum
    )
    d2 = jnp.sqrt(
        jnp.sum(jnp.sum((xn2 - mu2) ** 2, -1) * weights, -1, keepdims=True) / w_sum
    )
    s1 = jnp.sqrt(2.0) / (d1 + 1e-12)
    s2 = jnp.sqrt(2.0) / (d2 + 1e-12)
    p1 = (xn1 - mu1) * s1[..., None]
    p2 = (xn2 - mu2) * s2[..., None]

    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = jnp.ones_like(x1)
    # Row layout for vec(E) row-major: x2^T E x1 = 0.
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
    )  # (...,N,9)
    # Weighted homogeneous solve via row-normalized Gram + eigh (batched;
    # the Hartley normalization above keeps the squared conditioning inside
    # float32 — see ops.linalg).
    e = linalg_mod.solve_weighted_homogeneous(A, jnp.sqrt(weights + 0.0))
    E = e.reshape(e.shape[:-1] + (3, 3))
    # Denormalize: E = T2^T En T1 with Ti = [[si,0,-si*mui]; [0,0,1]].
    def _T(s, mu):
        z = jnp.zeros_like(s[..., 0])
        o = jnp.ones_like(z)
        sx = s[..., 0]
        row0 = jnp.stack([sx, z, -sx * mu[..., 0, 0]], axis=-1)
        row1 = jnp.stack([z, sx, -sx * mu[..., 0, 1]], axis=-1)
        row2 = jnp.stack([z, z, o], axis=-1)
        return jnp.stack([row0, row1, row2], axis=-2)

    T1 = _T(s1, mu1)
    T2 = _T(s2, mu2)
    E = jnp.swapaxes(T2, -1, -2) @ E @ T1
    # Project onto the essential manifold: singular values (1,1,0).
    U, _, Vt = jnp.linalg.svd(E)
    det_u = jnp.linalg.det(U)
    det_v = jnp.linalg.det(Vt)
    # Keep U, V in SO(3) so decomposition later is clean.
    U = U * jnp.stack([jnp.ones_like(det_u), jnp.ones_like(det_u), det_u], -1)[..., None, :]
    Vt = Vt * jnp.stack([jnp.ones_like(det_v), jnp.ones_like(det_v), det_v], -1)[..., :, None]
    S = jnp.asarray([1.0, 1.0, 0.0], dtype=E.dtype)
    return (U * S[..., None, :]) @ Vt


def epipolar_distance_sq(
    E: jnp.ndarray, xn1: jnp.ndarray, xn2: jnp.ndarray
) -> jnp.ndarray:
    """Symmetric squared point-to-epipolar-line distance (normalized coords).

    ≙ the MATLAB-style scoring in `estimateEssential`
    (src/v2/helper_functions.py:55-68): distance of x2 to line E x1 plus
    distance of x1 to line E^T x2.
    """
    X1 = _homog(xn1)
    X2 = _homog(xn2)
    l2 = jnp.einsum("...ij,...nj->...ni", E, X1)  # line in image 2
    l1 = jnp.einsum("...ji,...nj->...ni", E, X2)  # line in image 1
    num = jnp.einsum("...ni,...ni->...n", X2, l2)
    d2 = num**2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = num**2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    return d1 + d2


def sampson_error_sq(
    E: jnp.ndarray, xn1: jnp.ndarray, xn2: jnp.ndarray
) -> jnp.ndarray:
    """First-order geometric (Sampson) squared error."""
    X1 = _homog(xn1)
    X2 = _homog(xn2)
    Ex1 = jnp.einsum("...ij,...nj->...ni", E, X1)
    Etx2 = jnp.einsum("...ji,...nj->...ni", E, X2)
    num = jnp.einsum("...ni,...ni->...n", X2, Ex1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / (den + 1e-12)


def refine_essential_gn(
    E0: jnp.ndarray,
    xn1: jnp.ndarray,
    xn2: jnp.ndarray,
    weights: jnp.ndarray,
    n_iters: int = 5,
) -> jnp.ndarray:
    """Refine an essential matrix by Gauss-Newton on the Sampson error over
    its minimal (R, t) parameterization (5 DOF: so(3) x tangent-of-S2).

    This replaces large-SVD least-squares refits: float32 Gram/SVD solves
    cannot reach the precision the inlier classification needs, while a
    manifold GN iteration is cheap (einsums + one 5x5 solve per iteration)
    and lands at the geometric optimum. Robustness comes from the caller's
    IRLS weights.
    """
    from . import lie as lie_mod

    # Seed (R, t) from the cheirality-voted decomposition of E0.
    R_w, t_w, _, _, _ = recover_pose(E0, xn1, xn2, weights > 0)

    X1 = _homog(xn1)  # (N,3)
    X2 = _homog(xn2)

    def sampson_residual(R, t):
        E = lie_mod.hat(t) @ R
        Ex1 = X1 @ E.T  # (N,3)
        Etx2 = X2 @ E
        num = jnp.sum(X2 * Ex1, axis=-1)
        den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        return num / jnp.sqrt(den + 1e-12)

    def params_to_Rt(p, R_base, t_base, B):
        R = lie_mod.so3_exp(p[:3]) @ R_base
        t = t_base + B @ p[3:5]
        t = t / (jnp.linalg.norm(t) + 1e-12)
        return R, t

    def step(carry, _):
        R_base, t_base = carry
        # Tangent basis of S2 at t_base.
        a = jnp.where(
            jnp.abs(t_base[0]) < 0.9,
            jnp.asarray([1.0, 0.0, 0.0], t_base.dtype),
            jnp.asarray([0.0, 1.0, 0.0], t_base.dtype),
        )
        b1 = jnp.cross(t_base, a)
        b1 = b1 / (jnp.linalg.norm(b1) + 1e-12)
        b2 = jnp.cross(t_base, b1)
        B = jnp.stack([b1, b2], axis=-1)  # (3,2)

        def res_fn(p):
            R, t = params_to_Rt(p, R_base, t_base, B)
            return sampson_residual(R, t)

        p0 = jnp.zeros(5, dtype=t_base.dtype)
        r = res_fn(p0)
        J = jax.jacfwd(res_fn)(p0)  # (N,5)
        wJ = J * weights[:, None]
        H = wJ.T @ J + 1e-8 * jnp.eye(5, dtype=J.dtype)
        g = wJ.T @ r
        p = -jnp.linalg.solve(H, g)
        R_new, t_new = params_to_Rt(p, R_base, t_base, B)
        return (R_new, t_new), None

    (R, t), _ = jax.lax.scan(step, (R_w, t_w), None, length=n_iters)
    return lie_mod.hat(t) @ R


def decompose_essential(
    E: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """E -> two rotation candidates (Ra, Rb) and unit translation t.

    Closed-form SVD decomposition (≙ cv2.decomposeEssentialMat used inside
    recoverPose; same math the reference hand-derives in src/testing.py's
    `essentialToRt` cell).
    """
    U, _, Vt = jnp.linalg.svd(E)
    det_u = jnp.linalg.det(U)
    det_v = jnp.linalg.det(Vt)
    U = U * jnp.stack([jnp.ones_like(det_u), jnp.ones_like(det_u), det_u], -1)[..., None, :]
    Vt = Vt * jnp.stack([jnp.ones_like(det_v), jnp.ones_like(det_v), det_v], -1)[..., :, None]
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    return Ra, Rb, t


def recover_pose(
    E: jnp.ndarray,
    xn1: jnp.ndarray,
    xn2: jnp.ndarray,
    mask: jnp.ndarray,
    distance_thresh: float = 50.0,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Select the realizable (R, t) among the 4 essential decompositions by a
    cheirality vote, and triangulate the points under the winner.

    ≙ `cv2.recoverPose(E, ..., distanceThresh=50)` as used by
    `estimateRelativePose` (src/v2/helper_functions.py:174-195) and the
    cheirality vote of `chooseRealizableSolution` (:125-161).

    Args:
      E: (3,3). xn1/xn2: (N,2) normalized coords. mask: (N,) bool of valid
      correspondences. distance_thresh: max accepted depth in view 1.
    Returns:
      R (3,3), t (3,) cam1->cam2 with ||t||=1, X1 (N,3) points in *cam-1*
      frame, good (N,) bool cheirality mask, valid_fraction scalar.
    """
    Ra, Rb, t = decompose_essential(E)
    Rs = jnp.stack([Ra, Ra, Rb, Rb])  # (4,3,3)
    ts = jnp.stack([t, -t, t, -t])  # (4,3)

    eyeR = jnp.eye(3, dtype=E.dtype)
    zt = jnp.zeros(3, dtype=E.dtype)

    def count_for(Rc, tc):
        # Triangulate in cam-1 frame: cam1 = identity, cam2 = (Rc, tc).
        X1 = tri.triangulate_midpoint(eyeR, zt, Rc, tc, xn1, xn2)
        z1 = X1[..., 2]
        X2 = jnp.einsum("ij,nj->ni", Rc, X1) + tc
        z2 = X2[..., 2]
        good = (z1 > 0) & (z2 > 0) & (z1 < distance_thresh) & mask
        return jnp.sum(good), X1, good

    counts, X1s, goods = [], [], []
    for k in range(4):
        c, X1, g = count_for(Rs[k], ts[k])
        counts.append(c)
        X1s.append(X1)
        goods.append(g)
    counts = jnp.stack(counts)
    X1s = jnp.stack(X1s)
    goods = jnp.stack(goods)
    best = jnp.argmax(counts)
    n_valid = jnp.maximum(jnp.sum(mask), 1)
    valid_fraction = counts[best].astype(E.dtype) / n_valid.astype(E.dtype)
    return Rs[best], ts[best], X1s[best], goods[best], valid_fraction
