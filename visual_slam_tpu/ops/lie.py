"""SO(3) / SE(3) Lie-group operations as pure, batch-friendly jnp functions.

Replacement for the reference's OpenCV `cv2.Rodrigues` usage
(reference: src/v2/helper_functions.py:269-278 `transformMatrix`/`Rtorvec`)
and the `Isometry3d` rigid-transform class (reference: src/v2/main.py:32-51).

All functions accept arbitrary leading batch dimensions; the group element
is carried in the trailing dims ((3,) vectors, (3,3) matrices, (4,4)
homogeneous transforms, (6,) se3 tangent vectors ordered [omega, v]).
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: rotation vector (...,3) -> rotation matrix (...,3,3).

    Mirrors `cv2.Rodrigues(rvec)` (reference: src/v2/helper_functions.py:269-274).
    Uses Taylor-safe coefficients so it is differentiable through theta -> 0.
    """
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    # sin(t)/t and (1-cos(t))/t^2 with small-angle fallbacks.
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (...,3,3) -> rotation vector (...,3).

    Mirrors `cv2.Rodrigues(R)` (reference: src/v2/helper_functions.py:276-278).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # Generic branch: theta / (2 sin theta) * vee(R - R^T)
    sin_t = jnp.sin(theta)
    w_generic = vee(R - jnp.swapaxes(R, -1, -2))
    scale = jnp.where(
        jnp.abs(sin_t) > 1e-5, theta / (2.0 * sin_t + _EPS), 0.5 + theta * theta / 12.0
    )
    w = w_generic * scale[..., None]
    # Near theta == pi the generic formula degenerates; recover axis from
    # the diagonal of R = I + 2 sin^2(t/2) (aa^T - I) => aa^T = (R + I)/2 diag.
    near_pi = cos_t < -1.0 + 1e-5
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip((diag + 1.0) * 0.5, 0.0, 1.0)
    axis = jnp.sqrt(axis_sq + _EPS)
    # Fix signs from off-diagonal terms (largest-axis convention).
    sx = jnp.sign(
        jnp.where(R[..., 2, 1] - R[..., 1, 2] >= 0, 1.0, -1.0)
    )
    sy = jnp.where(R[..., 0, 1] + R[..., 1, 0] >= 0, sx, -sx)
    sz = jnp.where(R[..., 0, 2] + R[..., 2, 0] >= 0, sx, -sx)
    axis = axis * jnp.stack([sx, sy, sz], axis=-1)
    w_pi = axis * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w)


def se3_exp(xi: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """se(3) tangent (...,6) = [omega, v] -> (R (...,3,3), t (...,3))."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = jnp.where(
        theta2 > _EPS, (1.0 - a) / theta2, 1.0 / 6.0 - theta2 / 120.0
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    t = jnp.einsum("...ij,...j->...i", V, v)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) -> se(3) tangent (...,6) = [omega, v]."""
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    coef = jnp.where(
        theta2 > _EPS,
        (1.0 - a / (2.0 * b + _EPS)) / (theta2 + _EPS),
        1.0 / 12.0 + theta2 / 720.0,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    Vinv = eye - 0.5 * W + coef * W2
    v = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([w, v], axis=-1)


def make_T(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R (...,3,3), t (...,3)) -> homogeneous transform (...,4,4)."""
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def split_T(T: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    return T[..., :3, :3], T[..., :3, 3]


def inv_T(T: jnp.ndarray) -> jnp.ndarray:
    """Rigid-transform inverse (mirrors Isometry3d.inverse, src/v2/main.py:42-43)."""
    R, t = split_T(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def compose(Ta: jnp.ndarray, Tb: jnp.ndarray) -> jnp.ndarray:
    return Ta @ Tb


def transform_points(T: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Apply (...,4,4) rigid transform to points (...,N,3) -> (...,N,3)."""
    R, t = split_T(T)
    return jnp.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]


def rotate_points(R: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("...ij,...nj->...ni", R, X)


def project_so3(M: jnp.ndarray) -> jnp.ndarray:
    """Project an arbitrary (...,3,3) matrix onto SO(3) via SVD (det +1)."""
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.stack(
        [jnp.ones_like(det), jnp.ones_like(det), det], axis=-1
    )
    return (U * D[..., None, :]) @ Vt


def scale_edge_terms(R, t, i, j, meas):
    """Closed-form scale-edge residuals and Jacobians, shared by the BA
    back-end (models/ba.py) and the pose graph (models/pose_graph.py).

    ≙ g2o's EdgeSBAScale (reference LocalBA.py:115-131): r_e = ||t_rel|| -
    meas with t_rel = t_i - R_i R_j^T t_j. The rotational derivative
    vanishes exactly (u^T [w]x t_rel = 0 for u || t_rel), so
    J_i = [0_3, u], J_j = [0_3, -R_rel^T u] — no autodiff needed.

    Args: R (K,3,3), t (K,3), edge endpoints i/j (E,), meas (E,).
    Returns (r (E,), Ji (E,6), Jj (E,6)).
    """
    Ri, ti = R[i], t[i]
    Rj, tj = R[j], t[j]
    R_rel = jnp.einsum("eab,ecb->eac", Ri, Rj)  # R_i R_j^T
    t_rel = ti - jnp.einsum("eab,eb->ea", R_rel, tj)
    nrm = jnp.sqrt(jnp.sum(t_rel * t_rel, axis=-1) + 1e-12)
    r = nrm - meas
    u = t_rel / nrm[:, None]
    zeros = jnp.zeros_like(u)
    Ji = jnp.concatenate([zeros, u], axis=-1)  # (E,6)
    Jj = jnp.concatenate(
        [zeros, -jnp.einsum("eab,ea->eb", R_rel, u)], axis=-1
    )  # (E,6)
    return r, Ji, Jj
