"""Pinhole-camera projection primitives (pure jnp, batch-friendly).

Replacement for the reference's scattered projection helpers:
`MakeHomogeneous` (src/v2/helper_functions.py:362-364),
`CameraProjectionMatrix(2)` (src/v2/helper_functions.py:367-378),
`cv2.undistortPoints` normalization (src/v2/helper_functions.py:27-28).

Intrinsics are carried as a 4-vector (fx, fy, cx, cy) — the reference's
`Camera` class (src/v2/main.py:24-30) without the unused baseline.
Distortion-free pinhole, matching the reference (D = 0, src/v2/main.py:54).
"""
from __future__ import annotations

import jax.numpy as jnp


def intrinsics_matrix(intr: jnp.ndarray) -> jnp.ndarray:
    """(fx, fy, cx, cy) -> 3x3 K matrix."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z = jnp.zeros_like(fx)
    o = jnp.ones_like(fx)
    return jnp.stack(
        [
            jnp.stack([fx, z, cx]),
            jnp.stack([z, fy, cy]),
            jnp.stack([z, z, o]),
        ]
    )


def make_homogeneous(x: jnp.ndarray) -> jnp.ndarray:
    """(...,N,D) -> (...,N,D+1) with trailing ones (≙ MakeHomogeneous)."""
    ones = jnp.ones(x.shape[:-1] + (1,), dtype=x.dtype)
    return jnp.concatenate([x, ones], axis=-1)


def normalize_pixels(uv: jnp.ndarray, intr: jnp.ndarray) -> jnp.ndarray:
    """Pixels (...,2) -> normalized image coordinates via K^{-1}.

    Equivalent to `cv2.undistortPoints` with zero distortion
    (reference: src/v2/helper_functions.py:27-28).
    """
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return jnp.stack([x, y], axis=-1)


def denormalize(xy: jnp.ndarray, intr: jnp.ndarray) -> jnp.ndarray:
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    u = xy[..., 0] * fx + cx
    v = xy[..., 1] * fy + cy
    return jnp.stack([u, v], axis=-1)


def project(
    R_cw: jnp.ndarray, t_cw: jnp.ndarray, X_w: jnp.ndarray, intr: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Project world points into pixels.

    Args:
      R_cw, t_cw: world->camera rigid transform (camera extrinsics).
      X_w: (...,N,3) world points.
      intr: (fx, fy, cx, cy).
    Returns:
      uv (...,N,2) pixels, z (...,N) camera-frame depths.
    """
    Xc = jnp.einsum("...ij,...nj->...ni", R_cw, X_w) + t_cw[..., None, :]
    z = Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) > 1e-8, z, 1e-8)
    x = Xc[..., 0] / z_safe
    y = Xc[..., 1] / z_safe
    uv = denormalize(jnp.stack([x, y], axis=-1), intr)
    return uv, z


def projection_matrix(T_cw: jnp.ndarray, intr: jnp.ndarray) -> jnp.ndarray:
    """K @ [R|t] (3x4) from a world->camera 4x4 transform.

    ≙ `CameraProjectionMatrix2(Pose, K)` (src/v2/helper_functions.py:376-378),
    which the reference calls with Pose = inv(world pose) (src/v2/main.py:263-269).
    """
    K = intrinsics_matrix(intr)
    return jnp.einsum("ij,...jk->...ik", K, T_cw[..., :3, :4])
