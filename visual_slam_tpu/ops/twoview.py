"""Two-view relative pose estimation: RANSAC essential matrix + cheirality
pose recovery, composed from the batched primitives.

Equivalent of the reference's `estimateEssential`
(src/v2/helper_functions.py:47-70) and `estimateRelativePose` (:164-209)
pair as called from the map-initialization loop (src/v2/main.py:103-114).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import epipolar, projection, ransac as ransac_mod


def estimate_essential_ransac(
    key: jax.Array,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    intr: jnp.ndarray,
    mask: jnp.ndarray,
    threshold: float | None = None,
    n_hyps: int = 512,
):
    """RANSAC essential-matrix estimation from pixel correspondences.

    ≙ `estimateEssential` (src/v2/helper_functions.py:47-70): normalize via
    K^{-1}, robust-fit E, score with the symmetric epipolar distance at
    threshold essTh = 3.0/fx (reference: src/v2/main.py:103).

    Returns (E, inlier_mask, n_inliers).
    """
    if threshold is None:
        threshold = 3.0 / intr[0]
    xn1 = projection.normalize_pixels(uv1, intr)
    xn2 = projection.normalize_pixels(uv2, intr)

    def solver(idx):
        return epipolar.eight_point_essential(xn1[idx], xn2[idx])

    def residual(E):
        # Symmetric epipolar distance; factor 2 matches scoring both images.
        return 0.5 * epipolar.epipolar_distance_sq(E, xn1, xn2)

    E, inliers, _, n_in = ransac_mod.ransac(
        key,
        solver,
        residual,
        n_data=uv1.shape[0],
        mask=mask,
        n_hyps=n_hyps,
        set_size=8,
        threshold_sq=threshold**2,
    )
    # Local optimization: Gauss-Newton on the (R,t) manifold over the inlier
    # set (Sampson error). Float32 linear refits cannot reach the precision
    # the inlier classification needs (see refine_essential_gn); the manifold
    # GN lands at the geometric optimum with no large SVD.
    th_sq = threshold**2
    for _ in range(3):
        E = epipolar.refine_essential_gn(
            E, xn1, xn2, inliers.astype(xn1.dtype), n_iters=4
        )
        res = 0.5 * epipolar.epipolar_distance_sq(E, xn1, xn2)
        inliers = (res < th_sq) & mask
    # One last refine on the final (largest) inlier set.
    E = epipolar.refine_essential_gn(E, xn1, xn2, inliers.astype(xn1.dtype), n_iters=4)
    return E, inliers, jnp.sum(inliers)


def estimate_relative_pose_auto(
    key: jax.Array,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    intr: jnp.ndarray,
    mask: jnp.ndarray,
    h_ratio_threshold: float = 0.45,
    distance_thresh: float = 50.0,
):
    """Homography-vs-essential model selection two-view pose.

    ≙ the v1 pipeline's model selection (src/v1/slam_test.py:207-218): fit
    both models, pick homography when its inlier-support ratio exceeds
    `h_ratio_threshold` (planar/low-parallax scenes), else essential.

    Returns (R, t, X1, good, valid_fraction, used_homography(bool device)).
    """
    from . import homography as homog_mod

    kE, kH = jax.random.split(key)
    th = 3.0 / intr[0]
    E, inl_E, n_E = estimate_essential_ransac(kE, uv1, uv2, intr, mask, threshold=th)
    xn1 = projection.normalize_pixels(uv1, intr)
    xn2 = projection.normalize_pixels(uv2, intr)
    H, inl_H, n_H = homog_mod.estimate_homography_ransac(
        kH, xn1, xn2, mask, threshold=th
    )
    use_H = n_H.astype(jnp.float32) > h_ratio_threshold * jnp.maximum(
        (n_H + n_E).astype(jnp.float32), 1.0
    )
    R_E, t_E, X_E, g_E, f_E = epipolar.recover_pose(E, xn1, xn2, inl_E, distance_thresh)
    R_H, t_H, X_H, g_H, f_H = homog_mod.recover_pose_homography(
        H, xn1, xn2, inl_H, distance_thresh
    )
    pick = lambda a, b: jnp.where(use_H, a, b)
    return (
        pick(R_H, R_E),
        pick(t_H, t_E),
        jnp.where(use_H, X_H, X_E),
        jnp.where(use_H, g_H, g_E),
        pick(f_H, f_E),
        use_H,
    )


def estimate_relative_pose(
    E: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    intr: jnp.ndarray,
    inliers: jnp.ndarray,
    distance_thresh: float = 50.0,
):
    """E + inlier correspondences -> (R, t, X1, good_mask, valid_fraction).

    ≙ `estimateRelativePose(..., "Essential")` (src/v2/helper_functions.py:
    174-195): recoverPose with distanceThresh=50, returning triangulated
    points (cam-1 frame) filtered by the cheirality mask, plus the fraction
    of inliers that pass cheirality (gated at 0.9 by src/v2/main.py:113).
    """
    xn1 = projection.normalize_pixels(uv1, intr)
    xn2 = projection.normalize_pixels(uv2, intr)
    return epipolar.recover_pose(E, xn1, xn2, inliers, distance_thresh)
