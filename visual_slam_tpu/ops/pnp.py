"""Perspective-n-Point: batched DLT solver, Gauss-Newton refinement, and
fixed-budget RANSAC wrapper (pure jnp).

Replacement for `cv2.solvePnPRansac(..., useExtrinsicGuess=True)`
as used by the tracking loop (reference: src/v2/main.py:191-197) and for the
rvec/tvec <-> matrix helpers `transformMatrix`/`Rtorvec`
(src/v2/helper_functions.py:269-278) — the latter live in ops.lie here.

Convention: the solved pose (R_cw, t_cw) is the world->camera transform, the
direct analog of OpenCV's (rvec, tvec).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import lie, linalg as linalg_mod, projection, ransac as ransac_mod


def pnp_dlt(Xw: jnp.ndarray, xn: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Direct linear transform PnP from >=6 correspondences.

    Args:
      Xw: (S,3) world points; xn: (S,2) *normalized* image coordinates.
    Returns:
      (R_cw (3,3), t_cw (3,)). R is projected onto SO(3); accuracy comes from
      the subsequent Gauss-Newton polish, this only seeds RANSAC hypotheses.
    """
    S = Xw.shape[0]
    ones = jnp.ones((S, 1), dtype=Xw.dtype)
    zeros = jnp.zeros((S, 4), dtype=Xw.dtype)
    Xh = jnp.concatenate([Xw, ones], axis=-1)  # (S,4)
    x, y = xn[:, 0:1], xn[:, 1:2]
    rows_u = jnp.concatenate([Xh, zeros, -x * Xh], axis=-1)  # (S,12)
    rows_v = jnp.concatenate([zeros, Xh, -y * Xh], axis=-1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)  # (2S,12)
    P = linalg_mod.solve_homogeneous(A).reshape(3, 4)
    # Sign: majority of points must have positive depth.
    z = Xh @ P[2]
    P = P * jnp.sign(jnp.sum(jnp.sign(z)) + 0.5)
    M = P[:, :3]
    U, s, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = (U * D[None, :]) @ Vt
    scale = jnp.mean(s)
    t = P[:, 3] / jnp.where(scale > 1e-12, scale, 1e-12)
    return R, t


def reprojection_error_sq(
    R_cw: jnp.ndarray,
    t_cw: jnp.ndarray,
    Xw: jnp.ndarray,
    uv: jnp.ndarray,
    intr: jnp.ndarray,
) -> jnp.ndarray:
    """Squared pixel reprojection error (N,). Points behind camera -> inf."""
    pred, z = projection.project(R_cw, t_cw, Xw, intr)
    err = jnp.sum((pred - uv) ** 2, axis=-1)
    return jnp.where(z > 1e-6, err, jnp.inf)


@partial(jax.jit, static_argnames=("n_iters",))
def pnp_gauss_newton(
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    Xw: jnp.ndarray,
    uv: jnp.ndarray,
    intr: jnp.ndarray,
    weights: jnp.ndarray,
    n_iters: int = 10,
    huber_delta: float = 2.4477,  # sqrt(5.991), ≙ reference LocalBA.py:82
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Motion-only Gauss-Newton on the reprojection error.

    The same math as motion-only bundle adjustment with all landmarks fixed
    (reference: LocalBA.py:195-229) for a single camera; poses updated by
    left-multiplied se(3) increments.
    """
    fx, fy = intr[0], intr[1]
    # Channel-major layout: the big N axis is the contiguous one. The
    # original (N,2,3)/(N,3,6)/(N,2,6) einsum formulation padded its
    # trailing small dimensions to full vector tiles; these unrolled (N,)
    # ops + 6x6 sum-reductions are the same math at a fraction of the
    # traffic. Jacobian rows are the
    # identical closed forms used by models/ba_large._jacobians.
    Xt = Xw.T  # (3,N)
    uvt = uv.T  # (2,N)

    def step(carry, _):
        R, t = carry
        Xc = [
            R[i, 0] * Xt[0] + R[i, 1] * Xt[1] + R[i, 2] * Xt[2] + t[i]
            for i in range(3)
        ]
        x, y, z0 = Xc
        z = jnp.where(jnp.abs(z0) > 1e-8, z0, 1e-8)
        iz = 1.0 / z
        r0 = fx * x * iz + intr[2] - uvt[0]
        r1 = fy * y * iz + intr[3] - uvt[1]
        # Huber IRLS weight per observation.
        rn = jnp.sqrt(r0 * r0 + r1 * r1 + 1e-12)
        w_rob = jnp.where(rn <= huber_delta, 1.0, huber_delta / rn)
        w = weights * w_rob * (z0 > 1e-6)
        a = fx * iz
        b = -fx * x * iz * iz
        c = fy * iz
        d = -fy * y * iz * iz
        zero = jnp.zeros_like(a)
        # J rows for delta = [omega, v] left-composed (dXc = -[Xc]x w + v).
        J0 = [b * y, a * z - b * x, -a * y, a, zero, b]
        J1 = [-c * z + d * y, -d * x, c * x, zero, c, d]
        # ONE batched (27,N)->27 reduction: separate scalar reduces carry a
        # high fixed cross-lane cost each (measured ~0.1 ms/GN-iteration for
        # the 27 of them at N=2048).
        rows = [
            w * (J0[k] * J0[l] + J1[k] * J1[l])
            for k in range(6)
            for l in range(k, 6)
        ] + [w * (J0[k] * r0 + J1[k] * r1) for k in range(6)]
        sums = jnp.sum(jnp.stack(rows), axis=1)  # (27,)
        H = jnp.zeros((6, 6), R.dtype)
        idx = 0
        for k in range(6):
            for l in range(k, 6):
                H = H.at[k, l].set(sums[idx])
                if k != l:
                    H = H.at[l, k].set(sums[idx])
                idx += 1
        H = H + 1e-6 * jnp.eye(6, dtype=R.dtype)
        g = sums[21:]
        delta = -jnp.linalg.solve(H, g)
        dR, dt = lie.se3_exp(delta)
        R_new = dR @ R
        t_new = dR @ t + dt
        return (R_new, t_new), None

    (R, t), _ = jax.lax.scan(step, (R0, t0), None, length=n_iters)
    return R, t


def solve_pnp_tracked(
    key: jax.Array,
    Xw: jnp.ndarray,
    uv: jnp.ndarray,
    intr: jnp.ndarray,
    mask: jnp.ndarray,
    guess_R: jnp.ndarray,
    guess_t: jnp.ndarray,
    n_hyps: int = 128,
    threshold_px: float = 8.0,
    refine_iters: int = 10,
    min_inliers: int = 25,
    min_inlier_frac: float = 0.25,
):
    """Tiered PnP for the tracking hot path: prior-seeded Gauss-Newton first,
    full batched RANSAC only when the refined pose cannot explain the
    matches.

    Same contract as `solve_pnp_ransac` (and the same reference semantic —
    cv2.solvePnPRansac with useExtrinsicGuess, src/v2/main.py:191-197: OpenCV
    likewise refines the guess and only falls back to minimal-sample search
    when the guess-seeded model loses the inlier vote). Rationale: at
    production shapes (N=2048, 128 hypotheses) the batched 12x12 eigh inside
    the DLT hypothesis solver costs far more than the Huber-IRLS GN refine,
    and with frame-rate motion priors the hypothesis pool virtually never
    outvotes the refined prior. The RANSAC
    branch lives under `lax.cond`, so the common path never pays for it;
    a bad prior (fast motion, relocalization seeds) yields few GN inliers
    and auto-selects the RANSAC branch.

    Returns (R_cw, t_cw, inlier_mask, n_inliers).
    """
    # The fast branch is solve_pnp_ransac with the prior as the winning
    # hypothesis: gate inliers on the RAW prior (exactly how RANSAC scores
    # its models), GN-polish on that inlier set, re-gate, polish once more.
    # Refining on ALL Huber-damped matches instead measurably drags the
    # pose toward gross outliers (Huber is linear, not zero, in the tails:
    # 200-frame ATE 0.021-0.057 across seeds vs 0.014-0.018 this way).
    res_p = reprojection_error_sq(guess_R, guess_t, Xw, uv, intr)
    inl_p = (res_p < threshold_px**2) & mask
    R0, t0 = pnp_gauss_newton(
        guess_R, guess_t, Xw, uv, intr, inl_p.astype(Xw.dtype),
        n_iters=refine_iters,
    )
    res0 = reprojection_error_sq(R0, t0, Xw, uv, intr)
    inl0 = (res0 < threshold_px**2) & mask
    R1, t1 = pnp_gauss_newton(
        R0, t0, Xw, uv, intr, inl0.astype(Xw.dtype), n_iters=refine_iters
    )
    res1 = reprojection_error_sq(R1, t1, Xw, uv, intr)
    inl1 = (res1 < threshold_px**2) & mask
    n1 = jnp.sum(inl1)
    n_cand = jnp.maximum(jnp.sum(mask), 1)
    need_ransac = (n1 < min_inliers) | (
        n1.astype(Xw.dtype) < min_inlier_frac * n_cand.astype(Xw.dtype)
    )

    def ransac_branch(_):
        return solve_pnp_ransac(
            key, Xw, uv, intr, mask, guess_R, guess_t,
            n_hyps=n_hyps, threshold_px=threshold_px,
            refine_iters=refine_iters,
        )

    def fast_branch(_):
        return R1, t1, inl1, n1

    return jax.lax.cond(need_ransac, ransac_branch, fast_branch, None)


def solve_pnp_ransac(
    key: jax.Array,
    Xw: jnp.ndarray,
    uv: jnp.ndarray,
    intr: jnp.ndarray,
    mask: jnp.ndarray,
    guess_R: jnp.ndarray | None = None,
    guess_t: jnp.ndarray | None = None,
    n_hyps: int = 256,
    threshold_px: float = 8.0,
    refine_iters: int = 10,
):
    """Fixed-budget PnP-RANSAC + Gauss-Newton polish.

    ≙ `cv2.solvePnPRansac` with `useExtrinsicGuess=True` (reference:
    src/v2/main.py:196-197): the previous pose enters the hypothesis pool, so
    a good motion prior short-circuits bad minimal samples exactly like the
    guess does in OpenCV.

    Returns (R_cw, t_cw, inlier_mask, n_inliers).
    """
    xn = projection.normalize_pixels(uv, intr)

    def solver(idx):
        R, t = pnp_dlt(Xw[idx], xn[idx])
        return jnp.concatenate([R.reshape(9), t])

    def residual(model):
        R = model[:9].reshape(3, 3)
        t = model[9:]
        return reprojection_error_sq(R, t, Xw, uv, intr)

    extra = None
    if guess_R is not None:
        extra = jnp.concatenate([guess_R.reshape(9), guess_t])[None, :]

    model, inliers, _, n_in = ransac_mod.ransac(
        key,
        solver,
        residual,
        n_data=Xw.shape[0],
        mask=mask,
        n_hyps=n_hyps,
        set_size=6,
        threshold_sq=threshold_px**2,
        extra_models=extra,
    )
    R, t = model[:9].reshape(3, 3), model[9:]
    R, t = pnp_gauss_newton(
        R, t, Xw, uv, intr, inliers.astype(Xw.dtype), n_iters=refine_iters
    )
    # Recompute inliers under the polished pose.
    res = reprojection_error_sq(R, t, Xw, uv, intr)
    inliers = (res < threshold_px**2) & mask
    return R, t, inliers, jnp.sum(inliers)
