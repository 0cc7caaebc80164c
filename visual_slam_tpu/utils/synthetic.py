"""Synthetic large-map problem builder (config #5 shape).

A loop trajectory of K cameras observing P landmarks Q times each, emitted
directly in the packed planar BAProblem layout (point p's Q observation
slots are consecutive). Shared by scripts/large_map_bench.py (strong-scaling
/ absolute-rate runs) and scripts/weak_scaling.py (fixed landmarks-per-
device sweep) so both measure the same problem family.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..models import ba
from ..ops import lie


def build_loop_map(K: int, P: int, Q: int, seed: int = 0):
    """Synthetic config-#5 map. Returns (BAProblem, (R_cw, t_cw, X_gt))."""
    rng = np.random.RandomState(seed)
    # Loop trajectory: cameras on a circle, yawing along it.
    ang = 2 * np.pi * np.arange(K) / K
    radius = 8.0
    t_gt = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang), 0.05 * np.sin(5 * ang)],
        -1,
    ).astype(np.float32)
    # Camera-to-world axes (columns): forward z_cam tangent to the circle.
    yaw = ang + np.pi / 2
    cy, sy = np.cos(yaw), np.sin(yaw)
    zero = np.zeros_like(cy)
    one = np.ones_like(cy)
    x_cam = np.stack([-sy, cy, zero], -1)
    y_cam = np.stack([zero, zero, one], -1)
    z_cam = np.stack([cy, sy, zero], -1)
    R_gt = np.stack([x_cam, y_cam, z_cam], axis=-1).astype(np.float32)
    R_cw = np.transpose(R_gt, (0, 2, 1)).copy()
    t_cw = -np.einsum("kij,kj->ki", R_cw, t_gt).astype(np.float32)
    # Each point is anchored near a camera's frustum and observed by Q
    # cameras strided along the loop (stride supplies triangulation
    # parallax; consecutive cameras are near-identical viewpoints).
    stride = max(1, K // 128)
    base = rng.randint(0, K - Q * stride, P).astype(np.int32)
    C = t_gt[base]
    fwd = np.stack([np.cos(yaw[base]), np.sin(yaw[base]), 0 * yaw[base]], -1)
    X_gt = (
        C
        + fwd * rng.uniform(4.0, 9.0, (P, 1))
        + rng.normal(0, 0.8, (P, 3))
    ).astype(np.float32)
    cam = (
        base[:, None] + stride * np.arange(Q)[None, :]
    ).reshape(-1).astype(np.int32)
    intr = np.array([481.2, 480.0, 319.5, 239.5], np.float32)
    Rn = R_cw[cam]
    Xn = np.repeat(X_gt, Q, axis=0)
    Xc = np.einsum("nij,nj->ni", Rn, Xn) + t_cw[cam]
    z = Xc[:, 2]
    uv = np.stack(
        [
            intr[0] * Xc[:, 0] / np.maximum(z, 1e-3) + intr[2],
            intr[1] * Xc[:, 1] / np.maximum(z, 1e-3) + intr[3],
        ],
        -1,
    ).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    w = (z > 0.2).astype(np.float32)  # behind-camera slots are dead weight
    # Perturb initial estimates.
    dw = rng.normal(0, 0.004, (K, 3)).astype(np.float32)
    dR = np.asarray(jax.vmap(lie.so3_exp)(jnp.asarray(dw)))
    R0 = np.einsum("kij,kjl->kil", dR, R_cw).astype(np.float32)
    t0 = np.einsum("kij,kj->ki", dR, t_cw).astype(np.float32) + rng.normal(
        0, 0.02, (K, 3)
    ).astype(np.float32)
    R0[0], t0[0] = R_cw[0], t_cw[0]
    X0 = X_gt + rng.normal(0, 0.05, X_gt.shape).astype(np.float32)
    cam_fixed = np.zeros(K, bool)
    cam_fixed[0] = True
    se = np.zeros(1, np.float32)
    prob = ba.BAProblem(
        R=jnp.asarray(R0),
        t=jnp.asarray(t0),
        X=jnp.asarray(X0),
        pt_valid=jnp.ones(P, jnp.float32),
        cam=jnp.asarray(cam),
        uv=jnp.asarray(uv.T),
        w=jnp.asarray(w),
        intr=jnp.asarray(intr),
        cam_fixed=jnp.asarray(cam_fixed),
        se_i=jnp.zeros(1, jnp.int32),
        se_j=jnp.zeros(1, jnp.int32),
        se_meas=jnp.asarray(se),
        se_w=jnp.asarray(se),
        dinv=jnp.zeros(len(cam), jnp.float32),
        dw=jnp.zeros(len(cam), jnp.float32),
    )
    return prob, (R_cw, t_cw, X_gt)
