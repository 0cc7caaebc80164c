"""Batched-hypothesis RANSAC engine (fixed shape, jit/vmap-native).

Replacement for OpenCV's sequential RANSAC loops inside
`cv2.findEssentialMat` (reference: src/v2/helper_functions.py:52) and
`cv2.solvePnPRansac` (reference: src/v2/main.py:196).

Instead of data-dependent early-exit iteration, a fixed budget of B minimal
sets is sampled at once, all B models are solved with a vmapped minimal
solver, and all B x N residuals are scored in one batched computation —
turning RANSAC into a handful of large dense ops that XLA tiles onto the
device. Model selection uses the MSAC score (truncated residual), which is
what OpenCV's USAC/MAGSAC-era RANSAC effectively optimizes.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def sample_minimal_sets(
    key: jax.Array, n_hyps: int, set_size: int, n_data: int, mask: jnp.ndarray
) -> jnp.ndarray:
    """Sample (n_hyps, set_size) indices of valid data points.

    Sampling is with replacement across hypotheses and (approximately)
    without replacement inside a set via Gumbel top-k over masked logits —
    fully batched, no rejection loops.
    """
    logits = jnp.where(mask, 0.0, -jnp.inf)  # (N,)
    g = jax.random.gumbel(key, (n_hyps, n_data))
    scores = logits[None, :] + g
    _, idx = jax.lax.top_k(scores, set_size)
    return idx


def ransac(
    key: jax.Array,
    solver: Callable[[jnp.ndarray], jnp.ndarray],
    residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
    n_data: int,
    mask: jnp.ndarray,
    n_hyps: int,
    set_size: int,
    threshold_sq: float,
    extra_models: jnp.ndarray | None = None,
):
    """Generic fixed-budget RANSAC.

    Args:
      solver: maps a (set_size,) index vector to a model pytree-leaf array;
        vmapped over hypotheses.
      residual_fn: maps a model to per-datum squared residuals (N,);
        vmapped over models.
      mask: (N,) validity of data points.
      threshold_sq: inlier threshold on the squared residual.
      extra_models: optional (M, ...) models appended to the hypothesis pool
        (e.g. an extrinsic-guess pose, ≙ `useExtrinsicGuess=True` in
        cv2.solvePnPRansac, reference src/v2/main.py:196-197).
    Returns:
      best_model, inlier_mask (N,), best_score (scalar MSAC score, lower is
      better), n_inliers.
    """
    idx = sample_minimal_sets(key, n_hyps, set_size, n_data, mask)
    models = jax.vmap(solver)(idx)
    if extra_models is not None:
        models = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), models, extra_models
        )
    res = jax.vmap(residual_fn)(models)  # (B, N)
    res = jnp.where(mask[None, :], res, jnp.inf)
    capped = jnp.minimum(res, threshold_sq)
    msac = jnp.sum(jnp.where(mask[None, :], capped, 0.0), axis=-1)  # (B,)
    # Guard against NaN models.
    msac = jnp.where(jnp.isfinite(msac), msac, jnp.inf)
    best = jnp.argmin(msac)
    best_model = jax.tree.map(lambda a: a[best], models)
    inliers = (res[best] < threshold_sq) & mask
    return best_model, inliers, msac[best], jnp.sum(inliers)
