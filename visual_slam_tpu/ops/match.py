"""Brute-force binary-descriptor matching as one matmul.

Replacement for `cv2.BFMatcher().knnMatch(k=2)` + Lowe's ratio
test in the reference's FeatureMatcher (src/v2/frame.py:16-49), and for the
mutual-nearest-neighbor variant in src/slam.py:24-57.

The Hamming-distance matrix between two sets of 256-bit descriptors is
computed as a single matmul of their ±1 expansions: for ±1 vectors a,b of
length D, a·b = D - 2*hamming(a,b)  =>  hamming = (D - a·b)/2. A
[K,256]x[256,K] bf16 matmul runs on the tensor cores —
this replaces the N²·128 scalar-distance work called out as a reference hot
loop in SURVEY.md §3.

This is the single production matcher.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import descriptor as desc_mod


def hamming_matrix(desc1: jnp.ndarray, desc2: jnp.ndarray) -> jnp.ndarray:
    """(K1,8),(K2,8) packed uint32 -> (K1,K2) float32 Hamming distances."""
    a = desc_mod.unpack_pm1(desc1)
    b = desc_mod.unpack_pm1(desc2)
    # precision=DEFAULT: ±1 values are exact in bf16 and the matmul accumulates
    # in f32, so the fast path loses nothing (the package-wide default is
    # "highest", which would run this 6-pass for no accuracy gain).
    dot = jnp.dot(
        a, b.T, preferred_element_type=jnp.float32, precision=jax.lax.Precision.DEFAULT
    )
    return 0.5 * (desc_mod.N_BITS - dot)


@partial(jax.jit, static_argnames=("cross_check",))
def match_ratio_test(
    desc1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid1: jnp.ndarray,
    valid2: jnp.ndarray,
    ratio: float = 0.8,
    max_distance: float = 96.0,
    cross_check: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """knn(k=2) matching with Lowe's ratio test (ratio 0.8 ≙ frame.py:20).

    Fixed-shape output: one candidate match per query keypoint.

    Args:
      desc1/desc2: (K,8) packed descriptors. valid1/valid2: (K,) masks.
    Returns:
      idx2 (K1,) best-match index into set 2,
      dist (K1,) best Hamming distance,
      good (K1,) bool — passes ratio test, distance gate, validity, and
        (optionally) mutual-nearest-neighbor cross check.
    """
    D = hamming_matrix(desc1, desc2)  # (K1,K2)
    big = jnp.float32(1e9)
    D = jnp.where(valid1[:, None] & valid2[None, :], D, big)
    # Top-2 smallest along axis 1.
    neg_top2, idx_top2 = jax.lax.top_k(-D, 2)
    d1, d2 = -neg_top2[:, 0], -neg_top2[:, 1]
    idx2 = idx_top2[:, 0]
    good = (d1 < ratio * d2) & (d1 < max_distance) & valid1
    if cross_check:
        # Mutual NN: our best match's best match must be us.
        best_for_2 = jnp.argmin(D, axis=0)  # (K2,)
        mutual = best_for_2[idx2] == jnp.arange(D.shape[0])
        good = good & mutual
    return idx2, d1, good
