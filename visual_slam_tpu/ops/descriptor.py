"""ORB-style rotated-BRIEF binary descriptors (256 bit), fully batched.

Replacement for the SIFT descriptor stage of the reference's
FeatureExtractor (src/v2/frame.py:11-13; ORB itself is what the author
commented out at frame.py:8, and what the original north star named).

All K keypoints are described at once: the 256 point-pair pattern is rotated
by each keypoint's orientation, sampled with bilinear interpolation via one
batched gather, compared elementwise, and packed into uint32[8] words. No
per-keypoint loops anywhere.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH_RADIUS = 13  # sample offsets stay inside a 31x31 patch after rotation


def _make_pattern() -> np.ndarray:
    """Deterministic BRIEF test pattern: (N_BITS, 2, 2) float32 offsets.

    Gaussian-distributed around the center (sigma = patch/5), the classic
    BRIEF-32 recipe; fixed seed so descriptors are stable across runs.
    """
    rng = np.random.default_rng(20240616)
    sigma = PATCH_RADIUS / 2.0
    pts = rng.normal(scale=sigma, size=(N_BITS, 2, 2))
    return np.clip(pts, -PATCH_RADIUS, PATCH_RADIUS).astype(np.float32)


# Module-level constants are NumPy on purpose: a jnp array here would
# initialize a device backend at import time — before a CLI's --platform
# switch can take effect — and pin these to the wrong device for the whole
# process. NumPy constants are closed over by jit traces as literals.
PATTERN = _make_pattern()  # (256, 2, 2) — (pair, endpoint, xy)
# Lane-friendly flattening: [256 first endpoints, 256 second endpoints].
# Vector units want a large minor dimension; shapes like (K, 256, 2) put 2
# in the minor dimension, so all sampling math below runs on (K, 512)
# instead.
_PX = np.concatenate([PATTERN[:, 0, 0], PATTERN[:, 1, 0]])  # (512,)
_PY = np.concatenate([PATTERN[:, 0, 1], PATTERN[:, 1, 1]])  # (512,)


def _bilinear(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample of (H,W) image at float coords; x/y any shape."""
    H, W = img.shape
    x0 = jnp.clip(jnp.floor(x), 0, W - 2)
    y0 = jnp.clip(jnp.floor(y), 0, H - 2)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    flat = img.reshape(-1)
    idx00 = y0i * W + x0i
    v00 = flat[idx00]
    v01 = flat[idx00 + 1]
    v10 = flat[idx00 + W]
    v11 = flat[idx00 + W + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def sample_offsets(uv: jnp.ndarray, theta: jnp.ndarray, width: int, height: int):
    """Stage 1: rotated-pattern sample indices + bilinear fractions.

    Returns (idx (K,512) int32 into the flattened image, fx, fy (K,512)).
    All intermediates are (K, 512) — see the layout note at _PX above.
    """
    c, s = jnp.cos(theta)[:, None], jnp.sin(theta)[:, None]  # (K,1)
    rx = c * _PX[None, :] - s * _PY[None, :]  # (K,512)
    ry = s * _PX[None, :] + c * _PY[None, :]
    xs = uv[:, 0:1] + rx
    ys = uv[:, 1:2] + ry
    x0 = jnp.clip(jnp.floor(xs), 0, width - 2)
    y0 = jnp.clip(jnp.floor(ys), 0, height - 2)
    idx = y0.astype(jnp.int32) * width + x0.astype(jnp.int32)
    return idx, xs - x0, ys - y0


def gather_and_pack(
    img_blurred: jnp.ndarray, idx: jnp.ndarray, fx: jnp.ndarray, fy: jnp.ndarray
) -> jnp.ndarray:
    """Stage 2: bilinear gather + comparisons + bit packing -> (K,8) uint32."""
    W = img_blurred.shape[1]
    flat = img_blurred.reshape(-1)
    v00 = flat[idx]
    v01 = flat[idx + 1]
    v10 = flat[idx + W]
    v11 = flat[idx + W + 1]
    vals = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    bits = (vals[:, :N_BITS] < vals[:, N_BITS:]).astype(jnp.uint32)  # (K,256)
    bits = bits.reshape(bits.shape[0], N_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)  # (K,8)


_gather_and_pack_jit = jax.jit(gather_and_pack)
_sample_offsets_jit = jax.jit(sample_offsets, static_argnames=("width", "height"))


def describe(
    img_blurred: jnp.ndarray, uv: jnp.ndarray, theta: jnp.ndarray
) -> jnp.ndarray:
    """Compute packed 256-bit descriptors.

    Args:
      img_blurred: (H,W) pre-blurred grayscale (blur once per image, not per
        keypoint — reuse ops.detect.gaussian_blur).
      uv: (K,2) keypoint pixel coords. theta: (K,) orientations (radians).
    Returns:
      (K, 8) uint32 packed descriptors.

    NOTE: this is a TWO-dispatch composition on purpose. When the index
    computation and the 524k-element gather land in the same XLA fusion,
    the gather can be serialized; materializing the indices between two
    jits keeps the vector-gather path. Inside a larger
    jit use `describe_fused` (accepting the fusion penalty) or call the two
    stages explicitly.
    """
    H, W = img_blurred.shape
    idx, fx, fy = _sample_offsets_jit(uv, theta, W, H)
    return _gather_and_pack_jit(img_blurred, idx, fx, fy)


@jax.jit
def describe_fused(
    img_blurred: jnp.ndarray, uv: jnp.ndarray, theta: jnp.ndarray
) -> jnp.ndarray:
    """Single-jit variant of `describe` for use inside larger jits."""
    H, W = img_blurred.shape
    idx, fx, fy = sample_offsets(uv, theta, W, H)
    return gather_and_pack(img_blurred, idx, fx, fy)


def unpack_pm1(desc: jnp.ndarray, dtype=jnp.bfloat16) -> jnp.ndarray:
    """(K,8) uint32 -> (K,256) ±1 values, the matmul form for matching."""
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (desc[:, :, None] >> shifts) & jnp.uint32(1)
    bits = bits.reshape(desc.shape[0], N_BITS)
    return (bits.astype(dtype) * 2 - 1)
