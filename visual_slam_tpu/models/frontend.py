"""Feature front-end model: detect + orient + describe in one jittable step.

The composed equivalent of the reference's per-frame
`Frame.process_frame` -> `FeatureExtractor.compute_features`
(src/v2/frame.py:85-91, :10-14): Shi-Tomasi corners promoted to oriented
keypoints with ORB-style binary descriptors, at a fixed feature budget with
a validity mask.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import descriptor, descriptor_mxu, detect


class Features(NamedTuple):
    """Fixed-shape per-frame features (the SoA Frame record).

    uv: (K,2) float32 pixel coords; desc: (K,8) uint32 packed 256-bit
    descriptors; score: (K,) corner response; valid: (K,) bool.
    """

    uv: jnp.ndarray
    desc: jnp.ndarray
    score: jnp.ndarray
    valid: jnp.ndarray


@partial(jax.jit, static_argnames=("max_features", "quality_level", "nms_radius"))
def _extract_stage1(img: jnp.ndarray, max_features: int,
                    quality_level: float = 0.01, nms_radius: int = 3):
    """Detection + blur + orientation (conv/top-k work only)."""
    img = to_gray(img)  # also normalizes 2-D uint8 input to float [0,1]
    uv, score, valid = detect.detect_corners(
        img, max_corners=max_features, quality_level=quality_level,
        nms_radius=nms_radius,
    )
    blurred = detect.gaussian_blur(img, sigma=2.0, radius=4)
    theta = detect.orientation(img, uv)
    return uv, score, valid, blurred, theta


@jax.jit
def _to_gray_jit(img: jnp.ndarray) -> jnp.ndarray:
    return to_gray(img)


@partial(jax.jit, static_argnames=("max_features", "quality_level", "border"))
def _topk_select(peaks: jnp.ndarray, max_features: int, quality_level: float = 0.01, border: int = 16):
    """NMS'd peak map -> top-K corner coordinates.

    EXACT top_k on purpose: approx_max_k (recall 0.95) swaps the weakest
    corners near the cut, which moved the 200-frame ICL-NUIM ATE
    0.0147 -> 0.0187."""
    H, W = peaks.shape
    top, idx = jax.lax.top_k(peaks.reshape(-1), max_features)
    y = (idx // W).astype(jnp.float32)
    x = (idx % W).astype(jnp.float32)
    uv = jnp.stack([x, y], axis=-1)
    valid = (top > quality_level * top[0]) & jnp.isfinite(top)
    return uv, top, valid


@partial(jax.jit, static_argnames=("max_features", "quality_level", "nms_radius"))
def _extract_stencil_fused(
    img: jnp.ndarray,
    max_features: int,
    quality_level: float = 0.01,
    nms_radius: int = 3,
) -> Features:
    """Whole production front-end as ONE jit: stencil detect + blur
    (ops.detect.corner_peaks_and_blur), exact top-K, per-keypoint patch
    slices and the bf16 sampling-matrix descriptor (ops.descriptor_mxu).
    One dispatch per frame."""
    gray = to_gray(img)
    peaks, blurred = detect.corner_peaks_and_blur(gray, nms_radius=nms_radius)
    uv, score, valid = _topk_select(peaks, max_features, quality_level)
    patches = descriptor_mxu.extract_patches(blurred, uv)
    desc, theta = descriptor_mxu.describe_patches(patches)
    return Features(uv=uv, desc=desc, score=score, valid=valid)


# Front-end route: "stencil" = production (shift-and-add stencil detect and
# blur, patch slices, bf16 sampling-matrix descriptors); "xla" = the
# conv/gather route (ops.detect convolutions + ops.descriptor bilinear
# gathers). Descriptors of the two routes are not bit-compatible.
FRONTEND_BACKEND = "stencil"


def extract(
    img: jnp.ndarray,
    max_features: int = 1024,
    quality_level: float = 0.01,
    nms_radius: int = 3,
) -> Features:
    """Full front-end for one image: grayscale (H,W) float32 in [0,1] or
    RGB (H,W,3) uint8 (converted on-device). quality_level/nms_radius
    mirror goodFeaturesToTrack's qualityLevel/minDistance (frame.py:11).

    The "xla" route runs as separate jits (detection, sample offsets,
    gather-and-pack) so the descriptor gather never fuses with its index
    production.
    """
    if FRONTEND_BACKEND == "stencil":
        return _extract_stencil_fused(
            jnp.asarray(img), max_features, quality_level, nms_radius
        )
    uv, score, valid, blurred, theta = _extract_stage1(
        img, max_features, quality_level, nms_radius
    )
    H, W = (img.shape[:2] if img.ndim == 3 else img.shape)
    idx, fx, fy = descriptor._sample_offsets_jit(uv, theta, W, H)
    desc = descriptor._gather_and_pack_jit(blurred, idx, fx, fy)
    return Features(uv=uv, desc=desc, score=score, valid=valid)


@partial(
    jax.jit, static_argnames=("max_features", "quality_level", "nms_radius")
)
def extract_fused(
    img: jnp.ndarray,
    max_features: int = 1024,
    quality_level: float = 0.01,
    nms_radius: int = 3,
) -> Features:
    """Single-jit front-end for use inside larger jitted computations
    (pays the fused-gather penalty; prefer `extract` at the host level)."""
    img = to_gray(img)  # also normalizes 2-D uint8 input to float [0,1]
    uv, score, valid = detect.detect_corners(
        img, max_corners=max_features,
        quality_level=quality_level, nms_radius=nms_radius,
    )
    blurred = detect.gaussian_blur(img, sigma=2.0, radius=4)
    theta = detect.orientation(img, uv)
    desc = descriptor.describe_fused(blurred, uv, theta)
    return Features(uv=uv, desc=desc, score=score, valid=valid)


_extract_batch_xla_v = jax.vmap(extract_fused, in_axes=(0, None, None, None))

_extract_batch_stencil_v = jax.vmap(
    _extract_stencil_fused, in_axes=(0, None, None, None)
)


def extract_batch(
    imgs: jnp.ndarray,
    max_features: int = 1024,
    quality_level: float = 0.01,
    nms_radius: int = 3,
) -> Features:
    """Batched front-end over a (B,H,W) stack.

    Production path is the vmapped stencil front-end, so the batched
    route — multi.run_batched / config #3 / the multichip dryrun — computes
    the same features as single-sequence production. The conv/gather route
    (extract_fused) is used when FRONTEND_BACKEND == "xla"."""
    if FRONTEND_BACKEND == "stencil":
        return _extract_batch_stencil_v(
            imgs, max_features, quality_level, nms_radius
        )
    return _extract_batch_xla_v(imgs, max_features, quality_level, nms_radius)


def extract_rgb(rgb_u8: jnp.ndarray, max_features: int = 1024) -> Features:
    """Front-end from a device-resident (H,W,3) uint8 image.

    Grayscale conversion happens on-device so the host->device transfer is
    the raw 0.9 MB uint8 frame, not a 1.2 MB float gray."""
    return extract(rgb_u8, max_features)


def to_gray(rgb: jnp.ndarray) -> jnp.ndarray:
    """(H,W,3) RGB or (H,W) gray, uint8/float -> (H,W) float32 in [0,1]."""
    img = rgb.astype(jnp.float32)
    if rgb.dtype == jnp.uint8:
        img = img / 255.0
    if rgb.ndim == 2:
        return img
    return (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    )
