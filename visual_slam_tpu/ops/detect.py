"""Corner detection: Shi-Tomasi/Harris response, NMS, fixed-K selection,
and ORB-style orientation — all as fixed-shape XLA ops.

Replacement for `cv2.goodFeaturesToTrack(maxCorners=3000,
qualityLevel=0.01, minDistance=7)` in the reference's FeatureExtractor
(src/v2/frame.py:10-14). Instead of a variable-length corner list, the
detector returns exactly K keypoints with a validity mask — the fixed-shape
discipline the whole framework is built on (SURVEY.md §7).

Two formulations of the same detector:
  * `detect_corners` — convolutions + `reduce_window` NMS (the "xla"
    front-end route);
  * `corner_peaks_and_blur` — the production route's shift-and-add
    stencils: Sobel, 3x3 structure-tensor box sums, min-eigenvalue
    response, border mask, separable NMS and the descriptor-stage Gaussian
    blur as elementwise ops on whole arrays, which XLA fuses into a few
    memory-bound loops (~78 flops/px).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def _conv2d(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Same-padding 2D convolution of a (H,W) image with a (kh,kw) kernel.

    HIGHEST precision: corner selection ranks near-equal responses, and a
    reduced-precision convolution reorders that ranking across backends —
    exact f32 keeps detection deterministic.
    """
    return jax.lax.conv_general_dilated(
        img[None, None, :, :],
        kernel[None, None, :, :],
        window_strides=(1, 1),
        padding="SAME",
        precision=jax.lax.Precision.HIGHEST,
    )[0, 0]


def _box_blur(img: jnp.ndarray, size: int) -> jnp.ndarray:
    k = jnp.ones((size, size), dtype=img.dtype) / (size * size)
    return _conv2d(img, k)


def gaussian_blur(img: jnp.ndarray, sigma: float = 1.0, radius: int = 2) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=img.dtype)
    g = jnp.exp(-0.5 * (x / sigma) ** 2)
    g = g / jnp.sum(g)
    img = _conv2d(img, g[None, :])
    return _conv2d(img, g[:, None])


def shi_tomasi_response(img: jnp.ndarray, window: int = 3) -> jnp.ndarray:
    """Min-eigenvalue corner response (exactly what goodFeaturesToTrack ranks).

    img: (H,W) float32 grayscale in [0,1].
    """
    sobel_x = jnp.asarray(
        [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=img.dtype
    ) / 8.0
    sobel_y = sobel_x.T
    ix = _conv2d(img, sobel_x)
    iy = _conv2d(img, sobel_y)
    ixx = _box_blur(ix * ix, window)
    iyy = _box_blur(iy * iy, window)
    ixy = _box_blur(ix * iy, window)
    # Smaller eigenvalue of the structure tensor [[ixx,ixy],[ixy,iyy]].
    tr = 0.5 * (ixx + iyy)
    det_part = jnp.sqrt(jnp.maximum((0.5 * (ixx - iyy)) ** 2 + ixy * ixy, 0.0))
    return tr - det_part


def nms(score: jnp.ndarray, radius: int = 3) -> jnp.ndarray:
    """Non-maximum suppression: keep pixels that are the max of their
    (2r+1)^2 neighborhood (≙ goodFeaturesToTrack minDistance=7 -> r=3)."""
    w = 2 * radius + 1
    pooled = jax.lax.reduce_window(
        score,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(w, w),
        window_strides=(1, 1),
        padding="SAME",
    )
    return jnp.where(score >= pooled, score, -jnp.inf)


@partial(jax.jit, static_argnames=("max_corners", "nms_radius", "border"))
def detect_corners(
    img: jnp.ndarray,
    max_corners: int = 1024,
    quality_level: float = 0.01,
    nms_radius: int = 3,
    border: int = 16,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Detect up to `max_corners` Shi-Tomasi corners.

    Returns:
      uv (K,2) float32 pixel coordinates (x, y),
      score (K,) corner responses,
      valid (K,) bool — False for slots below the quality gate.
    """
    H, W = img.shape
    resp = shi_tomasi_response(img)
    # Suppress the border so descriptor patches never leave the image.
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    in_border = (
        (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    )
    resp = jnp.where(in_border, resp, -jnp.inf)
    peaks = nms(resp, nms_radius)
    flat = peaks.reshape(-1)
    top, idx = jax.lax.top_k(flat, max_corners)
    y = (idx // W).astype(jnp.float32)
    x = (idx % W).astype(jnp.float32)
    uv = jnp.stack([x, y], axis=-1)
    max_resp = top[0]
    valid = (top > quality_level * max_resp) & jnp.isfinite(top)
    return uv, top, valid


def _shift(x: jnp.ndarray, dy: int, dx: int, fill: float = 0.0) -> jnp.ndarray:
    """out[y, x] = x[y - dy, x - dx], `fill` where that falls outside."""
    H, W = x.shape
    p = jnp.pad(
        x, ((max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))),
        constant_values=fill,
    )
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[y0 : y0 + H, x0 : x0 + W]


def _box3(x: jnp.ndarray) -> jnp.ndarray:
    """3x3 box sum via separable shifts."""
    h = _shift(x, 0, -1) + x + _shift(x, 0, 1)
    return _shift(h, -1, 0) + h + _shift(h, 1, 0)


def corner_peaks(img: jnp.ndarray, nms_radius: int = 3, border: int = 16) -> jnp.ndarray:
    """(H,W) image -> (H,W) NMS'd Shi-Tomasi response, -inf off-peak and
    inside the `border` (the same response `detect_corners` ranks)."""
    img = img.astype(jnp.float32)
    H, W = img.shape
    # Sobel gradients, /8 normalization as in shi_tomasi_response.
    tl, t, tr = _shift(img, 1, 1), _shift(img, 1, 0), _shift(img, 1, -1)
    bl, b, br = _shift(img, -1, 1), _shift(img, -1, 0), _shift(img, -1, -1)
    l, r = _shift(img, 0, 1), _shift(img, 0, -1)
    ix = (tr + 2 * r + br - tl - 2 * l - bl) * 0.125
    iy = (bl + 2 * b + br - tl - 2 * t - tr) * 0.125
    ixx = _box3(ix * ix) * (1.0 / 9.0)
    iyy = _box3(iy * iy) * (1.0 / 9.0)
    ixy = _box3(ix * iy) * (1.0 / 9.0)
    tr_h = 0.5 * (ixx + iyy)
    det_part = jnp.sqrt(jnp.maximum((0.5 * (ixx - iyy)) ** 2 + ixy * ixy, 0.0))
    resp = tr_h - det_part
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    neg_inf = jnp.float32(-jnp.inf)
    resp = jnp.where(inside, resp, neg_inf)
    # NMS: max over the (2r+1)^2 neighbourhood, separable (rows, then columns).
    m = resp
    for d in range(1, nms_radius + 1):
        m = jnp.maximum(m, jnp.maximum(_shift(resp, 0, -d, -jnp.inf),
                                       _shift(resp, 0, d, -jnp.inf)))
    mm = m
    for d in range(1, nms_radius + 1):
        mm = jnp.maximum(mm, jnp.maximum(_shift(m, -d, 0, -jnp.inf),
                                         _shift(m, d, 0, -jnp.inf)))
    return jnp.where(resp >= mm, resp, neg_inf)


def gaussian_blur_stencil(img: jnp.ndarray, sigma: float = 2.0, radius: int = 4) -> jnp.ndarray:
    """Separable Gaussian blur by shift-and-add with baked-in weights (zero
    padding, as `gaussian_blur`)."""
    img = img.astype(jnp.float32)
    x = np.arange(-radius, radius + 1)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g = (g / g.sum()).astype(np.float32)
    h = img * float(g[radius])
    for d in range(1, radius + 1):
        h = h + (_shift(img, 0, -d) + _shift(img, 0, d)) * float(g[radius + d])
    v = h * float(g[radius])
    for d in range(1, radius + 1):
        v = v + (_shift(h, -d, 0) + _shift(h, d, 0)) * float(g[radius + d])
    return v


@partial(jax.jit, static_argnames=("nms_radius", "border", "blur_radius", "blur_sigma"))
def corner_peaks_and_blur(
    img: jnp.ndarray,
    nms_radius: int = 3,
    border: int = 16,
    blur_radius: int = 4,
    blur_sigma: float = 2.0,
):
    """(H,W) image -> (NMS'd corner peaks, Gaussian-blurred image): the
    production front-end's detection and descriptor-blur stage."""
    return (
        corner_peaks(img, nms_radius, border),
        gaussian_blur_stencil(img, blur_sigma, blur_radius),
    )


def orientation(
    img: jnp.ndarray, uv: jnp.ndarray, patch_radius: int = 15
) -> jnp.ndarray:
    """ORB intensity-centroid orientation per keypoint (radians).

    Computes the patch moments m01/m10 for the whole image with two
    weighted box convolutions, then gathers at keypoints.
    """
    r = patch_radius
    coords = jnp.arange(-r, r + 1, dtype=img.dtype)
    yy = coords[:, None] * jnp.ones((1, 2 * r + 1), dtype=img.dtype)
    xx = coords[None, :] * jnp.ones((2 * r + 1, 1), dtype=img.dtype)
    circle = ((yy**2 + xx**2) <= r * r).astype(img.dtype)
    # conv_general_dilated is cross-correlation in ML convention: the kernel
    # is applied un-flipped, which is exactly the patch moment we want.
    m10 = _conv2d(img, xx * circle)
    m01 = _conv2d(img, yy * circle)
    xi = jnp.clip(uv[:, 0].astype(jnp.int32), 0, img.shape[1] - 1)
    yi = jnp.clip(uv[:, 1].astype(jnp.int32), 0, img.shape[0] - 1)
    return jnp.arctan2(m01[yi, xi], m10[yi, xi])
