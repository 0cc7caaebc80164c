"""Plain NumPy float64 references for the front-end stencils and the
large-map segment movements, independent of JAX.

Tests and `chip_smoke.py` compare the compiled device versions against
these: `corner_peaks_and_blur_np` ≙ ops.detect.corner_peaks_and_blur,
`extract_patches_np` ≙ ops.descriptor_mxu.extract_patches,
`cam_reduce_np` / `cam_expand_np` ≙ models.ba_large.cam_reduce /
cam_expand.
"""
from __future__ import annotations

import numpy as np


def _shift(x: np.ndarray, dy: int, dx: int, fill: float = 0.0) -> np.ndarray:
    """out[y, x] = x[y - dy, x - dx], `fill` outside."""
    H, W = x.shape
    out = np.full_like(x, fill)
    ys, yd = (slice(0, H - dy), slice(dy, H)) if dy >= 0 else (slice(-dy, H), slice(0, H + dy))
    xs, xd = (slice(0, W - dx), slice(dx, W)) if dx >= 0 else (slice(-dx, W), slice(0, W + dx))
    out[yd, xd] = x[ys, xs]
    return out


def _box3(x: np.ndarray) -> np.ndarray:
    h = _shift(x, 0, -1) + x + _shift(x, 0, 1)
    return _shift(h, -1, 0) + h + _shift(h, 1, 0)


def corner_peaks_and_blur_np(
    img: np.ndarray,
    nms_radius: int = 3,
    border: int = 16,
    blur_radius: int = 4,
    blur_sigma: float = 2.0,
):
    """(H,W) -> (NMS'd Shi-Tomasi peaks, -inf off-peak; Gaussian blur),
    float64."""
    img = np.asarray(img, np.float64)
    H, W = img.shape
    s = _shift
    ix = (s(img, 1, -1) + 2 * s(img, 0, -1) + s(img, -1, -1)
          - s(img, 1, 1) - 2 * s(img, 0, 1) - s(img, -1, 1)) / 8.0
    iy = (s(img, -1, 1) + 2 * s(img, -1, 0) + s(img, -1, -1)
          - s(img, 1, 1) - 2 * s(img, 1, 0) - s(img, 1, -1)) / 8.0
    ixx = _box3(ix * ix) / 9.0
    iyy = _box3(iy * iy) / 9.0
    ixy = _box3(ix * iy) / 9.0
    resp = 0.5 * (ixx + iyy) - np.sqrt(
        np.maximum((0.5 * (ixx - iyy)) ** 2 + ixy * ixy, 0.0)
    )
    inside = np.zeros((H, W), bool)
    inside[border : H - border, border : W - border] = True
    resp = np.where(inside, resp, -np.inf)
    m = resp.copy()
    for d in range(1, nms_radius + 1):
        m = np.maximum(m, np.maximum(s(resp, 0, -d, -np.inf), s(resp, 0, d, -np.inf)))
    mm = m.copy()
    for d in range(1, nms_radius + 1):
        mm = np.maximum(mm, np.maximum(s(m, -d, 0, -np.inf), s(m, d, 0, -np.inf)))
    peaks = np.where(resp >= mm, resp, -np.inf)

    x = np.arange(-blur_radius, blur_radius + 1)
    g = np.exp(-0.5 * (x / blur_sigma) ** 2)
    g /= g.sum()
    h = sum(s(img, 0, k) * g[blur_radius + k] for k in range(-blur_radius, blur_radius + 1))
    blur = sum(s(h, k, 0) * g[blur_radius + k] for k in range(-blur_radius, blur_radius + 1))
    return peaks, blur


def extract_patches_np(img: np.ndarray, uv: np.ndarray, patch: int = 32) -> np.ndarray:
    """(H,W) image, (K,2) keypoints -> (K,patch,patch) slices whose
    (patch/2 - 1, patch/2 - 1) texel is the keypoint, clipped to the image."""
    H, W = img.shape
    c = patch // 2 - 1
    out = np.empty((len(uv), patch, patch), img.dtype)
    for k, (u, v) in enumerate(np.asarray(uv)):
        x0 = int(np.clip(np.floor(u) - c, 0, W - patch))
        y0 = int(np.clip(np.floor(v) - c, 0, H - patch))
        out[k] = img[y0 : y0 + patch, x0 : x0 + patch]
    return out


def cam_reduce_np(data: np.ndarray, cam: np.ndarray, K: int) -> np.ndarray:
    """(C,N) per-slot rows, (N,) camera ids -> (C,K) float64 per-camera sums."""
    data = np.asarray(data, np.float64)
    return np.stack([np.bincount(cam, weights=row, minlength=K) for row in data])


def cam_expand_np(x: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """(C,K) camera table, (N,) camera ids -> (C,N) per-slot copies."""
    return np.asarray(x)[:, cam]
