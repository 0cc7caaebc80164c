"""The production front-end's stencil and patch ops and the large-map
segment movements against plain float64 NumPy references, on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest

from visual_slam_tpu.models import ba_large, frontend
from visual_slam_tpu.ops import descriptor_mxu, detect, reference
from visual_slam_tpu.utils import roofline
from visual_slam_tpu.utils.scene import SceneDataset


@pytest.fixture(scope="module")
def frame():
    return SceneDataset(1, seed=3, width=320, height=240).gray(0)


def test_detect_blur_matches_float64_reference(frame):
    peaks, blur = map(np.asarray, detect.corner_peaks_and_blur(jnp.asarray(frame)))
    rp, rb = reference.corner_peaks_and_blur_np(frame)
    thr = 0.01 * rp[np.isfinite(rp)].max()
    strong = rp > thr
    assert strong.sum() > 100
    # Same peak set above the quality gate; values to float32 rounding (the
    # response's cancellation error scales with the strongest response).
    np.testing.assert_array_equal(peaks > thr, strong)
    scale = rp[strong].max()
    assert np.max(np.abs(peaks[strong] - rp[strong]) / (np.abs(rp[strong]) + 0.1 * scale)) < 1e-5
    np.testing.assert_allclose(blur, rb, rtol=1e-5, atol=1e-7)
    # Off-peak pixels and the border band are -inf in both.
    np.testing.assert_array_equal(np.isfinite(peaks), np.isfinite(rp))


def test_stencil_peaks_match_conv_detector():
    """The stencil detector and the conv/reduce_window detector
    (detect.detect_corners, the "xla" route) rank the same corners."""
    img = np.zeros((128, 256), np.float32)
    rng = np.random.default_rng(0)
    img += rng.uniform(0, 0.05, img.shape).astype(np.float32)
    img[40:80, 60:100] = 1.0
    img[90:110, 150:200] = 0.7
    uv_ref, s_ref, v_ref = detect.detect_corners(jnp.asarray(img), max_corners=64)
    peaks = detect.corner_peaks(jnp.asarray(img))
    uv, s, v = frontend._topk_select(peaks, 64)
    ref_set = {tuple(p) for p in np.asarray(uv_ref)[np.asarray(v_ref)].astype(int)}
    got_set = {tuple(p) for p in np.asarray(uv)[np.asarray(v)].astype(int)}
    assert len(ref_set & got_set) >= 0.9 * max(len(ref_set), 1)
    np.testing.assert_allclose(
        sorted(np.asarray(s)[np.asarray(v)])[-5:],
        sorted(np.asarray(s_ref)[np.asarray(v_ref)])[-5:],
        rtol=1e-3,
    )


def test_patches_match_numpy_slicing(frame):
    H, W = frame.shape
    rng = np.random.default_rng(1)
    uv = np.stack([rng.uniform(0, W - 1, 64), rng.uniform(0, H - 1, 64)], -1)
    uv[:4] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]]  # clipped corners
    uv = uv.astype(np.float32)
    got = np.asarray(descriptor_mxu.extract_patches(jnp.asarray(frame), jnp.asarray(uv)))
    assert got.shape == (64, descriptor_mxu.PATCH, descriptor_mxu.PATCH)
    np.testing.assert_array_equal(got, reference.extract_patches_np(frame, uv))


@pytest.mark.parametrize("C,N,K", [(8, 5000, 300), (27, 4096, 257)])
def test_seg_kernels_match_xla(rng, C, N, K):
    """Camera-segment reduce (scatter-add) and expand (gather) against
    NumPy bincount / fancy indexing."""
    data = rng.normal(size=(C, N)).astype(np.float32)
    cam = rng.integers(0, K, N).astype(np.int32)
    x = rng.normal(size=(C, K)).astype(np.float32)
    red = np.asarray(ba_large.cam_reduce(jnp.asarray(data), jnp.asarray(cam), K))
    mag = reference.cam_reduce_np(np.abs(data), cam, K)
    assert red.shape == (C, K)
    assert np.max(np.abs(red - reference.cam_reduce_np(data, cam, K)) / (mag + 1e-30)) < 1e-5
    exp = np.asarray(ba_large.cam_expand(jnp.asarray(x), jnp.asarray(cam)))
    np.testing.assert_array_equal(exp, reference.cam_expand_np(x, cam))


def test_peak_table_rejects_unknown_device():
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3")["bf16_tflops"] == 989.0
    with pytest.raises(ValueError):
        roofline.peaks_for("cpu")
    costs = roofline.stage_costs(H=240, W=320, K=256)
    with pytest.raises(ValueError):
        roofline.stage_table(costs, {"detect_blur": 0.1}, device_kind="cpu")
    assert set(roofline.stage_table(costs)) == {k for k in costs if not k.startswith("_")}


def test_compile_cache_location(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set; otherwise the
    cache goes to <checkout>/.jax_cache."""
    import os

    import jax

    from visual_slam_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable() == "/elsewhere/cache"
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = compile_cache.enable()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
