"""Front-end tests: corner detection, descriptors, matmul Hamming matching."""
import numpy as np
import jax.numpy as jnp

from visual_slam_tpu.models import frontend
from visual_slam_tpu.ops import descriptor, detect, match


def checkerboard(h=480, w=640, cell=40):
    y = np.arange(h)[:, None] // cell
    x = np.arange(w)[None, :] // cell
    img = ((y + x) % 2).astype(np.float32)
    return img


def test_detect_corners_checkerboard():
    img = checkerboard()
    uv, score, valid = detect.detect_corners(jnp.asarray(img), max_corners=512)
    uv = np.asarray(uv)[np.asarray(valid)]
    # Corners must sit near cell intersections (multiples of 40), away from border.
    off = np.minimum(uv % 40, 40 - (uv % 40))
    assert len(uv) > 50
    assert np.median(np.max(off, axis=1)) <= 2.0


def test_detector_is_fixed_shape():
    img = checkerboard()
    uv, score, valid = detect.detect_corners(jnp.asarray(img), max_corners=256)
    assert uv.shape == (256, 2)
    assert score.shape == (256,)
    assert valid.shape == (256,)


def test_descriptor_shift_invariance(rng):
    """Descriptors of the same texture patch should match across a pure
    translation (the detector grid shifts, descriptors stay put)."""
    base = rng.uniform(0, 1, size=(480 + 8, 640 + 8)).astype(np.float32)
    # Smooth it so bilinear sampling is meaningful.
    import scipy.ndimage as ndi

    base = ndi.gaussian_filter(base, 3.0).astype(np.float32)
    img1 = base[:480, :640]
    img2 = base[4:484, 6:646]  # shifted by (-6, -4) in (x, y)
    f1 = frontend.extract(jnp.asarray(img1), max_features=256)
    f2 = frontend.extract(jnp.asarray(img2), max_features=256)
    idx2, dist, good = match.match_ratio_test(f1.desc, f2.desc, f1.valid, f2.valid)
    idx2 = np.asarray(idx2)
    good_np = np.asarray(good)
    assert good_np.sum() > 40
    # Matched keypoints must be displaced by exactly the shift.
    uv1 = np.asarray(f1.uv)[good_np]
    uv2 = np.asarray(f2.uv)[idx2[good_np]]
    disp = uv1 - uv2
    med = np.median(disp, axis=0)
    np.testing.assert_allclose(med, [6.0, 4.0], atol=1.0)
    frac_correct = (np.abs(disp - [6, 4]).max(axis=1) < 2).mean()
    assert frac_correct > 0.8


def test_hamming_matrix_matches_numpy(rng):
    d1 = rng.integers(0, 2**32, size=(32, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, size=(48, 8), dtype=np.uint32)
    got = np.asarray(match.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    want = np.zeros((32, 48))
    for i in range(32):
        for j in range(48):
            x = d1[i] ^ d2[j]
            want[i, j] = sum(bin(int(v)).count("1") for v in x)
    np.testing.assert_allclose(got, want)


def test_pack_unpack_roundtrip(rng):
    d = rng.integers(0, 2**32, size=(16, 8), dtype=np.uint32)
    pm1 = np.asarray(descriptor.unpack_pm1(jnp.asarray(d), dtype=jnp.float32))
    assert pm1.shape == (16, 256)
    assert set(np.unique(pm1)) <= {-1.0, 1.0}


def test_match_ratio_test_rejects_ambiguous():
    # Two identical descriptors in set 2 -> ratio test must reject.
    d1 = np.zeros((4, 8), dtype=np.uint32)
    d1[0] = 0xDEADBEEF
    d2 = np.zeros((4, 8), dtype=np.uint32)
    d2[0] = 0xDEADBEEF
    d2[1] = 0xDEADBEEF
    idx2, dist, good = match.match_ratio_test(
        jnp.asarray(d1),
        jnp.asarray(d2),
        jnp.ones(4, bool),
        jnp.ones(4, bool),
        cross_check=False,
    )
    assert not bool(good[0])  # two perfect candidates -> ambiguous -> rejected


def test_extract_batch_rides_pallas_path(rng):
    """extract_batch must be bit-identical to the per-image production
    front-end `extract` (one production front-end: the batched route
    computes the same features as single-sequence production)."""
    assert frontend.FRONTEND_BACKEND == "stencil"
    imgs = (rng.random((3, 480, 640)) * 255).astype(np.float32) / 255.0
    batched = frontend.extract_batch(jnp.asarray(imgs), max_features=256)
    for b in range(3):
        single = frontend.extract(jnp.asarray(imgs[b]), max_features=256)
        np.testing.assert_array_equal(np.asarray(batched.desc[b]),
                                      np.asarray(single.desc))
        np.testing.assert_array_equal(np.asarray(batched.uv[b]),
                                      np.asarray(single.uv))
        np.testing.assert_array_equal(np.asarray(batched.valid[b]),
                                      np.asarray(single.valid))
