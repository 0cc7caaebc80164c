"""The seeded ICL-NUIM-shaped stream (utils/scene.py)."""
import numpy as np
import jax.numpy as jnp
import pytest

from visual_slam_tpu.models import frontend
from visual_slam_tpu.utils.dataset import DEPTH_SCALE
from visual_slam_tpu.utils.scene import SceneDataset, intrinsics_for


def test_same_seed_same_frames():
    a = SceneDataset(3, seed=5, width=160, height=120)
    b = SceneDataset(3, seed=5, width=160, height=120)
    c = SceneDataset(3, seed=6, width=160, height=120)
    for i in range(3):
        np.testing.assert_array_equal(a.gray_u8(i), b.gray_u8(i))
        np.testing.assert_array_equal(a.depth_raw(i), b.depth_raw(i))
    np.testing.assert_array_equal(a.ground_truth(), b.ground_truth())
    assert not np.array_equal(a.gray_u8(0), c.gray_u8(0))


def test_interface_and_shapes():
    ds = SceneDataset(4, seed=0, width=320, height=240)
    assert len(ds) == 4
    g = ds.gray(1)
    assert g.shape == (240, 320) and g.dtype == np.float32
    assert 0.0 <= g.min() and g.max() <= 1.0
    assert ds.rgb(1).shape == (240, 320, 3) and ds.rgb(1).dtype == np.uint8
    assert ds.depth_raw(1).dtype == np.uint16
    np.testing.assert_allclose(ds.depth(1), ds.depth_raw(1) / DEPTH_SCALE, rtol=1e-6)
    d = ds.depth(1)
    assert 0.3 < d.min() and d.max() < 7.0  # metres, inside the room
    frames = list(ds.frames(1, 3))
    assert [i for i, _, _ in frames] == [1, 2]
    assert frames[0][1].dtype == np.uint8
    np.testing.assert_array_equal(frames[0][1].astype(np.float32) / 255.0, g)
    gt = ds.ground_truth()
    assert gt.shape == (4, 4, 4)
    for T in gt:
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-9)
    np.testing.assert_allclose(ds.intrinsics, intrinsics_for(320))
    np.testing.assert_allclose(intrinsics_for(640), [481.2, 480.0, 319.5, 239.5])


def test_loop_speed_and_revisit():
    """~1 cm and ~0.5 deg per frame; the camera returns to its starting
    viewpoint after the loop."""
    from visual_slam_tpu.utils.scene import trajectory

    T = trajectory(401, seed=0)
    step = np.linalg.norm(np.diff(T[:, :3, 3], axis=0), axis=1)
    assert 0.007 < step.mean() < 0.013
    cosang = [(np.trace(T[i, :3, :3].T @ T[i + 1, :3, :3]) - 1) / 2 for i in range(400)]
    ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    assert 0.3 < ang.mean() < 0.8
    np.testing.assert_allclose(T[400], T[0], atol=1e-9)


def test_depth_and_poses_consistent():
    """Backproject pixels of frame 0 through its depth, project them into
    frame 8, backproject there through frame 8's depth, and reproject into
    frame 0: the round trip lands within 0.5 px."""
    ds = SceneDataset(9, seed=1, width=320, height=240)
    fx, fy, cx, cy = ds.intrinsics.astype(np.float64)
    gt = ds.ground_truth()

    def backproject(i, u, v):
        z = ds.depth(i)[v, u].astype(np.float64)
        Xc = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
        return Xc @ gt[i, :3, :3].T + gt[i, :3, 3]

    def project(i, Xw):
        Xc = (Xw - gt[i, :3, 3]) @ gt[i, :3, :3]
        return fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy, Xc[:, 2]

    rng = np.random.default_rng(0)
    u0 = rng.integers(20, 300, 400)
    v0 = rng.integers(20, 220, 400)
    u1, v1, z1 = project(8, backproject(0, u0, v0))
    inside = (u1 > 1) & (u1 < 318) & (v1 > 1) & (v1 < 238)
    ui, vi = np.rint(u1[inside]).astype(int), np.rint(v1[inside]).astype(int)
    # Visible (not occluded) where frame 8's depth agrees with the projection.
    vis = np.abs(ds.depth(8)[vi, ui] - z1[inside]) < 0.02
    assert vis.mean() > 0.8
    u2, v2, _ = project(0, backproject(8, ui[vis], vi[vis]))
    # Rounding (u1, v1) to the pixel grid moves the point by <= 0.71 px in
    # frame 8; undo that shift to first order before comparing.
    du = (u1[inside][vis] - ui[vis])
    dv = (v1[inside][vis] - vi[vis])
    err = np.hypot(u2 + du - u0[inside][vis], v2 + dv - v0[inside][vis])
    assert np.median(err) < 0.5 and np.mean(err < 0.5) > 0.9


def test_enough_corners_at_full_resolution():
    ds = SceneDataset(1, seed=0)
    f = frontend.extract(jnp.asarray(ds.gray(0)), max_features=1024)
    assert int(np.asarray(f.valid).sum()) >= 500
