"""Multi-sequence batched mode tests (config #3 semantics)."""
import os

import numpy as np
import pytest

DATA = "/root/reference/data/ICL_NUIM"

pytestmark = pytest.mark.skipif(
    not os.path.exists(DATA), reason="ICL-NUIM dataset not available"
)


def test_batched_matches_single():
    """Two copies of the same sequence must produce identical trajectories,
    and batched execution must match the single-sequence pipeline."""
    from visual_slam_tpu.config import SlamConfig
    from visual_slam_tpu.multi import run_batched
    from visual_slam_tpu.pipeline import run_sequence
    from visual_slam_tpu.utils.dataset import ICLNUIMDataset

    ds = ICLNUIMDataset(DATA)
    cfg = SlamConfig()
    cfg.use_depth = True  # fast init, no 65-frame monocular wait
    slams = run_batched([ds, ds], cfg, 0, 30)
    assert all(s.initialized for s in slams)
    i0, p0 = slams[0].positions()
    i1, p1 = slams[1].positions()
    np.testing.assert_allclose(p0, p1, atol=1e-5)
    # And equals the plain single-sequence run.
    single = run_sequence(ds, cfg, 0, 30)
    i2, p2 = single.positions()
    assert len(i0) == len(i2)
    np.testing.assert_allclose(p0, p2, atol=2e-2)  # batched vs single front-end


def test_batched_distinct_sequences_device_sharded():
    """Config #3 for real: DISTINCT pseudo-sequences (offset + reversed
    windows of traj3), front-end batch sharded over multiple devices, each
    result matching its own single-sequence run."""
    import jax
    from visual_slam_tpu.config import SlamConfig
    from visual_slam_tpu.multi import run_batched
    from visual_slam_tpu.pipeline import run_sequence
    from visual_slam_tpu.utils.dataset import ICLNUIMDataset, WindowView

    ds = ICLNUIMDataset(DATA)
    seqs = [WindowView(ds, 0), WindowView(ds, 120, reverse=True, length=400)]
    cfg = SlamConfig()
    cfg.use_depth = True
    slams = run_batched(seqs, cfg, 0, 30)
    assert all(s.initialized for s in slams)
    # Front-end ran device-parallel (8 virtual CPU devices in the suite).
    assert slams[0].stats["frontend_devices"] >= 2
    i0, p0 = slams[0].positions()
    i1, p1 = slams[1].positions()
    # Genuinely different trajectories.
    assert np.abs(p0 - p1).max() > 1e-3
    # Each matches its own single-sequence (unsharded) run.
    for seq, slam in zip(seqs, slams):
        single = run_sequence(seq, cfg, 0, 30)
        _, ps = single.positions()
        _, pb = slam.positions()
        np.testing.assert_allclose(pb, ps, atol=2e-2)


def test_batched_windowed_tracking_device_sharded():
    """Config #3, full loop: the whole tracking scan (extract -> match ->
    PnP -> keyframe rule) runs batched over sequences and sharded over
    devices (run_batched_windowed); each sequence must match its own
    single-sequence windowed run in quality."""
    from visual_slam_tpu.config import SlamConfig
    from visual_slam_tpu.multi import run_batched_windowed
    from visual_slam_tpu.pipeline import run_sequence
    from visual_slam_tpu.utils.dataset import ICLNUIMDataset, WindowView
    from visual_slam_tpu.utils.evaluate import ate_rmse

    ds = ICLNUIMDataset(DATA)
    gt = ds.ground_truth()
    seqs = [WindowView(ds, 0), WindowView(ds, 40)]
    cfg = SlamConfig()
    cfg.use_depth = True
    slams = run_batched_windowed(seqs, cfg, 0, 60, window=6)
    assert all(s.initialized for s in slams)
    # Tracking (not just the front-end) ran device-parallel.
    assert slams[0].stats["frontend_devices"] >= 2
    for b, (seq, slam) in enumerate(zip(seqs, slams)):
        idxs, est = slam.positions()
        assert idxs[-1] >= 55  # ran to the end of the range
        assert slam.stats["keyframes"] >= 1
        gt_idx = np.clip(np.asarray(idxs) + seq.offset, 0, len(gt) - 1)
        rmse, _ = ate_rmse(est, gt[gt_idx, :3, 3], align_scale=False)
        assert rmse < 0.03, (b, rmse)


@pytest.mark.slow
def test_batched_production_length_rgbd():
    """Config #3 at production length (VERDICT r4 next #7): two distinct
    600-frame RGB-D sequences through run_batched (the production
    multi-sequence mode — per-frame semantics, shared device-sharded
    front-end), each matching its own single-sequence run's ATE."""
    from visual_slam_tpu.models import frontend
    from visual_slam_tpu.multi import run_batched
    from visual_slam_tpu.pipeline import run_sequence, size_config_for
    from visual_slam_tpu.utils.dataset import ICLNUIMDataset, WindowView
    from visual_slam_tpu.utils.evaluate import ate_rmse

    old = frontend.FRONTEND_BACKEND
    frontend.FRONTEND_BACKEND = "xla"  # the route this gate was pinned on
    try:
        ds = ICLNUIMDataset(DATA)
        gt = ds.ground_truth()
        seqs = [WindowView(ds, 0), WindowView(ds, 300)]
        cfg = size_config_for(600)
        cfg.use_depth = True
        slams = run_batched(seqs, cfg, 0, 600)
        assert all(s.initialized for s in slams)
        for b, (seq, slam) in enumerate(zip(seqs, slams)):
            slam.optimize_pose_graph()
            idxs, est = slam.positions()
            assert idxs[-1] >= 590, (b, idxs[-1])
            gt_idx = np.clip(np.asarray(idxs) + seq.offset, 0, len(gt) - 1)
            rmse, _ = ate_rmse(est, gt[gt_idx, :3, 3], align_scale=False)
            single = run_sequence(seq, cfg, 0, 600)
            single.optimize_pose_graph()
            si, sp = single.positions()
            s_idx = np.clip(np.asarray(si) + seq.offset, 0, len(gt) - 1)
            s_rmse, _ = ate_rmse(sp, gt[s_idx, :3, 3], align_scale=False)
            # Batched must match its own single-sequence run (identical
            # semantics; front-end batching is the only difference).
            assert rmse < max(2 * s_rmse, s_rmse + 0.01), (b, rmse, s_rmse)
            assert rmse < 0.10, (b, rmse)
    finally:
        frontend.FRONTEND_BACKEND = old


@pytest.mark.slow
def test_batched_production_length_mono():
    """Config #3, monocular, 600 frames/sequence (the directive names
    mono explicitly — init search + scale handling run per sequence)."""
    from visual_slam_tpu.models import frontend
    from visual_slam_tpu.multi import run_batched
    from visual_slam_tpu.pipeline import run_sequence, size_config_for
    from visual_slam_tpu.utils.dataset import ICLNUIMDataset, WindowView
    from visual_slam_tpu.utils.evaluate import ate_rmse

    old = frontend.FRONTEND_BACKEND
    frontend.FRONTEND_BACKEND = "xla"  # the route this gate was pinned on
    try:
        ds = ICLNUIMDataset(DATA)
        gt = ds.ground_truth()
        seqs = [WindowView(ds, 0), WindowView(ds, 200)]
        cfg = size_config_for(600)
        cfg.use_depth = False
        slams = run_batched(seqs, cfg, 0, 600)
        assert all(s.initialized for s in slams)
        for b, (seq, slam) in enumerate(zip(seqs, slams)):
            slam.optimize_pose_graph()
            idxs, est = slam.positions()
            gt_idx = np.clip(np.asarray(idxs) + seq.offset, 0, len(gt) - 1)
            rmse, _ = ate_rmse(est, gt[gt_idx, :3, 3], align_scale=True)
            assert rmse < 0.10, (b, rmse)
    finally:
        frontend.FRONTEND_BACKEND = old
