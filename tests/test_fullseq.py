"""Full-sequence driver gates (VERDICT r3 next #1).

The round-3 windowed driver collapsed only beyond ~200 frames of monocular
tracking — precisely where the unit suite stopped. These integration gates
run the production drivers over 600 real ICL-NUIM frames on CPU.

The gates run the conv/gather front-end route (FRONTEND_BACKEND = "xla"),
on which their ATE bounds were pinned. The driver logic under test —
speculation, stale-candidate re-track, failure retry, mine freshness,
keyframe cadence — is identical on either front-end route.
"""
import os

import numpy as np
import pytest

from visual_slam_tpu.models import frontend
from visual_slam_tpu.pipeline import run_sequence, size_config_for
from visual_slam_tpu.utils.dataset import ICLNUIMDataset
from visual_slam_tpu.utils import evaluate

DATA = "/root/reference/data/ICL_NUIM"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(DATA), reason="ICL-NUIM dataset not present"
)


@pytest.fixture
def xla_frontend():
    old = frontend.FRONTEND_BACKEND
    frontend.FRONTEND_BACKEND = "xla"
    yield
    frontend.FRONTEND_BACKEND = old


def _run(mode: str, n: int):
    ds = ICLNUIMDataset(DATA)
    cfg = size_config_for(n)
    slam = run_sequence(
        ds, cfg, 0, n,
        windowed=(mode == "windowed"), window=16,
        pipelined=(mode == "pipelined"),  # production default pipeline depth
    )
    slam.optimize_pose_graph()
    idxs, est = slam.positions()
    gt = ds.ground_truth()
    gp = gt[np.clip(idxs, 0, len(gt) - 1), :3, 3]
    rmse, _ = evaluate.ate_rmse(est, gp, align_scale=True)
    fails = sum(
        1 for f in slam.trajectory if f.n_tracked < 10 and f.frame_idx > 0
    )
    return slam, rmse, fails


@pytest.mark.slow
def test_windowed_600_frame_mono_holds(xla_frontend):
    """The production-collapse configuration of VERDICT r3: 600 frames,
    monocular, windowed driver. r3 shipped ATE 0.245 / 251 failures here;
    the gate pins the fix (stale-candidate re-track + fail retry + forced
    mine freshness)."""
    slam, rmse, fails = _run("windowed", 600)
    assert slam.initialized
    assert rmse < 0.10, rmse
    assert fails < 10, fails
    # Adaptive cadence, not a floor-driven one: strictly more than the
    # r3 pathology's 27-keyframes-per-1000-frames rate, and no
    # window-boundary lock (which showed as adjacent-pair duplicates).
    assert slam.stats["keyframes"] > 20


@pytest.mark.slow
def test_pipelined_600_frame_mono_holds(xla_frontend):
    """Production default on the same segment (r3 judge measurement:
    ATE 0.0297, 0 failures)."""
    slam, rmse, fails = _run("pipelined", 600)
    assert slam.initialized
    assert rmse < 0.10, rmse
    assert fails < 10, fails


def test_pipelined_200_frame_ate_gate(xla_frontend):
    """Accuracy pin (VERDICT r4 next #5): the 200-frame headline
    configuration's ATE is bounded at 0.02 so speed work cannot silently
    trade it away again (r2 0.0161 -> r4 0.0187 went ungated). Measured at
    the time of pinning: 0.0158 (CPU XLA route)."""
    slam, rmse, fails = _run("pipelined", 200)
    assert slam.initialized
    assert rmse < 0.02, rmse
    assert fails == 0, fails
    # No trajectory hole (ADVICE r4 medium): every frame from the accepted
    # init pair to the end must have a pose — frames consumed while the
    # async init confirm was in flight used to be dropped.
    idxs = sorted(f.frame_idx for f in slam.trajectory)
    init_f = slam.stats["init_frame"]
    expected = set(range(init_f, 200))
    missing = expected - set(idxs)
    assert not missing, f"trajectory holes after init: {sorted(missing)[:10]}"


@pytest.mark.slow
def test_pipelined_1200_frame_mono_ate_gate(xla_frontend):
    """Full-production-length accuracy pin (VERDICT r4 next #5): 1200
    frames, monocular, pipelined driver + final pose graph, ATE bounded at
    0.09."""
    slam, rmse, fails = _run("pipelined", 1200)
    assert slam.initialized
    assert rmse < 0.09, rmse
    assert fails < 10, fails
    # The sequence's only genuine revisit (frames ~1090-1170) is inside
    # this window; the loop machinery must have engaged on it.
    assert slam.stats.get("loop_closures", 0) >= 1, slam.stats
