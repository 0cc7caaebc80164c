"""CPU rehearsal of chip_smoke.py's `main` phase at reduced size: the
production drivers on the generated stream (320x240, 256 features) must
initialize, track every frame, run BA, drop no fetched result and hold the
smoke's ATE bounds. Sized to finish well inside a minute on the CPU."""
import chip_smoke
from visual_slam_tpu.utils.scene import SceneDataset


def test_main_phase_rehearsal():
    ds = SceneDataset(60, seed=0, width=320, height=240)
    mono, _, ate_mono = chip_smoke.run_stream(ds, 60, rgbd=False, max_features=256)
    chip_smoke.check_run("mono", mono, ate_mono, chip_smoke.MONO_ATE_BOUND_M)
    rgbd, _, ate_rgbd = chip_smoke.run_stream(ds, 30, rgbd=True, max_features=256)
    chip_smoke.check_run("rgbd", rgbd, ate_rgbd, chip_smoke.RGBD_ATE_BOUND_M)
    assert rgbd.stats["init_frame"] == 0
