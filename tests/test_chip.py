"""The `kernels` comparisons of chip_smoke.py as tests: each compiled GPU
op against its plain reference at real widths. Marked `chip`; they skip
unless the run has a GPU (`JAX_PLATFORMS=cuda,cpu python -m pytest -m chip
tests/`)."""
import pytest

import chip_smoke


@pytest.fixture
def gpu():
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU in this run")


@pytest.fixture(scope="module")
def frame():
    from visual_slam_tpu.utils.scene import SceneDataset

    return SceneDataset(1, seed=0).gray_u8(0)


@pytest.mark.chip
def test_kernels_phase_on_gpu(gpu, frame):
    import jax

    with jax.default_device(gpu):
        chip_smoke.phase_kernels(frame)


@pytest.mark.chip
def test_large_map_phase_on_gpu(gpu):
    import jax

    with jax.default_device(gpu):
        chip_smoke.phase_large_map()
