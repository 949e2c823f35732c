import pytest

from bundleadjustment_tpu.pipeline import PipelineConfig
from tests.test_pipeline import run_and_ate


@pytest.mark.slow
def test_pipeline_with_dense_landmark_layout():
    """The dense landmark-major BA layout plugs into the tracking pipeline."""
    cfg = PipelineConfig(
        init_type="gtdepth",
        estimation="ba",
        n_features=300,
        n_levels=3,
        local_ba=False,
        final_ba_outer=1,
        final_ba_iters=8,
        ba_layout="dense_landmark",
    )
    res, pipe, stats = run_and_ate(cfg)
    assert res["rmse"] < 0.06, res
