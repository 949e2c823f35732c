"""Peak table and roofline shares (`utils/flops.py`)."""

from types import SimpleNamespace

import pytest

from bundleadjustment_tpu.utils import flops


@pytest.mark.parametrize("kind, fp32, hbm", [
    ("NVIDIA H100 80GB HBM3", 67e12, 3.35e12),
    ("NVIDIA H100 PCIe", 51e12, 2.0e12),
])
def test_h100_kinds_resolve(kind, fp32, hbm):
    dev = SimpleNamespace(device_kind=kind)
    peaks = flops.device_peaks(dev)
    assert peaks["fp32"] == fp32 and peaks["hbm"] == hbm
    assert peaks["bf16"] > peaks["tf32"] > peaks["fp32"]
    # roofline divides by the peak of the precision the products run at
    r = flops.roofline(10.0, 64, 10_000, 8, dev)
    assert r["peak_tflops"] == fp32 / 1e12
    assert r["flops_share"] == pytest.approx(
        r["flops_per_iter"] * 10.0 / fp32)


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        flops.device_peaks(SimpleNamespace(device_kind="cpu"))
