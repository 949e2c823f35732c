"""chip_smoke.py refuses to run anywhere but on a GPU."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices())
    assert exc.value.code not in (0, None)
