"""Roofline accounting: the peaks table and the per-phase report."""

import pytest

from hash_join_codes_knl_tpu.utils.roofline import (
    hbm_peak_bytes_per_s,
    merge_phj_traffic,
    roofline_report,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_h100_row():
    assert hbm_peak_bytes_per_s(H100) == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "Unknown Accelerator", "NVIDIA A100", ""])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no memory-bandwidth peak"):
        hbm_peak_bytes_per_s(kind)


def test_cpu_backend_has_no_peak():
    # device 0 is the CPU here: no nominal fallback peak
    with pytest.raises(KeyError):
        hbm_peak_bytes_per_s()


def test_traffic_model_scales_with_relations():
    t1 = merge_phj_traffic(1_000, 16_000)
    t2 = merge_phj_traffic(2_000, 32_000)
    assert t2["partition_probe"] == 2 * t1["partition_probe"]
    assert t2["partition_build"] == 2 * t1["partition_build"]
    assert t2["probe"] == 2 * t1["probe"]
    assert set(t1) == {"partition_build", "partition_probe", "probe"}


def test_report_fractions():
    traffic = {"probe": 1_000_000_000}
    rep = roofline_report({"probe": 0.01}, traffic, H100)
    assert rep["probe_gbps"] == 100.0
    assert rep["probe_pct_roofline"] == pytest.approx(100 * 100e9 / 3.35e12,
                                                      abs=0.01)
    assert rep["hbm_peak_gbps"] == 3350.0
    assert "pipeline_pct_roofline" in rep
