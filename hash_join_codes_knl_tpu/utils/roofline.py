"""Roofline accounting: achieved bandwidth vs the device's memory peak.

The reference reports raw seconds (npj.cpp:1104-1114); the CLI's
--timelog adds, per phase:

- the phase's modeled minimum device-memory traffic (bytes any
  implementation of that phase must move at least once),
- achieved bytes/s against wall time,
- the fraction of the device's peak memory bandwidth that represents.

Traffic model for the merge-mode PHJ pipeline (engine/phj.py):

- prep (partition-as-sort): lower bound = one read + one write of both
  relations' (key, val) streams.  A sort moves a multiple of this, which
  is what the roofline fraction makes visible.
- probe: reads the sorted probe keys and values and writes
  (match_val, match_cnt).
"""

from __future__ import annotations

import jax

# Peak device-memory bandwidth in bytes/s, keyed by jax's device_kind.
# NVIDIA H100 SXM5 80 GB: 3.35 TB/s of HBM3 (NVIDIA H100 Tensor Core GPU
# data sheet).
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak_bytes_per_s(device_kind: str | None = None) -> float:
    """Peak memory bandwidth of `device_kind` (default: device 0).
    Raises KeyError for a device the table does not list -- the CPU
    included -- rather than dividing by a guessed peak."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return HBM_PEAK[device_kind]
    except KeyError:
        raise KeyError(
            f"no memory-bandwidth peak recorded for device {device_kind!r}"
        ) from None


def merge_phj_traffic(ni: int, no: int) -> dict:
    """Per-phase minimum device-memory bytes for the merge-mode PHJ
    pipeline, keyed by the staged phase names (engine/phj.py
    phj_join_merge_staged)."""
    return {
        "partition_build": 2 * 8 * ni,  # r+w of (key,val) once
        "partition_probe": 2 * 8 * no,
        "probe": 8 * no + 8 * no,  # read (key,val), write (val,cnt)
    }


def roofline_report(phase_seconds: dict, traffic: dict,
                    device_kind: str | None = None) -> dict:
    """Achieved bytes/s and roofline fraction per phase + overall."""
    peak = hbm_peak_bytes_per_s(device_kind)
    out = {"hbm_peak_gbps": round(peak / 1e9, 1)}
    tot_b = tot_s = 0.0
    for phase, sec in phase_seconds.items():
        b = traffic.get(phase)
        if b is None or sec <= 0:
            continue
        tot_b += b
        tot_s += sec
        out[f"{phase}_gbps"] = round(b / sec / 1e9, 2)
        out[f"{phase}_pct_roofline"] = round(100 * b / sec / peak, 2)
    if tot_s > 0:
        out["pipeline_pct_roofline"] = round(100 * tot_b / tot_s / peak, 2)
    return out
