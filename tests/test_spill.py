"""Stage spill/resume roundtrip + corruption detection."""

import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine.spill import (
    resume_partitions,
    spill_partitions,
)
from hash_join_codes_knl_tpu.ops.radix_partition import radix_partition

import jax.numpy as jnp


def test_spill_resume_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    hk = rng.integers(1, 2**32, 20000, dtype=np.uint32)
    vals = rng.integers(0, 2**32, 20000, dtype=np.uint32)
    out_k, out_v, counts, ovf = radix_partition(
        jnp.asarray(hk), jnp.asarray(vals), 3
    )
    assert int(ovf) == 0
    spill_partitions(str(tmp_path), "pass1", out_k, out_v, counts,
                     meta={"bits": 3})
    rk, rv, rc, meta = resume_partitions(str(tmp_path), "pass1")
    np.testing.assert_array_equal(rk, np.asarray(out_k))
    np.testing.assert_array_equal(rv, np.asarray(out_v))
    np.testing.assert_array_equal(rc, np.asarray(counts))
    assert meta["bits"] == 3


def test_spill_detects_corruption(tmp_path):
    hk = np.arange(1, 1001, dtype=np.uint32)
    spill_partitions(str(tmp_path), "s", hk, hk, np.array([1000]))
    # flip a byte in the key file
    p = tmp_path / "s_hk.bin"
    data = bytearray(p.read_bytes())
    data[17] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        resume_partitions(str(tmp_path), "s")


def test_spill_detects_val_corruption(tmp_path):
    """Payload-file corruption must be rejected too (regression: only
    the key file was checksummed, so a flipped val byte resumed and
    joined silently wrong payloads)."""
    hk = np.arange(1, 1001, dtype=np.uint32)
    vals = hk * np.uint32(3)
    spill_partitions(str(tmp_path), "s", hk, vals, np.array([1000]))
    p = tmp_path / "s_val.bin"
    data = bytearray(p.read_bytes())
    data[21] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="val checksum"):
        resume_partitions(str(tmp_path), "s")


def test_spill_meta_cannot_clobber_integrity_fields(tmp_path):
    """Caller meta keys that collide with the computed sidecar fields
    lose: the real n/counts/checksums must win (regression: meta was
    spread last and silently overwrote them)."""
    hk = np.arange(1, 257, dtype=np.uint32)
    spill_partitions(str(tmp_path), "m", hk, hk, np.array([256]),
                     meta={"n": 7, "counts": [1], "checksum": 0})
    rk, rv, rc, meta = resume_partitions(str(tmp_path), "m")
    assert meta["n"] == 256 and len(rk) == 256
    np.testing.assert_array_equal(rc, np.array([256]))
