"""Stage spill / checkpoint: persist partitioned intermediates to disk.

The reference's only checkpoint is the relation files between `write` and
the join binaries (SURVEY.md section 5).  This module adds the optional
per-stage analog: any partitioned intermediate (the zero-padded
partition-contiguous layout produced by ops/radix_partition.py or
the exchange) can be spilled to disk and resumed, so a failed or
preempted multi-stage job restarts from the last completed stage instead
of the raw relations.  Every stage is a pure function of its inputs, so
resume-then-rerun is always sound (parallel/distributed.py).

Format: raw little-endian uint32 files via the native parallel IO path
(native/relio.cpp) plus one JSON sidecar with shape/counts metadata.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import native
from ..utils.host import u64sum


def _write_u32(path: str, arr: np.ndarray) -> None:
    if native.relio_available():
        native.write_u32(path, arr)
    else:
        np.ascontiguousarray(arr, dtype=np.uint32).astype("<u4").tofile(path)


def _read_u32(path: str, n: int) -> np.ndarray:
    if native.relio_available():
        return native.read_u32(path, n)
    out = np.fromfile(path, dtype="<u4", count=n)
    if len(out) != n:
        raise ValueError(f"{path} truncated")
    return out.astype(np.uint32)


def spill_partitions(directory: str, stage: str, hk, vals, counts,
                     meta: dict | None = None) -> str:
    """Persist one partitioned intermediate; returns the sidecar path."""
    os.makedirs(directory, exist_ok=True)
    hk = np.asarray(hk, dtype=np.uint32)
    vals = np.asarray(vals, dtype=np.uint32)
    counts = np.asarray(counts, dtype=np.uint32)
    _write_u32(os.path.join(directory, f"{stage}_hk.bin"), hk)
    _write_u32(os.path.join(directory, f"{stage}_val.bin"), vals)
    sidecar = os.path.join(directory, f"{stage}.json")
    with open(sidecar, "w") as f:
        # caller meta FIRST: the computed integrity fields must win a
        # key collision (a caller's own 'counts'/'n' overwriting the
        # real ones would corrupt or falsely reject every resume)
        json.dump(
            {
                **(meta or {}),
                "stage": stage,
                "n": int(hk.shape[0]),
                "partitions": int(counts.shape[0]),
                "counts": counts.tolist(),
                "checksum": u64sum(hk),
                "val_checksum": u64sum(vals),
            },
            f,
        )
    return sidecar


def resume_partitions(directory: str, stage: str):
    """Load a spilled intermediate; returns (hk, vals, counts, meta).

    BOTH column checksums are re-verified on load (write.cpp:1635-1645
    semantics): silent on-disk corruption is rejected, not joined.  A
    sidecar from before the val checksum existed is rejected the same
    way (recompute is always sound -- stages are pure functions).
    """
    with open(os.path.join(directory, f"{stage}.json")) as f:
        meta = json.load(f)
    hk = _read_u32(os.path.join(directory, f"{stage}_hk.bin"), meta["n"])
    vals = _read_u32(os.path.join(directory, f"{stage}_val.bin"), meta["n"])
    got = u64sum(hk)
    if got != meta["checksum"]:
        raise ValueError(
            f"spill {stage}: checksum mismatch ({got} != {meta['checksum']})"
        )
    got_v = u64sum(vals)
    if got_v != meta.get("val_checksum"):
        raise ValueError(
            f"spill {stage}: val checksum mismatch "
            f"({got_v} != {meta.get('val_checksum')})"
        )
    counts = np.asarray(meta["counts"], dtype=np.int32)
    return hk, vals, counts, meta
