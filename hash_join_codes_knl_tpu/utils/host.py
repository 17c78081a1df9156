"""Shared host-side helper: the u64 checksum (one definition for the
spill, stream, grace and relation modules)."""

from __future__ import annotations

import numpy as np


# below this, thread spawn + ctypes overhead beats numpy's single pass
_NATIVE_MIN = 1 << 20


def u64sum(arr) -> int:
    """u64 wraparound sum of words (write.cpp:1635-1645 checksum
    semantics).  Large u32 arrays go through the native relio kernel
    when it is available (multi-threaded, ~memory-bandwidth)."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint32 and arr.size >= _NATIVE_MIN:
        from .. import native

        if native.relio_available():
            return native.checksum_u32(arr)
    return int(np.sum(arr.astype(np.uint64), dtype=np.uint64))
