"""Output compaction: the close_gaps analog (K10, npj.cpp:475-514).

The reference compacts partially-filled output blocks with a two-pointer
move distributed by an atomic ticket counter.  Here the aligned join
output (flags per slot) is compacted deterministically: one stable sort by
the negated flag packs matched rows to the front in original order, and the
match count gives the valid prefix -- no atomics, no hole bookkeeping, and
the result order is deterministic (the reference's output order was not;
equality is defined on multisets either way, engine/oracle.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def compact_rows(flags: jnp.ndarray, *columns: jnp.ndarray):
    """Pack rows with flags != 0 to the front, preserving order.

    Returns (count, packed_columns...): the first `count` entries of each
    packed column are the surviving rows; the tail is the dropped rows.
    """
    key = (flags == 0).astype(jnp.uint32)
    sorted_all = jax.lax.sort((key, *columns), num_keys=1, is_stable=True)
    count = jnp.sum((flags != 0).astype(jnp.uint32))
    return (count, *sorted_all[1:])
