"""Standalone radix sort / sort-by-key operator.

The reference's multi-pass radix machinery is partitioning-only (phj/cpra
never fully sort); BASELINE.json asks for radix sort/partition as a
standalone op.  A full key sort IS XLA's variadic sort (payload columns
ride along).  The partition-only forms are ops/partition.py (fused-sort)
and ops/radix_partition.py (histogram + scatter, for bounded fanouts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sort_relation(keys: jnp.ndarray, *payloads: jnp.ndarray):
    """Sort rows ascending by key; payload columns permuted along."""
    return jax.lax.sort((keys, *payloads), num_keys=1, is_stable=True)
