"""Heavy-hitter handling for the distributed shuffle (BASELINE configs 4-5).

Zipf-skewed probe streams concentrate mass on a few keys; the owner-hash
exchange would route all copies of a heavy key to one chip and overflow its
bucket (the reference has no answer to this -- its shared-memory threads just
contend, phj.cpp:1715-1770).  This design replicates the heavy build
tuples instead of exchanging the heavy probe tuples:

1. every chip aggregates a leading sample of its local probe shard (the
   generator's global shuffle makes any contiguous slice a uniform sample)
   and nominates keys above a frequency threshold;
2. nominations are all_gathered into one global candidate list (duplicates
   are harmless: membership and match counting tolerate repeated slots on
   the key side but the *tuple* side holds each build tuple exactly once);
3. heavy build tuples are all_gathered (replicated) to every chip; heavy
   probe tuples are nulled out of the exchange and joined LOCALLY against
   the replicated table -- they never cross the interconnect, which is the
   entire point: per-chip exchange traffic stays bounded regardless of skew.

The result is two aligned row sets (exchanged-light + local-heavy) whose
union is the join output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.partition import PAD_KEY


def nominate_heavy(keys: jnp.ndarray, sample: int, k_max: int,
                   heavy_frac: float):
    """Top local keys by sampled frequency; returns (k_max,) key slots
    (PAD_KEY padded).  A key qualifies if it covers > heavy_frac of the
    sample (>= 2 hits)."""
    from ..ops.partition import _sorted_rank_and_starts

    s = keys[: min(sample, keys.shape[0])]
    sk = jax.lax.sort((s,), num_keys=1)[0]
    n = sk.shape[0]
    # shared sorted-run rank machinery (ops/partition.py): rank within
    # the run; the run LENGTH is known at the run's last element
    j, _, _, rank = _sorted_rank_and_starts(sk)
    lastrun = jnp.concatenate([sk[1:] != sk[:-1], jnp.ones(1, bool)])
    run_len = rank + 1
    thr = max(2, int(heavy_frac * n))
    cand = lastrun & (run_len >= thr) & (sk != PAD_KEY)
    # pack candidates: sort by (not cand, -run_len) and take k_max; the
    # sorted rank keys ride out of the SAME sort (no second pass)
    rank_key = jnp.where(cand, jnp.uint32(0x7FFFFFFF) - run_len.astype(
        jnp.uint32), jnp.uint32(0xFFFFFFFF))
    srk, packed = jax.lax.sort((rank_key, sk), num_keys=1, is_stable=True)
    slots = packed[:k_max]
    keep = srk[:k_max] != jnp.uint32(0xFFFFFFFF)
    return jnp.where(keep, slots, PAD_KEY)


def is_member(keys: jnp.ndarray, heavy_keys: jnp.ndarray) -> jnp.ndarray:
    """Membership of each key in the (small, padded) heavy list."""
    eq = keys[:, None] == heavy_keys[None, :]
    eq &= (keys != PAD_KEY)[:, None]
    return jnp.any(eq, axis=1)


def probe_small_table(probe_keys, table_keys, table_vals):
    """Dense-compare probe against a small replicated table; returns
    (match_vals, match_cnts) aligned to probe order."""
    eq = (probe_keys[:, None] == table_keys[None, :]) & (
        probe_keys != PAD_KEY
    )[:, None]
    mval = jnp.max(jnp.where(eq, table_vals[None, :], jnp.uint32(0)), axis=1)
    mcnt = jnp.sum(eq, axis=1).astype(jnp.int32)
    return mval, mcnt


def extract_rows(keys, vals, flags, cap: int):
    """First `cap` flagged rows (padded): the fixed-size replication buffer."""
    key = (~flags).astype(jnp.uint32)
    _, pk, pv = jax.lax.sort((key, keys, vals), num_keys=1, is_stable=True)
    count = jnp.sum(flags.astype(jnp.int32))
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < count
    return (
        jnp.where(valid, pk[:cap], PAD_KEY),
        jnp.where(valid, pv[:cap], 0),
        count,
    )
