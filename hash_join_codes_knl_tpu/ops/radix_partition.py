"""Radix partition pass: the reference's histogram + scatter, in plain XLA.

The reference partitions in three steps: a per-thread histogram
(phj.cpp:693-772), exclusive offsets (phj.cpp:1263-1291), and a scatter
through write-combining buffers (phj.cpp:1029-1231).  Here:

- **group**: one key-value sort of the pass-rotated key, so every
  partition's tuples are contiguous and null keys (0) sort first;
- **histogram**: partition starts are a searchsorted of the F partition
  boundaries in the sorted keys, counts their differences;
- **scatter**: each tuple's rank within its partition is its sorted
  position minus the partition start, and one scatter with
  ``mode="drop"`` writes it to ``pid * cap + rank``.

Output layout: F partition-contiguous regions of `cap` slots each, null-key
(0) padded beyond each partition's fill -- the zero-masking convention every
downstream consumer applies.  Counts are exact even when a region
overflows; overflow (tuples past `cap`, dropped) is returned as a value and
callers retry with a larger cap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _rotl(x, s: int):
    """Rotate left by a static s: brings hash bits [31-s, ...] to the top.
    A bijection fixing 0, so null keys stay null."""
    if not s:
        return x
    return (x << jnp.uint32(s)) | (x >> jnp.uint32(32 - s))


def _rotr(x, s: int):
    if not s:
        return x
    return (x >> jnp.uint32(s)) | (x << jnp.uint32(32 - s))


def region_cap(n: int, F: int, cap: int = 0) -> int:
    """Per-partition region capacity in tuples, a multiple of 128.  cap=0
    sizes for uniform hashes: the mean plus eight standard deviations."""
    if cap == 0:
        mean = n / F
        cap = int(mean + 8 * mean ** 0.5)
    return -(-max(cap, 128) // 128) * 128


@functools.partial(jax.jit, static_argnames=("bits", "skip_bits", "cap"))
def radix_partition(
    hk: jnp.ndarray,  # (n,) scrambled keys; 0 = null/pad (dropped)
    vals: jnp.ndarray,  # (n,)
    bits: int,  # fanout F = 2^bits
    skip_bits: int = 0,  # hash bits already consumed upstream
    cap: int = 0,  # per-partition capacity in tuples (0 = auto)
):
    """One radix-partition pass by hash bits [31-skip, 31-skip-bits].

    Returns (out_hk, out_val, counts, overflow): out_* are (F * cap,)
    partition-contiguous zero-padded regions, counts (F,) exact
    per-partition tuple counts, overflow the number of tuples dropped
    because their partition held more than cap (0 = complete).
    """
    F = 1 << bits
    n = hk.shape[0]
    cap = region_cap(n, F, cap)
    if n == 0:
        z = jnp.zeros(F * cap, jnp.uint32)
        return z, z, jnp.zeros(F, jnp.int32), jnp.zeros((), jnp.int32)
    rot, v = jax.lax.sort((_rotl(hk, skip_bits), vals), num_keys=1)
    # boundary 0 is 1 so null keys (rot == 0) fall before every partition
    bounds = jnp.maximum(
        jnp.arange(F, dtype=jnp.uint32) << jnp.uint32(32 - bits),
        jnp.uint32(1),
    )
    starts = jnp.searchsorted(rot, bounds).astype(jnp.int32)
    counts = jnp.diff(starts, append=jnp.int32(n))
    pid = (rot >> jnp.uint32(32 - bits)).astype(jnp.int32)
    rank = jnp.arange(n, dtype=jnp.int32) - starts[pid]
    dest = jnp.where((rot != 0) & (rank < cap), pid * cap + rank, F * cap)
    out_k = jnp.zeros(F * cap, jnp.uint32).at[dest].set(
        _rotr(rot, skip_bits), mode="drop")
    out_v = jnp.zeros(F * cap, jnp.uint32).at[dest].set(v, mode="drop")
    overflow = jnp.sum(jnp.maximum(counts - cap, 0))
    return out_k, out_v, counts, overflow


def multipass_partition(hk: jnp.ndarray, vals: jnp.ndarray,
                        pass_bits: tuple, skip_bits: int = 0,
                        min_cap: int = 0):
    """Compose radix passes into a full partitioning (the reference's
    local multi-pass loop, phj.cpp:1791-1863: pass k+1 runs once per
    pass-k sub-partition, here as one batched pass over all regions).

    Returns (out_hk, out_vals, counts, overflow): out_* are
    2^sum(pass_bits) partition-contiguous regions of equal capacity
    (out.shape[0] / P), zero-padded; counts are exact per final
    partition; overflow != 0 means some pass dropped tuples past a
    region capacity.  Every pass's regions hold at least min_cap
    tuples."""
    n = hk.shape[0]
    k, v, counts, ovf = radix_partition(
        hk, vals, pass_bits[0], skip_bits=skip_bits,
        cap=max(min_cap, region_cap(n, 1 << pass_bits[0])))
    skip = skip_bits + pass_bits[0]
    for b in pass_bits[1:]:
        F_prev = counts.shape[0]
        cap = max(min_cap, region_cap(k.shape[0] // F_prev, 1 << b))
        step = functools.partial(radix_partition, bits=b, skip_bits=skip,
                                 cap=cap)
        k2, v2, c2, o2 = jax.vmap(step)(k.reshape(F_prev, -1),
                                        v.reshape(F_prev, -1))
        k, v, counts = k2.reshape(-1), v2.reshape(-1), c2.reshape(-1)
        ovf = ovf + jnp.sum(o2)
        skip += b
    return k, v, counts, ovf


def radix_partition_oracle(hk, vals, bits, skip_bits=0):
    """numpy oracle of the layout contract: per-partition multisets of
    (hk, val) pairs, null keys dropped."""
    hk = np.asarray(hk)
    vals = np.asarray(vals)
    F = 1 << bits
    live = hk != 0
    if skip_bits:
        rot = (hk << np.uint32(skip_bits)) | (hk >> np.uint32(32 - skip_bits))
    else:
        rot = hk
    pid = (rot >> np.uint32(32 - bits)).astype(np.int64)
    out = []
    for p in range(F):
        m = live & (pid == p)
        out.append((hk[m], vals[m]))
    return out
